"""Device time a block of the live engine: the union over a stretch of 100
blocks after the window of every graph round trip's interval (the rows'
copy to the card, the replays, the copy back), each between two CUDA
events on the card's clock, on every stream (the Silero worker's too),
over the stretch's blocks. The stretch runs as the window does, in bursts
of one block; one where more than a quarter of the bursts drained more is
timed again (the breakdown reports its drained bursts)."""


def read(run):
    t = run.get("trace")
    if not run.get("live") or not t or not t.get("busy_s"):
        return None
    return t["busy_ms_per_block"]
