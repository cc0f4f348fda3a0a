"""Audio-seconds delivered to the sinks per wall second of the window, on
one card: every stream-block delivered, over the whole window."""

BLOCK_S = 480 / 48000.0


def read(run):
    if run["mix"]["loop"] != "closed":
        return None
    return run["delivered"] * BLOCK_S / run["window_s"]
