"""Blocks ticked in the live engine's window that the engine discarded in a
backlog drop (the gaps in the ``live.burst`` spans' ``first_sample``):
whether a drop happens turns on the length of one capture stall, so these
are not counted as failed (program span)."""


def read(run):
    live = run.get("live")
    return None if not live else live["dropped_blocks"]
