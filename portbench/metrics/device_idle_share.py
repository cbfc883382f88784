"""Share (%) of the traced calls' host-clock span in which no operation
ran on the device: 1 - (the union of the device intervals / the span)."""
from harness.trace import busy_seconds


def read(run):
    if not run.record.intervals or run.wall_s <= 0:
        return None
    return 100.0 * (1.0 - busy_seconds(run.record.intervals) / run.wall_s)
