"""ms per second of the window the Python collector held every thread
of the daemon's process (``gubernator_gc_pause_seconds``, all
generations)."""
from portbench.lib.program import window_sum


def read(run):
    s = window_sum(run, "gubernator_gc_pause_seconds_sum")
    return None if s is None else 1e3 * s / run.window_s
