"""Decisions answered without error in calls that completed in the
window, over the window's seconds, taken at the client."""
import numpy as np


def read(run):
    c = run.calls
    sel = run.done_in_window() & c["ok"]
    return float(np.sum(c["good_rows"][sel])) / run.window_s
