"""CPU time of the analytics worker thread in the window (the device
taps' copies, the sketch and tenant folds), in % of one core
(``gubernator_thread_cpu_seconds{thread="analytics"}``)."""
from portbench.lib.program import thread_cpu_pct


def read(run):
    return thread_cpu_pct(run, "analytics")
