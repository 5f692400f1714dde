"""CPU time of the dispatcher's worker thread in the window, in % of
one core (``gubernator_thread_cpu_seconds{thread="dispatcher"}``, read
from /proc at each scrape)."""
from portbench.lib.program import thread_cpu_pct


def read(run):
    return thread_cpu_pct(run, "dispatcher")
