"""Mean ms a job waited from its submit to its wave's launch in the
window (gubernator_dispatcher_queue_wait, every process)."""
from portbench.lib.readers import hist_ms


def read(run):
    return hist_ms(run, "gubernator_dispatcher_queue_wait")
