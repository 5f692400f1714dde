"""Mean rows of a device wave in the window
(gubernator_dispatcher_wave_size, every process)."""
from portbench.lib import prom


def read(run):
    return prom.hist_mean(run.scrapes, "gubernator_dispatcher_wave_size")
