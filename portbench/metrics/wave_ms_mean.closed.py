"""Mean ms of a device wave, launch to resolve, in the window
(gubernator_dispatcher_wave_duration, every process)."""
from portbench.lib.readers import hist_ms


def read(run):
    return hist_ms(run, "gubernator_dispatcher_wave_duration")
