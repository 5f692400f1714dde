"""Mean ms a call spent writing its response bytes from the wave's
result columns, on the caller's thread, in the window
(``gubernator_phase_duration{phase="build"}``)."""
from portbench.lib.readers import hist_ms


def read(run):
    return hist_ms(run, "gubernator_phase_duration", phase="build")
