"""Mean thread CPU ms per wave in the wave's host steps
(``gubernator_phase_cpu_seconds{phase="wave.<step>"}``), over the
window's waves: what of ``wave_host_ms_mean.closed`` the worker spent
on a core, and not waiting (the GIL, the scheduler, a sleeping sync)."""
from portbench.lib.program import STEP, per_wave_ms


def read(run):
    return per_wave_ms(run, "gubernator_phase_cpu_seconds_total", STEP)
