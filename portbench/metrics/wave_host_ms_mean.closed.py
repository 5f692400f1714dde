"""Mean ms per wave of the dispatcher's worker in the wave's host steps
(wave.fill, upload, plan, launch, download, collect: each
``gubernator_phase_duration{phase="wave.<step>"}``, exclusive of the
steps nested in it), over the window's waves.  Unlike
``wave_ms_mean.closed`` it is the worker's own time: a pipelined wave's
device phase overlaps the next wave's pack."""
from portbench.lib.program import STEP, per_wave_ms


def read(run):
    return per_wave_ms(run, "gubernator_phase_duration_sum", STEP)
