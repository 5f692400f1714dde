"""Mean ms per wave of the wave's copies between host and card: the
packed pair's uploads and the result vector's download
(``gubernator_phase_duration{phase="wave.upload"|"wave.download"}``),
over the window's waves."""
from portbench.lib.program import per_wave_ms


def read(run):
    return per_wave_ms(run, "gubernator_phase_duration_sum",
                       ("wave.upload", "wave.download"))
