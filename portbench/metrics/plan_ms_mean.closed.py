"""Mean ms per wave of K1's plan (``ops/decide.py › _plan``: the bucket
sort and its two host syncs; ``gubernator_phase_duration{phase=
"wave.plan"}``), over the window's waves."""
from portbench.lib.program import per_wave_ms


def read(run):
    return per_wave_ms(run, "gubernator_phase_duration_sum",
                       ("wave.plan",))
