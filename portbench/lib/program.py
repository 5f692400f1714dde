"""What the readers of the program's own step spans and counters share:
their increase over the window in /metrics, summed over every process,
and per wave.  A reader of a family the program does not export (an
older program) gets None, and the harness leaves its metric out."""
from __future__ import annotations

from portbench.lib import prom

#: the dispatcher's host steps of a wave carry phase labels "wave.<step>"
#: (pack, device and resolve, the wave's phases, carry none of the prefix)
STEP = "wave."


def window_sum(run, sample: str, label: str = "", values=None):
    """The window's increase of ``sample``, over every process; with
    ``label``, only the series whose ``label`` is in ``values`` (a
    str: starts with it).  None where no process exports the sample."""
    total, seen = 0.0, False
    for before, after in run.scrapes:
        for key, v in after.items():
            if key[0] != sample:
                continue
            if label:
                lv = dict(key[1]).get(label)
                if lv is None or not (lv.startswith(values)
                                      if isinstance(values, str)
                                      else lv in values):
                    continue
            seen = True
            total += v - before.get(key, 0.0)
    return total if seen else None


def waves(run) -> float:
    """Waves the dispatchers ran in the window."""
    return sum(prom.delta(b, a, "gubernator_dispatcher_wave_size_count")
               for b, a in run.scrapes)


def per_wave_ms(run, sample: str, steps):
    """ms per wave of the steps ``steps`` (a tuple of phase labels, or
    a prefix) of ``sample``, a seconds sum; None where the program
    exports none of them or ran no wave."""
    s = window_sum(run, sample, "phase", steps)
    n = waves(run)
    return None if s is None or n <= 0 else 1e3 * s / n


def thread_cpu_pct(run, thread: str):
    """A serving thread's CPU share of the window, in % of one core."""
    s = window_sum(run, "gubernator_thread_cpu_seconds_total", "thread",
                   (thread,))
    return None if s is None else 100.0 * s / run.window_s
