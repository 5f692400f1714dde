"""What the metric readers of ``portbench/metrics/`` share.

A reader is a file ``metrics/<metric name>.py`` with ``read(ctx)``,
which returns the metric's value, or None where the run gives it
nothing to read (the harness then leaves the metric out).  ``ctx`` is
a ``Run``.  A reader that needs the input shapes of host operations in
the traced window names them in ``HOST_OPS``; it finds them under the
trace's ``host_ops``."""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from portbench.lib import prom

#: H100 SXM's published HBM rate (NVIDIA's data sheet), bytes/s
HBM_BYTES_PER_S = 3.35e12


@dataclass
class Run:
    """One run as its readers see it.  Times are on the monotonic
    clock, in seconds."""

    window: tuple
    setup_s: float
    calls: dict
    #: per process: its /metrics before and after the window
    scrapes: list = field(default_factory=list)
    #: trace.reduce() of the window, or None
    trace: dict | None = None

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def done_in_window(self) -> np.ndarray:
        c = self.calls
        return (c["done"] >= self.window[0]) & (c["done"] < self.window[1])

    def due_in_window(self) -> np.ndarray:
        c = self.calls
        return (c["due"] >= self.window[0]) & (c["due"] < self.window[1])


def hist_ms(run: Run, family: str, **labels):
    v = prom.hist_mean(run.scrapes, family, **labels)
    return None if v is None else v * 1e3


def kernel_s(run: Run, fragment: str, what: str = "s"):
    """Device seconds (``what="launches"``: launches) of the kernels
    whose name holds ``fragment``."""
    if run.trace is None:
        return None
    ks = [k[what] for n, k in run.trace["kernels"].items() if fragment in n]
    return sum(ks) if ks else None


def idle_pct(run: Run):
    t = run.trace
    if t is None or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
