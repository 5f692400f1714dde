"""The ticker the GLOBAL manager's loops run on (the port's copy of
gubernator_tpu/interval.py; interval.go › Interval).

``Interval.wait()`` blocks until the next period or ``fire()``;
``IntervalLoop`` runs a function on every tick in a daemon thread, and
once more when it closes, so queues flush at shutdown.
"""
from __future__ import annotations

import logging
import threading
from typing import Callable

log = logging.getLogger("gubernator_tpu_torch.interval")


class Interval:
    """Periodic wakeup that ``fire()`` can bring forward."""

    def __init__(self, period_ms: int):
        self.period_s = max(period_ms, 1) / 1000.0
        self._ev = threading.Event()
        self._stopped = False

    def wait(self) -> bool:
        """True on a tick (or a fire), False once stopped."""
        if self._stopped:
            return False
        fired = self._ev.wait(self.period_s)
        if self._stopped:
            return False
        if fired:
            self._ev.clear()
        return True

    def fire(self) -> None:
        self._ev.set()

    def stop(self) -> None:
        self._stopped = True
        self._ev.set()


class IntervalLoop:
    """A daemon thread running ``fn()`` on every tick of an Interval."""

    #: how long close() waits for a running tick before it gives up
    DRAIN_TIMEOUT_S = 5.0

    def __init__(self, period_ms: int, fn: Callable[[], None], name: str):
        self.interval = Interval(period_ms)
        self._fn = fn
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while self.interval.wait():
            try:
                self._fn()
            except Exception:  # noqa: BLE001 - logged; the loop survives
                log.exception("interval loop %s", self._thread.name)

    def poke(self) -> None:
        self.interval.fire()

    def close(self, timeout_s: float = DRAIN_TIMEOUT_S) -> None:
        """Stop, then run ``fn()`` once more (the final flush) unless a
        wedged tick is still running: a flush concurrent with it would
        race the very queues it drains."""
        self.interval.stop()
        self._thread.join(timeout=timeout_s)
        if self._thread.is_alive():
            log.warning("interval loop %s did not drain within %.1f s; "
                        "skipping the final flush", self._thread.name,
                        timeout_s)
            return
        try:
            self._fn()
        except Exception:  # noqa: BLE001 - shutdown goes on
            log.exception("final flush of %s", self._thread.name)
