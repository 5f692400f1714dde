"""A closed loop: ``outstanding`` callers, each sending its next call as
soon as the last one is answered."""
from __future__ import annotations

import itertools
import threading
import time


def run(traffic: dict, calls: list, entry, t_start: float,
        t_window: float, t_end: float, seed: int) -> list:
    """Records ``(call, caller, due, sent, done, answer, code)`` of every
    call sent to ``entry`` from ``t_start`` until ``t_end`` (monotonic
    clock; the warm-up before ``t_window`` runs the same loop);
    ``answer`` is None and ``code`` the error of a failed call.  A
    closed loop's call is due when it is sent."""
    nxt = itertools.count()
    out: list = []

    def caller(me: int) -> None:
        rec = []
        time.sleep(max(0.0, t_start - time.monotonic()))
        while True:
            t0 = time.monotonic()
            if t0 >= t_end:
                break
            i = next(nxt)
            try:
                ans, code = entry(calls[i % len(calls)]), ""
            except Exception as e:  # a failed call is a record, not a stop
                ans, code = None, type(e).__name__
            rec.append((i, me, t0, t0, time.monotonic(), ans, code))
        out.extend(rec)

    threads = [threading.Thread(target=caller, args=(c,), name=f"caller-{c}")
               for c in range(int(traffic["outstanding"]))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return out
