"""The device trace of the window: torch.profiler over the harness's
process, reduced to the device's busy time, a kernel's time, the device
operations that took most time and the longest idle gaps."""
from __future__ import annotations

import re

import numpy as np

#: the CPU-side range the harness opens around the window
WINDOW_MARK = "portbench.window"


def _short(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.:-]+", "_", name)[:64]


def reduce(prof, host_ops=()) -> dict | None:
    """Busy seconds (the union of device intervals) inside the window
    mark, its length, each kernel's seconds and launches, the top device
    operations and the longest idle gaps, each labelled by the host
    event that overlaps it most; and, for each host operation named in
    ``host_ops``, ``(thread, start_ns, end_ns, input shapes)`` of each
    call that starts in the window (the profile records shapes).  None
    where the trace has no window mark or no device event in it.  Reads
    the profiler's raw events, without building its tree of them."""
    from torch.autograd import DeviceType

    evs = prof.profiler.kineto_results.events()
    if evs and hasattr(evs[0], "is_hidden_event"):
        evs = [e for e in evs if not e.is_hidden_event()]
    n = len(evs)
    names = [e.name() for e in evs]
    t0 = np.fromiter((e.start_ns() for e in evs), np.int64, n)
    t1 = t0 + np.fromiter((e.duration_ns() for e in evs), np.int64, n)
    dev = np.fromiter((e.device_type() == DeviceType.CUDA for e in evs),
                      bool, n)
    # a user annotation mirrored on the device's timeline is no work
    if n and hasattr(evs[0], "is_user_annotation"):
        for i in np.nonzero(dev)[0].tolist():
            dev[i] = not evs[i].is_user_annotation()
    wanted = set(host_ops)
    calls = [(names[i], evs[i].start_thread_id(), int(t0[i]), int(t1[i]),
              evs[i].shapes()) for i in range(n)
             if names[i] in wanted and not dev[i]] if wanted else []
    del evs
    marks = [i for i, n in enumerate(names) if n == WINDOW_MARK
             and not dev[i]]
    if not marks:
        return None
    w0, w1 = t0[marks[0]], t1[marks[0]]
    on = np.nonzero(dev & (t1 > w0) & (t0 < w1))[0]
    if not len(on):
        return None
    on = on[np.argsort(t0[on], kind="stable")]
    s, e = np.maximum(t0[on], w0), np.minimum(t1[on], w1)
    # the union of [s, e): a new run starts where s passes every end so far
    reach = np.maximum.accumulate(e)
    new_run = np.r_[True, s[1:] > reach[:-1]]
    run_s, run_e = s[new_run], np.maximum.reduceat(e, np.nonzero(new_run)[0])
    busy = int((run_e - run_s).sum())
    gaps = np.r_[run_s, w1] - np.r_[w0, run_e]
    g0 = np.r_[w0, run_e]
    top = np.argsort(-gaps, kind="stable")[:10]
    host = np.nonzero(~dev)[0]
    # the ranges that the harness and the profiler open around the window
    host = host[[names[i] != WINDOW_MARK
                 and not names[i].startswith("ProfilerStep#") for i in host]]
    idle = []
    for k in top:
        if gaps[k] <= 0:
            break
        a, b = g0[k], g0[k] + gaps[k]
        ov = np.minimum(t1[host], b) - np.maximum(t0[host], a)
        best = int(np.argmax(ov)) if len(ov) else -1
        label = names[host[best]] if best >= 0 and ov[best] > 0 \
            else "no host event"
        idle.append([_short(label), float(gaps[k]) / 1e9])
    by_name: dict = {}
    for i, d in zip(on.tolist(), (e - s).tolist()):
        t, c = by_name.get(names[i], (0, 0))
        by_name[names[i]] = (t + d, c + 1)
    ops = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)
    in_window: dict = {n: [] for n in host_ops}
    for name, tid, a, b, shapes in calls:
        if w0 <= a < w1:
            in_window[name].append((tid, a, b, shapes))
    return {"busy_s": busy / 1e9, "window_s": float(w1 - w0) / 1e9,
            "kernels": {n: {"s": t / 1e9, "launches": c}
                        for n, (t, c) in by_name.items()},
            "host_ops": in_window,
            "breakdown": {"device_ops": [[_short(n), t / 1e9]
                                         for n, (t, _) in ops[:10]],
                          "idle_gaps": idle}}
