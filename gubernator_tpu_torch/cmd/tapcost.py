"""The analytics worker's cost per wave: the object-lane tap (list
against columnar), and the worker's fold by section with the tenant
ledger off, on through the plain fold (the JAX algorithm) and on
through the host library's, on the object and the wire lane.

    python -m gubernator_tpu_torch.cmd.tapcost [--waves 200] [--jobs 8]
        [--batch 125] [--keys 10000000] [--seed 0]

The waves are built as the dispatcher builds an object-lane wave: --jobs
callers' batches of --batch requests on Zipf(1.1) ranks over --keys keys,
hashed and packed, with result columns that answer one row in ten
OVER_LIMIT, and the callers' response objects.  A wire wave is the same
callers' batches as GetRateLimitsReq bytes (one tenant learn tap each)
and the wave's columns.

The list / columnar comparison runs every wave in the order list,
columnar, columnar, list, each run on a fresh sketch:

- serving: the dispatcher thread's part, per wave (perf_counter): for
  the list tap the flattening of the wave's request and response lists
  and the enqueue, for the columnar tap its enqueue of references;
- worker: the analytics worker's part (the columnar tap's fold with the
  tenants off, as before the tenant ledger): per wave on the host's
  clock (perf_counter, the median), and over all the waves on this
  thread's CPU clock (thread_time, the mean a wave: a coarse clock reads
  0 for one wave).

The tenant arms (``off``, ``python``, ``native``) each run every wave
on a fresh KeyAnalytics, in the order off, python, native, native,
python, off, and time the worker's sections on this thread's CPU clock
(the sums over the waves, per wave): on the object lane ``numpy`` (the
work before the sketch's fold), ``sketch`` (its fold), ``names`` (the
name noting), ``tenants`` (the tenant learn and fold) and ``publish``
(``_maybe_publish``); on the wire lane ``learn`` (the wave's tenant
learn taps, applied together as the worker applies a drain's),
``sketch``, ``tenants`` (the fold) and ``publish``.  The host
library's calls (csrc/sketch.cpp, csrc/tenants.cpp) release the GIL:
their CPU time is counted apart (``cxx``), and ``gil_held`` is the rest.
Arms must leave equal sketches, and the two tenant folds equal ledgers.
Prints one JSON line.  CPU only: no device is touched.
"""
from __future__ import annotations

import argparse
import json
import queue
import sys
import time

import numpy as np


def build_waves(n_waves: int, jobs: int, batch: int, n_keys: int,
                seed: int) -> list:
    """[(khash, batch, cols, req_lists, resp_lists)] per wave."""
    from ..core.batch import pack_requests, responses_from_columns
    from ..dispatcher import _concat
    from ..hashing import hash_request_keys
    from ..types import RateLimitRequest

    rng = np.random.default_rng(seed)
    waves = []
    for _ in range(n_waves):
        req_lists, parts = [], []
        for _ in range(jobs):
            ranks = np.minimum(rng.zipf(1.1, batch), n_keys) - 1
            reqs = [RateLimitRequest(name="smoke", unique_key=f"k{r:08d}",
                                     hits=1, limit=100, duration=3_600_000)
                    for r in ranks.tolist()]
            kh = hash_request_keys([r.name for r in reqs],
                                   [r.unique_key for r in reqs])
            b, _ = pack_requests(reqs, 1, size=len(reqs), key_hashes=kh)
            req_lists.append(reqs)
            parts.append((b, kh))
        packed, khash = _concat(parts)
        n = len(khash)
        status = (rng.random(n) < 0.1).astype(np.int32)
        cols = (status, np.full(n, 100, np.int64),
                np.where(status == 1, 0, 50).astype(np.int64),
                np.zeros(n, np.int64), np.zeros(n, bool))
        resp_lists, a = [], 0
        for reqs in req_lists:
            resp_lists.append(responses_from_columns(
                tuple(c[a:a + len(reqs)] for c in cols)))
            a += len(reqs)
        waves.append((khash, packed, cols, req_lists, resp_lists))
    return waves


def list_tap_serving(q, khash, req_lists, resp_lists) -> None:
    """The dispatcher's part of the list tap: flatten the wave's request
    and response lists, copy them into the item, enqueue."""
    reqs = [r for rl in req_lists for r in rl]
    resps = [r for rl in resp_lists for r in rl]
    q.put_nowait(("reqs", list(reqs), list(resps),
                  int(time.time() * 1000), khash))


def list_tap_apply(sketch, item) -> None:
    """The worker's part of the list tap: hits, status and a name per
    request, then the sketch's fold with the names."""
    _, reqs, resps, t_ms, khash = item
    hits = np.fromiter((int(r.hits) for r in reqs), np.int64, len(reqs))
    over = np.fromiter((int(r.status) == 1 for r in resps), bool,
                       len(resps))
    names = [f"{r.name}_{r.unique_key}" for r in reqs]
    sketch.update(khash, hits, over, t_ms, names=names)


def run_arm(arm: str, ana, waves) -> tuple:
    """One arm over every wave, on a fresh sketch: the serving part's µs
    per wave, then the worker part over all the waves' items, timed as
    a whole on this thread's CPU clock (a coarse clock reads 0 for one
    wave) and on the host's clock per wave."""
    from ..analytics import NativeHeavyHitterSketch

    ana.sketch = NativeHeavyHitterSketch(k=ana.sketch.k,
                                         width=ana.sketch.width)
    ana._q = queue.Queue()
    serve, items, work = [], [], []
    for khash, packed, cols, req_lists, resp_lists in waves:
        t0 = time.perf_counter()
        if arm == "list":
            list_tap_serving(ana._q, khash, req_lists, resp_lists)
        else:
            ana.tap_named(khash, packed, cols, req_lists)
        serve.append((time.perf_counter() - t0) * 1e6)
        items.append(ana._q.get_nowait())
    c0 = time.thread_time()
    for item in items:
        t0 = time.perf_counter()
        if arm == "list":
            list_tap_apply(ana.sketch, item)
        else:
            ana._apply(item)
        work.append((time.perf_counter() - t0) * 1e6)
    cpu = (time.thread_time() - c0) * 1e6
    return serve, work, cpu, (ana.sketch.canonical_bytes(),
                              dict(ana.sketch._names))


class _CxxClock:
    """The host library with its ``gs_*`` and ``gt_*`` calls timed: each
    adds its thread CPU time to ``cxx``."""

    def __init__(self, lib):
        self._lib = lib
        self.cxx = 0.0

    def __getattr__(self, name):
        f = getattr(self._lib, name)
        if not name.startswith(("gs_", "gt_")):
            return f

        def call(*a):
            t0 = time.thread_time()
            try:
                return f(*a)
            finally:
                self.cxx += time.thread_time() - t0

        return call


def wire_items(waves) -> list:
    """Each wave's callers' batches as GetRateLimitsReq bytes with their
    key hashes (one tenant learn tap each), and the wave's columns."""
    from ..wire import encode_get_rate_limits

    out = []
    for khash, packed, cols, req_lists, _ in waves:
        learns, a = [], 0
        for reqs in req_lists:
            learns.append(("learn", encode_get_rate_limits(reqs),
                           khash[a:a + len(reqs)], False))
            a += len(reqs)
        over = (cols[0] == 1) & ~cols[4]
        out.append((learns, ("cols", khash, np.asarray(packed.hits),
                             over, 1)))
    return out


def tenant_arm(arm: str, waves, wire: list) -> dict:
    """One tenant arm over every wave, object lane then wire lane, each
    on a fresh KeyAnalytics: per-section CPU µs a wave, their C++ share,
    and the state the arm leaves."""
    from ..analytics import KeyAnalytics
    from ..metrics import Metrics

    out = {}
    for lane in ("object", "wire"):
        ana = KeyAnalytics(metrics=Metrics(),
                           tenant_fold="python" if arm == "python"
                           else "native")
        ana.close()  # the arm calls the worker's parts here
        if arm == "off":
            ana._tenants = None
        clock = _CxxClock(ana.sketch._lib)
        ana.sketch._lib = clock
        if arm == "native":
            ana._table._lib = clock
        secs: dict = {}
        cxx: dict = {}

        def part(name, fn, *a):
            c0, x0 = time.thread_time(), clock.cxx
            r = fn(*a)
            secs[name] = secs.get(name, 0.0) + time.thread_time() - c0
            cxx[name] = cxx.get(name, 0.0) + clock.cxx - x0
            return r

        wall = []
        for j, (khash, packed, cols, req_lists, _) in enumerate(waves):
            t0 = time.perf_counter()
            if lane == "object":
                item = ("named", khash, packed, cols, 1, req_lists)
                w = part("numpy", ana._named_columns, item)
                part("sketch", ana.sketch.update, w["khash"], w["hits"],
                     w["over"], w["t_ms"])
                part("names", ana._note_named, w)
                part("tenants", ana._fold_named_tenants, w)
            else:
                learns, (_, kh, hits, over, t_ms) = wire[j]
                # the worker applies a drain's learn taps together
                part("learn", ana._safe_learn, learns)
                part("sketch", ana.sketch.update, kh, hits, over, t_ms)
                if ana._tenants is not None:
                    part("tenants", ana._table.fold, ana._tenants, kh,
                         hits, over)
            part("publish", ana._maybe_publish)
            wall.append((time.perf_counter() - t0) * 1e6)
        n = len(waves)
        cpu = sum(secs.values())
        tot_cxx = sum(cxx.values())
        out[lane] = {
            "worker_us_median": float(np.median(wall)),
            "worker_cpu_us": cpu / n * 1e6,
            "cxx_us": tot_cxx / n * 1e6,
            "gil_held_us": (cpu - tot_cxx) / n * 1e6,
            "sections_cpu_us": {k: v / n * 1e6 for k, v in secs.items()},
            "sections_gil_held_us": {k: (secs[k] - cxx[k]) / n * 1e6
                                     for k in secs},
            "state": (ana.sketch.canonical_bytes(),
                      ana.tenants_snapshot()),
        }
    return out


def measure_tenants(waves) -> dict:
    """The three tenant arms (see the module), each run twice."""
    wire = wire_items(waves)
    runs: dict = {}
    for arm in ("off", "python", "native", "native", "python", "off"):
        runs.setdefault(arm, []).append(tenant_arm(arm, waves, wire))
    out: dict = {}
    for lane in ("object", "wire"):
        states = {arm: r[0][lane]["state"] for arm, r in runs.items()}
        if not states["off"][0] == states["python"][0] \
                == states["native"][0]:
            raise AssertionError(f"{lane}: the arms' sketches differ")
        if states["python"][1] != states["native"][1]:
            raise AssertionError(f"{lane}: the native tenant fold's "
                                 "ledger differs from the plain one's")
        lo = out[lane] = {"tenants_equal": True,
                          "tenant_totals": states["native"][1]["totals"]}
        for arm, rs in runs.items():
            a = {}
            for k in ("worker_us_median", "worker_cpu_us", "cxx_us",
                      "gil_held_us"):
                a[k] = float(np.mean([r[lane][k] for r in rs]))
            for k in ("sections_cpu_us", "sections_gil_held_us"):
                a[k] = {s: float(np.mean([r[lane][k][s] for r in rs]))
                        for s in rs[0][lane][k]}
            a["gil_longest_section"] = max(
                a["sections_gil_held_us"],
                key=a["sections_gil_held_us"].get)
            lo[arm] = a
    return out


def measure(n_waves: int = 200, jobs: int = 8, batch: int = 125,
            n_keys: int = 10_000_000, seed: int = 0) -> dict:
    """The tap's own cost, list against columnar (see the module)."""
    from ..analytics import KeyAnalytics

    waves = build_waves(n_waves, jobs, batch, n_keys, seed)
    ana = KeyAnalytics()
    ana.close()  # its worker stops: the arms call the worker's part here
    ana._tenants = None  # the tap alone, as it was measured before
    got = {"list": ([], [], []), "columnar": ([], [], [])}
    states = {}
    for arm in ("list", "columnar", "columnar", "list"):
        serve, work, cpu, state = run_arm(arm, ana, waves)
        got[arm][0].extend(serve)
        got[arm][1].extend(work)
        got[arm][2].append(cpu / n_waves)
        states.setdefault(arm, state)
    if states["list"] != states["columnar"]:
        raise AssertionError("the columnar tap's sketch differs from the "
                             "list tap's")
    out = {"waves": n_waves, "rows_per_wave": jobs * batch,
           "keys": n_keys, "sketches_equal": True}
    for arm, (serve, work, cpu) in got.items():
        out[arm] = {"serving_us_median": float(np.median(serve)),
                    "serving_us_mean": float(np.mean(serve)),
                    "worker_us_median": float(np.median(work)),
                    "worker_cpu_us_mean": float(np.mean(cpu))}
    for part in ("serving_us_median", "worker_us_median",
                 "worker_cpu_us_mean"):
        base = out["list"][part]
        out[f"{part}_columnar_over_list"] = (out["columnar"][part] / base
                                             if base else None)
    out["tenants"] = measure_tenants(waves)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--waves", type=int, default=200)
    ap.add_argument("--jobs", type=int, default=8)
    ap.add_argument("--batch", type=int, default=125)
    ap.add_argument("--keys", type=int, default=10_000_000)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    print(json.dumps(measure(a.waves, a.jobs, a.batch, a.keys, a.seed)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
