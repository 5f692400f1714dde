"""The object-lane analytics tap's own cost: the list tap it replaced
against the columnar tap (``KeyAnalytics.tap_named``), on the same waves.

    python -m gubernator_tpu_torch.cmd.tapcost [--waves 200] [--jobs 8]
        [--batch 125] [--keys 10000000] [--seed 0]

The waves are built as the dispatcher builds an object-lane wave: --jobs
callers' batches of --batch requests on Zipf(1.1) ranks over --keys keys,
hashed and packed, with result columns that answer one row in ten
OVER_LIMIT, and the callers' response objects.  Each arm runs every
wave, in the order list, columnar, columnar, list, each run on a fresh
sketch:

- serving: the dispatcher thread's part, per wave (perf_counter): for
  the list tap the flattening of the wave's request and response lists
  and the enqueue, for the columnar tap its enqueue of references;
- worker: the analytics worker's part: the list tap's per-request hits,
  status and name with the sketch's fold, against the columnar tap's
  fold and names for the keys the sketch has not named; per wave on the
  host's clock (perf_counter, the median), and over all the waves on
  this thread's CPU clock (thread_time, the mean a wave: a coarse clock
  reads 0 for one wave).

Both arms must leave equal sketches (the canonical bytes and the names).
Prints one JSON line: the µs a wave of each part, per arm, and the
columnar / list ratios.  CPU only: no device is touched.
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


def measure(n_waves: int = 200, jobs: int = 8, batch: int = 125,
            n_keys: int = 10_000_000, seed: int = 0) -> dict:
    """The tap's own cost, list against columnar (see the module)."""
    from ..analytics import KeyAnalytics

    waves = build_waves(n_waves, jobs, batch, n_keys, seed)
    ana = KeyAnalytics()
    ana.close()  # its worker stops: the arms call the worker's part here
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
