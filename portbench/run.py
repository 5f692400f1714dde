#!/usr/bin/env python3
"""Run one cell of the benchmark of gubernator_tpu_torch once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is a ``workloads`` entry of BENCHMARK.json: a configuration
(``portbench/configs/<config>.json``) under a traffic mix
(``portbench/traffic/<traffic>.json``, whose ``generator`` names a
module of ``portbench/gen/``).  Each metric the cell reports is read by
``portbench/metrics/<metric>.py``.

A run starts the configuration's deployment in this process, fills its
table while the load generator encodes its calls, warms up with the
cell's own traffic for the traffic file's ``warmup_s``, then measures
for ``--seconds`` while the generator's threads call the servicer's
entry and the main thread sleeps (with ``--trace 1``, the window's last
``TRACE_S`` seconds under torch.profiler, for the per-layer metrics).  After the window it
reads keys back through the served path, stops the deployment, and
holds every answer to the plain reference (``portbench/lib/ref.py``).
The last line of standard output is the result; the last lines of
standard error are the numbers compared, each beside its limit.

``--rehearse`` runs the same on the CPU at a tiny size (no device
metric, no timing worth keeping); ``--control`` judges the reference's
coalescing control in the program's place, which has to come out not
correct.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: top-level module names the process must not hold once the window
#: has closed (the JAX package and JAX itself)
FORBIDDEN = ("jax", "jaxlib", "flax", "gubernator_tpu")
#: seconds at the window's end that a traced run records: every thread's
#: host operations make the trace long to gather
TRACE_S = 20.0
#: a tiny size for --rehearse on the CPU
REHEARSAL = {"keys": 20_000, "log2_rows": 16, "pool_calls": 64,
             "warmup_s": 1,
             "readback": {"hottest": 100, "sent": 300, "population": 300}}


def process_start_s() -> float:
    """This process's start on the CLOCK_BOOTTIME clock (s)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return int(fields[19]) / os.sysconf("SC_CLK_TCK")


def load_json(*parts) -> dict:
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def load_cell(name: str) -> tuple:
    """(cell, configuration file, traffic file, end-to-end metrics,
    per-layer metrics) of a workload of BENCHMARK.json."""
    bench = load_json("BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"portbench: no workload {name!r}")
    cell = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = load_json(entry["file"])
    traffic = load_json("portbench", "traffic", cell["traffic"] + ".json")

    def mine(ms):
        return [m for m in ms if name in m.get("workloads", [name])]

    return (cell, cfg, traffic, mine(bench["end_to_end"]),
            mine(bench["per_layer"]))


def reader(metric: str):
    """The module of ``metrics/<metric>.py``: ``read(run)``, and the host
    operations whose shapes it reads (``HOST_OPS``), if any."""
    path = os.path.join(ROOT, "portbench", "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


class GcLog:
    """The collector's pauses in this process (the daemon's): every
    thread stops for them."""

    def __init__(self):
        import gc

        self.pauses, self._t0 = [], None
        gc.callbacks.append(self._cb)

    def _cb(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.monotonic()
        elif self._t0 is not None:
            self.pauses.append((self._t0, time.monotonic(),
                                info["generation"]))

    def summary(self, t0: float, t1: float) -> dict:
        p = [(b, e, g) for b, e, g in self.pauses if t0 <= b < t1]
        return {"collections": len(p),
                "gen2": sum(g == 2 for *_, g in p),
                "ms": sum(e - b for b, e, _ in p) * 1e3,
                "max_ms": max([(e - b) * 1e3 for b, e, _ in p] or [0.0])}


def sleep_until(t: float) -> None:
    time.sleep(max(0.0, t - time.monotonic()))


def judge(res: dict, spec: dict, control: bool) -> tuple:
    """(the numbers compared, each with its limit; the calls' good and
    bad rows) for the generator's records ``res``."""
    import numpy as np

    from portbench.lib import ref

    per = int(spec["traffic"]["checks_per_call"])
    pool, ok = res["pool"], res["ok"]
    n_keys, limit = spec["n_keys"], spec["limit"]
    key_limit = np.full(n_keys, limit, np.int64)
    key_reset = np.full(n_keys, spec["fill_ms"] + spec["duration_ms"],
                        np.int64)
    rows = res["rows"]
    whole = ok & (rows == per)
    ans = res["answers"]
    # the answered calls' rows, in the order of the answers
    call_keys = pool[res["call"][ok] % len(pool)]
    start = np.r_[0, np.cumsum(rows[ok])]
    keep = np.concatenate([np.arange(start[i], start[i] + per)
                           for i in np.nonzero(whole[ok])[0]]
                          or [np.zeros(0, np.int64)])
    keys = call_keys[whole[ok]].ravel()
    cols = {k: v[keep] for k, v in ans.items()}
    if control:
        cols["status"], cols["remaining"] = ref.coalesced_answers(
            call_keys[whole[ok]], key_limit)
    checks = {"calls_failed": int((~ok).sum()),
              "calls_short": int((ok & ~whole).sum())}
    got = ref.judge_hits(keys, cols["status"], cols["remaining"],
                         cols["limit"], cols["reset_time"], cols["error"],
                         key_limit, key_reset)
    checks.update({k: v for k, v in got.items() if k != "rows"})
    hits = np.bincount(keys, minlength=n_keys)
    for rc in res["reads"]:
        n = len(rc["status"])
        got = ref.judge_reads(res["read_rows"][:n], rc["status"],
                              rc["remaining"], rc["limit"],
                              rc["reset_time"], rc["error"], hits,
                              key_limit, key_reset)
        checks["read_errors"] = checks.get("read_errors", 0) \
            + got["read_errors"] + (len(res["read_rows"]) - n)
        checks["read_wrong"] = checks.get("read_wrong", 0) \
            + got["read_wrong"]
    bad = np.zeros(len(ok), np.int64)
    bad[whole] = ans["error"][keep].reshape(-1, per).sum(axis=1) \
        if whole.any() else 0
    good = np.where(whole, per - bad, 0)
    bad = np.where(whole, bad, per)
    return checks, good, bad


def main(argv=None, plant=None) -> int:
    """One run.  ``plant(deployment)``, where given, breaks the served
    path before the traffic starts (the faults of the harness's tests)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true")
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    t_proc = process_start_s()

    cell, cfg, traffic, e2e, per_layer = load_cell(args.workload)
    n_keys, log2_rows = int(cfg["keys"]), int(cfg["log2_rows"])
    device = "cuda"
    if args.rehearse:
        device, n_keys, log2_rows = "cpu", REHEARSAL["keys"], \
            REHEARSAL["log2_rows"]
        traffic = dict(traffic, **{k: REHEARSAL[k] for k in (
            "pool_calls", "warmup_s", "readback")})

    import torch

    if not args.rehearse and (not torch.cuda.is_available()
                              or torch.cuda.device_count() < cell["chips"]):
        print(f"portbench: {cell['chips']} CUDA device(s) needed, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 3
    print(f"card: {card_line()}", file=sys.stderr, flush=True)

    import gc
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from portbench.lib import deploy, generator, prom
    from portbench.lib import trace as trace_mod
    from portbench.lib.readers import Run, hist_ms

    spec = {"traffic": traffic, "seed": args.seed, "n_keys": n_keys,
            "name": cfg["name"], "key_prefix": cfg["key_prefix"],
            "key_width": int(cfg["key_width"]),
            "limit": int(cfg["assumed"]["limit"]),
            "duration_ms": int(cfg["assumed"]["duration_ms"]),
            "hits": int(cfg["assumed"]["hits"])}
    readers = {m["name"]: reader(m["name"])
               for m in (per_layer if args.trace else e2e)}
    host_ops = sorted({op for r in readers.values()
                       for op in getattr(r, "HOST_OPS", ())})
    gc_log = GcLog()
    stamps = []

    def stamp(what: str) -> None:
        stamps.append((what, round(time.clock_gettime(time.CLOCK_BOOTTIME)
                                   - t_proc, 2)))

    dep = None
    try:
        stamp("imports")
        dep = deploy.start(cfg, device, log2_rows)
        stamp("daemon up")
        if plant is not None:
            plant(dep)
        pop_idx, pop_hash = deploy.population(cfg, n_keys, log2_rows)
        stamp("population")
        print(f"population: {n_keys} keys, key indices up to "
              f"{int(pop_idx[-1])}, {int(pop_idx[-1]) + 1 - n_keys} skipped "
              f"for a full bucket", file=sys.stderr)
        with ThreadPoolExecutor(1) as encoder:  # encodes while the fill runs
            encoding = encoder.submit(generator.Load, spec, pop_idx)
            spec["fill_ms"] = int(time.time() * 1000) - 1000
            placed = dep.fill(pop_hash, spec["limit"], spec["duration_ms"],
                              spec["fill_ms"])
            load = encoding.result()
        if placed != n_keys:
            raise RuntimeError(f"the fill placed {placed} of {n_keys} keys")
        del pop_idx, pop_hash
        stamp("filled and encoded")
        # what set-up made lives to the end: the collector skips it
        gc.collect()
        gc.freeze()

        prof = None
        if args.trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if device == "cuda" else [])
            extra = {}
            if host_ops:  # the readers' operations run on the daemon's threads
                from torch._C._profiler import _ExperimentalConfig

                extra = {"record_shapes": True,
                         "experimental_config": _ExperimentalConfig(
                             profile_all_threads=True)}
            # warmed up now, recording from the first step to the second
            prof = profile(activities=acts, schedule=torch.profiler.schedule(
                wait=0, warmup=1, active=1, repeat=1), **extra)
            prof.__enter__()
        t_start = time.monotonic() + 0.1
        window = (t_start + float(traffic["warmup_s"]),
                  t_start + float(traffic["warmup_s"]) + args.seconds)
        sender = threading.Thread(
            target=load.drive, name="generator",
            args=(dep.d.instance.get_rate_limits_wire, t_start, *window))
        sender.start()
        sleep_until(window[0])
        setup_s = time.clock_gettime(time.CLOCK_BOOTTIME) - t_proc
        stamp("window")
        before = [prom.scrape(u) for u in dep.metrics_urls]
        mark = None
        if prof is not None:
            sleep_until(max(window[0], window[1] - TRACE_S))
            prof.step()
            mark = torch.profiler.record_function(trace_mod.WINDOW_MARK)
            mark.__enter__()
        sleep_until(window[1])
        if mark is not None:
            mark.__exit__(None, None, None)
        after = [prom.scrape(u) for u in dep.metrics_urls]
        stamp("window closed")
        if prof is not None:  # stops recording, and gathers what it holds
            if device == "cuda":
                torch.cuda.synchronize()
            prof.step()
        sender.join()
        reduced = None
        if prof is not None:
            prof.__exit__(None, None, None)
            t_red = time.monotonic()
            reduced = trace_mod.reduce(prof, host_ops)
            del prof
            print(f"trace reduced in {time.monotonic() - t_red:.1f} s",
                  file=sys.stderr, flush=True)
            if reduced is not None:
                top = sorted(reduced["kernels"].items(),
                             key=lambda kv: -kv[1]["s"])[:5]
                print("launches of the top kernels and calls of the readers'"
                      " host operations in the window: " + json.dumps(
                          [[n[:48], k["launches"]] for n, k in top]
                          + [[n, len(c)] for n, c in
                             reduced["host_ops"].items()]), file=sys.stderr)
        res = load.collect(dep.read_addresses)
        del load
        stamp("answers decoded")
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    finally:
        if dep is not None:
            dep.close()

    stamp("deployment closed")
    t_ref = time.monotonic()
    checks, good, bad = judge(res, spec, args.control)
    res.update(good_rows=good, bad_rows=bad)
    run = Run(window=window, setup_s=setup_s, calls=res,
              scrapes=list(zip(before, after)), trace=reduced)
    metrics = {}
    for m in (per_layer if args.trace else e2e):
        v = readers[m["name"]].read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    due = run.due_in_window()
    done = run.done_in_window() & res["ok"]
    sec = np.floor(res["done"][done] - window[0]).astype(np.int64)
    per_s = np.bincount(sec, weights=good[done], minlength=int(args.seconds))
    stamp("judged")
    print(f"s since the process started: {stamps}", file=sys.stderr)
    print(f"decisions by second of the window: {per_s.tolist()}",
          file=sys.stderr)
    print("daemon over the window: " + json.dumps({
        "waves": sum(prom.delta(b, a, "gubernator_dispatcher_wave_size_count")
                     for b, a in run.scrapes),
        "wave_rows_mean": prom.hist_mean(run.scrapes,
                                         "gubernator_dispatcher_wave_size"),
        "wave_ms_mean": hist_ms(run, "gubernator_dispatcher_wave_duration"),
        "queue_wait_ms_mean": hist_ms(run, "gubernator_dispatcher_queue_wait"),
        "gc": gc_log.summary(*window)}), file=sys.stderr)
    print(f"window {window} (monotonic s): {int(due.sum())} calls due, {int(done.sum())} answered;"
          f" failed codes {res['codes']}; read-back {res['read_s']:.2f} s;"
          f" decode {res['decode_s']:.2f} s; reference "
          f"{time.monotonic() - t_ref:.2f} s", file=sys.stderr)

    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        print(f"portbench: the process holds {found}", file=sys.stderr)
        return 4
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device == "cuda"
           else "cpu", "count": int(cell["chips"]),
           "memory_peak_bytes": int(peak)}
    if reduced is not None:
        dev.update(busy_s=reduced["busy_s"], window_s=reduced["window_s"])
    correct = all(v == 0 for v in checks.values())
    out = {"correct": correct,
           "attempted": int(due.sum()) * int(traffic["checks_per_call"]),
           "failed": int(bad[due].sum()), "metrics": metrics,
           "device": dev}
    if reduced is not None:
        out["breakdown"] = reduced["breakdown"]
    out["checks"] = {k: {"value": v, "limit": 0} for k, v in checks.items()}
    for k, v in checks.items():
        print(f"check {k}: {v} (limit 0)", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
