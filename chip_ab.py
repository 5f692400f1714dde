#!/usr/bin/env python3
"""Same-run comparisons on one NVIDIA GPU that chip_smoke.py does not
make on every run: K1, K2 and K3 against an earlier version of the
port's CUDA sources, and K1's launch alone against its hot-segment
threshold.

Run from the repository root on a machine with one NVIDIA GPU, with the
earlier sources unpacked inside the checkout (the GPU machine needs no
git), for example:

    mkdir -p build/ab_old
    git archive <commit> gubernator_tpu_torch/csrc | tar -x -C build/ab_old
    python3 chip_ab.py --old-csrc build/ab_old/gubernator_tpu_torch/csrc

The earlier K1 must take the same plan as the current one, without the
``hot`` and ``stats`` arguments (or with them: ``--old-k1-takes-hot``,
then it runs at the same threshold); the earlier K3 the same
arguments; the earlier K2 either one zeroed 64-bit counter (a
six-argument ``guber_sweep``, which its wrapper allocated a call) or the
current seven arguments (then both K2s are launched raw, the same way).
``--stream side`` runs everything on a stream of its own instead of
PyTorch's default stream.  ``--k3-only`` and ``--k2-only`` compare one
kernel.

Each pair is first checked equal on the same input (K1: outputs and the
whole table), then timed in turns, old, new, new, old, with two
measures: "device", the CUDA events around launches the host queued
while the stream spun in torch.cuda._sleep (device time only), and
"one_call", the events around one call on an idle stream, the host's
part of the launch inside.  K3's device measure is 20 queued launches,
beside torch.add on the same inputs.  K2 runs on phase 6's table of
chip_smoke.py (2^24 rows, 10M keys, ~30% expired): every version's
sweep of a fresh copy is checked equal to the plain version (key,
expire_at, live count, the other columns untouched), then each timed
launch sweeps a fresh copy followed by 128 MiB of writes and reads that
flush the L2 cache.  Its device time is the launch alone (the earlier
kernel's counter is zeroed before the spin), also with nothing expired
(reads only) and with everything expired (every non-empty row zeroed);
its one call is the wrapper as it was (the earlier six-argument one
allocates and zeroes its counter).  K1 runs on phase 4's table of
chip_smoke.py (2^25 rows, 10M keys) after the same waves; the threshold
sweep times the current K1 on every timed mixed and main-path wave.
The line before the last is nvidia-smi's name and power limit; the last
line is one JSON object with every number.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

import chip_smoke as cs

#: K1 hot-segment thresholds the sweep times (1 << 20: every segment on
#: one thread, no hot block)
HOT_SWEEP = (0, 4, 8, 12, 16, 24, 32, 48, 64, 128, 1 << 20)
#: the turn order of an A/B: old, new, new, old
TURNS = ("old", "new", "new", "old")


def takes_ring(sweep_cu: Path) -> bool:
    """Whether the ``guber_sweep`` of ``sweep_cu`` takes the current
    seven arguments (the count's counter and the one to clear)."""
    sig = re.search(r"int guber_sweep\(([^)]*)\)", sweep_cu.read_text())
    return sig is not None and sig.group(1).count(",") == 6


def build_old(csrc: Path, takes_hot: bool, names, k2_ring: bool) -> dict:
    """The earlier sources of ``names`` (of decide, probe, sweep), each
    built into a library of its own (one nvcc each, started together)
    under build/chip_ab/, and bound."""
    from gubernator_tpu_torch.ops import build

    out_dir = build.BUILD_DIR.parent / "chip_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = build.nvcc_path()
    procs = {}
    for name in names:
        lib = out_dir / f"old_{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *build.ARCH, *build.FLAGS, "-shared", "-o", str(lib),
             str(csrc / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, p) in procs.items():
        text, _ = p.communicate()
        cs.require(p.returncode == 0, f"nvcc on the old {name}.cu:\n{text}")
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas (old {name}):", line.strip(), flush=True)
        libs[name] = ctypes.CDLL(str(lib))
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    if "decide" in libs:
        libs["decide"].guber_decide.argtypes = (
            [ptr] * 6 + [i64, i64] + [i64, ptr] * takes_hot + [ptr, ptr])
        libs["decide"].guber_decide.restype = ctypes.c_int
    if "probe" in libs:
        libs["probe"].guber_probe_add.argtypes = [ptr, ptr, ptr, i64, ptr]
        libs["probe"].guber_probe_add.restype = ctypes.c_int
    if "sweep" in libs:
        libs["sweep"].guber_sweep.argtypes = (
            [ptr, ptr, i64, i64, ptr] + [ptr] * k2_ring + [ptr])
        libs["sweep"].guber_sweep.restype = ctypes.c_int
    return libs


def k3_ab(torch, old_lib, args) -> dict:
    """K3, earlier and current, and torch.add on 2^24 int32 elements."""
    from gubernator_tpu_torch.ops.build import load_library

    new_lib = load_library()
    rng = np.random.default_rng(args.seed + 3)
    x, y = (torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, 1 << 24)
                             .astype(np.int32)).cuda() for _ in range(2))
    want = x + y
    stream = torch.cuda.current_stream().cuda_stream
    outs = {v: torch.empty_like(x) for v in ("old", "new")}
    libs = {"old": old_lib, "new": new_lib}

    def launcher(v):
        if v == "add":
            return lambda: torch.add(x, y)

        def launch():
            rc = libs[v].guber_probe_add(x.data_ptr(), y.data_ptr(),
                                         outs[v].data_ptr(), x.numel(),
                                         stream)
            cs.require(rc == 0, f"{v} K3 launch failed: {rc}")
        return launch

    for v in ("old", "new"):
        launcher(v)()
        torch.cuda.synchronize()
        cs.require(torch.equal(outs[v], want), f"{v} K3 differs from x + y")
    # torch.add allocates its output: its first call must not be timed
    launcher("add")()
    res = {m: {"old": [], "new": [], "add": []} for m in ("device",
                                                          "one_call")}
    for _ in range(args.rounds):
        for v in TURNS + ("add",):
            f = launcher(v)
            res["device"][v].append(cs.queued_ms(torch, f))
            res["one_call"][v].append(cs.time_launch(torch, f, spin=False)[0])
    return res


def k2_raw(torch, lib, ring: bool):
    """A raw launch of a K2 library on a table: the earlier signature (one
    counter, which its wrapper allocated and zeroed a call) or, with
    ``ring``, the current one (the count's counter and one the kernel
    zeroes).  Returns (launch, the count's zeroing, one call as its
    wrapper made it)."""
    cnt = torch.zeros(2, dtype=torch.int64, device="cuda")

    def launch(state, now, live=cnt):
        clear = [live.data_ptr() + 8] * ring
        rc = lib.guber_sweep(state.key.data_ptr(),
                             state.expire_at.data_ptr(), state.key.numel(),
                             int(now), live.data_ptr(), *clear,
                             torch.cuda.current_stream().cuda_stream)
        cs.require(rc == 0, f"K2 launch failed: {rc}")
        return live[0]

    def one_call(state, now):
        return launch(state, now, torch.zeros(
            1, dtype=torch.int64, device=state.key.device))

    return launch, cnt.zero_, launch if ring else one_call


def k2_ab(torch, args, versions: dict) -> dict:
    """K2, earlier and current ({"old" / "new": (device-time call, its
    prepare or None, one call)}, each call ``(state, now) -> live
    count``), on phase 6's table: each equal to the plain version, then
    timed in turns (old, new, new, old) on fresh, L2-flushed copies,
    after one untimed round."""
    from gubernator_tpu_torch.ops import sweep as swm

    st, now, *_ = cs.sweep_table(torch, args)
    others = {f: getattr(st, f).clone() for f in st._fields
              if f not in ("key", "expire_at")}
    reclaim = cs.reclaimable(st, now)
    want = st._replace(key=st.key.clone(), expire_at=st.expire_at.clone())
    want_live = swm.sweep_plain(want, now)
    copies = cs.SweepCopies(torch, st)
    for v, (call, prepare, _) in versions.items():
        copies.reset()
        if prepare is not None:
            prepare()
        live = call(copies.state, now)
        cs.check_sweeps(torch, now, (copies.state, live), (want, want_live),
                        f"{v} K2 and the plain sweep")
    cs.require(all(torch.equal(getattr(st, f), c) for f, c in others.items()),
               "a sweep touched a column other than key / expire_at")
    del want, others
    # the same launch at now = int64 min, where no row is dead and the
    # sweep only reads ("read_only"), and at int64 max, where every row
    # is and it zeroes every row that is not empty ("all_dead")
    nows = {"device": now, "read_only": -2 ** 63, "all_dead": 2 ** 63 - 1}
    res = {m: {v: [] for v in versions} for m in nows}
    res["one_call"] = {v: [] for v in versions}
    for r in range(args.rounds + 1):  # round 0 warms up, untimed
        for v in TURNS:
            call, prepare, one = versions[v]
            for m, t in nows.items():
                ms = cs.time_sweep(torch, copies, call, t, True, prepare)[0]
                if r:
                    res[m][v].append(ms)
            ms = cs.time_sweep(torch, copies, one, now, False)[0]
            if r:
                res["one_call"][v].append(ms)
    res["bound_ms"] = cs.sweep_bound_ms(st.key.numel(), reclaim)
    res["reclaimed"] = reclaim
    del copies, st
    if cs.DEVICE == "cuda":
        torch.cuda.empty_cache()
    return res


def k1_launcher(torch, lib, inputs, hot=None):
    """A raw launch of K1 on ``inputs`` (chip_smoke.k1_inputs): the
    current signature when ``hot`` is given, else the earlier one."""
    scratch, plan, out = inputs
    stream = torch.cuda.current_stream().cuda_stream
    head = (scratch.data_ptr(), plan.req.data_ptr(), plan.order.data_ptr(),
            plan.seg_bucket.data_ptr(), plan.seg_start.data_ptr(),
            plan.seg_len.data_ptr(), plan.seg_bucket.numel(),
            plan.req.shape[1])

    def launch():
        if hot is None:
            rc = lib.guber_decide(*head, out.data_ptr(), stream)
        else:
            rc = lib.guber_decide(*head, hot, None, out.data_ptr(), stream)
        cs.require(rc == 0, f"K1 launch failed: {rc}")
    return launch


def k1_ab(torch, old_lib, rows, waves, args) -> dict:
    """K1, earlier and current (at HOT_SEGMENT), on the last mixed and
    the last main-path wave: equal, then timed in turns."""
    from gubernator_tpu_torch.ops import decide as dmod
    from gubernator_tpu_torch.ops.build import load_library

    new_lib = load_library()
    old_hot = dmod.HOT_SEGMENT if args.old_k1_takes_hot else None
    res = {}
    for kind in ("main-path", "mixed"):
        b, now = waves[kind][-1]
        runs = {}
        for v, lib, hot in (("old", old_lib, old_hot),
                            ("new", new_lib, dmod.HOT_SEGMENT)):
            inputs = cs.k1_inputs(torch, rows, b, now)
            k1_launcher(torch, lib, inputs, hot)()
            torch.cuda.synchronize()
            runs[v] = inputs
        cs.require(torch.equal(runs["old"][2], runs["new"][2])
                   and torch.equal(runs["old"][0], runs["new"][0]),
                   f"old and new K1 differ on the {kind} wave")
        del runs
        times = {m: {"old": [], "new": []} for m in ("device", "one_call")}
        for _ in range(args.rounds):
            for v in TURNS:
                lib, hot = ((old_lib, old_hot) if v == "old"
                            else (new_lib, dmod.HOT_SEGMENT))
                for m, spin in (("device", True), ("one_call", False)):
                    launch = k1_launcher(torch, lib, cs.k1_inputs(
                        torch, rows, b, now), hot)
                    times[m][v].append(cs.time_launch(torch, launch,
                                                      spin=spin)[0])
        res[kind] = times
    return res


def hot_sweep(torch, rows, waves) -> dict:
    """The current K1's launch alone (device time, median of 5) against
    the threshold, averaged over the timed waves of each kind."""
    res = {}
    for kind in ("main-path", "mixed"):
        res[kind] = {h: float(np.mean([
            cs.time_raw_launch(torch, rows, b, now, hot=h)[0]
            for b, now in waves[kind]])) for h in HOT_SWEEP}
    return res


def k1_phases(torch, args, old_lib):
    """Phase 4's table and waves, then K1 old against new and the
    threshold sweep."""
    from gubernator_tpu_torch.ops import decide as dmod

    with cs.phase("population"):
        pop_idx, pop_keys = cs.fit_population(args.keys, args.log2_cap)
    with cs.phase("waves"):
        eng = cs.fill_mixed_table(torch, args, pop_idx, pop_keys)
        waves = {"mixed": [], "main-path": []}
        t0 = time.perf_counter()
        for _, kind, _, b, now in cs.phase4_waves(torch, args, pop_idx,
                                                  pop_keys):
            dmod.decide_cuda(eng.rows, b, now)
            if kind in waves:
                waves[kind].append((b, now))
        torch.cuda.synchronize()
        print(f"waves applied in {time.perf_counter() - t0:.2f} s",
              flush=True)
    with cs.phase("K1 old vs new"):
        k1 = k1_ab(torch, old_lib, eng.rows, waves, args)
        print(f"K1: {json.dumps(k1)}", flush=True)
    with cs.phase("K1 hot-segment threshold"):
        sweep = hot_sweep(torch, eng.rows, waves)
        print(f"K1 launch alone (ms) by threshold: {json.dumps(sweep)}",
              flush=True)
    return k1, sweep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-csrc", type=Path, required=True,
                    help="directory holding the earlier decide.cu, "
                         "sweep.cu and probe.cu")
    ap.add_argument("--old-k1-takes-hot", action="store_true",
                    help="the earlier K1 takes the hot and stats arguments")
    ap.add_argument("--k3-only", action="store_true",
                    help="compare K3 only")
    ap.add_argument("--k2-only", action="store_true",
                    help="compare K2 only")
    ap.add_argument("--stream", choices=("default", "side"),
                    default="default")
    ap.add_argument("--rounds", type=int, default=3,
                    help="rounds of old, new, new, old turns")
    ap.add_argument("--log2-cap", type=int, default=25)
    ap.add_argument("--soa-log2-cap", type=int, default=24)
    ap.add_argument("--keys", type=int, default=10_000_000)
    ap.add_argument("--waves", type=int, default=8)
    ap.add_argument("--main-waves", type=int, default=4)
    ap.add_argument("--wave-rows", type=int, default=8192)
    ap.add_argument("--small-rows", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    from gubernator_tpu_torch.ops import decide as dmod
    from gubernator_tpu_torch.ops import sweep as swm
    from gubernator_tpu_torch.ops.build import load_library

    names = (["probe"] if args.k3_only else ["sweep"] if args.k2_only
             else ["probe", "sweep", "decide"])
    with cs.phase("device"):
        name, smi = cs.phase_device(torch)
    with cs.phase("build"):
        cs.phase_build()
        ring = "sweep" in names and takes_ring(args.old_csrc / "sweep.cu")
        old = build_old(args.old_csrc, args.old_k1_takes_hot, names, ring)
    if args.stream == "side":
        torch.cuda.set_stream(torch.cuda.Stream())
    k1 = k2 = k3 = sweep = None
    if "probe" in names:
        with cs.phase("K3 old vs new"):
            k3 = k3_ab(torch, old["probe"], args)
            print(f"K3: {json.dumps(k3)}", flush=True)
    if "sweep" in names:
        with cs.phase("K2 old vs new"):
            versions = {"old": k2_raw(torch, old["sweep"], ring),
                        "new": (k2_raw(torch, load_library(), True) if ring
                                else (swm.sweep_cuda, None,
                                      swm.sweep_cuda))}
            k2 = k2_ab(torch, args, versions)
            print(f"K2: {json.dumps(k2)}", flush=True)
    if "decide" in names:
        k1, sweep = k1_phases(torch, args, old["decide"])

    def means(d):
        return {k: means(v) if isinstance(v, dict) else float(np.mean(v))
                for k, v in d.items()}

    print(smi, flush=True)
    print(json.dumps({"device": name, "hot_segment": dmod.HOT_SEGMENT,
                      "old_csrc": str(args.old_csrc), "stream": args.stream,
                      "k2_old_takes_ring": ring,
                      "k3": k3 and {"runs": k3, "mean": means(k3)},
                      "k2": k2 and {"runs": k2, "mean": means(k2)},
                      "k1": k1 and {"runs": k1, "mean": means(k1)},
                      "k1_by_hot": sweep}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
