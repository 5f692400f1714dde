"""chip_smoke.py's phase 4 and chip_ab.py's threshold sweep rehearsed on
the CPU at a small size: the plain step stands in for K1 and the host
clock for CUDA events, so the phases' wave making, table fill, checks
and bookkeeping run here before they run on the card."""
import time
import types

import numpy as np
import pytest
import torch

import chip_ab
import chip_smoke
from gubernator_tpu_torch.ops import decide as dmod


class HostEvent:
    def __init__(self, **_):
        self.t = 0.0

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


@pytest.fixture()
def rehearsal(monkeypatch):
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(torch.cuda, "Event", HostEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    launches = []

    def plain_for_k1(rows, b, now, hot=dmod.HOT_SEGMENT, stats=None):
        launches.append(hot)
        return dmod.decide_plain(rows, b, now)

    def raw_launch(torch_, rows, b, now, hot=None):
        launches.append(hot)
        return 0.01, 0.002

    monkeypatch.setattr(dmod, "decide_cuda", plain_for_k1)
    monkeypatch.setattr(chip_smoke, "time_raw_launch", raw_launch)
    args = types.SimpleNamespace(log2_cap=13, keys=2_000, waves=2,
                                 main_waves=2, wave_rows=256, small_rows=64,
                                 seed=0)
    pop_idx, pop_keys = chip_smoke.fit_population(args.keys, args.log2_cap)
    return args, pop_idx, pop_keys, launches


def test_phase4_rehearses_on_the_cpu(rehearsal):
    args, pop_idx, pop_keys, launches = rehearsal
    res = chip_smoke.phase_kernel_vs_plain(torch, args, pop_idx, pop_keys)
    assert res["max_abs_err"] == 0 and res["err_rows"] > 0
    assert len(res["main_wave_ms"]) == args.main_waves
    assert len(res["mixed_wave_counts"]) == args.waves
    assert res["small_wave"]["rows"] == args.small_rows
    for k in ("decide_cuda_host_ms", "decide_cuda_main_host_ms",
              "launch_host_ms", "launch_mixed_host_ms"):
        assert res[k] > 0
    # every wave through the stand-in, then the two raw launches
    assert len(launches) == 1 + args.waves + 1 + args.main_waves + 2


def test_phase4_waves_come_in_order(rehearsal):
    args, pop_idx, pop_keys, _ = rehearsal
    kinds = [(k, n) for _, k, n, _, _ in chip_smoke.phase4_waves(
        torch, args, pop_idx, pop_keys)]
    assert kinds == ([("warm-up", 256)] + [("mixed", 256)] * 2
                     + [("small", 64)] + [("main-path", 256)] * 2)


def test_threshold_sweep_rehearses_on_the_cpu(rehearsal):
    args, pop_idx, pop_keys, launches = rehearsal
    waves = {"mixed": [], "main-path": []}
    for _, kind, _, b, now in chip_smoke.phase4_waves(torch, args, pop_idx,
                                                      pop_keys):
        if kind in waves:
            waves[kind].append((b, now))
    sweep = chip_ab.hot_sweep(torch, None, waves)
    assert set(sweep) == {"mixed", "main-path"}
    assert all(list(v) == list(chip_ab.HOT_SWEEP) for v in sweep.values())
    assert sorted(set(launches)) == sorted(chip_ab.HOT_SWEEP)
    assert np.isfinite([t for v in sweep.values() for t in v.values()]).all()
