"""chip_smoke.py's phases 4, 5, 6, 7, its cluster, tiers, cli and
scenarios phases, and chip_ab.py's threshold sweep and K2 section,
rehearsed on the CPU at a small size: the plain versions stand in for
K1 and K2 and the host clock for CUDA events, so the phases' wave
making, table fill, checks, timing set-up and bookkeeping run here
before they run on the card."""
import os
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

    def plain_for_k1(rows, b, now, hot=dmod.HOT_SEGMENT, stats=None,
                     tally=None):
        launches.append(hot)
        return dmod.decide_plain(rows, b, now, tally)

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


@pytest.fixture()
def sweep_rehearsal(monkeypatch):
    """Phase 6 at 2^12 rows on the CPU: the plain sweep stands in for
    K2 (counting its calls) and the host clock for CUDA events."""
    from gubernator_tpu_torch.ops import sweep as swm

    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "L2_FLUSH_BYTES", 1 << 16)
    calls = []

    def plain_for_k2(state, now):
        calls.append(now)
        return swm.sweep_plain(state, now)

    monkeypatch.setattr(swm, "sweep_cuda", plain_for_k2)
    args = types.SimpleNamespace(soa_log2_cap=12, keys=2_000, sweep_reps=2,
                                 seed=0, rounds=2)
    return args, calls, plain_for_k2


def test_phase6_rehearses_on_the_cpu(sweep_rehearsal):
    args, calls, _ = sweep_rehearsal
    res = chip_smoke.phase_sweep_vs_plain(torch, args)
    assert res["max_abs_err"] == 0 and res["rows"] == 1 << 12
    assert 0 < res["live"] < res["placed"] and res["reclaimed"] > 0
    for k in ("ms", "one_call_ms", "host_ms", "plain_ms"):
        assert res[k] > 0
    assert len(res["ms_runs"]) == len(res["one_call_ms_runs"]) == 2
    assert res["bound_ms"] == pytest.approx(
        16 * ((1 << 12) + res["reclaimed"]) / chip_smoke.HBM_BYTES_PER_S
        * 1e3)
    # the checked sweep, one untimed sweep of each measure, then a
    # device-time and a one-call sweep a rep
    assert len(calls) == 1 + 2 + 2 * args.sweep_reps


def test_sweep_copies_restore_the_table_before_each_timed_sweep(
        sweep_rehearsal):
    from gubernator_tpu_torch.ops import sweep as swm

    args, _, _ = sweep_rehearsal
    st, now, *_ = chip_smoke.sweep_table(torch, args)
    key, exp = st.key.clone(), st.expire_at.clone()
    copies = chip_smoke.SweepCopies(torch, st)
    lives = []
    for _ in range(3):
        ms, host = chip_smoke.time_sweep(
            torch, copies, lambda s, t: lives.append(int(
                swm.sweep_plain(s, t))), now, spin=True)
        assert ms >= 0 and host >= 0
    # every timed sweep found the full table, and the source is intact
    assert len(set(lives)) == 1 and lives[0] < int((key != 0).sum())
    assert torch.equal(st.key, key) and torch.equal(st.expire_at, exp)
    assert bool((copies.flush == 1).all())


def test_chip_ab_k2_section_rehearses_on_the_cpu(sweep_rehearsal):
    args, calls, plain = sweep_rehearsal
    prepared = []
    versions = {"old": (plain, lambda: prepared.append(1), plain),
                "new": (plain, None, plain)}
    res = chip_ab.k2_ab(torch, args, versions)
    # both versions checked once, then an untimed round and the timed
    # ones: old, new, new, old, at now and at the int64 ends, and one
    # call
    rounds = args.rounds + 1
    assert len(calls) == 2 + rounds * 4 * 4
    for m in ("device", "read_only", "all_dead", "one_call"):
        assert {v: len(t) for v, t in res[m].items()} == {
            "old": 4, "new": 4}
    assert len(prepared) == 1 + rounds * 2 * 3
    assert res["reclaimed"] > 0 and res["bound_ms"] > 0


def test_chip_ab_reads_the_earlier_k2_signature(tmp_path):
    """PR 3's guber_sweep takes one counter; the current one takes the
    count's counter and the one to clear."""
    from gubernator_tpu_torch.ops import build

    assert chip_ab.takes_ring(build.CSRC / "sweep.cu")
    old = tmp_path / "sweep.cu"
    old.write_text("int guber_sweep(void* key, void* expire_at, int64_t n,"
                   "\n                int64_t now, void* live, "
                   "void* stream) {")
    assert not chip_ab.takes_ring(old)


def test_chip_ab_k2_refuses_a_version_that_differs(sweep_rehearsal):
    args, _, plain = sweep_rehearsal

    def misses_the_boundary(state, now):
        return plain(state, now - 1)

    with pytest.raises(RuntimeError, match="bad K2 and the plain sweep"):
        chip_ab.k2_ab(torch, args, {"new": (plain, None, plain),
                                    "bad": (misses_the_boundary, None,
                                            None)})


@pytest.fixture()
def path_rehearsal(monkeypatch):
    """Phases 5 (with its wire path) and 7 (with its wire round) on the
    CPU at a small size: the plain step stands in for K1 (counting its
    launches, as decide_cuda does) and the host clock for CUDA events."""
    import gubernator_tpu_torch.engine as emod

    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(torch.cuda, "Event", HostEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    # the daemons pipeline as they do on the card by default
    monkeypatch.setenv("GUBER_PIPELINE", "1")
    # below one batch: every batch of the admission round sheds, so the
    # rehearsal's result does not depend on its few callers' timing
    monkeypatch.setattr(chip_smoke, "ADMISSION_ROWS", 999)
    # the plain step on the CPU takes ~100x K1's time: the decision_p99
    # SLO's target (250 ms on the card) scaled to it
    monkeypatch.setenv("GUBER_SLO_P99_MS", "60000")

    def k1(rows, b, now, hot=dmod.HOT_SEGMENT, stats=None, tally=None):
        return dmod.decide_plain(rows, b, now, tally)

    def decide(rows, b, now, tally=None):
        k1.launches += 1
        return dmod.decide_plain(rows, b, now, tally)

    k1.launches = 0
    monkeypatch.setattr(dmod, "decide_cuda", k1)
    monkeypatch.setattr(emod, "decide", decide)
    return types.SimpleNamespace(
        log2_cap=13, soa_log2_cap=12, keys=2_000, threads=3, rounds=2,
        batches=2, profile_batches=1, seed=0, classic_rounds=2,
        classic_sweep_ms=50)


def test_main_and_wire_paths_rehearse_on_the_cpu(path_rehearsal,
                                                 monkeypatch):
    args = path_rehearsal
    monkeypatch.setattr(chip_smoke, "AB_PAIRS", 2)
    monkeypatch.setattr(chip_smoke, "ANALYTICS_AB_PAIRS", 2)
    monkeypatch.setattr(chip_smoke, "AB_BATCHES", 1)
    monkeypatch.setattr(chip_smoke, "TAP_COST_WAVES", 4)
    monkeypatch.setattr(chip_smoke, "TENANT_AB_PAIRS", 1)
    pop_idx, pop_keys = chip_smoke.fit_population(args.keys, args.log2_cap)
    res = chip_smoke.phase_main_path(torch, args, pop_idx, pop_keys)
    wire = res["wire"]
    assert res["launches"] > 0 and wire["launches"] > 0
    assert wire["requests"] == res["requests"] == \
        args.threads * (args.rounds * args.batches + args.profile_batches) \
        * 1000
    assert wire["pool_leaks"] == 0 and len(wire["rounds"]) == args.rounds + 1
    off = res["wire_pipeline_off"]
    assert len(off["rounds"]) == args.rounds and off["pool_leaks"] == 0
    for r in wire["rounds"] + off["rounds"]:
        assert r["inline_waves"] + r["waves"] > 0
        # every batch takes the fused lane: one lease each
        assert r["pool_hits"] + r["pool_misses"] == r["batches"]
        assert 0 <= r["inline_share"] <= 1
    assert wire["pipelined_waves"] > 0 and wire["inline_share"] == 0
    assert off["pipelined_waves"] == 0 and off["launches"] > 0
    assert set(res["pipeline"]["p99_ms"]) == {"on", "off"}
    m = res["metrics"]
    assert m["getratelimit_api"] == m["api_sent"] == 1 + 5 + 5 + \
        res["requests"]
    assert m["over_limit"] == m["over_answers"] > 4
    assert m["wave_duration_count"] == m["dispatcher_waves"] > 0
    h = res["healthz_deep"]
    assert (h["stalled"], h["timeouts"], h["queued_rows"],
            h["pipeline_depth"]) == (False, 0, 0, 2)
    a = res["admission"]
    assert a["shed_batches"] == a["batches"] == args.threads * args.batches
    assert a["shed_counter"] == a["shed_rows"] == a["batches"] * 1000
    dr = res["drain"]
    assert "draining" in dr["shed_after"]
    assert dr["served_ms"] < dr["grace_ms"] <= dr["closed_ms"]
    assert dr["events"] == ["drain_started", "drain_completed"]
    top = res["topkeys"]
    assert top["taps_dropped"] == 0 and len(top["hottest"]) == 16
    assert all(r["count"] >= r["sent"] > 0 for r in top["hottest"])
    # the reference's A/B: a warm-up pair, then ANALYTICS_AB_PAIRS timed
    # pairs with the native fold, each pair's ratio printed
    for lane in ("wire", "object"):
        assert set(res["analytics_ab"][lane]) == {"native"}
        a = res["analytics_ab"][lane]["native"]
        assert a["order"] == ["on", "off"] and len(a["ratios"]) == 2
        assert len(a["on_decisions_per_s"]) == 2 and a["off_median"] > 0
        assert a["taps_dropped"] == 0
        assert a["overhead_pct"] == (a["median_ratio"] - 1.0) * 100
    # the tap's own cost, list against columnar, on equal sketches
    tc = res["tap_cost"]
    assert tc["waves"] == 4 and tc["sketches_equal"]
    for arm in ("list", "columnar"):
        assert tc[arm]["serving_us_median"] > 0
        assert tc[arm]["worker_us_median"] > 0
    assert res["wire_analytics_off_launches"] > 0
    # the fold's move alone: analytics on in both arms
    for lane in ("wire", "object"):
        f = res["fold_ab"][lane]
        assert f["order"] == ["python", "native"] and len(f["ratios"]) == 2
        assert f["python_median"] > 0 and f["native_median"] > 0
        assert f["taps_dropped"] == 0
    for lane in ("wire", "object"):
        t = res["tenant_ab"][lane]
        assert t["order"] == ["tenants", "detached"] and len(t["ratios"]) == 1
    # the worker's sections, tenants off / python / native, on equal
    # ledgers
    for lane in ("object", "wire"):
        arms = tc["tenants"][lane]
        assert arms["tenants_equal"]
        for arm in ("off", "python", "native"):
            assert arms[arm]["gil_held_us"] <= arms[arm]["worker_cpu_us"]
            assert arms[arm]["gil_longest_section"]
    h = res["hash_ab"]
    assert h["order"] == ["native", "plain"] and len(h["ratios"]) == 2
    assert h["native_median"] > 0 and h["plain_median"] > 0
    # the observability checks: tenants against the round's tally, the
    # memory ledger against the tensors, a healthy daemon's SLOs, sampled
    # traces (and unsampled ones recording nothing), a profile capture
    obs = res["observability"]
    t = obs["tenants"]
    assert t["delta"] == t["tally"] and t["delta"]["requests"] == \
        args.threads * chip_smoke.AB_BATCHES * 1000
    m = obs["memory"]
    assert m["device_bytes"] == m["tensor_nbytes"] == (1 << 13) * 128
    assert sum(m["advised"].values()) == m["advise_total_rows"]
    assert not any(r["breached"] for r in obs["slo"]["slos"])
    tr = obs["traces"]
    assert tr["trees_ok"] == tr["sampled"] == chip_smoke.TRACE_BATCHES
    assert tr["unsampled"] == chip_smoke.TRACE_BATCHES
    assert tr["unsampled_recorded"] == 0
    assert 0 < tr["wave_share_of_handler_median"] <= 1
    p = obs["profile"]
    assert p["second_request"] == 409 and p["trace_bytes"] > 0
    assert p["rate_without"] > 0 and p["rate_with_capture"] > 0
    prof = res["object_host_profile"]
    assert prof["order"] == ["on", "off"]
    for state in prof["order"]:
        r, p = prof[state]["round"], prof[state]["profile"]
        assert r["batches"] == args.threads * args.profile_batches
        assert set(p["threads"]) == {"device-dispatcher", "key-analytics"}
        assert p["samples"] > 0 and p["process_cpu_s"] > 0
        assert "device-dispatcher" in p["top"]


def test_classic_path_and_wire_round_rehearse_on_the_cpu(path_rehearsal):
    args = path_rehearsal
    res = chip_smoke.phase_classic_main_path(torch, args)
    wire = res["wire"]
    assert wire["requests"] == args.threads * args.profile_batches * 1000
    assert wire["pool_leaks"] == 0 and len(wire["rounds"]) == 1
    off = res["wire_pipeline_off"]
    assert off["requests"] == wire["requests"] and off["pool_leaks"] == 0
    assert wire["pipelined_waves"] > 0 and off["pipelined_waves"] == 0
    assert res["capacity_after"] == 2 * res["capacity_before"]


def cluster_args(path_rehearsal, monkeypatch):
    """The cluster phase at a small size; its outage phase with shorter
    gate and circuit timings than the card's (the JAX defaults) and a
    small joining table."""
    args = path_rehearsal
    args.cluster_log2_cap, args.cluster_rounds = 12, 1
    args.batches = args.profile_batches = 1
    args.outage_batches, args.handover_log2_cap = 2, 11
    monkeypatch.setattr(chip_smoke, "CLUSTER_BEHAVIOR_OVERRIDES", dict(
        peer_eject_after_ms=2000, peer_readmit_after_ms=500,
        peer_circuit_cooldown_ms=300))
    monkeypatch.setattr(chip_smoke, "OUTAGE_MARGIN_S", 0.8)
    return args


def test_cluster_phase_rehearses_on_the_cpu(path_rehearsal, monkeypatch):
    args = cluster_args(path_rehearsal, monkeypatch)
    res = chip_smoke.phase_cluster(torch, args, solo_rate=1e6)
    assert res["nodes"] == 3 and len(res["steps_per_daemon"]) == 3
    assert all(res["steps_per_daemon"]) and res["launches"] > 0
    assert res["requests"] == args.threads * 1000 * (
        args.cluster_rounds * args.batches + args.profile_batches)
    # the 32 hottest ranks of Zipf(1.1) over 2000 keys (16 at the TOKEN
    # limit, 16 at 10^9): about 60% of the requests are GLOBAL; about
    # two thirds of the rest are forwarded
    assert 0.5 < res["global_share"] < 0.7
    assert res["exact_global_hits"] > 0
    assert 0.5 < res["forwarded_share_of_non_global"] < 0.85
    assert res["peer_flushes"] > 0 and res["items_per_flush"] >= 1
    assert res["global_hits_queued"] == res["global_hits_flushed"] > 0
    assert res["broadcasts"] > 0
    assert res["global_over_admission_sum"] >= \
        res["global_over_admission_max"] >= 0
    assert 0 < res["share_of_solo_wire"]
    assert len(res["decisions_per_s_rounds"]) == args.cluster_rounds
    # the outage phase, rehearsed: degraded rows in the degraded and
    # rehomed windows only, all counted, two ring flips on daemons 0
    # and 1 alone, the degraded hits queued as flagged, K1 launched
    out = res["outage"]
    w = out["windows"]
    assert w["degraded"]["degraded_rows"] > 0
    assert w["rehomed"]["degraded_rows"] > 0
    assert w["recovered"]["degraded_rows"] == 0
    assert out["degraded_served"] == out["rows_flagged"] == sum(
        x["degraded_rows"] for x in w.values())
    assert out["hits_degraded"] >= out["rows_flagged"]
    assert [b - a for a, b in zip(out["ring_generation_before"],
                                  out["ring_generation_after"])] == [2, 2, 0]
    assert out["fault_injected"] > 0 and out["launches"] > 0
    assert out["leaks"] == 0 and out["outage_hits"] > 0
    assert all(ms > 0 for ms in out["eject_ms_after_arming"]
               + out["readmit_ms_after_clearing"])
    # the new planes: sampled forwards assemble into one tree each, the
    # audit conserves once the queues drained, the cost model holds both
    # phases; the outage's degraded serves are force-sampled and counted
    # by the tenants, error_ratio breaches (both burns past the
    # threshold) and --fail-on-burn follows it; a closed daemon dumps
    assert res["traces"]["one_tree_each"] == res["traces"]["traces"] == \
        chip_smoke.CLUSTER_TRACES
    assert res["audit"]["fold"]["conserved"] and \
        res["audit"]["drift"] == [0, 0, 0]
    # the port's CLI folds the three daemons' /healthz and /debug/audit
    fl = res["audit"]["fleet_cli"]
    assert (fl["status_rc"], fl["audit_rc"], fl["drift"]) == (0, 0, 0)
    assert fl["daemons"] == fl["healthy"] == 3 and fl["ring_consistent"]
    assert {"broadcast", "peer_flush"} <= set(res["costmodel"]["phases"])
    assert out["tenant_degraded"] == out["degraded_served"]
    assert all(out["forced_traces_degraded_window"])
    assert out["fail_on_burn_before_arming"] == [0, 0]
    for i in ("0", "1"):
        deg = out["slo"]["degraded"][int(i)]
        assert deg["fail_on_burn_rc"] == 1
        if deg["error_ratio_breached"]:
            assert deg["error_ratio_fast_burn"] > 2 \
                and deg["error_ratio_slow_burn"] > 2
    dump = res["dump"]["daemons"]
    assert len(dump) == 4 and all(d["events"] > 0 for d in dump)
    assert all(d["spans"] > 0 and d["slo_verdicts"] for d in dump[:3])
    # the handover: every moved row sent, placed or counted dropped
    ho = res["handover"]
    assert ho["rows_moved"] == ho["rows_sent"] > 0
    assert ho["rows_placed"] + ho["rows_dropped"] == ho["rows_moved"]
    assert ho["still_on_old_owner"] == 0


def test_interleaved_pairs_follow_the_reference_discipline():
    """One untimed warm-up pair, then the pairs in turn, the second
    state entered after ``before_second``; the median of the per-pair
    ratios second / first."""
    from contextlib import contextmanager

    log = []

    def ctx(name):
        @contextmanager
        def c():
            log.append(f"enter {name}")
            yield
            log.append(f"exit {name}")
        return c

    rates = iter([1.0, 1.0, 10.0, 9.0, 10.0, 8.0, 10.0, 11.0])

    def arm(state):
        log.append(f"run {state}")
        return next(rates)

    out = chip_smoke.interleaved_pairs(
        "t", arm, (("on", ctx("on")), ("off", ctx("off"))),
        before_second=lambda: log.append("flush"), pairs=3)
    assert log[:6] == ["enter on", "run on", "exit on", "flush",
                       "enter off", "run off"]
    assert log.count("flush") == 4 and log.count("run on") == 4
    assert out["ratios"] == [0.9, 0.8, 1.1]
    assert out["median_ratio"] == 0.9
    assert out["on_decisions_per_s"] == [10.0, 10.0, 10.0]
    assert out["off_median"] == 9.0


def test_plain_hashing_swaps_the_object_lane_hash_and_answers_alike():
    """Inside the hashing A/B's plain arm the dispatcher hashes with the
    Python loop; an instance driven there answers a stream exactly as
    one driven with the native hash, and the native hash is back
    after it."""
    from gubernator_tpu_torch import dispatcher, hashing
    from gubernator_tpu_torch.config import Config
    from gubernator_tpu_torch.instance import V1Instance
    from gubernator_tpu_torch.types import RateLimitRequest

    reqs = [RateLimitRequest(name="n", unique_key=f"k{i % 7}é", hits=1,
                             limit=3, duration=60_000) for i in range(30)]
    got = []
    for ctx in (chip_smoke.plain_hashing, chip_smoke.nullcontext):
        inst = V1Instance(Config(device="cpu", cache_size=4096))
        try:
            with ctx():
                plain = dispatcher.hash_request_keys is \
                    hashing.hash_request_keys_plain
                assert plain == (ctx is chip_smoke.plain_hashing)
                got.append([(int(r.status), r.remaining, r.reset_time)
                            for b in range(3) for r in inst.get_rate_limits(
                                reqs, now_ms=1_765_000_000_000 + b)])
        finally:
            inst.close()
    assert dispatcher.hash_request_keys is hashing.hash_request_keys
    assert got[0] == got[1] and any(s == 1 for s, _, _ in got[0])


def test_group_phase_rehearses_on_the_cpu(path_rehearsal, monkeypatch):
    """The subprocess group at a small size (3 CPU workers): every worker
    reached and serving, the 10^9 GLOBAL keys exact on every worker,
    then a worker killed: ejected by both survivors, its keys degraded
    and counted, the others exact."""
    args = cluster_args(path_rehearsal, monkeypatch)
    monkeypatch.setattr(chip_smoke, "GROUP_KILL_MAX_BATCHES", 60)
    res = chip_smoke.phase_group(torch, args, cluster_rate=1e5,
                                 solo_rate=1e6)
    assert res["workers"] == 3 and sorted(res["connections_per_worker"]) \
        != [0, 0, 3]
    assert all(a > 0 for a in res["answered_per_worker"])
    assert sum(res["answered_per_worker"]) >= args.threads * 1000
    assert res["exact_global_hits"] > 0 and res["checked_requests"] > 0
    assert 0 < res["share_of_cluster"] and 0 < res["share_of_solo_wire"]
    k = res["kill"]
    assert k["killed"] == 2 and len(k["eject_ms_after_kill"]) == 2
    assert all(ms > 0 for ms in k["eject_ms_after_kill"])
    assert k["rows_degraded"] == k["degraded_served_counter"] > 0
    assert k["requests"] > 0
    assert k["table_full_keys"] <= k["keys_that_may_find_no_room"]
    assert k["table_full_keys"] <= \
        k["table_full_rows_of_the_dead_workers_keys"]


def test_regions_phase_rehearses_on_the_cpu(path_rehearsal, monkeypatch):
    """2 regions x 2 daemons at a small size: MULTI_REGION keys exact in
    both regions, an armed mr_sync holding every hit, the other keys
    exact per region."""
    args = cluster_args(path_rehearsal, monkeypatch)
    res = chip_smoke.phase_regions(torch, args, solo_rate=1e6)
    assert res["daemons"] == 4 and res["launches"] > 0
    assert res["exact_mr_hits"] > 0
    assert res["mr_sync_held_hits"] == 2 * chip_smoke.EXACT_MR_RANKS
    assert all(n > 0 for n in res["checked_requests"].values())
    assert res["convergence_ms"] > 0
    assert res["mr_over_admission_max"]["both"] >= 0
    # the round at the default send deadline is measured, not held
    # exact: its losses are counted, never a hit counted twice
    dd = res["default_deadline"]
    assert dd["send_deadline_ms"] == 900 and dd["hits_sent"] > 0
    assert dd["failed_sends"] >= 0 and set(dd["hits_lost"]) == \
        set(chip_smoke.REGIONS)
    assert all(0 <= n <= dd["hits_sent"] for n in dd["hits_lost"].values())


def test_hot_phase_rehearses_on_the_cpu(path_rehearsal, monkeypatch):
    """One daemon alone with the hot set's defaults against one at
    capacity 0, at a small size: the GLOBAL ranks promoted and pinned,
    the limit-100 keys admitted exactly 100, the 10^9 keys exact, every
    other key exact, hot waves timed, and each demotion counted."""
    args = cluster_args(path_rehearsal, monkeypatch)
    args.cluster_log2_cap = 14  # the 2000 keys fit, no bucket full
    monkeypatch.setattr(chip_smoke, "HOT_AB_PAIRS", 1)
    monkeypatch.setattr(chip_smoke, "HOT_BATCHES", 2)
    res = chip_smoke.phase_hot(torch, args)
    assert res["launches"] > 0 and res["promotions"] >= 16
    assert res["seeded_promotions"] == res["promotions"]
    assert res["hot_waves"] > 0 and res["hot_step_host_ms_mean"] > 0
    assert res["hot_wave_ms_with_lock_wait_mean"] > 0
    assert res["pin_calls"] >= res["promotions"]
    for lane in ("object", "wire"):
        ab = res["ab"][lane]
        assert ab["order"] == ["off", "on"] and len(ab["ratios"]) == 1
        assert ab["hot_waves"] > 0
    assert res["global"]["on"]["admitted_limit_100"][0] == 100
    assert res["global"]["on"] == res["global"]["off"] or \
        res["global"]["on"]["exact_hits_sent"] > 0
    dem = res["demotions"]
    assert (dem["flagged"], dem["config_change"], dem["remove_counted"]) \
        == (1, 1, 0)
    assert dem["snapshot_membership_change"] == dem["snapshot_rows"] > 0


def test_membership_phase_rehearses_on_the_cpu(path_rehearsal, monkeypatch):
    """A TLS pair and a plaintext pair on file discovery at a small size:
    the daemon alone pins every GLOBAL rank, the file rewrite joins the
    pair and demotes them all with their rows, TLS and plaintext rounds
    exact with no failed forward, a plaintext client refused."""
    args = cluster_args(path_rehearsal, monkeypatch)
    args.member_log2_cap = 14  # the 2000 keys fit, no bucket full
    monkeypatch.setattr(chip_smoke, "TLS_PAIRS", 1)
    monkeypatch.setattr(chip_smoke, "MEMBER_BATCHES", 1)
    res = chip_smoke.phase_membership(torch, args)
    assert res["certs_by"] == "cryptography"
    assert res["demoted"] == res["pinned_before_join"] == 32
    assert all(len(v) == 2 and min(v) > 0 for v in res["join_ms"].values())
    assert res["forwarded_rows"]["tls"] > 0
    assert res["failed_forwards"] == {"tls": 0, "plain": 0}
    assert res["plaintext_client"] == "UNAVAILABLE"
    assert res["ab"]["order"] == ["plain", "tls"] and res["launches"] > 0


def test_certs_by_openssl_serve_tls(tmp_path, monkeypatch):
    """Where cryptography does not import, the openssl command writes
    the CA and certificate, and a daemon serves TLS with them."""
    import builtins
    import shutil

    if shutil.which("openssl") is None:
        pytest.skip("no openssl command here")
    real = builtins.__import__

    def no_crypto(name, *a, **k):
        if name.startswith("cryptography"):
            raise ImportError(name)
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_crypto)
    ca, cert, key, how = chip_smoke.write_certs(str(tmp_path))
    monkeypatch.setattr(builtins, "__import__", real)
    assert how == "openssl"
    import grpc

    from gubernator_tpu_torch.config import DaemonConfig, TLSSettings
    from gubernator_tpu_torch.daemon import spawn_daemon

    d = spawn_daemon(DaemonConfig(
        grpc_listen_address="127.0.0.1:0", http_listen_address="127.0.0.1:0",
        cache_size=4096, device="cpu",
        tls=TLSSettings(ca_file=ca, cert_file=cert, key_file=key)))
    try:
        creds = d.tls.grpc_client_credentials()
        with grpc.secure_channel(f"127.0.0.1:{d.grpc_port}", creds) as ch:
            ch.unary_unary("/grpc.health.v1.Health/Check")(b"", timeout=10)
    finally:
        d.close()


def test_gossip_phase_rehearses_on_the_cpu(path_rehearsal, monkeypatch):
    """3 gossip daemons converge, and drop a closed one after dead_ms
    (the gossip's timings shortened for the rehearsal)."""
    import gubernator_tpu_torch.discovery as disc

    class Quick(disc.GossipDiscovery):
        def __init__(self, *a, **kw):
            kw.update(interval_ms=100, suspect_ms=300, dead_ms=900)
            super().__init__(*a, **kw)

    monkeypatch.setattr(disc, "GossipDiscovery", Quick)
    res = chip_smoke.phase_gossip(torch, path_rehearsal)
    assert res["nodes"] == 3 and res["converge_ms"] > 0
    assert res["dead_ms"] == 900 and all(ms > 0 for ms in res["drop_ms"])
    assert all(len(r) == 2 for r in res["rings"]) and res["launches"] > 0


def test_rehomed_may_fill_marks_the_dead_workers_crowded_keys():
    """A dead worker's key may find no room on a survivor only where the
    survivor's own keys, its warm-up key and the dead worker's keys of
    that bucket exceed 8 slots; no key of a live worker is marked."""
    from gubernator_tpu_torch.hashing import hash_request_keys

    args = types.SimpleNamespace(cluster_log2_cap=6)  # 8 buckets
    nb = 8
    warm = int(hash_request_keys(["_warmup"], ["w"])[0] % nb)
    other = (warm + 1) % nb
    # bucket `other`: 5 keys of survivor 0, 4 of the dead worker 2 (9 in
    # all: crowded); bucket `warm`: 3 keys of survivor 1, the warm-up
    # key, 3 of the dead worker (7: room); one more dead key alone
    keys = np.array([other] * 5 + [other] * 4 + [warm] * 3 + [warm] * 3
                    + [(warm + 2) % nb], np.uint64) + np.uint64(nb) * \
        np.arange(16, dtype=np.uint64)
    owner = np.array([0] * 5 + [2] * 4 + [1] * 3 + [2] * 3 + [2])
    got = chip_smoke.rehomed_may_fill(args, keys, owner, 2, [0, 1])
    assert got.tolist() == [False] * 5 + [True] * 4 + [False] * 7


def test_regions_phase_stops_on_a_lost_send(path_rehearsal, monkeypatch):
    """A region owner whose sends never arrive leaves the other region
    short of the hits sent: the run stops."""
    from gubernator_tpu_torch.multiregion import MultiRegionManager

    args = cluster_args(path_rehearsal, monkeypatch)
    monkeypatch.setattr(chip_smoke, "CONVERGE_S", 1.0)

    def lose(self):
        with self._mu:
            self._hits, self._hits_raw = {}, {}

    monkeypatch.setattr(MultiRegionManager, "_run_async_reqs", lose)
    with pytest.raises(RuntimeError, match="10\\^9 keys read"):
        chip_smoke.phase_regions(torch, args)


@pytest.mark.parametrize("fault",
                         ["no broadcast", "lost hits flush", "lost forward"])
def test_cluster_phase_stops_on_a_fault(path_rehearsal, monkeypatch, fault):
    """A replica that drops the owner's broadcasts never converges; GLOBAL
    hits that never reach their owner leave it short of the hits sent
    (the counters agree: only the owner's row shows it); a forward that
    fails answers its rows degraded: each stops the run."""
    from gubernator_tpu_torch.global_manager import GlobalManager
    from gubernator_tpu_torch.instance import V1Instance
    from gubernator_tpu_torch.peer_client import PeerClient

    args = cluster_args(path_rehearsal, monkeypatch)
    monkeypatch.setattr(chip_smoke, "CONVERGE_S", 1.0)
    if fault == "no broadcast":
        monkeypatch.setattr(V1Instance, "update_peer_globals",
                            lambda self, updates: None)
        what = "GLOBAL keys did not converge"
    elif fault == "lost hits flush":
        def lose(self):
            with self._mu:
                hits, self._hits = self._hits, {}
                raw, self._hits_raw = self._hits_raw, {}
                self.stats["hits_flushed"] += sum(
                    a for q in (hits, raw) for _, a, _ in q.values())

        monkeypatch.setattr(GlobalManager, "_hits_tick", lose)
        what = "GLOBAL keys did not converge"
    else:
        def refuse(self, data, n_items):
            raise ConnectionError("forced")

        monkeypatch.setattr(PeerClient, "forward_raw", refuse)
        # the default behaviors answer a failed forward degraded
        what = "served degraded in the healthy cluster"
    with pytest.raises(RuntimeError, match=what):
        chip_smoke.phase_cluster(torch, args)


def test_decode_responses_reads_what_the_port_writes():
    from gubernator_tpu.proto import gubernator_pb2 as pb
    from gubernator_tpu_torch.ops import native

    cols = (np.array([0, 1, 0], np.int32),
            np.array([5, 2 ** 40, 0], np.int64),
            np.array([4, 0, 0], np.int64),
            np.array([1_765_000_000_000, 7, 0], np.int64),
            np.zeros(3, bool))
    data = native.build_responses_from_columns(
        cols, 0, 3, [None, None, "rate limit table full"])
    # and a degraded row, as the port's protobuf build writes it
    msg = pb.GetRateLimitsResp()
    r = msg.responses.add(status=0, limit=9, remaining=3, reset_time=11)
    r.metadata["degraded"] = "true"
    r.metadata["degraded_peer"] = "127.0.0.1:5001"
    data += msg.SerializeToString()
    got = chip_smoke.decode_responses(data)
    want = pb.GetRateLimitsResp.FromString(data).responses
    assert [tuple(g) for g in got] == [
        (w.status, w.limit, w.remaining, w.reset_time, w.error,
         w.metadata.get("degraded_peer", "")) for w in want]
    assert got[-1].degraded == "127.0.0.1:5001"


@pytest.fixture()
def cpu_daemon(monkeypatch):
    """A pipelined CPU daemon of the smoke's phase 5 shape (small)."""
    from gubernator_tpu_torch.config import DaemonConfig
    from gubernator_tpu_torch.daemon import spawn_daemon

    monkeypatch.setenv("GUBER_PIPELINE", "1")
    d = spawn_daemon(DaemonConfig(
        http_listen_address="127.0.0.1:0", grpc_listen_address="",
        cache_size=1 << 12, batch_rows=256, device="cpu",
        drain_grace_ms=chip_smoke.DRAIN_GRACE_MS))
    try:
        yield d
    finally:
        d.close()


def test_metrics_check_holds_and_catches_a_miscount(cpu_daemon):
    d = cpu_daemon
    api, over = chip_smoke.http_verify_flow(d.http_port)
    got = chip_smoke.check_metrics(d, api + 1, over)  # + the warm-up
    assert got["getratelimit_api"] == 6 and got["over_limit"] == 2
    with pytest.raises(RuntimeError, match="api requests"):
        chip_smoke.check_metrics(d, api, over)
    with pytest.raises(RuntimeError, match="OVER_LIMIT"):
        chip_smoke.check_metrics(d, api + 1, over + 1)


def test_deep_health_check_wants_the_pipeline(cpu_daemon, monkeypatch):
    d = cpu_daemon
    assert chip_smoke.check_deep_health(d)["pipeline_depth"] == 2
    with chip_smoke.pipeline_env("0"):
        timer = chip_smoke.WaveTimer(d.instance)
        chip_smoke.rebuild_dispatcher(d.instance, timer)
    with pytest.raises(RuntimeError, match="pipeline depth 0"):
        chip_smoke.check_deep_health(d)
    import os
    assert os.environ["GUBER_PIPELINE"] == "1"


def test_admission_round_sheds_and_checks_the_rest(cpu_daemon, monkeypatch):
    """Admitted batches are checked per key; shed ones counted apart, the
    counter equal to the rows shed (a bound at 1.5 batches here)."""
    d = cpu_daemon
    args = types.SimpleNamespace(threads=6, batches=3)
    tally = chip_smoke.Tally(100)
    got = chip_smoke.admission_round(
        d.instance, np.random.default_rng(0), 500, lambda r: f"k{r}", 100,
        3_600_000, args, tally)
    assert got["batches"] == 18 and got["shed_batches"] > 0
    assert got["shed_counter"] == got["shed_rows"] == \
        1000 * got["shed_batches"]
    assert tally.n_req == got["admitted_decisions"] == \
        1000 * (18 - got["shed_batches"])
    tally.check()
    assert d.instance.dispatcher.admission_limit == \
        d.instance.dispatcher.ADMISSION_LIMIT_WAVES * 2048


def test_drain_check_sees_503_then_a_shed(cpu_daemon):
    got = chip_smoke.drain_check(cpu_daemon)
    assert got["events"] == ["drain_started", "drain_completed"]
    assert got["draining_seen_ms"] < got["served_ms"] < \
        chip_smoke.DRAIN_GRACE_MS <= got["closed_ms"]


def test_wave_timer_times_pipelined_and_coalesced_waves(cpu_daemon):
    """Pipelined waves get one record from launch to sync and a slot;
    after a rebuild with the pipeline off, coalesced waves get theirs."""
    from gubernator_tpu_torch.types import RateLimitRequest
    from gubernator_tpu_torch.wire import encode_get_rate_limits

    inst = cpu_daemon.instance
    timer = chip_smoke.WaveTimer(inst)
    data = encode_get_rate_limits([RateLimitRequest(
        name="t", unique_key=f"k{i}", hits=1, limit=5, duration=60_000)
        for i in range(10)])
    t0 = time.perf_counter()
    inst.get_rate_limits_wire(data)
    inst.get_rate_limits([RateLimitRequest(name="t", unique_key="o",
                                           limit=5)])
    assert len(timer.rec) == 2 and [r[3] for r in timer.rec] == [10, 1]
    assert timer.pipelined(t0, 60) == {"pipelined_waves": 1, "max_slot": 0}
    with chip_smoke.pipeline_env("0"):
        chip_smoke.rebuild_dispatcher(inst, timer)
    inline = chip_smoke.time_inline(inst.dispatcher)
    inst.get_rate_limits_wire(data)
    assert len(inline) == 1 and len(timer.slots) == 1
    for start, end, jobs, rows, engine_s, wait_s in timer.rec:
        assert end >= start and jobs == 1 and 0 <= engine_s <= end - start


def test_tiers_phase_rehearses_on_the_cpu(path_rehearsal):
    """The tiers phase at a small size: 2000 keys behind a 1024-row table
    (the instance's least), so half the rows restore cold; every check
    of the phase holds."""
    args = path_rehearsal
    args.tier_log2_cap = 10
    res = chip_smoke.phase_tiers(torch, args)
    r = res["restore"]
    assert r["device_rows"] + r["cold_rows"] == args.keys
    assert r["cold_rows"] == res["snapshot_in"]["predicted_cold"] > 500
    assert r["dropped_rows"] == 0 and r["native_store"]
    s = res["served"]
    assert s["promotions"] > 0 and s["launches"] > 0
    assert s["requests"] == args.threads * 1000 * (
        args.rounds * args.batches + args.profile_batches)
    assert 0 < s["cold_share"] < 1 and len(s["rounds"]) == 3
    adm = s["admission"]
    assert adm["offers"].get("promoted_evicting", 0) + adm["offers"].get(
        "promoted_free_slot", 0) == s["promotions"] == len(adm["promoted"])
    assert sum(sum(b.values()) for b in
               adm["keys_by_population_rank"].values()) == \
        sum(adm["keys"].values()) > 0
    assert res["ood"] == {"object": 192, "wire": 192}
    assert set(res["remove"]) == {"device", "cold"}
    out = res["snapshot_out"]
    assert out["restored_rows"] == out["rows"] - 1 and out["file_bytes"] > 0
    assert res["item_vs_column"]["rows"] == args.keys
    st = res["store"]
    assert st["store_calls"]["on_change"] == st["requests"] == \
        args.threads * 2 * 1000
    assert st["store_calls"]["get"] == st["misses"] > 0
    assert all(t["cold_rows"] > 0 for t in st["tiers"])


def test_tier_population_and_prediction():
    rows, ood = chip_smoke.tier_population(1000, 100, 60_000, 1)
    assert ood.sum() == 10 and (rows["meta"] == 1).sum() == 100
    assert (rows["limit"][ood] == chip_smoke.OOD_LIMIT).all()
    cold = chip_smoke.predicted_cold(rows["key"], ood, 6)  # 8 buckets
    assert cold[ood].all() and (~cold).sum() == 64


def test_shards_mesh_and_multihost_phases_rehearse_on_the_cpu(
        path_rehearsal, monkeypatch):
    """The shards, mesh and multihost phases at a small size on the CPU
    (4 CPU shards; gloo in place of NCCL): n = 4 answers and tables equal
    n = 1's, K1 stands in on every shard, the mesh daemon's fused lane,
    folds, stand-down and recovery, every key exact, the six families
    moved, and the one-process group's all_reduce and step."""
    args = path_rehearsal
    args.log2_cap = 15  # 4096 buckets: no bucket of the rehearsal fills
    args.wave_rows = 512
    args.threads = 2
    monkeypatch.setattr(chip_smoke, "SHARD_KEYS", 5_000)
    monkeypatch.setattr(chip_smoke, "SHARD_WAVES", 2)
    monkeypatch.setattr(chip_smoke, "SHARD_BATCHES", 2)
    monkeypatch.setattr(chip_smoke, "SHARD_CLASSIC_WAVES", 2)
    monkeypatch.setattr(chip_smoke, "MESH_BATCHES", 2)
    monkeypatch.setenv("GUBER_MESH_GLOBAL_CAP", "4096")
    sh = chip_smoke.phase_shards(torch, args)
    for kind in ("bucket", "classic"):
        assert sh[kind]["waves"] == 2
        assert sh[kind]["steps_per_shard"] == [2] * 4
    assert sh["classic"]["live_after_sweep"] > 0
    assert sh["wire"]["keys"] > 0 and sh["wire"]["ratio"] > 0
    msh = chip_smoke.phase_mesh(torch, args)
    assert msh["mesh_fused_hits"] > 0 and msh["launches"] > 0
    assert msh["keys_exact"] > 0 and msh["outage"]["degraded_gauge"] == 1
    assert msh["mesh_step"]["steps"] > 0
    assert set(msh["rate_ratio_mesh_over_grpc"]) == {"object", "wire"}
    mh = chip_smoke.phase_multihost(torch, args)
    assert mh["inserted"] == 4 * 1024 and mh["backend"] == "gloo"


def test_cli_phase_rehearses_on_the_cpu(path_rehearsal, monkeypatch):
    """The cli phase at a small size: a daemon process on the CPU (2^13
    rows), the load tester over gRPC and over HTTP for 1.5 s each, its
    counts equal to the daemon's /metrics deltas, every debug
    subcommand exiting 0.  The daemon process steps through the plain
    version, which counts no K1 launch."""
    for name, v in (("CLI_KEYS", 2_000), ("CLI_SECONDS", 1.5),
                    ("CLI_CONCURRENCY", 2), ("CLI_BATCH", 100)):
        monkeypatch.setattr(chip_smoke, name, v)
    res = chip_smoke.phase_cli(torch, path_rehearsal)
    assert res["rows"] == 1 << path_rehearsal.log2_cap
    for t in ("grpc", "http"):
        r = res[t]
        assert r["errors"] == [] and r["decisions"] > 0
        assert r["decisions"] == r["daemon_api_requests"]
        assert r["over_limit"] == r["daemon_over_limit"] > 0
        assert (r["batch"], r["concurrency"]) == (100, 2)
    assert res["launches"] == 0
    assert set(res["debug"]) == {"events", "spans", "topkeys", "tenants",
                                 "slos", "memory_device_bytes",
                                 "faults_armed"}
    assert res["debug"]["events"] > 0 and res["debug"]["topkeys"] > 0


def test_scenarios_phase_rehearses_on_the_cpu(path_rehearsal):
    """The whole library through the port's runner on the CPU in full
    mode, as on the card: every scenario ok, each parity digest its
    reference's, the runs counted once each, the mesh stack on two CPU
    entries, K1's stand-in launched."""
    res = chip_smoke.phase_scenarios(torch, path_rehearsal)
    assert res["all_ok"]
    assert res["count"] == len([f for f in os.listdir(os.path.join(
        chip_smoke.REPO, "scenarios")) if f.endswith(".json")])
    assert res["launches"] > 0
    rows = res["scenarios"]
    assert rows["mesh_global"]["mesh_devices"] == ["cpu", "cpu"]
    parity = [r for r in rows.values() if r["reference_digest"]]
    assert len(parity) == 5
    assert all(r["digest"] == r["reference_digest"] for r in parity)
    assert all(r["runs_ok_counted"] == 1 for r in rows.values())


def test_only_lists_the_new_phases_and_the_last_line_is_unchanged():
    import inspect

    src = inspect.getsource(chip_smoke.main)
    for p in ("shards", "mesh", "multihost", "cli", "scenarios"):
        assert f'"{p}": phase_{p}' in src
    assert '"cli_launches": cli["launches"]' in src
    assert '"scenarios_launches": scen["launches"]' in src
    assert ('print(json.dumps({"ok": True, "device": {\n'
            '        "platform": "gpu", "kind": name,\n'
            '        "count": torch.cuda.device_count()}}), flush=True)'
            in src)
