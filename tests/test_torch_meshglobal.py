"""The port's mesh-resident GLOBAL tier (meshglobal.py, the instance's
``GUBER_GLOBAL_MODE=mesh``) on a 4-shard CPU mesh, held to the JAX
package's mesh mode on ``make_mesh(n=4)`` on the same seeded streams.

The stories of tests/test_mesh_global.py: exact conservation (folded ==
injected), every replica converged after the fold, staleness within
the reconcile interval, answers equal to the gRPC GLOBAL path, the
``global_psum`` / ``global_accum_swap`` chaos with nothing lost, the
degraded fallback and recovery, a config change demoting with state,
flagged requests bypassing the tier, grpc mode untouched by default, an
unknown mode loud, the sketch feeding the hot set's promotion; and the
fused mesh lane of tests/test_pallas_serving.py (TestMeshFusedScatter):
the bucket engine decides the tier's rows inside its wave, with
``mesh_fused_hits`` = 3 × 20 × 2 and folded == injected.  Each port
engine faces the JAX engine of its kind: the classic engine the JAX
ShardedEngine, the bucket engine the JAX fused engine (``engine=
"pallas"``, its compiled-XLA flavor on the CPU).  Answers are exact
(integers, tolerance 0).
"""
import time

import numpy as np
import pytest

from gubernator_tpu.config import BehaviorConfig as JaxBehaviors
from gubernator_tpu.config import Config as JaxConfig
from gubernator_tpu.instance import V1Instance as JaxInstance
from gubernator_tpu.parallel import make_mesh as jax_mesh
from gubernator_tpu.proto import gubernator_pb2 as jpb
from gubernator_tpu.types import Behavior as JaxBehavior
from gubernator_tpu.types import RateLimitRequest as JaxReq
from gubernator_tpu_torch.config import BehaviorConfig, Config
from gubernator_tpu_torch.hashing import hash_key
from gubernator_tpu_torch.instance import V1Instance
from gubernator_tpu_torch.mesh import make_mesh
from gubernator_tpu_torch.types import Behavior, RateLimitRequest, Status
from gubernator_tpu_torch.wire import encode_get_rate_limits

NOW = 1_781_000_000_000
SYNC_MS = 100
N = 4
#: engine selector → the JAX one of the same kind: "pallas" is the port's
#: bucket engine and the JAX fused engine, "xla" both classic engines
KINDS = {"pallas": "pallas", "xla": "xla"}


def greq(key, hits=1, name="mg", cls=RateLimitRequest, beh=Behavior, **kw):
    d = dict(limit=100_000, duration=600_000, behavior=beh.GLOBAL)
    d.update(kw)
    return cls(name=name, unique_key=key, hits=hits, **d)


def port_mesh_instance(monkeypatch, kind="pallas", **cfg):
    monkeypatch.setenv("GUBER_MESH_GLOBAL_CAP", "256")
    d = dict(device="cpu", cache_size=1 << 12, sweep_interval_ms=0,
             global_mode="mesh", batch_rows=64, engine=kind,
             behaviors=BehaviorConfig(global_sync_wait_ms=SYNC_MS))
    d.update(cfg)
    return V1Instance(Config(**d), mesh=make_mesh(["cpu"] * N))


def jax_mesh_instance(monkeypatch, kind="pallas", **cfg):
    monkeypatch.setenv("GUBER_MESH_GLOBAL_CAP", "256")
    monkeypatch.delenv("GUBER_ENGINE", raising=False)
    d = dict(cache_size=1 << 12, sweep_interval_ms=0, global_mode="mesh",
             batch_rows=64, engine=KINDS[kind],
             behaviors=JaxBehaviors(global_sync_wait_ms=SYNC_MS))
    d.update(cfg)
    return JaxInstance(JaxConfig(**d), mesh=jax_mesh(n=N))


def stream(waves=4, keys=5, hits=2, name="mg"):
    """Deterministic GLOBAL wire traffic: [(bytes, now)]."""
    return [(encode_get_rate_limits(
        [greq(f"k{i % keys}", hits=hits, name=name)
         for i in range(4 * keys)]), NOW + 1 + w) for w in range(waves)]


def answers(data: bytes) -> list:
    return [(r.status, r.limit, r.remaining, r.reset_time, r.error)
            for r in jpb.GetRateLimitsResp.FromString(data).responses]


def drive(inst, traffic) -> list:
    return [answers(inst.get_rate_limits_wire(d, now_ms=t))
            for d, t in traffic]


def obj_answer(r):
    return (int(r.status), r.limit, r.remaining, r.reset_time, r.error)


@pytest.mark.parametrize("kind", list(KINDS))
def test_conservation_convergence_staleness(monkeypatch, kind):
    """GLOBAL hits reconcile with exact conservation, every replica
    converges after the fold, the staleness stays within the reconcile
    interval, nothing is queued for a gRPC peer, and every answer equals
    the JAX mesh instance's."""
    inst = port_mesh_instance(monkeypatch, kind)
    ref = jax_mesh_instance(monkeypatch, kind)
    try:
        traffic = stream()
        assert drive(inst, traffic) == drive(ref, traffic)
        # the object lane rides the same tier
        r = inst.get_rate_limits([greq("k0", hits=3)], now_ms=NOW + 50)
        rj = ref.get_rate_limits(
            [greq("k0", hits=3, cls=JaxReq, beh=JaxBehavior)],
            now_ms=NOW + 50)
        assert obj_answer(r[0]) == obj_answer(rj[0])
        assert r[0].error == "" and r[0].status == Status.UNDER_LIMIT
        inst._mesh_reconcile_tick()
        mge = inst._meshglobal
        s = mge.stats()
        injected = 4 * 20 * 2 + 3
        assert s["injected_hits"] == s["folded_hits"] == injected, s
        assert s["generation"] >= 1 and s["n_shards"] == N
        assert s["last_staleness_s"] * 1000 <= SYNC_MS, s
        assert inst.metrics.mesh_global_staleness._value.get() * 1000 \
            <= SYNC_MS
        rem = mge.replica_columns("remaining")
        for kh, slot in mge.slots.items():
            assert len(set(rem[:, slot].tolist())) == 1, (kh, rem[:, slot])
        kh0 = hash_key("mg", "k0")
        assert int(rem[0, mge.slots[kh0]]) == 100_000 - (4 * 4 * 2 + 3)
        gm = inst.global_manager
        assert gm is not None and gm.queued_hits() == (0, 0)
        assert inst.dispatcher.reconcile_gen == mge.generation
        # the JAX tier conserved the same hits
        jm = ref._meshglobal
        jm.drain()
        assert jm.stats()["injected_hits"] == injected
        if kind == "pallas":
            # the fused lane decided the wire rows inside K1's waves
            assert inst.engine.mesh_fused_hits == 4 * 20 * 2
            assert inst.metrics.pallas_mesh_fused_hits._value.get() == 160
    finally:
        inst.close()
        ref.close()


@pytest.mark.parametrize("kind", list(KINDS))
def test_answers_equal_the_grpc_path(monkeypatch, kind):
    """The same traffic through mesh mode and the gRPC mode's solo path
    (hot set off: owner-sharded GLOBAL) gives the same answers."""
    mi = port_mesh_instance(monkeypatch, kind)
    try:
        traffic = stream()
        mesh_out = drive(mi, traffic)
        m_obj = mi.get_rate_limits([greq("k1", hits=5)], now_ms=NOW + 60)
    finally:
        mi.close()
    gi = V1Instance(Config(device="cpu", cache_size=1 << 12,
                           sweep_interval_ms=0, hot_set_capacity=0,
                           batch_rows=64, engine=kind),
                    mesh=make_mesh(["cpu"] * N))
    try:
        assert drive(gi, traffic) == mesh_out
        g_obj = gi.get_rate_limits([greq("k1", hits=5)], now_ms=NOW + 60)
        assert obj_answer(g_obj[0]) == obj_answer(m_obj[0])
    finally:
        gi.close()


def test_fused_scatter_serves_and_conserves(monkeypatch):
    """The bucket engine binds the tier at construction; its waves
    decide the tier's rows in the same launch (mesh_fused_hits grows,
    K1 still runs per shard) and the fold conserves them."""
    inst = port_mesh_instance(monkeypatch)
    ref = jax_mesh_instance(monkeypatch)
    try:
        assert inst.engine.mesh_bound and ref.engine.mesh_bound
        calls = []
        decide = inst.engine._decide

        def counted(*a):
            calls.append(a[0])
            return decide(*a)

        inst.engine._decide = counted
        traffic = stream(waves=3)
        assert drive(inst, traffic) == drive(ref, traffic)
        assert inst.engine.mesh_fused_hits == \
            ref.engine.mesh_fused_hits == 3 * 20 * 2
        assert sorted(set(calls)) == list(range(N))  # K1 on every shard
        inst._mesh_reconcile_tick()
        s = inst._meshglobal.stats()
        assert s["folded_hits"] == s["injected_hits"] == 120, s
        assert inst.global_manager.queued_hits() == (0, 0)
    finally:
        inst.close()
        ref.close()


@pytest.mark.parametrize("kind", list(KINDS))
def test_chaos_collective_fault_conservation(monkeypatch, kind):
    """A collective faultpoint armed mid-traffic: reconcile ticks abort
    (the accumulators swap back, no hit stranded) and one clean fold
    after the fault clears recovers exact conservation, as in JAX."""
    out = []
    for make in (port_mesh_instance, jax_mesh_instance):
        inst = make(monkeypatch, kind)
        try:
            drive(inst, stream(waves=2))
            inst.faults.arm("global_psum:error", seed=11)
            inst._mesh_reconcile_tick()
            assert inst.metrics.mesh_global_fold_errors._value.get() >= 1
            drive(inst, stream(waves=2))
            inst.faults.arm("global_accum_swap:error", seed=11)
            inst._mesh_reconcile_tick()
            inst.faults.clear()
            inst._mesh_reconcile_tick()
            mge = inst._meshglobal
            mge.drain()
            s = mge.stats()
            assert s["folded_hits"] == s["injected_hits"] == 4 * 20 * 2, s
            out.append(s["injected_hits"])
        finally:
            inst.close()
    assert out[0] == out[1]


@pytest.mark.parametrize("kind", list(KINDS))
def test_degraded_fallback_and_recovery(monkeypatch, kind):
    """Consecutive fold failures stand the tier down: keys demote to the
    table exactly, traffic keeps serving, and a clean fold after the
    cooldown re-arms the tier."""
    monkeypatch.setenv("GUBER_MESH_FALLBACK_AFTER", "2")
    inst = port_mesh_instance(
        monkeypatch, kind,
        behaviors=BehaviorConfig(global_sync_wait_ms=60_000))
    try:
        drive(inst, stream(waves=2, keys=3))
        inst._mesh_reconcile_tick()
        inst.faults.arm("global_psum:error", seed=3)
        inst._mesh_reconcile_tick()
        assert not inst._mesh_degraded
        inst._mesh_reconcile_tick()
        assert inst._mesh_degraded
        assert inst.metrics.mesh_global_degraded._value.get() == 1
        mge = inst._meshglobal
        assert not mge.pinned_keys()
        # 2 waves × 4 occurrences × 2 hits on k0 moved to the table
        kh0 = hash_key("mg", "k0")
        found, cols = inst.engine.gather_rows(np.array([kh0], np.uint64))
        assert found[0] and int(cols["remaining"][0]) == 100_000 - 16
        got = answers(inst.get_rate_limits_wire(
            encode_get_rate_limits([greq("k0", hits=1)]), now_ms=NOW + 200))
        assert got[0][4] == "" and got[0][2] == 100_000 - 17
        assert not mge.pinned_keys()  # the table served it
        inst.faults.clear()
        inst._mesh_down_until = time.monotonic() - 1
        inst._mesh_reconcile_tick()
        assert not inst._mesh_degraded
        assert inst.metrics.mesh_global_degraded._value.get() == 0
        kinds = [e["kind"] for e in inst.recorder.events()]
        assert "mesh_degraded" in kinds and "mesh_recovered" in kinds
        got = answers(inst.get_rate_limits_wire(
            encode_get_rate_limits([greq("k0", hits=1)]), now_ms=NOW + 300))
        assert got[0][2] == 100_000 - 18
        assert mge.pinned_keys()  # routing resumed on the tier
    finally:
        inst.close()


@pytest.mark.parametrize("kind", list(KINDS))
def test_config_change_demotes_with_state(monkeypatch, kind):
    inst = port_mesh_instance(monkeypatch, kind)
    ref = jax_mesh_instance(monkeypatch, kind)
    try:
        kh = hash_key("mg", "cfg")
        got = []
        for i, (hits, limit) in enumerate(((11, 100), (1, 50), (2, 50))):
            r = inst.get_rate_limits([greq("cfg", hits=hits, limit=limit)],
                                     now_ms=NOW + i)[0]
            rj = ref.get_rate_limits(
                [greq("cfg", hits=hits, limit=limit, cls=JaxReq,
                      beh=JaxBehavior)], now_ms=NOW + i)[0]
            assert obj_answer(r) == obj_answer(rj)
            got.append(r)
            if i == 0:
                assert inst._meshglobal.is_pinned(kh)
        # 11 at limit 100 → 89; 100 → 50 adjusts by -50: 39, less 1
        assert got[1].limit == 50 and got[1].remaining == 38
        # the third request pins the key again, under its new config
        assert inst._meshglobal.is_pinned(kh)
        assert got[2].remaining == 36
    finally:
        inst.close()
        ref.close()


def test_flagged_requests_bypass_the_tier(monkeypatch):
    inst = port_mesh_instance(monkeypatch)
    try:
        for beh in (Behavior.RESET_REMAINING, Behavior.DRAIN_OVER_LIMIT,
                    Behavior.MULTI_REGION):
            r = inst.get_rate_limits(
                [greq("flg", behavior=Behavior.GLOBAL | beh)],
                now_ms=NOW)[0]
            assert r.error == ""
        assert not inst._meshglobal.pinned_keys()
        # on the wire lane too
        out = answers(inst.get_rate_limits_wire(encode_get_rate_limits(
            [greq("flw", behavior=Behavior.GLOBAL
                  | Behavior.RESET_REMAINING)]), now_ms=NOW + 1))
        assert out[0][4] == ""
        assert not inst._meshglobal.pinned_keys()
    finally:
        inst.close()


def test_grpc_mode_untouched_by_default():
    inst = V1Instance(Config(device="cpu", cache_size=1 << 10,
                             sweep_interval_ms=0),
                      mesh=make_mesh(["cpu"] * N))
    try:
        assert inst._global_mode == "grpc"
        inst.get_rate_limits([greq("g0")], now_ms=NOW)
        assert inst._meshglobal is None
        assert not inst.engine.mesh_bound
    finally:
        inst.close()


def test_unknown_global_mode_is_loud(monkeypatch):
    with pytest.raises(ValueError, match="global_mode"):
        V1Instance(Config(device="cpu", cache_size=1 << 10,
                          global_mode="typo"))
    monkeypatch.setenv("GUBER_GLOBAL_MODE", "nope")
    with pytest.raises(ValueError, match="global_mode"):
        V1Instance(Config(device="cpu", cache_size=1 << 10))


def test_sketch_feeds_hotset_promotion_on_a_mesh():
    """grpc mode on a 4-shard mesh: a key made hot by non-GLOBAL traffic
    is promoted into the hot set (4 replicas, one a shard) at its first
    GLOBAL request, as in JAX."""
    inst = V1Instance(
        Config(device="cpu", cache_size=1 << 10, sweep_interval_ms=0,
               hot_set_capacity=64, hot_promote_threshold=8,
               behaviors=BehaviorConfig(global_sync_wait_ms=25)),
        mesh=make_mesh(["cpu"] * N))
    ref = JaxInstance(
        JaxConfig(cache_size=1 << 10, sweep_interval_ms=0,
                  hot_set_capacity=64, hot_promote_threshold=8,
                  behaviors=JaxBehaviors(global_sync_wait_ms=25)),
        mesh=jax_mesh(n=N))
    try:
        for side, cls, beh in ((inst, RateLimitRequest, Behavior),
                               (ref, JaxReq, JaxBehavior)):
            plain = cls(name="mg", unique_key="skp", hits=1,
                        limit=100_000, duration=600_000)
            for i in range(10):
                side.get_rate_limits([plain], now_ms=NOW + i)
            assert side.analytics.flush()
            side.get_rate_limits([greq("skp", cls=cls, beh=beh)],
                                 now_ms=NOW + 20)
        kh = hash_key("mg", "skp")
        assert inst._hotset is not None and inst._hotset.is_pinned(kh)
        assert ref._hotset.is_pinned(kh)
        assert inst._hotset.n == ref._hotset.n == N
    finally:
        inst.close()
        ref.close()


def test_remove_snapshot_and_peers_demote_mesh_keys(monkeypatch):
    """remove() deletes a pinned key's state; a peer joining demotes
    every pinned key into the table with its hits."""
    from gubernator_tpu_torch.types import PeerInfo

    inst = port_mesh_instance(monkeypatch)
    try:
        drive(inst, stream(waves=1, keys=3))
        mge = inst._meshglobal
        assert len(mge.pinned_keys()) == 3
        assert inst.remove("mg", "k2")
        assert not mge.is_pinned(hash_key("mg", "k2"))
        inst.set_peers([PeerInfo(grpc_address="127.0.0.1:1"),
                        PeerInfo(grpc_address=inst._self_addr or "self")])
        assert not mge.pinned_keys()
        found, cols = inst.engine.gather_rows(
            np.array([hash_key("mg", "k0")], np.uint64))
        assert found[0] and int(cols["remaining"][0]) == 100_000 - 8
    finally:
        inst.close()


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("lane", ["object", "wire"])
@pytest.mark.parametrize("demote", ["stand_down", "remove_other",
                                    "config_change"])
def test_demotion_waits_for_the_waves_routed_to_the_tier(monkeypatch, kind,
                                                         lane, demote):
    """A demotion made while a batch routed to the tier has not run its
    wave yet waits for that wave, so the row it moves into the table
    holds the batch's hits: the stand-down, another key's removal and a
    config change each leave every key exact, on both lanes."""
    import threading

    inst = port_mesh_instance(monkeypatch, kind)
    try:
        drive(inst, stream(waves=1, keys=3))  # k0..k2 pinned, 8 hits each
        mge = inst._meshglobal
        assert len(mge.pinned_keys()) == 3
        entered, release = threading.Event(), threading.Event()
        # the tier's own waves, and the fused lane's mesh rows
        steps = {f: getattr(mge, f) for f in ("_run_wave", "serve_rows")}

        def late(f):
            def wave(*a):  # routed, its wave not started
                entered.set()
                assert release.wait(10)
                return steps[f](*a)
            return wave

        for f in steps:
            monkeypatch.setattr(mge, f, late(f))
        reqs = [greq("k0", hits=5), greq("k1", hits=5)]
        if lane == "object":
            send = lambda: inst.get_rate_limits(reqs, now_ms=NOW + 10)  # noqa: E731
        else:
            send = lambda: inst.get_rate_limits_wire(  # noqa: E731
                encode_get_rate_limits(reqs), now_ms=NOW + 10)
        wave = threading.Thread(target=send)
        wave.start()
        assert entered.wait(10)  # routed to the tier
        for f, fn in steps.items():
            monkeypatch.setattr(mge, f, fn)
        if demote == "stand_down":
            act = inst._mesh_stand_down
        elif demote == "remove_other":
            act = lambda: inst.remove("mg", "k2")  # noqa: E731
        else:
            act = lambda: inst.get_rate_limits(  # noqa: E731
                [greq("k0", hits=1, limit=50_000)], now_ms=NOW + 11)
        demoter = threading.Thread(target=act)
        demoter.start()
        demoter.join(0.3)
        # the demotion waits for the wave holding the gate
        assert demoter.is_alive()
        release.set()
        wave.join(10)
        demoter.join(10)
        assert not wave.is_alive() and not demoter.is_alive()
        want = {"k0": 100_000 - 13, "k1": 100_000 - 13}
        if demote == "config_change":
            # k0 left the tier with its 13 hits and took the new limit's
            # one more in the table
            assert not mge.is_pinned(hash_key("mg", "k0"))
            got = inst.get_rate_limits([greq("k0", hits=0, limit=50_000)],
                                       now_ms=NOW + 12)[0].remaining
            assert got == 50_000 - 14
            want.pop("k0")
        for k, rem in want.items():
            r = inst.get_rate_limits([greq(k, hits=0)], now_ms=NOW + 12)
            assert r[0].error == "" and r[0].remaining == rem, (k, r[0])
    finally:
        inst.close()


@pytest.mark.parametrize("kind", list(KINDS))
def test_fold_does_not_wait_for_a_wave(monkeypatch, kind):
    """The reconcile tick takes no serving lock: with a wave holding the
    tier's replicas (its SoA step), the tick still swaps and folds, and
    the hits served before it are folded."""
    import threading

    inst = port_mesh_instance(monkeypatch, kind)
    try:
        drive(inst, stream(waves=2))
        mge = inst._meshglobal
        gen = mge.generation
        with mge._state_mu:  # a wave in its SoA step
            tick = threading.Thread(target=inst._mesh_reconcile_tick)
            tick.start()
            tick.join(10)
            assert not tick.is_alive() and mge.generation == gen + 1
        s = mge.stats()
        assert s["folded_hits"] == s["injected_hits"] == 2 * 20 * 2, s
    finally:
        inst.close()


@pytest.mark.parametrize("lane", ["object", "wire"])
def test_a_caller_folds_when_the_tick_is_late(monkeypatch, lane):
    """A batch served by the tier folds in its caller's thread, after
    its steps, once the oldest unfolded hit is half an interval old:
    under load the tick's thread waits for the GIL behind the callers.
    A fresh hit does not, and every hit is folded once."""
    slow_ms = 60_000  # the GLOBAL manager's own tick stays asleep
    inst = port_mesh_instance(
        monkeypatch, behaviors=BehaviorConfig(global_sync_wait_ms=slow_ms))
    try:
        def send(reqs, now):
            if lane == "object":
                return inst.get_rate_limits(reqs, now_ms=now)
            return inst.get_rate_limits_wire(encode_get_rate_limits(reqs),
                                             now_ms=now)

        mge = inst._meshglobal
        send([greq("k0", hits=2)], NOW + 1)
        gen = mge.generation
        send([greq("k0", hits=3)], NOW + 2)
        assert mge.generation == gen  # the oldest hit is fresh
        mge._first_unfolded_t -= slow_ms / 2000.0  # a tick that is late
        send([greq("k1", hits=4)], NOW + 3)
        assert mge.generation == gen + 1
        s = mge.stats()
        assert s["folded_hits"] == s["injected_hits"] == 9, s
        assert s["last_staleness_s"] >= slow_ms / 2000.0
    finally:
        inst.close()
