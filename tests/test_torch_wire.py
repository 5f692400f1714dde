"""The port's wire entry (V1Instance.get_rate_limits_wire) on the CPU:
under concurrent callers whose streams never share a key, every response
must be byte-equal to a JAX V1Instance's (no hot set, analytics off), on
the bucket engine (against a one-device PallasServingEngine) and on the
classic engine (against the JAX ShardedEngine), through all three lanes:
fused, parse (Gregorian, GLOBAL) and protobuf (metadata).  One exception
is held apart: a row outside the bucket engine's value domain answers
``rate limit table full`` as the JAX object lane does, where the JAX
fused lane lets it reach its kernel."""
import gc
import sys
import threading
import time

import numpy as np
import pytest

from gubernator_tpu_torch.config import Config
from gubernator_tpu_torch.core.batch import WaveBufferPool
from gubernator_tpu_torch.instance import V1Instance
from gubernator_tpu_torch.types import RateLimitRequest
from gubernator_tpu_torch.wire import encode_get_rate_limits

from test_torch_service import caller_stream  # noqa: E402

NOW = 1_765_000_000_000
CAP = 1 << 12
ENGINES = {"bucket": "", "classic": "xla"}


def quiet_jax(monkeypatch):
    for var in ("GUBER_ANALYTICS", "GUBER_SLO", "GUBER_MEM_LEDGER"):
        monkeypatch.setenv(var, "0")
    monkeypatch.delenv("GUBER_ENGINE", raising=False)
    monkeypatch.delenv("GUBER_STEP_IMPL", raising=False)


def jax_instance(engine: str, batch_rows: int = 64):
    from gubernator_tpu.config import Config as JaxConfig
    from gubernator_tpu.instance import V1Instance as JaxInstance
    from gubernator_tpu.parallel import make_mesh
    from gubernator_tpu.parallel.pallas_engine import PallasServingEngine
    from gubernator_tpu.parallel.sharded import ShardedEngine as JaxEngine

    cls = JaxEngine if engine == "xla" else PallasServingEngine
    return JaxInstance(
        JaxConfig(cache_size=CAP, batch_rows=batch_rows,
                  sweep_interval_ms=0, hot_set_capacity=0),
        engine=cls(make_mesh(n=1), capacity_per_shard=CAP,
                   batch_per_shard=batch_rows))


def port_instance(engine: str, batch_rows: int = 64):
    return V1Instance(Config(cache_size=CAP, batch_rows=batch_rows,
                             device="cpu", engine=engine,
                             sweep_interval_ms=0, hot_set_capacity=0))


def wire_stream(caller: int, seed: int):
    """caller_stream's batches as wire bytes, with a Gregorian row (the
    parse lane) in batch 1 and a metadata row (the protobuf lane) in
    batch 2; batches 0 and 3 drop the GLOBAL flag, so they take the
    fused lane (a GLOBAL row sends its batch to the parse lane)."""
    out = []
    for b, (reqs, now) in enumerate(caller_stream(caller, seed)):
        if b in (0, 3):
            reqs = [dict(r, behavior=r["behavior"] & ~2) for r in reqs]
        reqs = [RateLimitRequest(**r) for r in reqs]
        if b == 1:
            reqs.append(RateLimitRequest(
                name=f"c{caller}", unique_key="greg", hits=1, limit=5,
                duration=1, behavior=4))
        if b == 2:
            reqs.append(RateLimitRequest(
                name=f"c{caller}", unique_key="meta", hits=1, limit=5,
                duration=20_000, metadata={"tenant": "t"}))
        out.append((encode_get_rate_limits(reqs), now))
    return out


def run_wire_callers(inst, streams):
    """Every caller's stream in its own thread, all started together."""
    out, failures = {}, []
    start = threading.Barrier(len(streams))

    def go(c):
        try:
            start.wait(timeout=60)
            out[c] = [inst.get_rate_limits_wire(data, now)
                      for data, now in streams[c]]
        except Exception as e:  # noqa: BLE001 - re-raised below
            failures.append(e)

    threads = [threading.Thread(target=go, args=(c,)) for c in streams]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    if failures:
        raise failures[0]
    return out


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_concurrent_wire_callers_match_jax(monkeypatch, engine, seed):
    import gubernator_tpu_torch.instance as inst_mod

    quiet_jax(monkeypatch)
    streams = {c: wire_stream(c, seed) for c in range(12)}
    port = port_instance(ENGINES[engine])
    # fused waves run inline (check_prepacked) or, busy, copy their rows
    # out of the lease (lease_batch) and go through the worker
    fused = {"inline": 0, "busy": 0}

    def counted(fn, path):
        def call(*a, **k):
            fused[path] += 1
            return fn(*a, **k)
        return call

    monkeypatch.setattr(port.engine, "check_prepacked",
                        counted(port.engine.check_prepacked, "inline"))
    monkeypatch.setattr(inst_mod, "lease_batch",
                        counted(inst_mod.lease_batch, "busy"))
    try:
        got = run_wire_callers(port, streams)
        pool = port.engine.wave_pool.stats()
        inline = port.dispatcher.inline_waves
        worker = port.dispatcher.wave_count
    finally:
        port.close()
    assert pool["leaks"] == 0 and pool["outstanding"] == 0
    assert pool["hits"] + pool["misses"] >= 2 * len(streams)
    assert inline > 0 and worker > 0
    assert fused["inline"] > 0 and fused["busy"] > 0, fused
    # the reference runs the callers one after another: their keys are
    # disjoint, so each caller's answers do not depend on the order, and
    # the JAX wire lane under concurrent callers now and then answers a
    # batch's last rows zeroed (ROADMAP, section C)
    jax_inst = jax_instance(ENGINES[engine])
    try:
        want = {c: [jax_inst.get_rate_limits_wire(data, now)
                    for data, now in streams[c]] for c in streams}
    finally:
        jax_inst.close()
    for c in streams:
        assert got[c] == want[c], c


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_hot_set_at_the_default_matches_jax(monkeypatch, engine):
    """The hot-set streams of test_torch_service as wire bytes, both
    packages at the default hot_set_capacity (1024), the callers one
    after another (see that test): byte-equal answers, equal pinned
    keys and demotion counters.  GLOBAL batches take the wire_hotset
    lane, or the protobuf lane where a pinned key demotes."""
    from gubernator_tpu.config import Config as JaxConfig
    from gubernator_tpu.instance import V1Instance as JaxInstance
    from gubernator_tpu.parallel import make_mesh
    from gubernator_tpu.parallel.pallas_engine import PallasServingEngine
    from gubernator_tpu.parallel.sharded import ShardedEngine as JaxEngine

    from test_torch_service import demotion_counts, hot_caller_stream

    quiet_jax(monkeypatch)
    streams = {c: [(encode_get_rate_limits(
        [RateLimitRequest(**r) for r in reqs]), now)
        for reqs, now in hot_caller_stream(c, 3)] for c in range(4)}
    port = V1Instance(Config(cache_size=CAP, batch_rows=64, device="cpu",
                             engine=ENGINES[engine], sweep_interval_ms=0))
    cls = JaxEngine if ENGINES[engine] == "xla" else PallasServingEngine
    jax_inst = JaxInstance(
        JaxConfig(cache_size=CAP, batch_rows=64, sweep_interval_ms=0),
        engine=cls(make_mesh(n=1), capacity_per_shard=CAP,
                   batch_per_shard=64))
    try:
        for c in streams:
            for data, now in streams[c]:
                assert port.get_rate_limits_wire(data, now) == \
                    jax_inst.get_rate_limits_wire(data, now), c
        assert port._hotset.slots == jax_inst._hotset.slots
        assert demotion_counts(port) == demotion_counts(jax_inst)
        lanes = port.metrics.registry.get_sample_value(
            "gubernator_wire_lane_requests_total", {"lane": "wire_hotset"})
        assert lanes == jax_inst.metrics.registry.get_sample_value(
            "gubernator_wire_lane_requests_total", {"lane": "wire_hotset"})
        assert lanes > 0
    finally:
        port.close()
        jax_inst.close()


def lane_batch(lane: str):
    base = [RateLimitRequest(name="lane", unique_key=f"k{i % 4}", hits=1,
                             limit=3, duration=60_000) for i in range(10)]
    extra = {
        "fused": [],
        "gregorian": [RateLimitRequest(name="lane", unique_key="g",
                                       limit=3, duration=2, behavior=4)],
        "bad gregorian": [RateLimitRequest(name="lane", unique_key="g",
                                           limit=3, duration=9,
                                           behavior=4)],
        "global": [RateLimitRequest(name="lane", unique_key="k1", limit=3,
                                    duration=60_000, behavior=2)],
        "multi-region": [RateLimitRequest(name="lane", unique_key="k2",
                                          limit=3, duration=60_000,
                                          behavior=16)],
        "metadata": [RateLimitRequest(name="lane", unique_key="m", limit=3,
                                      metadata={"a": "b"})],
        "empty key": [RateLimitRequest(name="lane", unique_key="",
                                       limit=3)],
        "empty name": [RateLimitRequest(name="", unique_key="k", limit=3)],
    }[lane]
    return encode_get_rate_limits(base + extra)


LANES = {"fused": "fused", "gregorian": "parse", "bad gregorian": "parse",
         "global": "parse", "multi-region": "parse", "metadata": "pb2",
         "empty key": "pb2", "empty name": "pb2"}


@pytest.mark.parametrize("lane", sorted(LANES))
@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_each_lane_matches_jax(monkeypatch, engine, lane):
    """One batch per lane, twice (the second sees the first's state):
    the lane the port took, and bytes equal to the JAX instance's."""
    quiet_jax(monkeypatch)
    data = lane_batch(lane)
    port = port_instance(ENGINES[engine])
    taken = []
    for name in ("_run_fused", "_wire_check_columns", "_wire_pb2"):
        fn = getattr(port, name)

        def spy(*a, _fn=fn, _name=name):
            taken.append(_name)
            return _fn(*a)

        monkeypatch.setattr(port, name, spy)
    try:
        got = [port.get_rate_limits_wire(data, NOW + i) for i in range(2)]
        pool = port.engine.wave_pool.stats()
    finally:
        port.close()
    assert set(taken) == {{"fused": "_run_fused",
                           "parse": "_wire_check_columns",
                           "pb2": "_wire_pb2"}[LANES[lane]]}
    assert pool["leaks"] == 0 and pool["outstanding"] == 0
    jax_inst = jax_instance(ENGINES[engine])
    try:
        want = [jax_inst.get_rate_limits_wire(data, NOW + i)
                for i in range(2)]
    finally:
        jax_inst.close()
    assert got == want


@pytest.mark.parametrize("lane", ["fused", "parse", "pb2"])
def test_more_than_max_batch_size_raises(monkeypatch, lane):
    """1001 rows raise ValueError on every lane (batch_rows 128: the
    largest wave bucket holds 1024 rows, so the fused lane sees them)."""
    quiet_jax(monkeypatch)
    reqs = [RateLimitRequest(name="big", unique_key=f"k{i}", limit=5,
                             duration=1000) for i in range(1001)]
    if lane == "parse":
        reqs[0] = RateLimitRequest(name="big", unique_key="g", limit=5,
                                   duration=1, behavior=4)
    if lane == "pb2":
        reqs[0] = RateLimitRequest(name="big", unique_key="m", limit=5,
                                   metadata={"a": "b"})
    data = encode_get_rate_limits(reqs)
    port = port_instance("", batch_rows=128)
    jax_inst = jax_instance("", batch_rows=128)
    try:
        with pytest.raises(ValueError, match="list too large"):
            port.get_rate_limits_wire(data, NOW)
        with pytest.raises(ValueError, match="list too large"):
            jax_inst.get_rate_limits_wire(data, NOW)
        assert port.engine.wave_pool.stats()["outstanding"] == 0
        # exactly MAX_BATCH_SIZE still serves
        assert port.get_rate_limits_wire(
            encode_get_rate_limits(reqs[1:]), NOW)
    finally:
        port.close()
        jax_inst.close()


def test_garbage_bytes_raise_value_error():
    port = port_instance("")
    try:
        with pytest.raises(ValueError, match="invalid GetRateLimitsReq"):
            port.get_rate_limits_wire(b"\xff\xff\xff", NOW)
        assert port.get_rate_limits_wire(b"", NOW) == b""
    finally:
        port.close()


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_out_of_domain_row(monkeypatch, engine):
    """A limit of 2^40 beside in-domain rows.  Bucket engine: the port's
    wire answer equals the JAX object lane's (table full for that row
    only); the JAX fused wire lane lets the row reach its kernel (a
    fault of the reference).  Classic engine: served, equal to the JAX
    classic engine's wire answer."""
    from gubernator_tpu.types import RateLimitRequest as JaxReq
    from gubernator_tpu.wire import resp_to_pb
    from gubernator_tpu.proto import gubernator_pb2 as pb

    quiet_jax(monkeypatch)
    rows = [dict(name="ood", unique_key="small", hits=1, limit=5,
                 duration=60_000),
            dict(name="ood", unique_key="big", hits=1, limit=2 ** 40,
                 duration=60_000),
            dict(name="ood", unique_key="small", hits=1, limit=5,
                 duration=60_000)]
    data = encode_get_rate_limits([RateLimitRequest(**r) for r in rows])
    port = port_instance(ENGINES[engine])
    try:
        got = port.get_rate_limits_wire(data, NOW)
    finally:
        port.close()
    jax_inst = jax_instance(ENGINES[engine])
    try:
        if engine == "bucket":
            out = pb.GetRateLimitsResp()
            out.responses.extend(resp_to_pb(r) for r in
                                 jax_inst.get_rate_limits(
                                     [JaxReq(**r) for r in rows], NOW))
            want = out.SerializeToString()
        else:
            want = jax_inst.get_rate_limits_wire(data, NOW)
    finally:
        jax_inst.close()
    assert got == want
    resps = pb.GetRateLimitsResp.FromString(got).responses
    assert [r.remaining for r in (resps[0], resps[2])] == [4, 3]
    if engine == "bucket":
        assert resps[1].error == "rate limit table full"
        assert (resps[1].status, resps[1].limit, resps[1].remaining) == \
            (0, 0, 0)
    else:
        assert not resps[1].error and resps[1].remaining == 2 ** 40 - 1


def test_busy_dispatcher_copies_rows_out_of_the_lease(monkeypatch):
    """With the inline path taken, a fused wave coalesces through the
    worker: its rows are copied out and the lease goes back at once.
    Twice (the second sees the first's state), held to JAX."""
    quiet_jax(monkeypatch)
    data = lane_batch("fused")
    jax_inst = jax_instance("")
    try:
        want = [jax_inst.get_rate_limits_wire(data, NOW + t)
                for t in (0, 1)]
    finally:
        jax_inst.close()
    port = port_instance("")
    try:
        port.dispatcher._inline_mu.acquire()
        try:
            got = [port.get_rate_limits_wire(data, NOW + t)
                   for t in (0, 1)]
        finally:
            port.dispatcher._inline_mu.release()
        assert got == want
        assert port.dispatcher.wave_count == 2
        assert port.dispatcher.inline_waves == 0
        assert port.engine.wave_pool.stats()["outstanding"] == 0
    finally:
        port.close()


def test_no_inline_wave_starts_after_close():
    port = port_instance("")
    port.close()
    assert port.dispatcher._try_inline() is False
    assert port.dispatcher.run_inline_wave(lambda: 1) is \
        port.dispatcher._BUSY


def test_pool_reuse_under_concurrency():
    """Threads lease, stamp and check their pair while others do the
    same: a pair is never handed to two holders, every lease arrives
    zeroed, and a dropped lease counts as a leak and comes back."""
    pool = WaveBufferPool()
    errors = []
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)

    def worker(t):
        try:
            for i in range(200):
                lease = pool.lease(64 if i % 2 else 128)
                if lease.a64.any() or lease.a32.any():
                    errors.append("not zeroed")
                lease.a64.fill(t * 1000 + i)
                lease.a32.fill(t)
                time.sleep(0)
                if (lease.a64 != t * 1000 + i).any() or \
                        (lease.a32 != t).any():
                    errors.append("shared")
                lease.release()
                lease.release()  # idempotent
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))

    try:
        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(switch)
    assert not errors, errors[:3]
    s = pool.stats()
    assert s["hits"] + s["misses"] == 16 * 200
    assert s["outstanding"] == 0 and s["leaks"] == 0
    assert s["pooled"] <= 2 * WaveBufferPool.MAX_PER_WIDTH
    lease = pool.lease(64)
    del lease
    gc.collect()
    assert pool.stats()["leaks"] == 1
    assert pool.stats()["outstanding"] == 0
