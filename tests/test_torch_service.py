"""The port's service layer on the CPU: V1Instance, the dispatcher and
the HTTP daemon.  Responses under 16 concurrent callers must equal a JAX
V1Instance's (no hot set, analytics off) on a one-device
PallasServingEngine for the same seeded streams."""
import json
import threading
import urllib.request

import numpy as np
import pytest

from gubernator_tpu_torch.config import (Config, DaemonConfig,
                                         setup_daemon_config)
from gubernator_tpu_torch.daemon import spawn_daemon
from gubernator_tpu_torch.instance import V1Instance
from gubernator_tpu_torch.types import RateLimitRequest

NOW = 1_765_000_000_000
CAP = 1 << 12


def _post(port, reqs):
    body = json.dumps({"requests": reqs}).encode()
    r = urllib.request.Request(f"http://127.0.0.1:{port}/v1/GetRateLimits",
                               body, {"Content-Type": "application/json"})
    with urllib.request.urlopen(r, timeout=30) as resp:
        return json.loads(resp.read())


def test_http_verify_flow():
    d = spawn_daemon(DaemonConfig(http_listen_address="127.0.0.1:0",
                                  grpc_listen_address="127.0.0.1:0",
                                  cache_size=CAP, device="cpu"))
    try:
        got = [_post(d.http_port, [{"name": "api", "uniqueKey": "u1",
                                    "hits": 1, "limit": 3,
                                    "duration": 5000}])["responses"][0]
               for _ in range(5)]
        assert [r["status"] for r in got] == [0, 0, 0, 1, 1]
        assert [r["remaining"] for r in got] == [2, 1, 0, 0, 0]
        assert got[0]["resetTime"] == got[0]["reset_time"] > 0
        with urllib.request.urlopen(
                f"http://127.0.0.1:{d.http_port}/healthz", timeout=30) as r:
            assert json.loads(r.read())["status"] == "healthy"
        # snake_case fields and a per-request error in one batch
        out = _post(d.http_port, [{"name": "api", "unique_key": "u2",
                                   "limit": 2, "duration": 5000},
                                  {"name": "api", "unique_key": ""}])
        assert out["responses"][0]["remaining"] == 1
        assert out["responses"][1]["error"] == \
            "field 'unique_key' cannot be empty"
    finally:
        d.close()


def test_empty_name_and_unique_key_errors():
    inst = V1Instance(Config(cache_size=CAP, device="cpu",
                             sweep_interval_ms=0))
    try:
        out = inst.get_rate_limits([
            RateLimitRequest(name="", unique_key="k", limit=5,
                             duration=1000),
            RateLimitRequest(name="n", unique_key="", limit=5,
                             duration=1000),
            RateLimitRequest(name="n", unique_key="k", limit=5,
                             duration=1000)], now_ms=NOW)
        assert out[0].error == "field 'name' cannot be empty"
        assert out[1].error == "field 'unique_key' cannot be empty"
        assert not out[2].error and out[2].remaining == 4
        with pytest.raises(ValueError):
            inst.get_rate_limits([RateLimitRequest()] * 1001)
    finally:
        inst.close()


def caller_stream(caller: int, seed: int):
    """One caller's batches: its own keys (so the streams of different
    callers never share a key), TOKEN and LEAKY, flags, queries."""
    rng = np.random.default_rng(seed * 100 + caller)
    batches = []
    for b in range(4):
        reqs = []
        for _ in range(int(rng.integers(5, 40))):
            kid = int(rng.zipf(1.4)) % 12
            beh = int(rng.choice([0, 0, 0, 2, 8, 32]))  # GLOBAL too
            reqs.append(dict(name=f"c{caller}", unique_key=f"k{kid}",
                             hits=int(rng.integers(0, 4)),
                             limit=8 + kid % 5, duration=20_000,
                             algorithm=kid % 2, behavior=beh,
                             burst=8 + kid % 5))
        batches.append((reqs, NOW + 300 * b + caller))
    return batches


def run_callers(inst, cls, streams):
    out = {}

    def go(c):
        out[c] = [inst.get_rate_limits([cls(**r) for r in reqs],
                                       now_ms=now)
                  for reqs, now in streams[c]]

    threads = [threading.Thread(target=go, args=(c,)) for c in streams]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def flat(resps):
    return [(int(r.status), r.limit, r.remaining, r.reset_time, r.error)
            for batch in resps for r in batch]


@pytest.mark.parametrize("seed", range(2))
def test_16_concurrent_callers_match_jax_instance(monkeypatch, seed):
    from gubernator_tpu.config import Config as JaxConfig
    from gubernator_tpu.instance import V1Instance as JaxInstance
    from gubernator_tpu.parallel import make_mesh
    from gubernator_tpu.parallel.pallas_engine import PallasServingEngine
    from gubernator_tpu.types import RateLimitRequest as JaxReq

    for var in ("GUBER_ANALYTICS", "GUBER_SLO", "GUBER_MEM_LEDGER"):
        monkeypatch.setenv(var, "0")
    streams = {c: caller_stream(c, seed) for c in range(16)}
    port = V1Instance(Config(cache_size=CAP, batch_rows=64, device="cpu",
                             sweep_interval_ms=0, hot_set_capacity=0))
    try:
        got = run_callers(port, RateLimitRequest, streams)
    finally:
        port.close()
    jax_inst = JaxInstance(
        JaxConfig(cache_size=CAP, batch_rows=64, sweep_interval_ms=0,
                  hot_set_capacity=0),
        engine=PallasServingEngine(make_mesh(n=1), capacity_per_shard=CAP,
                                   batch_per_shard=64))
    try:
        want = run_callers(jax_inst, JaxReq, streams)
    finally:
        jax_inst.close()
    for c in streams:
        assert flat(got[c]) == flat(want[c]), c


def hot_caller_stream(caller: int, seed: int):
    """GLOBAL-heavy batches at the hot set's default settings: a few keys
    take enough hits to pass the default promotion threshold (64) and
    ride the hot set; RESET_REMAINING rows and a new limit on a key
    demote it again; non-GLOBAL rows take the table."""
    rng = np.random.default_rng(seed * 100 + caller + 7)
    batches = []
    for b in range(8):
        reqs = []
        for _ in range(int(rng.integers(20, 60))):
            kid = int(rng.zipf(1.3)) % 8
            beh = int(rng.choice([2, 2, 2, 2, 0, 10]))  # 10 = GLOBAL|RESET
            limit = 500 + kid * 50 + (25 if b == 6 and kid == 1 else 0)
            reqs.append(dict(name=f"h{caller}", unique_key=f"k{kid}",
                             hits=int(rng.integers(0, 5)), limit=limit,
                             duration=60_000, algorithm=kid % 2,
                             behavior=beh, burst=0))
        batches.append((reqs, NOW + 200 * b + caller))
    return batches


def demotion_counts(inst):
    return [inst.metrics.registry.get_sample_value(
        "gubernator_hotset_demotions_total", {"reason": r}) or 0.0
        for r in ("flagged", "config_change", "membership_change")]


@pytest.mark.parametrize("seed", range(2))
def test_hot_set_at_the_default_matches_jax_instance(monkeypatch, seed):
    """Both packages at the default hot_set_capacity (1024) and
    threshold (64), GLOBAL rows in the mix: equal answers, pinned keys
    and demotion counters.  The callers run one after another on both
    sides: a promotion queued by one caller can be drained by another's
    batch before its own step (JAX's too), so concurrent runs may
    differ."""
    from gubernator_tpu.config import Config as JaxConfig
    from gubernator_tpu.instance import V1Instance as JaxInstance
    from gubernator_tpu.parallel import make_mesh
    from gubernator_tpu.parallel.pallas_engine import PallasServingEngine
    from gubernator_tpu.types import RateLimitRequest as JaxReq

    for var in ("GUBER_ANALYTICS", "GUBER_SLO", "GUBER_MEM_LEDGER"):
        monkeypatch.setenv(var, "0")
    streams = {c: hot_caller_stream(c, seed) for c in range(4)}

    def run(inst, cls):
        return {c: [inst.get_rate_limits([cls(**r) for r in reqs],
                                         now_ms=now)
                    for reqs, now in streams[c]] for c in streams}

    port = V1Instance(Config(cache_size=CAP, batch_rows=64, device="cpu",
                             sweep_interval_ms=0))
    jax_inst = JaxInstance(
        JaxConfig(cache_size=CAP, batch_rows=64, sweep_interval_ms=0),
        engine=PallasServingEngine(make_mesh(n=1), capacity_per_shard=CAP,
                                   batch_per_shard=64))
    try:
        got, want = run(port, RateLimitRequest), run(jax_inst, JaxReq)
        assert port._hotset is not None and port._hotset.slots
        assert port._hotset.slots == jax_inst._hotset.slots
        assert demotion_counts(port) == demotion_counts(jax_inst)
        assert sum(demotion_counts(port)) > 0
    finally:
        port.close()
        jax_inst.close()
    for c in streams:
        assert flat(got[c]) == flat(want[c]), c


def test_dispatcher_coalesces_concurrent_callers():
    inst = V1Instance(Config(cache_size=CAP, device="cpu",
                             sweep_interval_ms=0))
    try:
        inst.dispatcher.max_delay_s = 0.05  # a wide window: waves merge
        streams = {c: [([dict(name="m", unique_key=f"{c}", limit=5,
                              duration=60_000)] * 3, NOW)]
                   for c in range(16)}
        got = run_callers(inst, RateLimitRequest, streams)
        assert inst.dispatcher.wave_count < 16
        for c in streams:
            assert [r.remaining for r in got[c][0]] == [4, 3, 2]
    finally:
        inst.close()


def test_daemon_config_layering(tmp_path):
    conf = tmp_path / "d.conf"
    conf.write_text("# comment\nGUBER_HTTP_ADDRESS = 0.0.0.0:1050\n"
                    "GUBER_CACHE_SIZE = 1000\nGUBER_GRPC_ADDRESS = x:1\n")
    cfg = setup_daemon_config(str(conf), env={"GUBER_DEVICE": "cpu",
                                              "GUBER_BATCH_ROWS": "256"})
    assert (cfg.http_listen_address, cfg.cache_size, cfg.batch_rows,
            cfg.device) == ("0.0.0.0:1050", 1000, 256, "cpu")
    assert cfg.instance_config().cache_size == 1024
    assert setup_daemon_config(env={}).device == "cuda"


def test_dispatcher_check_packed_matches_engine():
    """Columnar submits from concurrent callers get the slices a direct
    engine call returns (disjoint keys per caller)."""
    from gubernator_tpu_torch.core.batch import pack_columns
    from gubernator_tpu_torch.dispatcher import Dispatcher
    from gubernator_tpu_torch.engine import BucketEngine
    from gubernator_tpu_torch.hashing import hash_request_keys

    def columns(c):
        n = 30
        kh = hash_request_keys([f"p{c}"] * n, [f"k{i % 7}" for i in range(n)])
        ones = np.ones(n, np.int64)
        return pack_columns(kh, ones, 3 * ones, 60_000 * ones,
                            np.zeros(n, np.int32), np.zeros(n, np.int32),
                            np.zeros(n, np.int64), NOW + c)[0], kh

    cols = {c: columns(c) for c in range(8)}
    disp = Dispatcher(BucketEngine(device="cpu", capacity=CAP,
                                   batch_rows=64), max_delay_ms=20)
    got = {}

    def go(c):
        got[c] = disp.check_packed(*cols[c], NOW + c)

    threads = [threading.Thread(target=go, args=(c,)) for c in cols]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    disp.close()
    ref = BucketEngine(device="cpu", capacity=CAP, batch_rows=64)
    for c in cols:
        want = ref.check_packed(*cols[c], NOW + c)
        for a, b in zip(got[c], want):
            assert (np.asarray(a) == np.asarray(b)).all(), c


# ---- the classic SoA engine (GUBER_ENGINE=xla) --------------------------

def _quiet_jax_instance(monkeypatch):
    for var in ("GUBER_ANALYTICS", "GUBER_SLO", "GUBER_MEM_LEDGER"):
        monkeypatch.setenv(var, "0")
    monkeypatch.delenv("GUBER_ENGINE", raising=False)
    monkeypatch.delenv("GUBER_STEP_IMPL", raising=False)


@pytest.mark.parametrize("seed", range(2))
def test_classic_engine_instance_matches_jax_instance(monkeypatch, seed):
    from gubernator_tpu.config import Config as JaxConfig
    from gubernator_tpu.instance import V1Instance as JaxInstance
    from gubernator_tpu.parallel import make_mesh
    from gubernator_tpu.parallel.sharded import ShardedEngine as JaxEngine
    from gubernator_tpu.types import RateLimitRequest as JaxReq
    from gubernator_tpu_torch.sharded import ShardedEngine

    _quiet_jax_instance(monkeypatch)
    streams = {c: caller_stream(c, seed + 10) for c in range(8)}
    port = V1Instance(Config(cache_size=CAP, batch_rows=64, device="cpu",
                             engine="xla", sweep_interval_ms=0,
                             hot_set_capacity=0))
    assert isinstance(port.engine, ShardedEngine)
    health = port.health_check()
    try:
        got = run_callers(port, RateLimitRequest, streams)
    finally:
        port.close()
    jax_inst = JaxInstance(
        JaxConfig(cache_size=CAP, batch_rows=64, sweep_interval_ms=0,
                  hot_set_capacity=0),
        engine=JaxEngine(make_mesh(n=1), capacity_per_shard=CAP,
                         batch_per_shard=64))
    jax_health = jax_inst.health_check()
    assert (health.status, health.message, health.peer_count) == \
        (jax_health.status, jax_health.message, jax_health.peer_count)
    try:
        want = run_callers(jax_inst, JaxReq, streams)
    finally:
        jax_inst.close()
    for c in streams:
        assert flat(got[c]) == flat(want[c]), c


def test_limit_2_40_classic_serves_bucket_refuses(monkeypatch):
    """A 2^40 limit is outside the bucket engine's domain (table full in
    both packages) and served by the classic engine (in both)."""
    from gubernator_tpu.config import Config as JaxConfig
    from gubernator_tpu.instance import V1Instance as JaxInstance
    from gubernator_tpu.parallel import make_mesh
    from gubernator_tpu.parallel.pallas_engine import PallasServingEngine
    from gubernator_tpu.parallel.sharded import ShardedEngine as JaxEngine
    from gubernator_tpu.types import RateLimitRequest as JaxReq

    _quiet_jax_instance(monkeypatch)
    kw = dict(name="big", unique_key="k", hits=1, limit=2 ** 40,
              duration=60_000)
    for engine, jax_engine, served in (
            ("xla", JaxEngine, True), ("", PallasServingEngine, False)):
        port = V1Instance(Config(cache_size=CAP, batch_rows=64,
                                 device="cpu", engine=engine,
                                 sweep_interval_ms=0, hot_set_capacity=0))
        jax_inst = JaxInstance(
            JaxConfig(cache_size=CAP, batch_rows=64, sweep_interval_ms=0,
                      hot_set_capacity=0),
            engine=jax_engine(make_mesh(n=1), capacity_per_shard=CAP,
                              batch_per_shard=64))
        try:
            got = port.get_rate_limits([RateLimitRequest(**kw)], NOW)
            want = jax_inst.get_rate_limits([JaxReq(**kw)], NOW)
        finally:
            port.close()
            jax_inst.close()
        assert flat([got]) == flat([want]), engine
        if served:
            assert not got[0].error and got[0].remaining == 2 ** 40 - 1
        else:
            assert got[0].error == "rate limit table full"


def test_unknown_engine_raises():
    from gubernator_tpu_torch.instance import resolve_engine_kind

    assert [resolve_engine_kind(s) for s in
            ("", "auto", "Pallas", "xla", " sharded ")] == \
        ["bucket", "bucket", "bucket", "classic", "classic"]
    with pytest.raises(ValueError, match="unknown GUBER_ENGINE"):
        V1Instance(Config(cache_size=CAP, device="cpu", engine="xlaa"))


def test_engine_and_autogrow_are_parsed(tmp_path):
    conf = tmp_path / "d.conf"
    conf.write_text("GUBER_ENGINE = pallas\nGUBER_CACHE_AUTOGROW_MAX = 5000\n")
    cfg = setup_daemon_config(str(conf), env={"GUBER_ENGINE": "xla"})
    assert (cfg.engine, cfg.cache_autogrow_max) == ("xla", 5000)
    ic = cfg.instance_config()
    assert (ic.engine, ic.cache_autogrow_max) == ("xla", 5000)
    assert (setup_daemon_config(env={}).engine,
            setup_daemon_config(env={}).cache_autogrow_max) == ("", 0)
    inst = V1Instance(Config(cache_size=1024, device="cpu", engine="xla",
                             cache_autogrow_max=5000, sweep_interval_ms=0))
    try:
        assert inst.engine.auto_grow_limit == 4096
    finally:
        inst.close()


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_small_cache_size_gets_the_jax_capacity(monkeypatch, engine):
    """cache_size=256: both packages serve 1024 rows (the floor, as the
    JAX instance sets it at one shard), and answer a stream of 450 keys
    the same."""
    from gubernator_tpu.config import Config as JaxConfig
    from gubernator_tpu.instance import V1Instance as JaxInstance
    from gubernator_tpu.parallel import make_mesh
    from gubernator_tpu.types import RateLimitRequest as JaxReq

    _quiet_jax_instance(monkeypatch)
    port = V1Instance(Config(cache_size=256, batch_rows=64, device="cpu",
                             engine=engine, sweep_interval_ms=0,
                             hot_set_capacity=0))
    classic = engine == "xla"
    jax_inst = JaxInstance(
        JaxConfig(cache_size=256, batch_rows=64, sweep_interval_ms=0,
                  hot_set_capacity=0, engine="xla" if classic else "",
                  step_impl="" if classic else "pallas"),
        mesh=make_mesh(n=1))
    try:
        assert type(port.engine).__name__ == type(jax_inst.engine).__name__ \
            .replace("PallasServingEngine", "BucketEngine")
        assert port.engine.cap_local == \
            jax_inst.engine.cap_local * jax_inst.engine.n == 1024
        for w in range(2):
            reqs = [dict(name="cap", unique_key=f"k{i}", hits=1 + i % 2,
                         limit=5, duration=60_000, algorithm=i % 2)
                    for i in range(w * 150, w * 150 + 300)]
            got = [port.get_rate_limits([RateLimitRequest(**r)
                                         for r in reqs[a:a + 150]],
                                        NOW + w)
                   for a in range(0, 300, 150)]
            want = [jax_inst.get_rate_limits([JaxReq(**r)
                                              for r in reqs[a:a + 150]],
                                             NOW + w)
                    for a in range(0, 300, 150)]
            assert flat(got) == flat(want), w
            if classic:
                assert not any(r.error for b in got for r in b)
        assert port.engine.occupancy() > 256
    finally:
        port.close()
        jax_inst.close()


def test_http_daemon_serves_through_the_classic_engine(monkeypatch):
    from gubernator_tpu.config import Config as JaxConfig
    from gubernator_tpu.instance import V1Instance as JaxInstance
    from gubernator_tpu.parallel import make_mesh
    from gubernator_tpu.parallel.sharded import ShardedEngine as JaxEngine
    from gubernator_tpu_torch.sharded import ShardedEngine

    d = spawn_daemon(DaemonConfig(http_listen_address="127.0.0.1:0",
                                  grpc_listen_address="127.0.0.1:0",
                                  cache_size=CAP, device="cpu",
                                  engine="xla"))
    try:
        assert isinstance(d.instance.engine, ShardedEngine)
        got = [_post(d.http_port, [{"name": "api", "uniqueKey": "u1",
                                    "hits": 1, "limit": 3,
                                    "duration": 5000}])["responses"][0]
               for _ in range(5)]
        assert [r["status"] for r in got] == [0, 0, 0, 1, 1]
        assert [r["remaining"] for r in got] == [2, 1, 0, 0, 0]
        big = _post(d.http_port, [{"name": "api", "uniqueKey": "big",
                                   "limit": 2 ** 40,
                                   "duration": 5000}])["responses"][0]
        assert big["remaining"] == 2 ** 40 - 1 and not big["error"]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{d.http_port}/healthz", timeout=30) as r:
            h = json.loads(r.read())
    finally:
        d.close()
    _quiet_jax_instance(monkeypatch)
    jax_inst = JaxInstance(
        JaxConfig(cache_size=CAP, sweep_interval_ms=0, hot_set_capacity=0),
        engine=JaxEngine(make_mesh(n=1), capacity_per_shard=CAP,
                         batch_per_shard=64))
    try:
        want = jax_inst.health_check()
    finally:
        jax_inst.close()
    assert (h["status"], h["message"], h["peer_count"]) == \
        (want.status, want.message, want.peer_count)
