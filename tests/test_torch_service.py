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
                             sweep_interval_ms=0))
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
