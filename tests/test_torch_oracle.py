"""The port's pure-Python oracle (gubernator_tpu_torch/oracle.py) held to
the JAX package's, and an injected engine through the port's stack:

- ``Oracle`` on seeded numpy request streams (token and leaky buckets,
  Gregorian ordinals, RESET_REMAINING, DRAIN_OVER_LIMIT, hits=0
  queries, limit, duration and algorithm changes, expiry): every
  response and every key's item equal to JAX's;
- ``V1Instance(engine=OracleEngine())``: the dispatcher's list lane
  answers as JAX's instance on its own OracleEngine, batch for batch;
  the engine's type decides the lanes (the wire lanes and the cold tier
  raise on it, the hot set and mesh mode stand aside), and the same
  injection runs through ``spawn_daemon`` and ``cluster.start``.
"""
import json
import urllib.request

import numpy as np
import pytest

from gubernator_tpu.config import Config as JaxConfig
from gubernator_tpu.instance import V1Instance as JaxInstance
from gubernator_tpu.oracle import Oracle as JaxOracle
from gubernator_tpu.oracle import OracleEngine as JaxOracleEngine
from gubernator_tpu.types import RateLimitRequest as JaxReq
from gubernator_tpu_torch import cluster
from gubernator_tpu_torch.config import Config, DaemonConfig
from gubernator_tpu_torch.daemon import spawn_daemon
from gubernator_tpu_torch.instance import V1Instance
from gubernator_tpu_torch.oracle import Oracle, OracleEngine
from gubernator_tpu_torch.types import Behavior, RateLimitRequest
from gubernator_tpu_torch.wire import encode_get_rate_limits

NOW = 1_790_000_000_000
ITEM_FIELDS = ("algorithm", "limit", "duration", "eff_ms", "burst",
               "remaining", "t_ms", "expire_at", "status")
GREG = int(Behavior.DURATION_IS_GREGORIAN)
RESET = int(Behavior.RESET_REMAINING)
DRAIN = int(Behavior.DRAIN_OVER_LIMIT)


def stream(seed: int, n: int = 600, keys: int = 12):
    """``n`` (now, request) pairs over ``keys`` keys.  A key keeps its
    config for a stretch, then changes limit, duration, algorithm or
    Gregorian interpretation; clocks advance by up to a window and now
    and then jump past it."""
    rng = np.random.default_rng(seed)
    cfg = {}

    def fresh():
        greg = rng.random() < 0.2
        return {"algorithm": int(rng.integers(0, 2)),
                "limit": int(rng.choice([0, 1, 5, 20, 1000])),
                "duration": (int(rng.integers(0, 6)) if greg
                             else int(rng.choice([1, 250, 5_000, 60_000,
                                                  86_400_000]))),
                "greg": greg,
                "burst": int(rng.choice([0, 0, 3, 50]))}

    now = NOW
    out = []
    for _ in range(n):
        now += int(rng.choice([0, 0, 1, 37, 900, 20_000, 4_000_000]))
        k = int(rng.integers(0, keys))
        if k not in cfg or rng.random() < 0.08:
            cfg[k] = fresh()
        c = cfg[k]
        u = rng.random()
        beh = (RESET if u < 0.05 else DRAIN if u < 0.12 else 0) \
            | (GREG if c["greg"] else 0)
        hits = int(rng.choice([0, 1, 1, 1, 2, 7, 40]))
        out.append((now, dict(name="o", unique_key=f"k{k}", hits=hits,
                              limit=c["limit"], duration=c["duration"],
                              algorithm=c["algorithm"], behavior=beh,
                              burst=c["burst"])))
    return out


def resp_tuple(r):
    return (int(r.status), int(r.limit), int(r.remaining),
            int(r.reset_time), r.error)


def item_tuple(it):
    return tuple(int(getattr(it, f)) for f in ITEM_FIELDS)


@pytest.mark.parametrize("seed", range(6))
def test_oracle_answers_and_items_equal_jax(seed):
    port, ref = Oracle(), JaxOracle()
    for now, kw in stream(seed):
        assert resp_tuple(port.check(RateLimitRequest(**kw), now)) == \
            resp_tuple(ref.check(JaxReq(**kw), now)), (now, kw)
    assert port.items.keys() == ref.items.keys()
    for k in port.items:
        assert item_tuple(port.items[k]) == item_tuple(ref.items[k]), k


def test_oracle_covers_the_contract_on_its_streams():
    """The streams reach every branch the contract names: both
    algorithms, Gregorian rows, RESET and DRAIN rows, queries, OVER
    answers, limit and duration changes on a live item."""
    seen = set()
    port = Oracle()
    for now, kw in stream(0, n=2000):
        prev = port.items.get(f"o_{kw['unique_key']}")
        r = port.check(RateLimitRequest(**kw), now)
        seen.add(("algo", kw["algorithm"]))
        seen.update(k for k, on in (("greg", kw["behavior"] & GREG),
                                    ("reset", kw["behavior"] & RESET),
                                    ("drain", kw["behavior"] & DRAIN),
                                    ("query", kw["hits"] == 0),
                                    ("over", int(r.status) == 1)) if on)
        if prev is not None and now < prev.expire_at:
            if prev.limit != kw["limit"]:
                seen.add("limit_change")
            if prev.duration != kw["duration"]:
                seen.add("duration_change")
    assert seen >= {("algo", 0), ("algo", 1), "greg", "reset", "drain",
                    "query", "over", "limit_change", "duration_change"}


def test_invalid_gregorian_raises_in_both():
    kw = dict(name="o", unique_key="g", limit=5, duration=9,
              behavior=GREG)
    with pytest.raises(ValueError):
        Oracle().check(RateLimitRequest(**kw), NOW)
    with pytest.raises(ValueError):
        JaxOracle().check(JaxReq(**kw), NOW)


def test_oracle_engine_mirrors_jax():
    port, ref = OracleEngine(capacity=64), JaxOracleEngine(capacity=64)
    assert (port.cap_local, port.n, port.dropped_rows) == \
        (ref.cap_local, ref.n, ref.dropped_rows)
    batch = [kw for _, kw in stream(3, n=80)]
    a = port.check_batch([RateLimitRequest(**k) for k in batch], NOW)
    b = ref.check_batch([JaxReq(**k) for k in batch], NOW)
    assert [resp_tuple(x) for x in a] == [resp_tuple(x) for x in b]
    assert port.occupancy() == ref.occupancy() > 0
    port.sweep(NOW + 10 ** 12)
    ref.sweep(NOW + 10 ** 12)
    assert port.occupancy() == ref.occupancy() == 0
    assert port.snapshot() == ref.snapshot() == {}
    assert not hasattr(port, "check_packed")


# ---- the injected engine through the instance ------------------------


@pytest.fixture()
def quiet(monkeypatch):
    """Both instances without the background planes whose threads race
    the stream (their outputs are not what these tests compare)."""
    for var in ("GUBER_SLO", "GUBER_MEM_LEDGER"):
        monkeypatch.setenv(var, "0")


def batches_of(seed: int, per: int = 25):
    """The stream cut into batches of ``per`` requests, each at the
    batch's last now, with no invalid row (JAX's OracleEngine raises for
    the whole batch on one) and an empty unique key now and then."""
    rows = stream(seed, n=400)
    out = []
    for i in range(0, len(rows), per):
        chunk = rows[i:i + per]
        reqs = [dict(kw) for _, kw in chunk]
        if i % 100 == 0:
            reqs[0]["unique_key"] = ""
        out.append((chunk[-1][0], reqs))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_injected_oracle_instance_answers_as_jax(quiet, seed):
    port = V1Instance(Config(device="cpu", hot_set_capacity=0,
                             sweep_interval_ms=0), engine=OracleEngine())
    ref = JaxInstance(JaxConfig(hot_set_capacity=0, sweep_interval_ms=0),
                      engine=JaxOracleEngine())
    try:
        for now, reqs in batches_of(seed):
            a = port.get_rate_limits([RateLimitRequest(**k) for k in reqs],
                                     now_ms=now)
            b = ref.get_rate_limits([JaxReq(**k) for k in reqs],
                                    now_ms=now)
            assert [resp_tuple(x) for x in a] == \
                [resp_tuple(x) for x in b], now
        assert port.engine.occupancy() == ref.engine.occupancy()
        kinds = {e["wave_kind"] for e in port.recorder.events(
            kind="wave_launched")}
        assert kinds == {"list"}
    finally:
        port.close()
        ref.close()


def test_injected_engine_answers_global_rows_from_its_own_table(quiet):
    """Alone, GLOBAL rows need the hot set's row interface, which an
    injected list engine lacks: they are decided by the engine itself
    (exactly, as JAX's with the hot set off), and mesh mode stands aside
    as JAX's ``_mesh_mode`` does."""
    port = V1Instance(Config(device="cpu", global_mode="mesh"),
                      engine=OracleEngine())
    ref = JaxInstance(JaxConfig(hot_set_capacity=0),
                      engine=JaxOracleEngine())
    try:
        assert not port._mesh_mode() and not port._row_engine()
        for i in range(100):
            kw = dict(name="g", unique_key=f"k{i % 3}", limit=50,
                      duration=60_000, behavior=int(Behavior.GLOBAL))
            a = port.get_rate_limits([RateLimitRequest(**kw)], NOW + i)
            b = ref.get_rate_limits([JaxReq(**kw)], NOW + i)
            assert resp_tuple(a[0]) == resp_tuple(b[0])
        assert port._hotset is None and port._meshglobal is None
    finally:
        port.close()
        ref.close()


def test_invalid_rows_answer_their_error_as_the_packed_lane(quiet):
    """A row the packer refuses (a Gregorian ordinal past YEARS) answers
    its error on the list lane as on the bucket engine's packed lane,
    and the rest of its batch is decided."""
    reqs = [RateLimitRequest(name="e", unique_key="a", limit=5,
                             duration=60_000),
            RateLimitRequest(name="e", unique_key="b", limit=5,
                             duration=9, behavior=GREG),
            RateLimitRequest(name="e", unique_key="a", limit=5,
                             duration=60_000)]
    insts = [V1Instance(Config(device="cpu", sweep_interval_ms=0),
                        engine=e) for e in (OracleEngine(), None)]
    try:
        outs = [[resp_tuple(r) for r in i.get_rate_limits(reqs, NOW)]
                for i in insts]
        assert outs[0] == outs[1]
        assert outs[0][1][4] and not outs[0][0][4]
        assert [o[2] for o in outs[0]] == [4, 0, 3]
    finally:
        for i in insts:
            i.close()


def test_lanes_an_injected_list_engine_cannot_serve_raise(quiet):
    inst = V1Instance(Config(device="cpu"), engine=OracleEngine())
    try:
        data = encode_get_rate_limits([RateLimitRequest(
            name="w", unique_key="k", limit=5, duration=1000)])
        with pytest.raises(NotImplementedError, match="packed interface"):
            inst.get_rate_limits_wire(data)
        with pytest.raises(NotImplementedError, match="packed interface"):
            inst.get_peer_rate_limits_wire(data)
        # nothing was decided on another engine meanwhile
        assert inst.engine.occupancy() == 0
    finally:
        inst.close()
    with pytest.raises(ValueError, match="row operations"):
        V1Instance(Config(device="cpu", tier_cold=True),
                   engine=OracleEngine())


def test_injection_builds_no_device_engine():
    """``device`` defaults to cuda; an injected engine builds nothing
    there (these tests run without a GPU), and the memory ledger enrols
    only what the engine holds."""
    inst = V1Instance(Config(), engine=OracleEngine())
    try:
        assert isinstance(inst.engine, OracleEngine)
        consumers = (inst.memledger.consumers()
                     if inst.memledger is not None else [])
        assert "hot_table" not in consumers
        assert "wave_pool" not in consumers
        r = inst.get_rate_limits([RateLimitRequest(
            name="d", unique_key="k", limit=2, duration=1000)], NOW)
        assert r[0].remaining == 1
    finally:
        inst.close()


def post(port: int, body: dict) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/GetRateLimits",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as f:
        return json.loads(f.read())


def test_spawn_daemon_serves_an_injected_engine_over_http():
    d = spawn_daemon(DaemonConfig(http_listen_address="127.0.0.1:0",
                                  grpc_listen_address=""),
                     engine=OracleEngine())
    try:
        assert isinstance(d.instance.engine, OracleEngine)
        body = {"requests": [{"name": "api", "uniqueKey": "u1", "hits": 1,
                              "limit": 3, "duration": 5000}]}
        got = [post(d.http_port, body)["responses"][0] for _ in range(5)]
        assert [g["status"] for g in got] == [0, 0, 0, 1, 1]
        assert [g["remaining"] for g in got] == [2, 1, 0, 0, 0]
        assert d.instance.engine.occupancy() == 2  # u1 and the warm-up
        with urllib.request.urlopen(
                f"http://127.0.0.1:{d.http_port}/debug/topkeys") as f:
            top = json.loads(f.read())
        assert {k["key"] for k in top["keys"]} >= {"api_u1"}
    finally:
        d.close()


def test_cluster_start_takes_an_engine_factory_and_addresses():
    made = []

    def factory():
        made.append(OracleEngine())
        return made[-1]

    c = cluster.start(2, device="cpu", engine=factory)
    try:
        assert [c.instance_at(i).engine for i in range(2)] == made
        assert c.grpc_address(1) == c.daemon_at(1).advertise_address
        for i in range(2):
            with urllib.request.urlopen(c.http_address(i) + "/healthz") as f:
                assert json.loads(f.read())["status"] == "healthy"
        own = next(k for k in (f"k{i}" for i in range(100))
                   if c.owner_daemon_of(f"c_{k}") is c.daemon_at(0))
        r = c.instance_at(0).get_rate_limits([RateLimitRequest(
            name="c", unique_key=own, limit=4, duration=60_000)], NOW)
        assert (r[0].error, r[0].remaining) == ("", 3)
        c.restart(1)
        assert len(made) == 3 and c.instance_at(1).engine is made[2]
    finally:
        c.stop()
