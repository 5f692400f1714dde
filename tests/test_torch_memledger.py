"""The port's memory ledger (memledger.py) on the CPU: the ledger itself
against the JAX package's on the same probes (snapshots, pressure
events, advice, gauges), and the instance's enrolment against the live
tensors: exact bytes for the bucket and classic engines, a tiered
daemon spilling to the cold store, a snapshot-restored one, and the hot
set's replicas once a key is pinned; enroll / release without leaks,
GUBER_MEM_LEDGER=0, probe errors contained, ``occupancy_nowait``
returning None while the waves hold the engine, and ``/debug/memory``
(with ``?advise=1``).  Bytes compare exactly."""
import json
import threading
import urllib.error
import urllib.request

import pytest

from gubernator_tpu import memledger as jm
from gubernator_tpu.metrics import Metrics as JaxMetrics
from gubernator_tpu_torch import memledger as pm
from gubernator_tpu_torch.config import Config, DaemonConfig
from gubernator_tpu_torch.daemon import spawn_daemon
from gubernator_tpu_torch.instance import V1Instance
from gubernator_tpu_torch.metrics import Metrics
from gubernator_tpu_torch.store import MockLoader
from gubernator_tpu_torch.types import Behavior, RateLimitRequest

NOW = 1_791_000_000_000


class _Recorder:
    def __init__(self):
        self.events = []

    def record(self, kind, **fields):
        self.events.append(dict(fields, kind=kind))


def both_ledgers():
    out = []
    for mod in (pm, jm):
        rec = _Recorder()
        out.append((mod.MemoryLedger(recorder=rec), rec))
    return out


def test_pressure_edge_triggering_equals_jax():
    occ = {"n": 0}
    got = []
    for led, rec in both_ledgers():
        occ["n"] = 0
        led.enroll("tbl", lambda: {"bytes": 1 << 20, "capacity_rows": 100,
                                   "occupied_rows": occ["n"]},
                   advisable=True)
        led.enroll("cold", lambda: {"bytes": 50, "capacity_rows": 10,
                                    "occupied_rows": 10}, host=True)
        samples = []
        for n in (0, 95, 96, 10, 95, 100, 200):
            occ["n"] = n
            samples.append(led.pressure_sample())
        got.append((samples, rec.events))
    assert got[0] == got[1]
    samples, evs = got[0]
    assert [e["kind"] for e in evs] == ["memory_pressure"] * 2
    assert evs[0]["occupancy"] == {"tbl": 0.95}
    assert samples[0] == (0.0, 0.85) and samples[-1][0] == 1.0


@pytest.mark.parametrize("total", [None, 2048, 100, 5000])
@pytest.mark.parametrize("floor", ["64", "1", "700"])
def test_advice_equals_jax(total, floor, monkeypatch):
    monkeypatch.setenv("GUBER_MEM_ADVISE_FLOOR", floor)
    docs = []
    for led, _ in both_ledgers():
        led.enroll("hot", lambda: {
            "bytes": 1 << 20, "capacity_rows": 1024, "occupied_rows": 1024,
            "demand": {"ranks": [1000 - i for i in range(512)]}},
            advisable=True)
        led.enroll("idle", lambda: {
            "bytes": 1 << 20, "capacity_rows": 1024, "occupied_rows": 8,
            "demand": {"fold_rate": 2.0}}, advisable=True)
        led.enroll("flat", lambda: {
            "bytes": 1 << 10, "capacity_rows": 256, "occupied_rows": 100,
            "demand": {"hit_rate": 500.0}}, advisable=True)
        led.enroll("host_thing", lambda: {"bytes": 123}, host=True)
        docs.append((led.advise(total_rows=total), led.advise(granule=32)))
    assert docs[0] == docs[1]
    adv = docs[0][0]
    assert set(adv["advised"]) == {"hot", "idle", "flat"}
    budget = adv["total_rows"]
    assert sum(adv["advised"].values()) == budget or \
        budget < adv["floor_rows"] * 3
    for n, v in adv["advised"].items():
        assert adv["advised_pow2"][n] >= v


def test_probe_errors_suspend_and_release_equal_jax():
    docs = []
    for led, _ in both_ledgers():
        led.enroll("ok", lambda: {"bytes": 64})
        led.enroll("boom", lambda: (_ for _ in ()).throw(RuntimeError("x")))
        a = led.snapshot()
        led.suspend()
        b = (led.enabled, led.snapshot())
        led.resume()
        c = led.snapshot()
        d = (led.release("ok"), led.release("ok"), led.consumers())
        docs.append((a, b, c, d))
    assert docs[0] == docs[1]
    a = docs[0][0]
    assert a["device_bytes"] == 64 and "error" in a["consumers"]["boom"]


def test_republish_removes_departed_labels():
    m = Metrics()
    led = pm.MemoryLedger()
    led.enroll("a", lambda: {"bytes": 10, "capacity_rows": 4,
                             "occupied_rows": 2})
    led.republish(m)
    text = m.render().decode()
    assert 'gubernator_memledger_bytes{consumer="a"} 10.0' in text
    assert ('gubernator_memledger_rows{consumer="a",state="capacity"} '
            '4.0') in text
    led.release("a")
    led.enroll("b", lambda: {"bytes": 7})
    led.republish(m)
    text = m.render().decode()
    assert 'consumer="a"' not in text
    assert 'gubernator_memledger_bytes{consumer="b"} 7.0' in text
    # JAX's ledger publishes the same samples into its own registry
    jl, jmet = jm.MemoryLedger(), JaxMetrics()
    jl.enroll("b", lambda: {"bytes": 7})
    jl.republish(jmet)
    assert jmet.registry.get_sample_value(
        "gubernator_memledger_bytes", {"consumer": "b"}) == \
        m.registry.get_sample_value("gubernator_memledger_bytes",
                                    {"consumer": "b"})


def reqs(prefix, n, **kw):
    return [RateLimitRequest(name="mem/api", unique_key=f"{prefix}{i}",
                             hits=1, limit=100, duration=600_000, **kw)
            for i in range(n)]


def audit(inst):
    """The snapshot, with each device consumer's bytes checked against
    the live tensors it reads."""
    snap = inst.memledger.snapshot()
    eng = inst.engine
    tensors = sum(int(t.nbytes) for t in eng.table_tensors())
    assert snap["consumers"]["hot_table"]["bytes"] == tensors
    hs = inst._hotset
    if hs is not None:
        hb = sum(int(t.nbytes) for t in
                 list(hs.state) + [hs.base_rem, hs.base_t])
        assert snap["consumers"]["hotset"]["bytes"] == hb
        tensors += hb
    assert snap["device_bytes"] == tensors
    assert snap["consumers"]["hot_table"]["capacity_rows"] == eng.cap_local
    return snap


@pytest.mark.parametrize("engine", ["", "xla"])
def test_exact_bytes_on_both_engines(engine):
    inst = V1Instance(Config(cache_size=4096, device="cpu", batch_rows=64,
                             engine=engine, hot_set_capacity=0))
    try:
        inst.get_rate_limits(reqs("k", 300))
        assert inst.analytics.flush()  # the sketch's ranks are folded
        snap = audit(inst)
        hot = snap["consumers"]["hot_table"]
        assert hot["advisable"] and not hot["host"]
        assert hot["occupied_rows"] == inst.engine.occupancy() == 300
        assert hot["demand"]["ranks"]
        assert snap["consumers"]["sketch"]["host"]
        assert snap["consumers"]["sketch"]["bytes"] == 5 * 8 * 1024
        assert snap["host_bytes"] == sum(
            c["bytes"] for c in snap["consumers"].values() if c["host"])
        assert snap["pressure"] == pytest.approx(300 / inst.engine.cap_local)
        if engine == "xla":
            inst.engine.grow(inst.engine.cap_local * 2)
            audit(inst)  # the probe reads the regrown table
    finally:
        inst.close()


def test_exact_bytes_tiered_and_restored():
    loader = MockLoader()

    def cfg():
        return Config(cache_size=1024, device="cpu", batch_rows=64,
                      tier_cold=True, tier_promote_threshold=2,
                      hot_set_capacity=0, loader=loader)

    inst = V1Instance(cfg())
    try:
        for base in range(0, 3000, 500):
            inst.get_rate_limits(reqs(f"t{base}_", 500), now_ms=NOW + base)
        snap = audit(inst)
        cold = snap["consumers"]["cold_store"]
        assert cold["host"] and cold["bytes"] == inst._tier.mem_bytes() > 0
        assert cold["bytes"] == cold["occupied_rows"] * 9 * 8
    finally:
        inst.close()
    assert loader.called["save"] == 1
    inst2 = V1Instance(cfg())
    try:
        snap2 = audit(inst2)
        assert snap2["consumers"]["cold_store"]["occupied_rows"] > 0
    finally:
        inst2.close()


def test_the_hot_set_enrolls_with_its_replicas():
    inst = V1Instance(Config(cache_size=4096, device="cpu", batch_rows=64,
                             hot_set_capacity=64, hot_promote_threshold=1))
    try:
        assert "hotset" not in inst.memledger.consumers()
        inst.get_rate_limits(reqs("g", 4, behavior=Behavior.GLOBAL))
        assert inst._hotset is not None and inst._hotset.slots
        snap = audit(inst)
        hs = snap["consumers"]["hotset"]
        assert hs["capacity_rows"] == 64 and hs["occupied_rows"] == 4
        assert not hs["advisable"]
    finally:
        inst.close()


def test_enroll_release_leak_free_and_disabled(monkeypatch):
    inst = V1Instance(Config(cache_size=1024, device="cpu"))
    led = inst.memledger
    assert led.consumers() == ["hot_table", "sketch", "wave_pool"]
    inst.close()
    assert led.consumers() == [] and led.release("hot_table") is False
    snap = led.snapshot()
    assert snap["device_bytes"] == 0 and snap["consumers"] == {}
    monkeypatch.setenv("GUBER_MEM_LEDGER", "0")
    inst = V1Instance(Config(cache_size=1024, device="cpu"))
    try:
        assert inst.memledger is None
        assert "hbm_pressure" not in inst.slo.names()
    finally:
        inst.close()


@pytest.mark.parametrize("engine", ["", "xla"])
def test_occupancy_nowait_never_waits_on_the_waves(engine):
    """While a wave holds the engine (its lock), the probe's count
    returns None and the ledger reuses the last sample; once free, the
    count is fresh."""
    inst = V1Instance(Config(cache_size=4096, device="cpu", batch_rows=64,
                             engine=engine, hot_set_capacity=0))
    try:
        inst.get_rate_limits(reqs("a", 50))
        assert inst.engine.occupancy_nowait(lock=inst._engine_mu) == 50
        first = inst.memledger.snapshot()["consumers"]["hot_table"]
        assert first["occupied_rows"] == 50
        inst.get_rate_limits(reqs("b", 30))
        held = threading.Event()
        release = threading.Event()

        def hold():
            with inst._engine_mu:
                held.set()
                release.wait(10)

        t = threading.Thread(target=hold)
        t.start()
        try:
            held.wait(10)
            assert inst.engine.occupancy_nowait(lock=inst._engine_mu) \
                is None
            stale = inst.memledger.snapshot()["consumers"]["hot_table"]
            assert stale["occupied_rows"] == 50  # the last sample
        finally:
            release.set()
            t.join()
        fresh = inst.memledger.snapshot()["consumers"]["hot_table"]
        assert fresh["occupied_rows"] == 80
    finally:
        inst.close()


@pytest.fixture(scope="module")
def mdaemon():
    d = spawn_daemon(DaemonConfig(device="cpu", cache_size=4096,
                                  http_listen_address="127.0.0.1:0",
                                  grpc_listen_address="127.0.0.1:0"))
    yield d
    d.close()


def _get(d, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{d.http_port}{path}",
                                timeout=30) as f:
        return f.read()


def test_debug_memory_and_gauges(mdaemon):
    mdaemon.instance.get_rate_limits(reqs("d", 20))
    body = json.loads(_get(mdaemon, "/debug/memory"))
    assert body["enabled"] and "advise" not in body
    assert body["device_bytes"] == sum(
        int(t.nbytes) for t in mdaemon.instance.engine.table_tensors())
    assert body["pressure_target"] == 0.85
    adv = json.loads(_get(mdaemon, "/debug/memory?advise=1"))["advise"]
    assert adv["total_rows"] == mdaemon.instance.engine.cap_local
    assert sum(adv["advised"].values()) == adv["total_rows"]
    deep = json.loads(_get(mdaemon, "/healthz?deep=1"))["memory"]
    assert deep["device_bytes"] == body["device_bytes"]
    text = _get(mdaemon, "/metrics").decode()
    assert 'gubernator_memledger_bytes{consumer="hot_table"}' in text
    assert 'gubernator_memledger_rows{consumer="hot_table",' \
           'state="capacity"}' in text


def test_debug_memory_404_when_off(monkeypatch):
    monkeypatch.setenv("GUBER_MEM_LEDGER", "0")
    d = spawn_daemon(DaemonConfig(device="cpu", cache_size=1024,
                                  http_listen_address="127.0.0.1:0",
                                  grpc_listen_address="127.0.0.1:0"))
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(d, "/debug/memory")
        assert e.value.code == 404
        assert "memory" not in json.loads(_get(d, "/healthz?deep=1"))
    finally:
        d.close()


def test_the_mesh_tier_enrolls_with_its_replicas(monkeypatch):
    """mesh_global: the replicas and both accumulator buffers of every
    mesh device, as JAX's consumer counts them."""
    from gubernator_tpu_torch.mesh import make_mesh

    monkeypatch.setenv("GUBER_MESH_GLOBAL_CAP", "256")
    inst = V1Instance(Config(cache_size=4096, device="cpu", batch_rows=64,
                             global_mode="mesh"),
                      mesh=make_mesh(["cpu"] * 4))
    try:
        inst.get_rate_limits(reqs("m", 5, behavior=Behavior.GLOBAL))
        snap = inst.memledger.snapshot()
        mg = snap["consumers"]["mesh_global"]
        mge = inst._meshglobal
        want = 4 * 256 * (8 * 8 + 4) + 2 * 4 * 256 * 8
        assert mg["bytes"] == want == sum(
            int(t.nbytes) for t in mge.table_tensors())
        assert mg["capacity_rows"] == 256 and mg["occupied_rows"] == 5
        assert mg["advisable"] and not mg["host"]
        table = sum(int(t.nbytes) for t in inst.engine.table_tensors())
        assert snap["consumers"]["hot_table"]["bytes"] == table
        assert snap["device_bytes"] == table + want
    finally:
        inst.close()
