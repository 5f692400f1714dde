"""The port's tenant ledger and cost model (analytics.py) against the JAX
package's on the CPU: the ledger after every fold of seeded streams on
the object lane (``tap_named`` against JAX's ``tap_reqs``) and the wire
lanes (``tap_wire_names`` and the wave's columns), with the learned
table evicting (more keys than it holds) and the ledger overflowing
into ``__other__``, through the host library's fold
(csrc/tenants.cpp) and its plain version, which are held equal; bounded
cardinality, fold conservation and a 16-thread soak; shed, degraded and
error flags; the event hints; the cost model's fit; ``/debug/tenants``
and ``/debug/costmodel``.  Counts are compared exactly."""
import json
import threading
import urllib.request

import numpy as np
import pytest

from gubernator_tpu import analytics as ja
from gubernator_tpu_torch import analytics as pa
from gubernator_tpu_torch.config import Config, DaemonConfig
from gubernator_tpu_torch.daemon import spawn_daemon
from gubernator_tpu_torch.hashing import hash_request_keys
from gubernator_tpu_torch.instance import V1Instance
from gubernator_tpu_torch.types import RateLimitRequest
from gubernator_tpu_torch.wire import encode_get_rate_limits
from test_torch_analytics import named_tap

NOW = 1_765_000_000_000
FOLDS = ("native", "python")


def both(fold, **kw):
    clock = lambda: NOW / 1000  # noqa: E731 - a fixed wall clock
    return (pa.KeyAnalytics(clock=clock, tenant_fold=fold, **kw),
            ja.KeyAnalytics(clock=clock, **kw))


def stream(seed, waves, size, n_keys, n_tenants):
    """Seeded waves of request dicts: Zipf keys over ``n_keys``, names
    ``t{i}/api`` over ``n_tenants`` tenants (some without the
    delimiter), hits incl. 0, negative and past the clamp, invalid
    Gregorian rows, table-full rows and OVER_LIMIT answers."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(waves):
        n = int(rng.integers(size // 2, size))
        rows = []
        for _ in range(n):
            kid = int(min(rng.zipf(1.1), n_keys)) - 1
            t = kid % n_tenants
            greg = rng.random() < 0.03
            rows.append((dict(
                name=(f"t{t}/api" if t % 5 else f"t{t}"),
                unique_key=f"u{kid}", hits=int(rng.choice(
                    [0, 1, 1, 1, 2, 7, -3, 1 << 40])), limit=100,
                algorithm=kid % 2,
                duration=99 if greg else 60_000 * (1 + kid % 7),
                behavior=4 if greg else 0),
                "greg" if greg else ("full" if rng.random() < 0.03
                                     else bool(rng.random() < 0.2))))
        out.append(rows)
    return out


def jax_resps(rows):
    from gubernator_tpu.types import RateLimitResponse as JaxResp

    out = []
    for _, a in rows:
        if a == "greg":
            out.append(JaxResp(error="invalid gregorian"))
        elif a == "full":
            out.append(JaxResp(error="rate limit table full"))
        else:
            out.append(JaxResp(status=int(a)))
    return out


@pytest.mark.parametrize("fold", FOLDS)
@pytest.mark.parametrize("seed", range(3))
def test_object_lane_ledger_equals_jax_after_every_fold(fold, seed,
                                                        monkeypatch):
    """Over 4,096 keys (the learned table evicts) and 12 tenants over a
    ledger of 8 (it overflows): equal after every wave."""
    from gubernator_tpu.types import RateLimitRequest as JaxReq

    monkeypatch.setenv("GUBER_TENANT_MAX", "8")
    p, j = both(fold, k=8, width=32)
    try:
        for rows in stream(seed, 10, 1200, 9000, 12):
            reqs = [RateLimitRequest(**r) for r, _ in rows]
            over = [a is True for _, a in rows]
            full = [i for i, (_, a) in enumerate(rows) if a == "full"]
            p.tap_named(*named_tap(reqs, over, (len(reqs) // 3,), full))
            j.tap_reqs([JaxReq(**r) for r, _ in rows], jax_resps(rows))
            assert p.flush() and j.flush()
            assert p.tenants_snapshot() == j.tenants_snapshot()
        snap = p.tenants_snapshot()
        assert snap["overflowed"] and snap["tenant_count"] == 9
        assert snap["totals"]["errors"] > 0
        assert len(p._table) == len(j._kh_tenant) < 9000
        for k, v in list(j._kh_tenant.items())[-50:]:
            assert p._table.bucket_of(k) == v
    finally:
        p.close()
        j.close()


def wire_wave(rows):
    """A wave as its callers' GetRateLimitsReq bytes (three callers) and
    its columns: key hashes, hits as packed (clamped at 0), status."""
    reqs = [RateLimitRequest(**r) for r, _ in rows]
    kh = hash_request_keys([r.name for r in reqs],
                           [r.unique_key for r in reqs])
    cut = [0, len(reqs) // 3, 2 * len(reqs) // 3, len(reqs)]
    learns = [(encode_get_rate_limits(reqs[a:b]), kh[a:b])
              for a, b in zip(cut, cut[1:])]
    hits = np.maximum(np.array([r.hits for r in reqs], np.int64), 0)
    status = np.array([a is True for _, a in rows], np.int32)
    return learns, kh, hits, status


@pytest.mark.parametrize("fold", FOLDS)
@pytest.mark.parametrize("seed", range(3))
def test_wire_lane_ledger_equals_jax_after_every_fold(fold, seed,
                                                      monkeypatch):
    """The wire lanes carry key hashes: the tenants learn new keys from
    the bytes (each learn queued ahead of its wave's columns, as the
    lanes tap them), evicting and overflowing."""
    monkeypatch.setenv("GUBER_TENANT_MAX", "8")
    p, j = both(fold, k=8, width=32)
    try:
        for w, rows in enumerate(stream(seed, 10, 1200, 9000, 12)):
            learns, kh, hits, status = wire_wave(rows)
            for data, k in learns:
                # every other wave without the lane's hashes: no early
                # exit, the bytes are walked
                kk = k if w % 2 else None
                p.tap_wire_names(data, kk)
                j.tap_wire_names(data, kk)
            p.tap_packed(kh, hits, status)
            j.tap_packed(kh, hits, status)
            assert p.flush() and j.flush()
            assert p.tenants_snapshot() == j.tenants_snapshot()
        snap = p.tenants_snapshot()
        assert snap["overflowed"] and snap["totals"]["requests"] > 5000
        assert snap["tenants"]["__other__"]["requests"] > 0
        assert len(p._table) == len(j._kh_tenant)
    finally:
        p.close()
        j.close()


def test_raw_learn_hashes_and_early_exit_equal_jax():
    """The parse lane taps its pre-finalizer hashes (``raw``); a learn
    whose hashes are all known parses nothing (JAX's early exit), and a
    malformed message learns nothing, on both folds."""
    from gubernator_tpu_torch.ops import native

    reqs = [RateLimitRequest(name=f"r{i % 3}/x", unique_key=f"k{i}",
                             hits=1, limit=5, duration=1000)
            for i in range(50)]
    data = encode_get_rate_limits(reqs)
    raw = native.parse_get_rate_limits(data)["khash_raw"]
    kh = hash_request_keys([r.name for r in reqs],
                           [r.unique_key for r in reqs])
    for fold in FOLDS:
        p, j = both(fold)
        try:
            for a in (p, j):
                a.tap_wire_names(data, raw, raw=True)
                a.tap_wire_names(b"\x0a\xff\xff", None)
                a.tap_packed(kh, np.ones(50, np.int64),
                             np.zeros(50, np.int32))
                a.tap_wire_names(data, raw, raw=True)
                assert a.flush()
            assert p.tenants_snapshot() == j.tenants_snapshot()
            assert p.tenants_snapshot()["tenants"]["r1"]["requests"] == 17
        finally:
            p.close()
            j.close()


@pytest.mark.parametrize("seed", range(2))
def test_native_and_plain_tables_hold_equal(seed, monkeypatch):
    """The host library's table and its plain version, fed the same
    notes (evicting), answer every lookup alike and attribute alike."""
    monkeypatch.setenv("GUBER_TENANT_MAX", "6")
    rng = np.random.default_rng(seed)
    nat, pln = pa.NativeTenantTable(64), pa.PlainTenantTable(64)
    tn, tp = pa.TenantLedger(), pa.TenantLedger()
    seen = []
    for w in range(30):
        reqs = [RateLimitRequest(name=f"t{int(rng.integers(0, 9))}/a",
                                 unique_key=f"k{int(rng.integers(0, 300))}")
                for _ in range(int(rng.integers(1, 40)))]
        kh = hash_request_keys([r.name for r in reqs],
                               [r.unique_key for r in reqs])
        seen.extend(kh.tolist())
        hits = rng.integers(0, 5, len(reqs))
        over = rng.random(len(reqs)) < 0.3
        if w % 3:
            a = nat.learn_fold_objects(tn, kh, lambda: reqs, hits, over)
            b = pln.learn_fold_objects(tp, kh, lambda: reqs, hits, over)
            assert a.tolist() == b.tolist()
        else:
            data = encode_get_rate_limits(reqs)
            nat.learn_wire(tn, data, kh)
            pln.learn_wire(tp, data, kh)
            nat.fold(tn, kh, hits, over)
            pln.fold(tp, kh, hits, over)
        assert tn.snapshot() == tp.snapshot()
        assert len(nat) == len(pln) <= 64
        assert [nat.bucket_of(k) for k in seen] == \
            [pln.bucket_of(k) for k in seen]


def test_native_table_without_the_host_library_raises(monkeypatch):
    from gubernator_tpu_torch.ops import build

    def broken():
        raise RuntimeError("c++ failed")

    with pytest.raises(ValueError):
        pa.KeyAnalytics(tenant_fold="gpu")
    monkeypatch.setattr(build, "load_wire_library", broken)
    with pytest.raises(RuntimeError, match="c\\+\\+ failed"):
        pa.NativeTenantTable(16)


@pytest.mark.parametrize("n", [9, 80])
def test_bounded_cardinality_equals_jax(n, monkeypatch):
    monkeypatch.setenv("GUBER_TENANT_MAX", "8")
    p, j = pa.TenantLedger(), ja.TenantLedger()
    for i in range(n):
        for tl in (p, j):
            idx = tl.index_of(f"t{i:03d}/api")
            tl.add(idx, "requests", 3)
            tl.add(tl.index_of(f"t{i:03d}", pre_split=True), "shed", 1)
    assert p.snapshot() == j.snapshot()
    snap = p.snapshot()
    assert snap["tenant_count"] == 9 and snap["overflowed"]
    assert snap["tenants"]["__other__"]["requests"] == (n - 8) * 3
    assert snap["totals"]["requests"] == n * 3
    assert p.red("shed") == j.red("shed") and p.red("errors") == \
        j.red("errors")
    assert p.tenant_of("a/b/c") == j.tenant_of("a/b/c") == "a"


def test_fold_conservation_equals_jax(monkeypatch):
    monkeypatch.setenv("GUBER_TENANT_MAX", "4")
    p, j = pa.TenantLedger(), ja.TenantLedger()
    for tl in (p, j):
        idxs = np.array([tl.index_of(f"p{i}/k") for i in range(12)])
        hits = np.arange(12, dtype=np.int64) + 1
        over = np.arange(12) % 3 == 0
        tl.fold(idxs, hits, over)
    assert p.snapshot() == j.snapshot()
    tot = p.totals()
    assert tot == j.totals()
    assert (tot["requests"], tot["hits"], tot["over_limit"]) == (12, 78, 4)


def test_sixteen_thread_soak_conserves(monkeypatch):
    monkeypatch.setenv("GUBER_TENANT_MAX", "16")
    tl = pa.TenantLedger()
    errs = []

    def worker(w):
        try:
            rng = np.random.default_rng(w)
            for i in range(200):
                idx = tl.index_of(f"ten{int(rng.integers(0, 40))}/x")
                tl.add(idx, "requests", 1)
                if i % 7 == 0:
                    tl.fold(np.array([idx, tl.index_of("soak/y")]),
                            np.array([2, 1], np.int64),
                            np.array([False, True]))
                if i % 13 == 0:
                    tl.snapshot()
                    tl.red("shed")
        except Exception as e:  # noqa: BLE001 - reported below
            errs.append(e)

    ts = [threading.Thread(target=worker, args=(w,)) for w in range(16)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not errs
    expect = 16 * 200 + sum(2 for _ in range(16)
                            for i in range(200) if i % 7 == 0)
    snap = tl.snapshot()
    assert snap["totals"]["requests"] == expect
    assert sum(c["requests"] for c in snap["tenants"].values()) == expect
    assert snap["tenant_count"] == 17


def test_flags_resolve_as_jax():
    """Flags by tenant id, by a learned key hash, by an unknown one, by
    name and by nothing land in the same buckets on both."""
    p, j = both("native")
    try:
        reqs = [RateLimitRequest(name="flagco/api", unique_key="k1")]
        kh = hash_request_keys(["flagco/api"], ["k1"])
        for a in (p, j):
            a.tap_wire_names(encode_get_rate_limits(reqs), kh)
            a.tap_flag("degraded", 3, khash=int(kh[0]))
            a.tap_flag("errors", 1, khash=12345)
            a.tap_flag("shed", 2, tenant="shedco")
            a.tap_flag("shed", 1, name="nameco/x")
            a.tap_flag("errors", 1)
            assert a.flush()
        assert p.tenants_snapshot() == j.tenants_snapshot()
        t = p.tenants_snapshot()["tenants"]
        assert t["flagco"]["degraded"] == 3 and t["shedco"]["shed"] == 2
        assert t["__other__"]["errors"] == 2
        assert p.tenant_hint(khash=int(kh[0])) == "flagco"
        assert p.tenant_hint(khash=1) is None
        assert p.tenant_hint(name="zz/q") == j.tenant_hint(name="zz/q")
    finally:
        p.close()
        j.close()


def test_detached_ledger_takes_nothing():
    a = pa.KeyAnalytics()
    try:
        a._tenants = None
        assert a.tap_flag("shed") and a.tap_wire_names(b"")
        assert a.tenants_snapshot() == {"enabled": False}
        assert a.tenant_red("errors") == {} and a.tenant_totals() == {}
        assert a.tenant_hint(name="x/y") is None
    finally:
        a.close()


def req(name, key, hits=1):
    return RateLimitRequest(name=name, unique_key=key, hits=hits,
                            limit=100, duration=60_000)


def test_instance_sheds_and_table_full_rows_by_tenant():
    from gubernator_tpu_torch.dispatcher import ResourceExhausted

    inst = V1Instance(Config(cache_size=1 << 10, device="cpu",
                             batch_rows=64))
    try:
        inst.get_rate_limits([req("shedco/api", "warm")])
        evs = inst.recorder.events(kind="wave_completed")
        assert evs[-1]["tenant"] == "shedco"
        assert inst.recorder.events(tenant="shedco")
        inst.dispatcher.drain()
        with pytest.raises(ResourceExhausted):
            inst.get_rate_limits([req("shedco/api", "k1"),
                                  req("shedco/api", "k2")])
        with pytest.raises(ResourceExhausted):
            inst.get_rate_limits_wire(encode_get_rate_limits(
                [req("wireco/api", "k1")]))
        assert inst.recorder.events(kind="admission_shed")[-1]["tenant"] \
            == "shedco"  # one event a second: the first names its tenant
        ana = inst.analytics
        assert ana.flush()
        t = ana.tenants_snapshot()["tenants"]
        assert t["shedco"]["shed"] == 2 and t["wireco"]["shed"] == 1
        assert ana.tenant_totals()["shed"] == 3
        assert ana.tenant_red("shed")["shedco"] == (2, 3)
    finally:
        inst.close()


def test_degraded_serves_counted_as_the_counter(monkeypatch):
    """A daemon whose sends to its peer fail serves the peer's keys
    degraded: the tenant ledger's degraded rows equal
    gubernator_degraded_served, on both lanes."""
    from gubernator_tpu_torch import cluster

    c = cluster.start_with([DaemonConfig(
        grpc_listen_address="127.0.0.1:0",
        http_listen_address="127.0.0.1:0", cache_size=4096, batch_rows=64,
        device="cpu") for _ in range(2)])
    try:
        inst = c.instance_at(0)
        other = c.daemon_at(1).advertise_address
        inst.faults.arm(f"peer_send@{other}:error")
        keys = [f"d{i}" for i in range(60)
                if c.owner_daemon_of(f"degco/api_d{i}") is c.daemon_at(1)]
        reqs = [req("degco/api", k) for k in keys[:10]]
        out = inst.get_rate_limits(reqs)
        assert all(r.metadata.get("degraded") == "true" for r in out)
        inst.get_rate_limits_wire(encode_get_rate_limits(
            [req("degco/api", k) for k in keys[10:20]]))
        served = sum(
            s.value for m in inst.metrics.degraded_served.collect()
            for s in m.samples if s.name.endswith("_total"))
        ana = inst.analytics
        assert ana.flush()
        t = ana.tenants_snapshot()["tenants"]
        assert t["degco"]["degraded"] == served == 20
        # the object lane's event names its tenant from the key name (the
        # wire lane's from the learned table, which may not know it yet)
        ev = inst.recorder.events(kind="degraded")[0]
        assert ev["tenant"] == "degco" and ev["rows"] == 10
        # forced samples: the degraded traces survived at sample 0
        assert inst.span_recorder.sample == 0.0
    finally:
        c.stop()


@pytest.mark.parametrize("seed", [7, 11])
def test_cost_model_fit_equals_jax_and_recovers_held_out(seed):
    rng = np.random.default_rng(seed)
    p, j = pa.CostModel(), ja.CostModel()
    alpha, beta = 200e-6, 0.8e-9
    for s in rng.integers(10_000, 5_000_000, size=60):
        y = (alpha + beta * int(s)) * (1.0 + float(rng.normal(0, 0.01)))
        for cm in (p, j):
            cm.add("broadcast", int(s), 3, y)
            cm.add("peer_flush", 4096, 2, y)
    for cm in (p, j):
        cm.add("single", 10, 2, 1.0)
    assert p.snapshot() == j.snapshot()
    assert p.fit("broadcast", 3) == j.fit("broadcast", 3)
    assert p.fit("peer_flush", 2)["beta_s_per_byte"] == 0.0
    assert p.fit("single", 2) is None and p.predict("none", 1, 5) is None
    for s in (25_000, 400_000, 4_000_000):
        truth = alpha + beta * s
        assert abs(p.predict("broadcast", 3, s) - truth) / truth < 0.10


@pytest.fixture(scope="module")
def tdaemon():
    d = spawn_daemon(DaemonConfig(device="cpu", cache_size=4096,
                                  http_listen_address="127.0.0.1:0",
                                  grpc_listen_address="127.0.0.1:0"))
    yield d
    d.close()


def _get(d, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{d.http_port}{path}",
                                timeout=30) as f:
        return json.loads(f.read())


def test_debug_tenants_and_costmodel_endpoints(tdaemon):
    inst = tdaemon.instance
    inst.get_rate_limits([req("endpointco/api", f"k{i}") for i in range(5)])
    inst.get_rate_limits_wire(encode_get_rate_limits(
        [req("wirepoint/api", f"k{i}") for i in range(4)]))
    body = _get(tdaemon, "/debug/tenants")
    assert body["enabled"] and body["delim"] == "/"
    assert body["max_tenants"] == 64
    assert body["tenants"]["endpointco"]["requests"] == 5
    assert body["tenants"]["wirepoint"]["requests"] == 4
    assert body["totals"]["requests"] == sum(
        t["requests"] for t in body["tenants"].values())
    inst.analytics.tap_cost("broadcast", 1000, 3, 0.001)
    inst.analytics.tap_cost("broadcast", 3000, 3, 0.002)
    cm = _get(tdaemon, "/debug/costmodel")
    assert cm["model"] == "T = alpha + beta * bytes"
    assert cm["buckets"][0]["phase"] == "broadcast"
    assert cm["buckets"][0]["samples"] == 2
    assert cm["buckets"][0]["beta_ns_per_byte"] == pytest.approx(500.0)
    inst.analytics.republish()
    assert inst.metrics.registry.get_sample_value(
        "gubernator_tenant_requests", {"tenant": "endpointco"}) == 5
