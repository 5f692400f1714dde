"""The port's persistence hooks (store.py) and their instance wiring on
the CPU against the JAX package's: the item codec, the ``.npz`` snapshot
read across packages, MockStore / MockLoader call counts on the same
flows (read-through and write-through included), ``remove``, the
daemon's GUBER_SNAPSHOT_PATH round trip, and the ``snapshot`` /
``restore`` faultpoints.  The tolerance is zero."""
import json
import urllib.request

import numpy as np
import pytest

from gubernator_tpu_torch import store
from gubernator_tpu_torch.config import Config
from gubernator_tpu_torch.daemon import spawn_daemon
from gubernator_tpu_torch.instance import V1Instance
from gubernator_tpu_torch.tiering import ROW_COLS
from gubernator_tpu_torch.types import RateLimitRequest

NOW = 1_765_000_000_000
CAP = 1024


def seeded_arrays(n: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"key": rng.integers(1, 2 ** 64 - 1, n, dtype=np.uint64),
            "meta": rng.integers(0, 4, n).astype(np.int32),
            "limit": rng.integers(0, 2 ** 40, n),
            "duration": rng.integers(0, 2 ** 33, n),
            "eff_ms": rng.integers(0, 2 ** 33, n),
            "burst": rng.integers(0, 2 ** 40, n),
            "remaining": rng.integers(0, 2 ** 60, n),
            "t_ms": rng.integers(NOW - 10 ** 6, NOW, n),
            "expire_at": rng.integers(NOW, NOW + 10 ** 6, n)}


def same_columns(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for f in a:
        assert np.asarray(a[f]).dtype == np.asarray(b[f]).dtype, f
        assert (np.asarray(a[f]) == np.asarray(b[f])).all(), f


@pytest.mark.parametrize("seed", range(3))
def test_item_codec_equals_jax(seed):
    from gubernator_tpu import store as jax_store

    arrays = seeded_arrays(500, seed)
    items = store.items_from_arrays(arrays)
    assert [vars(i) for i in items] == \
        [vars(i) for i in jax_store.items_from_arrays(arrays)]
    same_columns(store.arrays_from_items(items),
                 jax_store.arrays_from_items(
                     jax_store.items_from_arrays(arrays)))
    # keyed by name only: both hash "name_uniquekey" alike
    named = [store.CacheItem(key=f"n{i}_u{i}", limit=i) for i in range(50)]
    jnamed = [jax_store.CacheItem(key=f"n{i}_u{i}", limit=i)
              for i in range(50)]
    same_columns(store.arrays_from_items(named),
                 jax_store.arrays_from_items(jnamed))
    # the column path yields what the item round trip yields
    same_columns(store.normalized_arrays(arrays),
                 store.arrays_from_items(items))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_npz_loads_in_the_other_package(tmp_path, writer):
    from gubernator_tpu import store as jax_store

    arrays = seeded_arrays(300, 7)
    path = str(tmp_path / "snap.npz")
    if writer == "port":
        store.FileLoader(path).save(iter(store.items_from_arrays(arrays)))
        got = jax_store.FileLoader(path).load()
        want = jax_store.items_from_arrays(arrays)
    else:
        jax_store.FileLoader(path).save(
            iter(jax_store.items_from_arrays(arrays)))
        got = store.FileLoader(path).load()
        want = store.items_from_arrays(arrays)
    assert [vars(i) for i in got] == [vars(i) for i in want]
    # and the port's column path reads the same rows
    same_columns(store.FileLoader(path).load_arrays(),
                 store.normalized_arrays(arrays))


def test_column_save_writes_the_item_save(tmp_path):
    arrays = seeded_arrays(200, 9)
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    store.FileLoader(a).save_arrays(arrays)
    store.FileLoader(b).save(iter(store.items_from_arrays(arrays)))
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for f in za.files:
            assert za[f].dtype == zb[f].dtype
            assert (za[f] == zb[f]).all()
    assert store.FileLoader(str(tmp_path / "none.npz")).load_arrays() is None


def test_save_is_atomic(tmp_path, monkeypatch):
    """A failed write keeps the old snapshot and leaves no temp file."""
    path = str(tmp_path / "snap.npz")
    store.FileLoader(path).save_arrays(seeded_arrays(10, 1))

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez_compressed", boom)
    with pytest.raises(OSError):
        store.FileLoader(path).save_arrays(seeded_arrays(10, 2))
    assert len(store.FileLoader(path).load_arrays()["key"]) == 10
    assert [p.name for p in tmp_path.iterdir()] == ["snap.npz"]


# ---- instances with a Store and a Loader ---------------------------------

@pytest.fixture()
def quiet(monkeypatch):
    for var in ("GUBER_SLO", "GUBER_MEM_LEDGER", "GUBER_ANALYTICS"):
        monkeypatch.setenv(var, "0")
    monkeypatch.delenv("GUBER_TIER_COLD", raising=False)
    monkeypatch.setenv("GUBER_PIPELINE", "0")
    return monkeypatch


def jax_instance(engine: str, **jax_kw):
    from gubernator_tpu.config import Config as JaxConfig
    from gubernator_tpu.instance import V1Instance as JaxInstance
    from gubernator_tpu.parallel import make_mesh
    from gubernator_tpu.parallel.pallas_engine import PallasServingEngine
    from gubernator_tpu.parallel.sharded import ShardedEngine as JaxEngine

    cls = JaxEngine if engine == "xla" else PallasServingEngine
    return JaxInstance(
        JaxConfig(cache_size=CAP, batch_rows=64, sweep_interval_ms=0,
                  hot_set_capacity=0, **jax_kw),
        engine=cls(make_mesh(n=1), capacity_per_shard=CAP,
                   batch_per_shard=64))


def pair(engine: str, port_kw: dict, jax_kw: dict):
    port = V1Instance(Config(cache_size=CAP, batch_rows=64, device="cpu",
                             sweep_interval_ms=0, engine=engine,
                             hot_set_capacity=0, **port_kw))
    try:
        return port, jax_instance(engine, **jax_kw)
    except BaseException:
        port.close()
        raise


def flow(seed: int):
    rng = np.random.default_rng(seed)
    out = []
    for b in range(4):
        out.append(([dict(name="s", unique_key=f"k{int(rng.integers(0, 40))}",
                          hits=int(rng.integers(0, 3)), limit=5,
                          duration=60_000, algorithm=int(rng.integers(0, 2)))
                     for _ in range(int(rng.integers(5, 30)))]
                    + [dict(name="", unique_key="bad")],
                    NOW + 1000 * b))
    return out


def answers(resps):
    return [(int(r.status), int(r.limit), int(r.remaining),
             int(r.reset_time), r.error) for r in resps]


def items_of(st) -> dict:
    return {k: (v.key, v.algorithm, v.limit, v.duration, v.remaining,
                v.expire_at, v.status) for k, v in st.items.items()}


@pytest.mark.parametrize("engine", ["", "xla"])
@pytest.mark.parametrize("lane", ["object", "wire"])
def test_mock_store_counts_equal_jax(quiet, engine, lane):
    """Read-through (get on a device miss) and write-through (on_change
    per non-error answer) on the same flows: equal answers, call counts
    and items.  With a Store set the wire bytes take the object path."""
    from gubernator_tpu import store as jax_store
    from gubernator_tpu.types import RateLimitRequest as JaxReq
    from gubernator_tpu_torch.proto import gubernator_pb2 as pb
    from gubernator_tpu_torch.wire import encode_get_rate_limits

    ps, js = store.MockStore(), jax_store.MockStore()
    # a pre-seeded item: read through on its first request
    for st, cls in ((ps, store.CacheItem), (js, jax_store.CacheItem)):
        st.items["s_k3"] = cls(key="s_k3", limit=5, duration=60_000,
                               remaining=1, t_ms=NOW,
                               expire_at=NOW + 60_000)
    port, jx = pair(engine, {"store": ps}, {"store": js})
    try:
        for reqs, now in flow(3):
            if lane == "wire":
                data = encode_get_rate_limits(
                    [RateLimitRequest(**r) for r in reqs])
                a, b = [[(r.status, r.limit, r.remaining, r.reset_time,
                          r.error) for r in pb.GetRateLimitsResp.FromString(
                              inst.get_rate_limits_wire(data, now_ms=now)
                          ).responses] for inst in (port, jx)]
            else:
                a = answers(port.get_rate_limits(
                    [RateLimitRequest(**r) for r in reqs], now_ms=now))
                b = answers(jx.get_rate_limits(
                    [JaxReq(**r) for r in reqs], now_ms=now))
            assert a == b
        assert ps.called == js.called
        assert ps.called["get"] > 0 and ps.called["on_change"] > 0
        assert items_of(ps) == items_of(js)
        assert port.remove("s", "k3") == jx.remove("s", "k3") is True
        assert "s_k3" not in ps.items and ps.called == js.called
    finally:
        port.close()
        jx.close()


def test_peer_object_lane_reads_and_writes_through(quiet):
    from gubernator_tpu import store as jax_store
    from gubernator_tpu.types import RateLimitRequest as JaxReq

    ps, js = store.MockStore(), jax_store.MockStore()
    port, jx = pair("", {"store": ps}, {"store": js})
    try:
        for reqs, now in flow(4):
            reqs = [r for r in reqs if r["name"]]
            assert answers(port.get_peer_rate_limits(
                [RateLimitRequest(**r) for r in reqs], now_ms=now)) == \
                answers(jx.get_peer_rate_limits(
                    [JaxReq(**r) for r in reqs], now_ms=now))
        assert ps.called == js.called and items_of(ps) == items_of(js)
    finally:
        port.close()
        jx.close()


@pytest.mark.parametrize("engine", ["", "xla"])
def test_mock_loader_round_trip_equals_jax(quiet, engine):
    """Close saves both tiers through the Loader (one save), a new
    instance loads them (one load): equal items and answers after."""
    from gubernator_tpu import store as jax_store
    from gubernator_tpu.types import RateLimitRequest as JaxReq

    pl, jl = store.MockLoader(), jax_store.MockLoader()
    port, jx = pair(engine, {"loader": pl}, {"loader": jl})
    for reqs, now in flow(5):
        port.get_rate_limits([RateLimitRequest(**r) for r in reqs],
                             now_ms=now)
        jx.get_rate_limits([JaxReq(**r) for r in reqs], now_ms=now)
    port.close()
    jx.close()
    assert pl.called == jl.called == {"load": 1, "save": 1}

    def rows(items):
        return sorted((i.key_hash, i.algorithm, i.status, i.limit,
                       i.duration, i.eff_ms, i.remaining, i.t_ms,
                       i.expire_at) for i in items)

    assert rows(pl.contents) == rows(jl.contents) and pl.contents
    port, jx = pair(engine, {"loader": pl}, {"loader": jl})
    try:
        probe = [dict(name="s", unique_key=f"k{i}", hits=1, limit=5,
                      duration=60_000) for i in range(40)]
        assert answers(port.get_rate_limits(
            [RateLimitRequest(**r) for r in probe], now_ms=NOW + 5000)) == \
            answers(jx.get_rate_limits([JaxReq(**r) for r in probe],
                                       now_ms=NOW + 5000))
        assert pl.called["load"] == jl.called["load"] == 2
    finally:
        port.close()
        jx.close()


@pytest.mark.parametrize("point", ["snapshot", "restore"])
def test_loader_faultpoints_raise_as_jax(quiet, point):
    """``restore`` armed: the instance is not built; ``snapshot`` armed:
    close raises before the Loader saves.  As in the JAX package."""
    from gubernator_tpu import store as jax_store
    from gubernator_tpu.faults import FaultInjected as JaxFault
    from gubernator_tpu_torch.faults import FaultInjected

    quiet.setenv("GUBER_FAULT", f"{point}:error")
    pl, jl = store.MockLoader(), jax_store.MockLoader()
    if point == "restore":
        with pytest.raises(FaultInjected):
            V1Instance(Config(cache_size=CAP, device="cpu", loader=pl))
        with pytest.raises(JaxFault):
            jax_instance("xla", loader=jl)
        assert pl.called["load"] == jl.called["load"] == 0
        return
    port, jx = pair("", {"loader": pl}, {"loader": jl})
    with pytest.raises(FaultInjected):
        port.close()
    with pytest.raises(JaxFault):
        jx.close()
    assert pl.called == jl.called == {"load": 1, "save": 0}
    assert port.faults.describe()["points"][0]["fired"] == 1


def test_remove_clears_device_cold_and_store(quiet):
    """remove: the device row, the cold row and the Store item go; the
    next request starts fresh.  Equal to JAX on the classic engine."""
    quiet.setenv("GUBER_TIER_COLD", "1")
    ps = store.MockStore()
    inst = V1Instance(Config(cache_size=CAP, batch_rows=64, device="cpu",
                             sweep_interval_ms=0, store=ps))
    try:
        reqs = [RateLimitRequest(name="r", unique_key=f"k{i}", hits=3,
                                 limit=5, duration=60_000)
                for i in range(1000)]
        inst.get_rate_limits(reqs, now_ms=NOW)
        cold = set(inst._tier.snapshot_arrays()["key"].tolist())
        from gubernator_tpu_torch.hashing import hash_key

        khs = {i: hash_key("r", f"k{i}") for i in range(1000)}
        c = next(i for i in range(1000) if khs[i] in cold)
        d = next(i for i in range(1000) if khs[i] not in cold)
        for i in (c, d):
            assert inst.remove("r", f"k{i}")
            assert f"r_k{i}" not in ps.items
            out = inst.get_rate_limits([RateLimitRequest(
                name="r", unique_key=f"k{i}", hits=1, limit=5,
                duration=60_000)], now_ms=NOW + 1)[0]
            assert (out.remaining, out.error) == (4, "")
        assert not inst.remove("r", "never")
        assert ps.called["remove"] == 3
    finally:
        inst.close()


# ---- the daemon's snapshot path ------------------------------------------

def _post(port, reqs):
    body = json.dumps({"requests": reqs}).encode()
    r = urllib.request.Request(f"http://127.0.0.1:{port}/v1/GetRateLimits",
                               body, {"Content-Type": "application/json"})
    with urllib.request.urlopen(r, timeout=30) as resp:
        return json.loads(resp.read())["responses"]


def union(inst) -> dict:
    snap = inst.engine.snapshot()
    out = {k: tuple(int(snap[f][i]) for f in ROW_COLS)
           for i, k in enumerate(np.asarray(snap["key"]).tolist())}
    tier = getattr(inst, "_tier", None)
    cold = tier.snapshot_arrays() if tier is not None else None
    if cold is not None:
        for i, k in enumerate(np.asarray(cold["key"]).tolist()):
            out[k] = tuple(int(cold[f][i]) for f in ROW_COLS)
    return out


@pytest.mark.parametrize("tier", ["0", "1"])
def test_snapshot_path_round_trip(quiet, tmp_path, tier):
    """GUBER_SNAPSHOT_PATH: close writes the file, a new daemon restores
    equal state (both tiers), and the JAX package's FileLoader reads the
    file into a JAX instance with the same rows."""
    from gubernator_tpu import store as jax_store
    from gubernator_tpu.config import Config as JaxConfig
    from gubernator_tpu.instance import V1Instance as JaxInstance
    from gubernator_tpu.parallel import make_mesh
    from gubernator_tpu.parallel.sharded import ShardedEngine as JaxEngine
    from gubernator_tpu_torch.config import setup_daemon_config

    quiet.setenv("GUBER_TIER_COLD", tier)
    path = str(tmp_path / "snap" / "guber.npz")
    cfg = setup_daemon_config(env={
        "GUBER_SNAPSHOT_PATH": path, "GUBER_HTTP_ADDRESS": "127.0.0.1:0",
        "GUBER_GRPC_ADDRESS": "", "GUBER_CACHE_SIZE": str(CAP),
        "GUBER_DEVICE": "cpu"})
    assert cfg.snapshot_path == path
    d = spawn_daemon(cfg)
    try:
        for a in range(0, 1500, 500):
            _post(d.http_port, [{"name": "d", "unique_key": f"k{i}",
                                 "hits": 2, "limit": 9, "duration": 600_000,
                                 "algorithm": i % 2}
                                for i in range(a, a + 500)])
        before = union(d.instance)
    finally:
        d.close()
    from gubernator_tpu_torch.hashing import hash_key

    before.pop(hash_key("_warmup", "w"))  # each daemon's warm-up query
    assert len(before) == (1500 if tier == "1" else
                           len(d.instance.engine.snapshot()["key"]) - 1)
    d2 = spawn_daemon(cfg)
    try:
        after = union(d2.instance)
        assert {k: after.get(k) for k in before} == before
        if tier == "1":
            assert d2.instance._tier.cold_keys() > 0
    finally:
        d2.close()
    quiet.setenv("GUBER_TIER_COLD", "1")
    jx = JaxInstance(
        JaxConfig(cache_size=CAP, batch_rows=64, sweep_interval_ms=0,
                  hot_set_capacity=0, tier_cold=True,
                  loader=jax_store.FileLoader(path)),
        engine=JaxEngine(make_mesh(n=1), capacity_per_shard=CAP,
                         batch_per_shard=64))
    try:
        saved = store.FileLoader(path).load_arrays()
        assert len(union(jx)) == len(saved["key"])
    finally:
        jx.loader = None  # keep the file as the port wrote it
        jx.close()
