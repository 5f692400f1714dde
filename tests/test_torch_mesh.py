"""The port's engines over a mesh of n > 1 CPU shards (mesh.py) against
the JAX package's on ``make_mesh(n=...)`` of the same size.

The classic engine (sharded.py) is held to the JAX ShardedEngine and
the bucket engine (engine.py) to the JAX PallasServingEngine (its
kernel in interpret mode), at n = 2 and n = 4, at equal capacity per
shard and batch: responses, counters and the whole global table (shard
d's block at rows [d·cap, (d+1)·cap)) after every call, tolerance 0
(integers).  Covered: the object lane, the columnar lane (what the wire
lane's parse path calls at n > 1), the pipelined launch / sync split,
waves past the largest bucket on one shard, grow with its dropped
count, the row ops, occupancy, the snapshot, restore across shard
counts (n = 4 into n = 1 and back), and the default mesh.
"""
import numpy as np
import pytest
import torch

from gubernator_tpu.parallel import make_mesh as jax_mesh
from gubernator_tpu.parallel.pallas_engine import PallasServingEngine
from gubernator_tpu.parallel.sharded import ShardedEngine as JaxClassic
from gubernator_tpu.types import RateLimitRequest as JaxReq
from gubernator_tpu_torch.core.batch import pack_requests
from gubernator_tpu_torch.engine import BucketEngine
from gubernator_tpu_torch.hashing import hash_request_keys, shard_of
from gubernator_tpu_torch.mesh import Mesh, make_mesh
from gubernator_tpu_torch.sharded import ShardedEngine
from gubernator_tpu_torch.state import soa_to_numpy, table_to_numpy
from gubernator_tpu_torch.types import RateLimitRequest as TorchReq

NOW = 1_765_000_000_000
CAP = 1 << 9  # rows per shard
B = 64


def cpu_mesh(n):
    return make_mesh(["cpu"] * n)


def classic(n, cap=CAP, grow_to=0):
    je = JaxClassic(jax_mesh(n=n), capacity_per_shard=cap,
                    batch_per_shard=B, auto_grow_limit=grow_to)
    te = ShardedEngine(capacity=cap, batch_rows=B, auto_grow_limit=grow_to,
                       mesh=cpu_mesh(n))
    assert te.wave_buckets == je.wave_buckets
    return je, te


def bucket(n, cap=CAP):
    je = PallasServingEngine(jax_mesh(n=n), capacity_per_shard=cap,
                             batch_per_shard=B)
    te = BucketEngine(capacity=cap, batch_rows=B, mesh=cpu_mesh(n))
    return je, te


def tables_equal(je, te):
    assert je.cap_local == te.cap_local
    if isinstance(te, BucketEngine):
        got = np.concatenate([table_to_numpy(r) for r in te.shard_rows])
        assert (np.asarray(je.state) == got).all()
        return
    parts = [soa_to_numpy(st) for st in te.states]
    for f in parts[0]:
        want = np.asarray(getattr(je.state, f))
        col = np.concatenate([p[f] for p in parts])
        assert want.shape == col.shape, f
        assert (want == col).all(), (f, np.nonzero(want != col)[0][:8])


def spec(k, **kw):
    d = dict(hits=1, limit=10, duration=60_000)
    d.update(kw)
    return (k, d)


def both(je, te, specs, now, name="ms"):
    rj = je.check_batch([JaxReq(name=name, unique_key=k, **kw)
                         for k, kw in specs], now)
    rt = te.check_batch([TorchReq(name=name, unique_key=k, **kw)
                         for k, kw in specs], now)
    for i, (a, b) in enumerate(zip(rj, rt)):
        assert (int(a.status), a.limit, a.remaining, a.reset_time,
                a.error) == (int(b.status), b.limit, b.remaining,
                             b.reset_time, b.error), i
    assert (je.over_count, je.insert_count, je.sweep_count) == \
        (te.over_count, te.insert_count, te.sweep_count)
    tables_equal(je, te)
    return rt


def mixed(rng, rows=300, keys=200, flags=True):
    out = []
    for _ in range(rows):
        kid = int(rng.zipf(1.3)) % keys
        beh = int(rng.choice([0, 0, 0, 8, 32, 4])) if flags else 0
        dur = int(rng.integers(0, 3)) if beh == 4 else int(
            rng.choice([10_000, 60_000]))
        out.append(spec(f"m{kid}", algorithm=kid % 2,
                        hits=int(rng.integers(0, 4)), limit=20 + kid % 7,
                        burst=20 + kid % 7, behavior=beh, duration=dur))
    return out


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kind", ["classic", "bucket"])
def test_object_lane_equals_jax(kind, n):
    je, te = (classic if kind == "classic" else bucket)(n)
    rng = np.random.default_rng(n)
    for w in range(3):
        both(je, te, mixed(rng), NOW + 700 * w)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kind", ["classic", "bucket"])
def test_columnar_and_pipelined_lanes_equal_jax(kind, n):
    """check_packed (the wire lane's parse path at n > 1) and the
    launch / sync split the pipelined dispatcher calls."""
    je, te = (classic if kind == "classic" else bucket)(n)
    rng = np.random.default_rng(10 + n)
    for w in range(3):
        reqs = [TorchReq(name="col", unique_key=k, **kw)
                for k, kw in mixed(rng, flags=False)]
        kh = hash_request_keys([r.name for r in reqs],
                               [r.unique_key for r in reqs])
        now = NOW + 500 * w
        batch, _ = pack_requests(reqs, now, size=len(reqs), key_hashes=kh)
        want = je.check_packed(batch, kh, now)
        got = (te.check_packed(batch, kh, now) if w != 1
               else te.sync_packed(te.launch_packed(batch, kh, now)))
        for a, b in zip(want, got):
            assert (np.asarray(a) == np.asarray(b)).all()
        tables_equal(je, te)


@pytest.mark.parametrize("n", [2, 4])
def test_waves_past_the_largest_bucket_on_one_shard(n):
    """One shard's rows exceed the largest bucket: the stable sort keeps
    their order across waves, and each wave rides the bucket of its
    densest shard."""
    je, te = classic(n)
    names = [f"w{i}" for i in range(4000)]
    kh = hash_request_keys(["ms"] * len(names), names)
    hot = [k for k, h in zip(names, kh) if shard_of(int(h), n) == 0][:700]
    specs = [spec(k) for k in hot] + [spec(k) for k in names[:40]]
    both(je, te, specs, NOW)
    both(je, te, specs[::-1], NOW + 10)


def test_grow_with_dropped_count_at_n4():
    je, te = classic(4, grow_to=4 * CAP)
    both(je, te, [spec(f"d{i}", algorithm=i % 2, hits=i % 3)
                  for i in range(1500)], NOW)
    assert je.grow(2 * CAP) == te.grow(2 * CAP) == 0
    tables_equal(je, te)
    dj, dt = je.grow(CAP // 4), te.grow(CAP // 4)  # shrink: drops rows
    assert dj == dt > 0
    assert je.dropped_rows == te.dropped_rows == dt
    tables_equal(je, te)
    # auto-grow under live-key pressure, per shard
    je, te = classic(4, grow_to=4 * CAP)
    for w in range(2):
        both(je, te, [spec(f"g{w}_{i}") for i in range(1400)], NOW + w)
    assert te.cap_local > CAP
    je.sweep(NOW + 5)
    te.sweep(NOW + 5)
    assert je.live_rows == te.live_rows
    tables_equal(je, te)


@pytest.mark.parametrize("kind", ["classic", "bucket"])
def test_row_ops_and_occupancy_at_n4(kind):
    je, te = (classic if kind == "classic" else bucket)(4)
    both(je, te, [spec(f"r{i}", algorithm=i % 2, hits=i % 4, limit=30,
                       burst=30) for i in range(200)], NOW)
    assert je.occupancy() == te.occupancy() == 200
    kh = hash_request_keys(["ms"] * 200, [f"r{i}" for i in range(200)])
    probe = np.concatenate([kh[:100], np.array([12345], np.uint64)])
    fj, cj = je.gather_rows(probe)
    ft, ct = te.gather_rows(probe)
    assert (fj == ft).all() and ft[:100].all() and not ft[100]
    for f in cj:
        assert (np.asarray(cj[f]) == ct[f]).all(), f
    if kind == "bucket":
        # one key a call on the JAX side: its bucket remove drops the
        # removal of a key whose bucket a later key of the same call
        # shares (test_bucket_remove_of_keys_sharing_a_bucket)
        assert sum(je.remove_rows(kh[i:i + 1]) for i in range(70)) == 70
        assert te.remove_rows(kh[:70]) == 70
    else:
        assert je.remove_rows(kh[:70]) == te.remove_rows(kh[:70]) == 70
    tables_equal(je, te)
    assert je.occupancy() == te.occupancy() == 130
    new = hash_request_keys(["up"] * 90, [f"u{i}" for i in range(90)])
    keys = np.concatenate([kh[100:150], new])
    cols = {f: np.concatenate([np.asarray(c)[:50]] * 3)[:140]
            for f, c in cj.items()}
    cols["limit"] = cols["limit"] + 7
    assert je.upsert_rows(keys, cols) == te.upsert_rows(keys, cols) == 140
    tables_equal(je, te)
    if kind == "bucket":
        assert je.occupancy_and_saturation() == \
            te.occupancy_and_saturation()
    for k in kh[150:154]:
        assert (te.probe_occupant_keys(int(k))
                == je.probe_occupant_keys(int(k))).all()
    both(je, te, [spec(f"r{i}", limit=30) for i in range(0, 200, 3)],
         NOW + 100)


@pytest.mark.parametrize("kind", ["classic", "bucket"])
def test_snapshot_at_n4_equals_jax_and_restores_across_shard_counts(kind):
    make = classic if kind == "classic" else bucket
    je, te = make(4)
    specs = [spec(f"s{i}", algorithm=i % 2, hits=i % 4, limit=30,
                  burst=30, duration=60_000) for i in range(400)]
    both(je, te, specs, NOW)
    snap_j, snap_t = je.snapshot(), te.snapshot()
    assert snap_j.keys() == snap_t.keys()
    for f in snap_j:
        assert (np.asarray(snap_j[f]) == np.asarray(snap_t[f])).all(), f
    # n = 4 into n = 1 and n = 1 back into n = 4, each side from the
    # other package's snapshot: rows re-route by shard_of at the new n
    for n_to, cap in ((1, 4 * CAP), (4, CAP)):
        je2, te2 = make(n_to, cap)
        assert te2.restore(snap_j) == je2.restore(snap_t) == 400
        tables_equal(je2, te2)
        both(je2, te2, specs, NOW + 100)
        snap_j, snap_t = je2.snapshot(), te2.snapshot()
    # into a table too small: the same rows drop in both
    je3, te3 = make(2, CAP // 4)
    assert te3.restore(snap_j) == je3.restore(snap_t) < 400
    tables_equal(je3, te3)


@pytest.mark.parametrize("kind", ["classic", "bucket"])
def test_sweep_per_shard_at_n4(kind):
    je, te = (classic if kind == "classic" else bucket)(4)
    both(je, te, [spec(f"e{i}", duration=1_000) for i in range(100)]
         + [spec(f"l{i}") for i in range(50)], NOW)
    je.sweep(NOW + 5_000)
    te.sweep(NOW + 5_000)
    assert te.live_rows == je.occupancy() == te.occupancy() == 50
    tables_equal(je, te)


def test_bucket_remove_of_keys_sharing_a_bucket():
    """The port removes every key of a call; the JAX bucket engine's
    remove_rows writes each key's own copy of a shared bucket back, so
    the last one wins and the others' removals are lost while the count
    says they were removed (ROADMAP §C.2)."""
    je, te = bucket(1, cap=64)  # 8 buckets: 40 keys share them
    both(je, te, [spec(f"x{i}") for i in range(40)], NOW)
    kh = hash_request_keys(["ms"] * 40, [f"x{i}" for i in range(40)])
    assert je.remove_rows(kh) == te.remove_rows(kh) == 40
    assert te.occupancy() == 0
    assert je.occupancy() > 0


def test_default_mesh_takes_every_gpu_and_cpu_devices_on_request(
        monkeypatch):
    m = make_mesh(["cpu"] * 3)
    assert m.n == 3 and m.shape == {"shard": 3} and m.rehearsal
    assert make_mesh(["cpu"] * 4, n=2).n == 2
    with pytest.raises(ValueError):
        make_mesh(["cpu"], n=2)
    with pytest.raises(ValueError):
        Mesh([])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Mesh(["cuda:0"])
    # with GPUs, every visible one once
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    got = make_mesh()
    assert [str(d) for d in got.devices] == ["cuda:0", "cuda:1", "cuda:2"]
    assert not got.rehearsal


@pytest.mark.parametrize("engine", ["pallas", "xla"])
def test_instance_lanes_at_n4_equal_jax(engine):
    """V1Instance on a 4-shard mesh against the JAX instance on
    make_mesh(n=4), the same engine kind: the object lane and the wire
    lane (its parse path at n > 1) answer alike."""
    from gubernator_tpu.config import Config as JaxConfig
    from gubernator_tpu.instance import V1Instance as JaxInstance
    from gubernator_tpu.proto import gubernator_pb2 as jpb
    from gubernator_tpu_torch.config import Config
    from gubernator_tpu_torch.instance import V1Instance
    from gubernator_tpu_torch.wire import encode_get_rate_limits

    kw = dict(cache_size=1 << 12, sweep_interval_ms=0, batch_rows=64,
              hot_set_capacity=0, engine=engine)
    te = V1Instance(Config(device="cpu", **kw), mesh=cpu_mesh(4))
    je = JaxInstance(JaxConfig(**kw), mesh=jax_mesh(n=4))
    try:
        assert te.engine.n == 4 and te.engine.cap_local == 1024
        rng = np.random.default_rng(44)
        for w in range(4):
            specs = mixed(rng, rows=120, flags=False)
            now = NOW + 300 * w
            if w % 2:
                data = encode_get_rate_limits(
                    [TorchReq(name="in", unique_key=k, **kw2)
                     for k, kw2 in specs])
                got = [(r.status, r.limit, r.remaining, r.reset_time,
                        r.error) for r in jpb.GetRateLimitsResp.FromString(
                            te.get_rate_limits_wire(data, now_ms=now)
                        ).responses]
                want = [(r.status, r.limit, r.remaining, r.reset_time,
                         r.error) for r in jpb.GetRateLimitsResp.FromString(
                             je.get_rate_limits_wire(data, now_ms=now)
                         ).responses]
            else:
                got = [(int(r.status), r.limit, r.remaining, r.reset_time,
                        r.error) for r in te.get_rate_limits(
                            [TorchReq(name="in", unique_key=k, **kw2)
                             for k, kw2 in specs], now_ms=now)]
                want = [(int(r.status), r.limit, r.remaining, r.reset_time,
                         r.error) for r in je.get_rate_limits(
                             [JaxReq(name="in", unique_key=k, **kw2)
                              for k, kw2 in specs], now_ms=now)]
            assert got == want, w
    finally:
        te.close()
        je.close()
