"""The port's classic engine (gubernator_tpu_torch/sharded.py ›
ShardedEngine, on the CPU) against the JAX package's ShardedEngine on a
one-device mesh, at equal capacity and batch.

Responses, counters and the nine table columns must be equal after every
call (tolerance 0: integers): wave splitting past the largest bucket,
the sweep-then-retry, auto-grow under live-key pressure, the proactive
grow on a sweep, grow and shrink with their dropped counts, the row ops,
occupancy, and snapshot / restore in both directions.
"""
import numpy as np
import pytest

from gubernator_tpu.parallel import make_mesh
from gubernator_tpu.parallel.sharded import ShardedEngine as JaxEngine
from gubernator_tpu.types import RateLimitRequest as JaxReq
from gubernator_tpu_torch.hashing import hash_request_keys
from gubernator_tpu_torch.sharded import (ShardedEngine,
                                          autogrow_limit_per_shard)
from gubernator_tpu_torch.state import restore_from_snapshot, soa_to_numpy
from gubernator_tpu_torch.types import RateLimitRequest as TorchReq

NOW = 1_765_000_000_000
CAP = 1 << 10
B = 64


def engines(cap=CAP, grow_to=0):
    je = JaxEngine(make_mesh(n=1), capacity_per_shard=cap,
                   batch_per_shard=B, auto_grow_limit=grow_to)
    te = ShardedEngine(device="cpu", capacity=cap, batch_rows=B,
                       auto_grow_limit=grow_to)
    assert te.wave_buckets == je.wave_buckets
    return je, te


def tables_equal(je, te):
    assert je.cap_local == te.cap_local
    got = soa_to_numpy(te.state)
    for f, col in got.items():
        want = np.asarray(getattr(je.state, f))
        assert want.shape == col.shape, f
        assert (want == col).all(), (f, np.nonzero(want != col)[0][:8])


def both(je, te, specs, now, name="sh"):
    """specs: [(key, kwargs)] → the same requests through both engines;
    responses, counters and tables must be equal."""
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


def spec(k, **kw):
    d = dict(hits=1, limit=10, duration=60_000)
    d.update(kw)
    return (k, d)


def test_mixed_traffic_and_waves_past_the_largest_bucket():
    je, te = engines()
    rng = np.random.default_rng(0)
    for w in range(3):
        specs = []
        for _ in range(600):  # > the 512-row big bucket: two waves
            kid = int(rng.zipf(1.3)) % 300
            beh = int(rng.choice([0, 0, 0, 8, 32, 4]))
            dur = int(rng.integers(0, 3)) if beh == 4 else int(
                rng.choice([10_000, 60_000]))
            specs.append(spec(f"m{kid}", algorithm=kid % 2,
                              hits=int(rng.integers(0, 4)),
                              limit=20 + kid % 7, burst=20 + kid % 7,
                              behavior=beh, duration=dur))
        both(je, te, specs, NOW + 700 * w)


def test_full_value_domain_is_served():
    """Limits far above the bucket engine's 2^30 are served exactly."""
    je, te = engines()
    specs = [spec("big", limit=2 ** 40), spec("huge", limit=2 ** 53,
                                              hits=2 ** 52),
             spec("lk", algorithm=1, limit=2 ** 35, burst=2 ** 35,
                  duration=1 << 32)]
    rt = both(je, te, specs, NOW)
    assert not any(r.error for r in rt)
    assert rt[0].remaining == 2 ** 40 - 1


def test_sweep_then_retry_frees_expired_windows():
    je, te = engines()
    # more keys than rows, all short-lived: windows fill, some rows err
    both(je, te, [spec(f"s{i}", duration=1_000) for i in range(1200)], NOW)
    assert te.occupancy() == je.occupancy() > 0.9 * CAP
    sweeps = te.sweep_count
    rt = both(je, te, [spec(f"n{i}") for i in range(300)], NOW + 5_000)
    assert not any(r.error for r in rt)
    assert te.sweep_count == sweeps + 1  # one sweep, then the retry


def test_auto_grow_under_live_key_pressure():
    je, te = engines(grow_to=4 * CAP)
    for w in range(3):
        both(je, te, [spec(f"g{w}_{i}") for i in range(700)],
             NOW + 10 * w)
    assert te.cap_local > CAP
    assert te.dropped_rows == je.dropped_rows
    assert te.occupancy() == je.occupancy() > 2000


def test_live_key_pressure_without_grow_is_table_full():
    je, te = engines()
    rt = both(je, te, [spec(f"f{i}") for i in range(1100)], NOW)
    assert sum(r.error == "rate limit table full" for r in rt) > 0


def test_proactive_grow_on_a_sweep():
    je, te = engines(grow_to=4 * CAP)
    both(je, te, [spec(f"p{i}") for i in range(650)], NOW)  # > 60%
    je.sweep(NOW + 1)
    te.sweep(NOW + 1)
    assert je.live_rows == te.live_rows > 0.6 * CAP
    assert te.cap_local == 2 * CAP
    assert te.dropped_rows == je.dropped_rows
    tables_equal(je, te)


def test_grow_and_shrink_with_dropped_counts():
    je, te = engines()
    both(je, te, [spec(f"d{i}", algorithm=i % 2, hits=i % 3)
                  for i in range(900)], NOW)
    assert je.grow(4 * CAP) == te.grow(4 * CAP) == 0
    tables_equal(je, te)
    dj, dt = je.grow(CAP // 2), te.grow(CAP // 2)  # shrink: drops rows
    assert dj == dt > 0
    assert je.dropped_rows == te.dropped_rows == dt
    tables_equal(je, te)
    both(je, te, [spec(f"d{i}") for i in range(0, 900, 7)], NOW + 50)
    with pytest.raises(ValueError):
        te.grow(3000)


def test_row_ops_and_occupancy():
    je, te = engines()
    both(je, te, [spec(f"r{i}", algorithm=i % 2, hits=i % 4, limit=30,
                       burst=30) for i in range(200)], NOW)
    assert je.occupancy() == te.occupancy() == 200
    kh = hash_request_keys(["sh"] * 200, [f"r{i}" for i in range(200)])
    probe = np.concatenate([kh[:100], np.array([12345, 0], np.uint64)])
    fj, cj = je.gather_rows(probe)
    ft, ct = te.gather_rows(probe)
    assert (fj == ft).all() and ft[:100].all() and not ft[100:].any()
    for f in cj:
        assert np.asarray(cj[f]).dtype == ct[f].dtype, f
        assert (np.asarray(cj[f]) == ct[f]).all(), f
    assert je.remove_rows(kh[:70]) == te.remove_rows(kh[:70]) == 70
    tables_equal(je, te)
    assert je.occupancy() == te.occupancy() == 130
    # upsert: existing keys overwrite, new ones insert (distinct keys)
    new = hash_request_keys(["up"] * 90, [f"u{i}" for i in range(90)])
    keys = np.concatenate([kh[100:150], new])
    cols = {f: np.concatenate([np.asarray(c)[:50]] * 3)[:140]
            for f, c in cj.items()}
    cols["limit"] = cols["limit"] + 7
    assert je.upsert_rows(keys, cols) == te.upsert_rows(keys, cols) == 140
    tables_equal(je, te)
    both(je, te, [spec(f"r{i}", limit=30) for i in range(0, 200, 3)],
         NOW + 100)


def test_snapshot_and_restore_both_ways():
    je, te = engines()
    specs = [spec(f"s{i}", algorithm=i % 2, hits=i % 4, limit=30,
                  burst=30, duration=60_000 if i % 5 else 1_000)
             for i in range(300)]
    both(je, te, specs, NOW)
    snap_j, snap_t = je.snapshot(), te.snapshot()
    assert snap_j.keys() == snap_t.keys()
    for f in snap_j:
        assert (np.asarray(snap_j[f]) == snap_t[f]).all(), f
    # JAX snapshot → a port engine, port snapshot → a JAX engine, into
    # smaller tables, so some probe windows fill and rows drop
    for cap in (CAP, CAP // 4):
        je2, te2 = engines(cap)
        assert restore_from_snapshot(te2, snap_j) == je2.restore(snap_t)
        tables_equal(je2, te2)
    assert te2.occupancy() < 300
    # both keep serving identically from the restored state
    both(je2, te2, specs, NOW + 2_000)


def test_restore_places_duplicates_and_keeps_existing_rows():
    """Restore into a non-empty table; a key repeated in the snapshot
    takes its last values, as the JAX host loop leaves it."""
    je, te = engines()
    both(je, te, [spec(f"e{i}") for i in range(50)], NOW)
    snap = te.snapshot()
    rows = {f: np.concatenate([c[:40], c[10:30]]) for f, c in snap.items()}
    rows["limit"] = rows["limit"] + np.arange(60)
    assert je.restore(rows) == te.restore(rows) == 60
    tables_equal(je, te)


def test_autogrow_limit_per_shard():
    assert autogrow_limit_per_shard(0, 1, 1024) == 0
    assert autogrow_limit_per_shard(5000, 1, 1024) == 4096
    assert autogrow_limit_per_shard(100, 1, 1024) == 1024
