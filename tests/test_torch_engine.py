"""BucketEngine (the port, on the CPU) against the JAX package's
PallasServingEngine on a one-device mesh (kernel in interpret mode).

Responses of check_batch on mixed streams (out-of-domain rows come back
as table_full in both), the table words after every call, snapshot /
restore across the two packages, sweep, occupancy and the row ops.
"""
import numpy as np
import pytest

from gubernator_tpu.parallel import make_mesh
from gubernator_tpu.parallel.pallas_engine import PallasServingEngine
from gubernator_tpu_torch.engine import BucketEngine
from gubernator_tpu_torch.hashing import hash_request_keys
from gubernator_tpu_torch.state import restore_from_snapshot, table_to_numpy
from gubernator_tpu_torch.types import RateLimitRequest as TorchReq
from gubernator_tpu.types import RateLimitRequest as JaxReq

NOW = 1_765_000_000_000
CAP = 1 << 12


def req(cls, key, **kw):
    d = dict(hits=1, limit=10, duration=10_000)
    d.update(kw)
    return cls(name="pe", unique_key=key, **d)


@pytest.fixture()
def engines():
    je = PallasServingEngine(make_mesh(n=1), capacity_per_shard=CAP,
                             batch_per_shard=64)
    te = BucketEngine(device="cpu", capacity=CAP, batch_rows=64)
    assert te.wave_buckets == je.wave_buckets
    return je, te


def tables_equal(je, te):
    assert (np.asarray(je.state) == table_to_numpy(te.rows)).all()


def both(engines, specs, now):
    """specs: [(key, kwargs)] → the same requests through both engines;
    responses, counters and tables must be equal."""
    je, te = engines
    rj = je.check_batch([req(JaxReq, k, **kw) for k, kw in specs], now)
    rt = te.check_batch([req(TorchReq, k, **kw) for k, kw in specs], now)
    for i, (a, b) in enumerate(zip(rj, rt)):
        assert (int(a.status), a.limit, a.remaining, a.reset_time,
                a.error) == (int(b.status), b.limit, b.remaining,
                             b.reset_time, b.error), i
    assert (je.over_count, je.insert_count) == \
        (te.over_count, te.insert_count)
    tables_equal(je, te)
    return rt


def test_token_flow_and_expiry(engines):
    specs = [(f"k{i % 6}", {"hits": 2}) for i in range(24)]
    for dt in (0, 500, 600, 30_000):
        both(engines, specs, NOW + dt)


def test_leaky_flow(engines):
    specs = [(f"l{i % 4}", dict(algorithm=1, hits=3, limit=100, burst=100,
                                duration=60_000)) for i in range(16)]
    for dt in (0, 2_000, 90_000):
        both(engines, specs, NOW + dt)


@pytest.mark.parametrize("seed", range(3))
def test_mixed_algorithms_flags_and_gregorian(engines, seed):
    rng = np.random.default_rng(seed)
    for w in range(3):
        specs = []
        for i in range(96):
            kid = int(rng.zipf(1.3)) % 40
            beh = int(rng.choice([0, 0, 0, 8, 32, 4]))
            dur = int(rng.integers(0, 3)) if beh == 4 else int(
                rng.choice([10_000, 60_000]))
            specs.append((f"m{kid}", dict(
                algorithm=kid % 2, hits=int(rng.integers(0, 4)),
                limit=20 + kid % 7, burst=20 + kid % 7, behavior=beh,
                duration=dur)))
        both(engines, specs, NOW + 700 * w)


def test_waves_past_the_largest_bucket(engines):
    # 1100 rows > the 512-row big bucket: two waves, duplicates split
    specs = [(f"w{i % 300}", {"hits": 1, "limit": 5}) for i in range(1100)]
    both(engines, specs, NOW)
    both(engines, specs, NOW + 10)


def test_out_of_domain_rows_are_table_full(engines):
    specs = [("ok1", {}), ("big", {"limit": 1 << 31}),
             ("lk", {"algorithm": 1, "duration": 1 << 32, "limit": 5}),
             ("ok2", {"hits": 3})]
    rt = both(engines, specs, NOW)
    assert [r.error for r in rt] == ["", "rate limit table full",
                                     "rate limit table full", ""]


def test_bucket_full_retry_after_sweep(engines):
    je, te = engines
    # 9 keys whose hashes share a bucket: find them by hashing
    nb_mask = CAP // 8 - 1
    names = [f"b{i}" for i in range(20000)]
    kh = hash_request_keys(["pe"] * len(names), names)
    target = int(kh[0]) & nb_mask
    same = [n for n, h in zip(names, kh) if int(h) & nb_mask == target][:10]
    assert len(same) == 10
    short = [(k, {"duration": 1_000}) for k in same[:8]]
    both(engines, short, NOW)
    # the bucket is full of live rows: the 2 new keys err
    rt = both(engines, [(k, {}) for k in same[8:]], NOW + 10)
    assert all(r.error == "rate limit table full" for r in rt)
    # past expiry the sweep-once retry frees the slots
    rt = both(engines, [(k, {}) for k in same[8:]], NOW + 5_000)
    assert not any(r.error for r in rt)
    # one sweep per call that met a full bucket
    assert te.sweep_count == je.sweep_count == 2


def test_sweep_and_occupancy_match(engines):
    je, te = engines
    specs = ([(f"s{i}", {"duration": 1_000}) for i in range(30)]
             + [(f"t{i}", {"duration": 60_000}) for i in range(20)])
    both(engines, specs, NOW)
    assert je.occupancy_and_saturation() == te.occupancy_and_saturation()
    je.sweep(NOW + 5_000)
    te.sweep(NOW + 5_000)
    tables_equal(je, te)
    assert je.live_rows == te.live_rows == 20
    assert je.occupancy_and_saturation() == te.occupancy_and_saturation()


def _seed_rows(engines):
    specs = [(f"r{i}", dict(algorithm=i % 2, hits=i % 4, limit=30,
                            burst=30, duration=60_000)) for i in range(40)]
    both(engines, specs, NOW)
    return hash_request_keys(["pe"] * 40, [f"r{i}" for i in range(40)])


def test_snapshot_restores_across_packages(engines):
    je, te = engines
    _seed_rows(engines)
    snap_j, snap_t = je.snapshot(), te.snapshot()
    assert snap_j.keys() == snap_t.keys()
    for f in snap_j:
        assert (np.asarray(snap_j[f]) == np.asarray(snap_t[f])).all(), f
    # JAX snapshot → fresh port engine, port snapshot → fresh JAX engine
    te2 = BucketEngine(device="cpu", capacity=CAP, batch_rows=64)
    je2 = PallasServingEngine(make_mesh(n=1), capacity_per_shard=CAP,
                              batch_per_shard=64)
    assert restore_from_snapshot(te2, snap_j) == je2.restore(snap_t) == 40
    tables_equal(je2, te2)
    tables_equal(je, te2)
    # and both keep serving identically from the restored state
    both((je2, te2), [(f"r{i}", dict(algorithm=i % 2, limit=30, burst=30,
                                     duration=60_000)) for i in range(40)],
         NOW + 100)


def test_row_ops_match(engines):
    je, te = engines
    kh = _seed_rows(engines)
    probe = np.concatenate([kh[:10], np.array([12345], np.uint64)])
    fj, cj = je.gather_rows(probe)
    ft, ct = te.gather_rows(probe)
    assert (fj == ft).all() and ft[:10].all() and not ft[10]
    for f in cj:
        assert (np.asarray(cj[f]) == np.asarray(ct[f])).all(), f
    assert je.remove_rows(kh[:5]) == te.remove_rows(kh[:5]) == 5
    tables_equal(je, te)
    cols = {f: np.asarray(v)[:8] for f, v in cj.items()}
    cols["limit"] = cols["limit"] + 7
    assert je.upsert_rows(kh[:8], cols) == te.upsert_rows(kh[:8], cols) == 8
    tables_equal(je, te)
    assert je.dropped_rows == te.dropped_rows


def test_launch_sync_split_matches_check_packed(engines):
    from gubernator_tpu_torch.core.batch import pack_requests

    je, te = engines
    reqs = [req(TorchReq, f"p{i % 17}", hits=i % 3) for i in range(200)]
    kh = hash_request_keys([r.name for r in reqs],
                           [r.unique_key for r in reqs])
    batch, _ = pack_requests(reqs, NOW, size=len(reqs), key_hashes=kh)
    got = te.sync_packed(te.launch_packed(batch, kh, NOW))
    ref = BucketEngine(device="cpu", capacity=CAP, batch_rows=64)
    want = ref.check_packed(batch, kh, NOW)
    for a, b in zip(got, want):
        assert (a == b).all()
    assert (table_to_numpy(te.rows) == table_to_numpy(ref.rows)).all()


def test_device_tap_matches_jax(engines):
    """The [4, B] tap each wave hands the sink: key, hits, over-limit,
    served — the same columns as the JAX engine's fused tap."""
    from gubernator_tpu_torch.core.batch import pack_requests

    je, te = engines
    taps_j, taps_t = [], []
    je.tap_sink = lambda t: taps_j.append(np.asarray(t))
    te.tap_sink = lambda t: taps_t.append(t.numpy())
    reqs = [req(TorchReq, f"t{i % 9}", hits=i % 3, limit=2)
            for i in range(40)]
    reqs.append(req(TorchReq, "ood", limit=1 << 31))  # served = 0
    kh = hash_request_keys([r.name for r in reqs],
                           [r.unique_key for r in reqs])
    batch, _ = pack_requests(reqs, NOW, size=len(reqs), key_hashes=kh)
    for a, b in zip(je.check_packed(batch, kh, NOW),
                    te.check_packed(batch, kh, NOW)):
        assert (np.asarray(a) == np.asarray(b)).all()
    assert len(taps_j) == len(taps_t) == 1
    assert taps_t[0].shape == (4, 64) and (taps_j[0] == taps_t[0]).all()
    assert taps_t[0][3].sum() == 40
