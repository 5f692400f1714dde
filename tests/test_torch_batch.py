"""The port's host packers and key hashes against the JAX package's on
the same request lists (Gregorian rows and invalid ordinals included):
bucket placement and every packed column depend on them bit for bit."""
import numpy as np
import pytest

from gubernator_tpu import hashing as jax_hashing
from gubernator_tpu.core import batch as jax_batch
from gubernator_tpu.parallel import sharded as jax_sharded
from gubernator_tpu.types import RateLimitRequest as JaxReq
from gubernator_tpu_torch import hashing
from gubernator_tpu_torch.core import batch
from gubernator_tpu_torch.types import RateLimitRequest as TorchReq

NOW = 1_760_000_000_000


def random_requests(seed: int, n: int = 300):
    """Seeded request specs over every field the packers clamp."""
    rng = np.random.default_rng(seed)
    specs = []
    for i in range(n):
        beh = int(rng.choice([0, 1, 2, 4, 8, 32, 8 | 32, 4 | 8]))
        greg = beh & 4
        specs.append(dict(
            name=f"svc{int(rng.integers(0, 5))}",
            unique_key=f"user-{int(rng.integers(0, 10_000))}-é",
            hits=int(rng.choice([-3, 0, 1, 7, 2 ** 55])),
            limit=int(rng.choice([-1, 0, 10, 10 ** 9, 2 ** 60])),
            duration=(int(rng.integers(0, 8)) if greg else
                      int(rng.choice([0, 1, 60_000, 2 ** 40, 2 ** 62]))),
            algorithm=int(rng.choice([0, 1, 2])),
            behavior=beh,
            burst=int(rng.choice([0, 5, 2 ** 58])),
            created_at=int(rng.choice([0, 0, NOW - 5]))))
    return specs


@pytest.mark.parametrize("seed", range(3))
def test_pack_requests_matches_jax(seed):
    specs = random_requests(seed)
    tb, terr = batch.pack_requests([TorchReq(**s) for s in specs], NOW)
    jb, jerr = jax_batch.pack_requests([JaxReq(**s) for s in specs], NOW)
    assert terr == jerr
    assert any(terr)  # invalid Gregorian ordinals are in the stream
    for f, a, b in zip(jb._fields, jb, tb):
        assert np.asarray(a).dtype == np.asarray(b).dtype, f
        assert (np.asarray(a) == np.asarray(b)).all(), f


@pytest.mark.parametrize("seed", range(3))
def test_pack_columns_matches_jax(seed):
    specs = random_requests(seed)
    kh = hashing.hash_request_keys([s["name"] for s in specs],
                                   [s["unique_key"] for s in specs])
    cols = [np.array([s[k] for s in specs], dtype)
            for k, dtype in (("hits", np.int64), ("limit", np.int64),
                             ("duration", np.int64),
                             ("algorithm", np.int32),
                             ("behavior", np.int32), ("burst", np.int64))]
    created = np.array([s["created_at"] for s in specs], np.int64)
    tb, terr = batch.pack_columns(kh, *cols, NOW, created_at=created)
    jb, jerr = jax_batch.pack_columns(kh, *cols, NOW, created_at=created)
    assert terr == jerr and terr
    for f, a, b in zip(jb._fields, jb, tb):
        assert (np.asarray(a) == np.asarray(b)).all(), f
    for a, b in zip(jax_sharded.pack_wave_host(jb),
                    batch.pack_wave_host(tb)):
        assert a.dtype == b.dtype and (a == b).all()


def test_key_hashes_match_jax():
    specs = random_requests(7, n=500)
    names = [s["name"] for s in specs] + ["", "a"]
    keys = [s["unique_key"] for s in specs] + ["", "_"]
    a = hashing.hash_request_keys(names, keys)
    b = jax_hashing.hash_request_keys(names, keys)
    assert a.dtype == b.dtype == np.uint64 and (a == b).all()
    joined = [n + "_" + k for n, k in zip(names, keys)]
    assert (hashing.hash_keys(joined) == jax_hashing.hash_keys(joined)).all()
    assert hashing.hash_key("api", "u1") == jax_hashing.hash_key("api", "u1")
    for n in (1, 2, 7):
        assert (hashing.shard_of(a, n) == jax_hashing.shard_of(b, n)).all()
    assert hashing.fnv1a64(b"x") == jax_hashing.fnv1a64(b"x")


def test_clamp_config_matches_jax():
    for args in [(0, 10, 1000, 0), (1, 2 ** 60, 10, 0), (1, 5, 2, 9, 4),
                 (2, -4, 2 ** 62, 3), (1, 7, 2 ** 40, 2 ** 50)]:
        assert batch.clamp_config(*args) == jax_batch.clamp_config(*args)


def test_responses_from_columns_matches_jax():
    rng = np.random.default_rng(3)
    n = 50
    cols = (rng.integers(0, 2, n).astype(np.int32),
            rng.integers(0, 100, n), rng.integers(0, 100, n),
            NOW + rng.integers(0, 10 ** 6, n), rng.random(n) < 0.2)
    errs = ["" if i % 7 else "bad ordinal" for i in range(n)]
    a = batch.responses_from_columns(cols, errs)
    b = jax_sharded.responses_from_columns(cols, errs)
    assert [(int(r.status), r.limit, r.remaining, r.reset_time, r.error)
            for r in a] == [(int(r.status), r.limit, r.remaining,
                             r.reset_time, r.error) for r in b]


def test_empty_batch_and_bucket_size_match_jax():
    for f, a, b in zip(jax_batch.RequestBatch._fields,
                       jax_batch.empty_batch(70), batch.empty_batch(70)):
        assert (np.asarray(a) == np.asarray(b)).all(), f
    for n in (1, 64, 65, 4096, 5000):
        assert batch.bucket_size(n) == jax_batch.bucket_size(n)
