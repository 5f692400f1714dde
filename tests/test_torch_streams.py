"""Request streams shared by the decision-step tests (those of
test_pallas_step.py plus seeded property streams), as numpy batches of
the port's RequestBatch.  JAX-free, so the GPU tests (test_torch_cuda.py)
import them on a machine without JAX; the checks here need no JAX
either."""
import numpy as np
import pytest
import torch

from gubernator_tpu_torch.core.batch import RequestBatch, pack_wave_host
from gubernator_tpu_torch.core.table import EFF_BOUND, SLOTS, VALUE_BOUND
from gubernator_tpu_torch.ops import decide as dmod
from gubernator_tpu_torch.types import Behavior, GregorianDuration

NOW = 1_760_000_000_000
CAP = 1 << 12
RESET = int(Behavior.RESET_REMAINING)
DRAIN = int(Behavior.DRAIN_OVER_LIMIT)
GREG = int(Behavior.DURATION_IS_GREGORIAN)


def mk_batch(keys, **over):
    B = len(keys)
    cols = dict(
        key=np.asarray(keys, np.uint64),
        hits=np.ones(B, np.int64), limit=np.full(B, 10, np.int64),
        duration=np.full(B, 10_000, np.int64),
        eff_ms=np.full(B, 10_000, np.int64), greg_end=np.zeros(B, np.int64),
        behavior=np.zeros(B, np.int32), algorithm=np.zeros(B, np.int32),
        burst=np.full(B, 10, np.int64), valid=np.ones(B, bool),
        now=np.zeros(B, np.int64))
    cols.update({k: np.asarray(v) for k, v in over.items()})
    cols["behavior"] = cols["behavior"].astype(np.int32)
    cols["algorithm"] = cols["algorithm"].astype(np.int32)
    return RequestBatch(**cols)


def mk_leaky(keys, **over):
    n = len(keys)
    base = dict(algorithm=np.ones(n, np.int32),
                limit=np.full(n, 10, np.int64),
                burst=np.full(n, 10, np.int64),
                duration=np.full(n, 10_000, np.int64),
                eff_ms=np.full(n, 10_000, np.int64))
    base.update(over)
    return mk_batch(keys, **base)


def keyify(ids):
    k = (np.asarray(ids, np.uint64) + np.uint64(1)) \
        * np.uint64(0x9E3779B97F4A7C15)
    return np.where(k == 0, np.uint64(1), k)


def to_torch(b: RequestBatch) -> RequestBatch:
    a64, a32 = pack_wave_host(b)
    return dmod.batch_from_packed(torch.from_numpy(a64),
                                  torch.from_numpy(a32))


# ---- streams (test_pallas_step.py's shapes) -----------------------------

def s_zipf_duplicates():
    rng = np.random.default_rng(1)
    batches, nows = [], []
    for w in range(6):
        ids = rng.zipf(1.3, size=512) % 200
        batches.append(mk_batch(keyify(ids),
                                hits=rng.integers(0, 4, size=512)))
        nows.append(NOW + w * 700)
    return batches, nows


def s_expiry_and_refresh():
    keys = keyify(np.arange(64))
    b = mk_batch(keys, hits=np.full(64, 3))
    return [b, b, b], [NOW, NOW + 5_000, NOW + 25_000]


def s_limit_and_duration_change():
    keys = keyify(np.arange(40))
    return ([mk_batch(keys, hits=np.full(40, 4)),
             mk_batch(keys, limit=np.full(40, 25)),
             mk_batch(keys, limit=np.full(40, 25),
                      duration=np.full(40, 60_000),
                      eff_ms=np.full(40, 60_000)),
             mk_batch(keys, limit=np.full(40, 3))],
            [NOW, NOW + 100, NOW + 200, NOW + 300])


def s_reset_and_drain():
    rng = np.random.default_rng(2)
    keys = keyify(rng.integers(0, 30, size=256))
    beh = np.zeros(256, np.int32)
    beh[::7] = RESET
    beh[3::11] = DRAIN
    hits = rng.integers(0, 6, size=256)
    return ([mk_batch(keys, hits=hits, behavior=beh) for _ in range(3)],
            [NOW, NOW + 50, NOW + 90])


def s_gregorian_expiry():
    keys = keyify(np.arange(32))
    greg = np.full(32, NOW + 3_600_000, np.int64)
    beh = np.full(32, GREG, np.int32)
    b = mk_batch(keys, behavior=beh, greg_end=greg,
                 eff_ms=np.full(32, 3_600_000))
    b2 = mk_batch(keys, behavior=beh, greg_end=greg + 3_600_000,
                  eff_ms=np.full(32, 3_600_000))
    return [b, b, b2], [NOW, NOW + 1000, NOW + 3_700_000]


def s_mixed_per_request_now():
    rng = np.random.default_rng(3)
    keys = keyify(rng.integers(0, 20, size=256))
    nows = NOW + rng.integers(0, 3_000, size=256).astype(np.int64)
    order = np.lexsort((nows, keys))  # per-key arrival order
    b = mk_batch(keys[order], now=nows[order])
    return [b], [NOW + 5_000]


def s_invalid_rows():
    keys = keyify(np.arange(64))
    valid = np.ones(64, bool)
    valid[10:20] = False
    return [mk_batch(keys, valid=valid)], [NOW]


def s_invalid_first_occupant():
    keys = keyify(np.arange(1, 9))
    key_col = np.concatenate([[keys[5]], keys[:8]])
    valid = np.ones(9, bool)
    valid[0] = False
    return ([mk_batch(key_col, valid=valid, hits=np.full(9, 4)),
             mk_batch(key_col, valid=valid, hits=np.zeros(9, np.int64))],
            [NOW, NOW + 1])


def s_bucket_full():
    keys = np.array([(j << 40) | 5 for j in range(1, SLOTS + 4)], np.uint64)
    b = mk_batch(keys)
    return [b, b], [NOW, NOW + 1]


def s_sustained():
    rng = np.random.default_rng(7)
    batches, nows, t = [], [], NOW
    for w in range(10):
        n = 384
        ids = rng.zipf(1.2, size=n) % 100
        beh = np.where(rng.random(n) < 0.05, RESET, 0)
        beh = np.where(rng.random(n) < 0.05, beh | DRAIN, beh)
        batches.append(mk_batch(keyify(ids), hits=rng.integers(0, 5, size=n),
                                limit=np.full(n, 10 + (w % 3) * 5),
                                behavior=beh))
        t += int(rng.integers(0, 6_000))
        nows.append(t)
    return batches, nows


def s_leaky_drain_and_replenish():
    keys = keyify(np.arange(48))
    return ([mk_leaky(keys, hits=np.full(48, 3)) for _ in range(8)],
            [NOW + w * 700 for w in range(8)])


def s_leaky_burst_above_limit():
    keys = keyify(np.arange(32))
    b = mk_leaky(keys, burst=np.full(32, 25), hits=np.full(32, 4))
    return [b, b, b], [NOW, NOW + 100, NOW + 5_000]


def s_leaky_burst_below_limit():
    keys = keyify(np.arange(32))
    b = mk_leaky(keys, burst=np.full(32, 3), hits=np.full(32, 2))
    return [b, b], [NOW, NOW + 30_000]


def s_leaky_queries_and_flags():
    rng = np.random.default_rng(5)
    keys = keyify(rng.integers(0, 24, size=192))
    beh = np.zeros(192, np.int32)
    beh[::5] = RESET
    beh[2::7] = DRAIN
    hits = rng.integers(0, 5, size=192)
    return ([mk_leaky(keys, hits=hits, behavior=beh) for _ in range(4)],
            [NOW, NOW + 400, NOW + 900, NOW + 12_000])


def s_leaky_eff_change():
    keys = keyify(np.arange(40))
    return ([mk_leaky(keys, hits=np.full(40, 4)),
             mk_leaky(keys, duration=np.full(40, 60_000),
                      eff_ms=np.full(40, 60_000)),
             mk_leaky(keys, duration=np.full(40, 7_000),
                      eff_ms=np.full(40, 7_000), hits=np.full(40, 2))],
            [NOW, NOW + 333, NOW + 666])


def s_leaky_limit_change_and_alg_switch():
    keys = keyify(np.arange(24))
    lk = mk_leaky(keys, hits=np.full(24, 5))
    lk2 = mk_leaky(keys, limit=np.full(24, 30), burst=np.full(24, 30))
    tok = mk_batch(keys, hits=np.full(24, 2))
    return [lk, lk2, tok, lk], [NOW, NOW + 50, NOW + 100, NOW + 150]


def s_mixed_token_and_leaky():
    rng = np.random.default_rng(9)
    n = 256
    ids = rng.integers(0, 40, size=n)
    b = mk_batch(keyify(ids), algorithm=ids % 2,
                 hits=rng.integers(0, 4, size=n))
    return [b, b], [NOW, NOW + 800]


def s_leaky_gregorian():
    eff = 3_600_000
    keys = keyify(np.arange(16))
    b = mk_leaky(keys, behavior=np.full(16, GREG),
                 duration=np.full(16, int(GregorianDuration.HOURS)),
                 eff_ms=np.full(16, eff),
                 greg_end=np.full(16, NOW + 3_600_000),
                 hits=np.full(16, 2))
    return [b, b], [NOW, NOW + 60_000]


def s_td_bounds_stress():
    big_v, big_e = VALUE_BOUND - 1, EFF_BOUND - 1
    keys = keyify(np.arange(12))
    b = mk_leaky(keys, limit=np.full(12, big_v), burst=np.full(12, big_v),
                 duration=np.full(12, big_e), eff_ms=np.full(12, big_e),
                 hits=np.full(12, big_v // 2))
    return [b, b, b], [NOW, NOW + 1_000_000, NOW + big_e + 5]


def s_td_odd_remainders():
    keys = keyify(np.arange(12))
    b = mk_leaky(keys, limit=np.full(12, 999_983),
                 burst=np.full(12, 1_000_003),
                 duration=np.full(12, 2_147_483_629),
                 eff_ms=np.full(12, 2_147_483_629), hits=np.full(12, 7))
    return [b, b], [NOW, NOW + 777_777]


def s_leaky_bucket_full():
    keys = np.array([(j << 40) | 9 for j in range(1, SLOTS + 3)], np.uint64)
    return [mk_leaky(keys)], [NOW]


def s_sustained_mixed():
    rng = np.random.default_rng(11)
    batches, nows, t = [], [], NOW
    for w in range(10):
        n = 256
        ids = rng.zipf(1.2, size=n) % 60
        beh = np.where(rng.random(n) < 0.06, RESET, 0)
        beh = np.where(rng.random(n) < 0.06, beh | DRAIN, beh)
        dur = np.where(ids % 5 == 0, 25_000, 10_000)
        lim = np.full(n, 10 + (w % 4) * 7)
        batches.append(mk_batch(
            keyify(ids), algorithm=ids % 2,
            hits=rng.integers(0, 5, size=n), limit=lim, burst=lim,
            duration=dur, eff_ms=dur, behavior=beh))
        t += int(rng.integers(0, 9_000))
        nows.append(t)
    return batches, nows


# ---- streams aimed at K1's hot path (segments > HOT_SEGMENT) ----------

HOT = dmod.HOT_SEGMENT


def in_bucket(bucket: int, ids) -> np.ndarray:
    """Distinct keys that all land in ``bucket`` of a CAP-row table."""
    return np.array([(int(j) << 40) | bucket for j in ids], np.uint64)


def s_hot_token_run_exhausts():
    """One key, a uniform TOKEN run well past HOT_SEGMENT that exhausts
    its limit mid-run, per-request now."""
    n = 3 * HOT
    keys = np.repeat(keyify([7]), n)
    now = NOW + 10 * np.arange(n)
    return ([mk_batch(keys, limit=np.full(n, 2 * HOT), now=now),
             mk_batch(keys, limit=np.full(n, 2 * HOT), now=now + 5_000)],
            [NOW + 1_000, NOW + 6_000])


def s_hot_token_run_crosses_x():
    """A uniform TOKEN run whose per-request now crosses the window end
    x part-way, twice."""
    n = 3 * HOT
    keys = np.repeat(keyify([11]), n)
    now = NOW + (2_500 * np.arange(n)) // n
    return ([mk_batch(keys, limit=np.full(n, 20), duration=np.full(n, 1_000),
                      eff_ms=np.full(n, 1_000), now=now)], [NOW + 3_000])


def s_hot_runs_broken():
    """A hot key's runs broken mid-way by RESET, DRAIN (over the limit), a
    limit change and a duration change."""
    n = 4 * HOT
    keys = np.repeat(keyify([13]), n)
    beh = np.zeros(n, np.int32)
    beh[HOT // 2] = RESET
    beh[HOT + 3:HOT + 6] = DRAIN
    hits = np.ones(n, np.int64)
    hits[HOT + 3:HOT + 6] = 50  # over the limit: DRAIN empties it
    limit = np.where(np.arange(n) < 2 * HOT, 40, 45)
    dur = np.where(np.arange(n) < 3 * HOT, 10_000, 20_000)
    b = mk_batch(keys, hits=hits, limit=limit, burst=limit, behavior=beh,
                 duration=dur, eff_ms=dur)
    return [b, b], [NOW, NOW + 400]


def s_hot_queries_only():
    """Runs of queries only, TOKEN and LEAKY, after a batch that spent
    some of each key."""
    n = 2 * HOT + 5
    tok, lk = np.repeat(keyify([17]), n), np.repeat(keyify([19]), n)
    spend = [mk_batch(keyify([17, 17]), hits=np.full(2, 3)),
             mk_leaky(keyify([19, 19]), hits=np.full(2, 3))]
    return (spend + [mk_batch(tok, hits=np.zeros(n, np.int64)),
                     mk_leaky(lk, hits=np.zeros(n, np.int64))],
            [NOW, NOW, NOW + 100, NOW + 100])


def s_hot_leaky_uniform_now():
    """A LEAKY run longer than HOT_SEGMENT at one now: it drains td by
    hits x eff a request, then denies."""
    n = 3 * HOT
    keys = np.repeat(keyify([23]), n)
    b = mk_leaky(keys, hits=np.full(n, 2), limit=np.full(n, 50),
                 burst=np.full(n, 60))
    return [b, b], [NOW, NOW + 700]


def s_hot_leaky_mixed_now():
    """A LEAKY run longer than HOT_SEGMENT whose now steps every few
    requests (replenishing in between), with queries among them."""
    n = 4 * HOT
    keys = np.repeat(keyify([29]), n)
    now = NOW + 40 * (np.arange(n) // 3)
    hits = np.where(np.arange(n) % 9 == 8, 0, 1)
    return ([mk_leaky(keys, hits=hits, limit=np.full(n, 30),
                      burst=np.full(n, 12), duration=np.full(n, 1_000),
                      eff_ms=np.full(n, 1_000), now=now)], [NOW + 10_000])


def s_hot_shared_bucket():
    """A hot key sharing its bucket with other keys, and more new keys
    than empty slots interleaved with it in batch order: the first new
    keys are inserted, the rest err on every request."""
    rng = np.random.default_rng(31)
    bucket = 77
    old = in_bucket(bucket, [1, 2, 3])
    new = in_bucket(bucket, range(4, 15))  # 11 new keys, 5 empty slots
    first = mk_batch(old, hits=np.full(3, 2))
    hot = np.repeat(old[:1], 3 * HOT)
    rest = np.concatenate([np.repeat(new, 3), old[1:]])
    keys = np.concatenate([hot, rest])
    keys = keys[rng.permutation(len(keys))]
    n = len(keys)
    return ([first, mk_batch(keys, hits=rng.integers(0, 3, n)),
             mk_batch(keys, hits=np.ones(n, np.int64))],
            [NOW, NOW + 10, NOW + 20])


def s_hot_segment_edges():
    """Segments of exactly HOT_SEGMENT - 1, HOT_SEGMENT and
    HOT_SEGMENT + 1 requests (one key each, and two keys sharing one
    bucket), TOKEN and LEAKY, with queries and over-limit rows."""
    rng = np.random.default_rng(37)
    parts, algs = [], []
    for b, n in ((101, HOT - 1), (102, HOT), (103, HOT + 1)):
        parts.append(np.repeat(in_bucket(b, [1]), n))
        algs.append(np.full(n, b % 2))
    two = in_bucket(104, [1, 2])
    parts.append(two[rng.integers(0, 2, HOT + 1)])
    algs.append(np.zeros(HOT + 1))
    keys, alg = np.concatenate(parts), np.concatenate(algs)
    perm = rng.permutation(len(keys))
    keys, alg = keys[perm], alg[perm]
    n = len(keys)
    b = mk_batch(keys, algorithm=alg, hits=rng.integers(0, 3, n),
                 limit=np.full(n, 20), burst=np.full(n, 20))
    return [b, b], [NOW, NOW + 300]


STREAMS = {f.__name__[2:]: f for f in (
    s_zipf_duplicates, s_expiry_and_refresh, s_limit_and_duration_change,
    s_reset_and_drain, s_gregorian_expiry, s_mixed_per_request_now,
    s_invalid_rows, s_invalid_first_occupant, s_bucket_full, s_sustained,
    s_leaky_drain_and_replenish, s_leaky_burst_above_limit,
    s_leaky_burst_below_limit, s_leaky_queries_and_flags,
    s_leaky_eff_change, s_leaky_limit_change_and_alg_switch,
    s_mixed_token_and_leaky, s_leaky_gregorian, s_td_bounds_stress,
    s_td_odd_remainders, s_leaky_bucket_full, s_sustained_mixed,
    s_hot_token_run_exhausts, s_hot_token_run_crosses_x, s_hot_runs_broken,
    s_hot_queries_only, s_hot_leaky_uniform_now, s_hot_leaky_mixed_now,
    s_hot_shared_bucket, s_hot_segment_edges)}


def property_stream(seed: int):
    """Seeded twin of test_pallas_step's hypothesis fuzz: up to 4
    batches of up to 32 rows over 12 keys (forced duplicates), every
    flag combination, both algorithms, padded with invalid rows."""
    rng = np.random.default_rng(seed)
    B = 32
    beh_choices = np.array([0, RESET, DRAIN, RESET | DRAIN], np.int32)
    batches, nows, now = [], [], NOW
    for _ in range(int(rng.integers(1, 5))):
        n = int(rng.integers(1, B + 1))
        pad = B - n
        dur = rng.integers(1, 50_001, n)
        batches.append(mk_batch(
            np.pad(keyify(rng.integers(0, 12, n)), (0, pad),
                   constant_values=1),
            hits=np.pad(rng.integers(0, 7, n), (0, pad)),
            limit=np.pad(rng.integers(0, 31, n), (0, pad)),
            duration=np.pad(dur, (0, pad), constant_values=1),
            eff_ms=np.pad(dur, (0, pad), constant_values=1),
            behavior=np.pad(beh_choices[rng.integers(0, 4, n)], (0, pad)),
            algorithm=np.pad(rng.integers(0, 2, n), (0, pad)),
            burst=np.pad(rng.integers(1, 36, n), (0, pad),
                         constant_values=1),
            valid=np.arange(B) < n))
        now += int(rng.integers(0, 40_001))
        nows.append(now)
    return batches, nows


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_stream_is_in_the_kernel_domain(name):
    batches, nows = STREAMS[name]()
    assert len(batches) == len(nows)
    assert all(dmod.qualifies(b) for b in batches)


@pytest.mark.parametrize("seed", range(4))
def test_plain_step_is_deterministic(seed):
    """Two runs of the plain step over one stream leave equal tables."""
    batches, nows = property_stream(seed)
    tables = []
    for _ in range(2):
        rows = torch.zeros((CAP, 32), dtype=torch.int32)
        for b, now in zip(batches, nows):
            dmod.decide_plain(rows, to_torch(b), now)
        tables.append(rows)
    assert torch.equal(*tables)


HOT_STREAMS = sorted(n for n in STREAMS if n.startswith("hot_"))


@pytest.mark.parametrize("name", HOT_STREAMS)
def test_hot_stream_reaches_k1_hot_path(name):
    """Every hot_* stream has a segment longer than HOT_SEGMENT (K1 gives
    it a block); segment_edges has segments of exactly HOT_SEGMENT - 1,
    HOT_SEGMENT and HOT_SEGMENT + 1."""
    batches, nows = STREAMS[name]()
    lens = set()
    for b, now in zip(batches, nows):
        plan = dmod._plan(torch.zeros((CAP, 32), dtype=torch.int32),
                          to_torch(b), now)
        lens |= set(plan.seg_len.tolist())
    assert max(lens) > HOT
    if name == "hot_segment_edges":
        assert {HOT - 1, HOT, HOT + 1} <= lens


def test_k1_constants_match_the_source():
    """ops/decide.py's K1_TILE and K1_STATS are csrc/decide.cu's TILE and
    ST_* counters."""
    import re
    from pathlib import Path

    src = (Path(dmod.__file__).parents[1] / "csrc" / "decide.cu").read_text()
    assert int(re.search(r"constexpr int TILE = (\d+);", src).group(1)) \
        == dmod.K1_TILE
    names = re.search(r"enum \{ (ST_[^}]*)N_STATS", src).group(1)
    assert tuple(n.strip().lower()[3:] for n in names.split(",")
                 if n.strip()) == dmod.K1_STATS
