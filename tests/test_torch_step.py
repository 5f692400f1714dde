"""The port's SoA decision step (gubernator_tpu_torch/core/step.py, on the
CPU) against the JAX package's core.decide_batch.

Both start from equal tables (soa_from_jax) and take the same packed
batches; outputs, counters and all nine columns must be equal after
every batch (tolerance 0: every value is an integer).  The streams are
test_step_parity.py's, plus Gregorian rows, mixed per-row ``now`` (both
sort branches), leaky mixed-time segments that pass and that fail the
speculative scan (and reach its -2^62 clamp), values near VALUE_MAX,
keys with the top bit set, probe-window exhaustion and seeded property
streams.  Every batch is padded to one width and every table has one
capacity, so JAX compiles the step once.
"""
import numpy as np
import pytest
import torch

from gubernator_tpu import Algorithm, Behavior, GregorianDuration
from gubernator_tpu import RateLimitRequest as JaxReq
from gubernator_tpu.core import decide_batch as jax_decide
from gubernator_tpu.core import init_table as jax_init
from gubernator_tpu.core import pack_requests as jax_pack
from gubernator_tpu.core.batch import RequestBatch as JaxBatch
from gubernator_tpu_torch.core import step as tstep
from gubernator_tpu_torch.core.batch import pack_wave_host
from gubernator_tpu_torch.ops.decide import batch_from_packed
from gubernator_tpu_torch.state import soa_from_jax, soa_to_numpy
from gubernator_tpu_torch.types import EFF_MAX, TD_BOUND, VALUE_MAX

NOW = 1_760_000_000_000
CAP = 1 << 10
B = 256
L = Algorithm.LEAKY_BUCKET
RESET = Behavior.RESET_REMAINING
DRAIN = Behavior.DRAIN_OVER_LIMIT
GREG = Behavior.DURATION_IS_GREGORIAN


def to_torch(b) -> object:
    a64, a32 = pack_wave_host(b)
    return batch_from_packed(torch.from_numpy(a64), torch.from_numpy(a32))


def assert_tables_equal(js, ts, where):
    tn = soa_to_numpy(ts)
    for f in js._fields:
        a = np.asarray(getattr(js, f))
        assert (a == tn[f]).all(), (where, f, np.nonzero(a != tn[f])[0][:8])


def run_batches(batches):
    """batches: [(numpy RequestBatch, now)] through both steps; returns
    the port's outputs."""
    js = jax_init(CAP)
    ts = soa_from_jax(js, "cpu")
    outs = []
    for i, (b, now) in enumerate(batches):
        js, jo = jax_decide(js, b, now)
        to = tstep.decide_batch(ts, to_torch(b), now)
        for f in jo._fields:
            a, c = np.asarray(getattr(jo, f)), getattr(to, f).numpy()
            assert a.dtype == c.dtype or f in ("over_count", "insert_count")
            assert (a == c).all(), (i, f, np.nonzero(a != c))
        assert_tables_equal(js, ts, i)
        outs.append(to)
    return outs


def run_reqs(stream):
    """stream: [(requests, now)] packed by the JAX packer at width B."""
    return run_batches([(jax_pack(reqs, now, size=B)[0], now)
                        for reqs, now in stream])


def mk(name="t", key="k", **kw):
    d = dict(hits=1, limit=10, duration=60_000,
             algorithm=Algorithm.TOKEN_BUCKET)
    d.update(kw)
    return JaxReq(name=name, unique_key=key, **d)


def raw_batch(keys, **cols):
    """A numpy RequestBatch padded to B with invalid rows."""
    n = len(keys)
    base = dict(key=np.asarray(keys, np.uint64), hits=np.ones(n, np.int64),
                limit=np.full(n, 10, np.int64),
                duration=np.full(n, 60_000, np.int64),
                eff_ms=np.full(n, 60_000, np.int64),
                greg_end=np.zeros(n, np.int64),
                behavior=np.zeros(n, np.int32),
                algorithm=np.zeros(n, np.int32),
                burst=np.full(n, 10, np.int64), valid=np.ones(n, bool),
                now=np.zeros(n, np.int64))
    base.update({k: np.asarray(v) for k, v in cols.items()})
    pad = B - n
    fill = dict(eff_ms=1)
    out = {}
    for f in JaxBatch._fields:
        a = base[f].astype(base[f].dtype if f not in ("behavior",
                                                        "algorithm")
                           else np.int32)
        out[f] = np.concatenate([a, np.full(pad, fill.get(f, 0), a.dtype)])
    return JaxBatch(**out)


def keyify(ids):
    k = (np.asarray(ids, np.uint64) + np.uint64(1)) \
        * np.uint64(0x9E3779B97F4A7C15)
    return np.where(k == 0, np.uint64(1), k)


# ---- test_step_parity.py's streams -------------------------------------

PARITY = {
    "single_key_token": lambda: [([mk()], NOW + i * 100) for i in range(15)],
    "single_key_leaky": lambda: [([mk(algorithm=L)], NOW + i * 700)
                                 for i in range(30)],
    "many_unique_keys": lambda: [
        ([mk(key=f"k{i}", hits=1 + i % 3, limit=5 + i % 7)
          for i in range(100)], NOW + t * 1000) for t in range(5)],
    "expiry_across_batches": lambda: [
        ([mk(hits=10)], NOW), ([mk(hits=1)], NOW + 59_999),
        ([mk(hits=1)], NOW + 60_000), ([mk(hits=1)], NOW + 200_000)],
    "hits_zero_queries": lambda: [
        ([mk(hits=3)], NOW), ([mk(hits=0)], NOW + 1),
        ([mk(hits=100)], NOW + 2), ([mk(hits=0)], NOW + 3)],
    "uniform_duplicates": lambda: [([mk(limit=5) for _ in range(7)], NOW)],
    "uniform_duplicates_multi_hit": lambda: [
        ([mk(hits=3, limit=10) for _ in range(5)], NOW)],
    "mixed_hits": lambda: [
        ([mk(hits=5, limit=10)], NOW),
        ([mk(hits=3), mk(hits=4), mk(hits=2)], NOW + 1)],
    "mixed_flags": lambda: [([
        mk(hits=8), mk(hits=5), mk(hits=1, behavior=RESET),
        mk(hits=4, behavior=DRAIN | Behavior.BATCHING),
        mk(hits=20, behavior=DRAIN), mk(hits=0)], NOW)],
    "config_change_within_batch": lambda: [(
        [mk(hits=1, limit=100), mk(hits=1, limit=50),
         mk(hits=1, limit=200)], NOW)],
    "new_key_duplicates": lambda: [
        ([mk(key="brand-new", limit=3) for _ in range(5)], NOW)],
    "reset_remaining": lambda: [
        ([mk(hits=10)], NOW), ([mk(hits=2, behavior=RESET)], NOW + 1)],
    "drain_over_limit": lambda: [
        ([mk(hits=7)], NOW), ([mk(hits=5, behavior=DRAIN)], NOW + 1)],
    "gregorian_token": lambda: [
        ([mk(hits=2, duration=GregorianDuration.MINUTES, behavior=GREG)],
         NOW + dt) for dt in (0, 30_000, 70_000)],
    "leaky_burst_and_duration_change": lambda: [
        ([mk(algorithm=L, hits=4, burst=20)], NOW),
        ([mk(algorithm=L, hits=0, duration=120_000, burst=20)], NOW + 500),
        ([mk(algorithm=L, hits=3, duration=120_000, burst=20)],
         NOW + 1_000)],
    "algorithm_switch": lambda: [
        ([mk(hits=5)], NOW), ([mk(hits=1, algorithm=L)], NOW + 1),
        ([mk(hits=1)], NOW + 2)],
}


@pytest.mark.parametrize("name", sorted(PARITY))
def test_parity_stream(name):
    run_reqs(PARITY[name]())


def random_stream(seed):
    rng = np.random.default_rng(seed)
    behs = [Behavior.BATCHING, RESET, DRAIN]
    stream, now = [], NOW
    for _ in range(6):
        reqs = [JaxReq(
            name=f"n{rng.integers(0, 3)}", unique_key=f"u{rng.integers(0, 40)}",
            hits=int(rng.integers(0, 6)), limit=int(rng.integers(1, 30)),
            duration=int(rng.choice([1_000, 10_000, 60_000])),
            algorithm=int(rng.integers(0, 2)),
            behavior=behs[int(rng.integers(0, 3))],
            burst=int(rng.choice([0, 0, 15])))
            for _ in range(int(rng.integers(1, 120)))]
        stream.append((reqs, now))
        now += int(rng.integers(0, 20_000))
    return stream


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_random_stream(seed):
    run_reqs(random_stream(seed))


def test_zipf_stream():
    rng = np.random.default_rng(7)
    run_reqs([([mk(key=f"z{k}", limit=50)
                for k in rng.zipf(1.5, size=B) % 500], NOW + 3_000 * t)
              for t in range(5)])


# ---- streams beyond test_step_parity.py --------------------------------

def test_gregorian_rows_both_algorithms():
    stream = []
    for dt in (0, 20_000, 3_700_000):
        reqs = []
        for i in range(40):
            alg = i % 2
            dur = [GregorianDuration.MINUTES, GregorianDuration.HOURS][i % 4
                                                                      // 2]
            reqs.append(mk(key=f"g{i % 13}", algorithm=alg, hits=i % 3,
                           duration=dur, behavior=GREG, limit=20,
                           burst=25 if alg else 0))
        stream.append((reqs, NOW + dt))
    run_reqs(stream)


@pytest.mark.parametrize("uniform_now", [True, False])
def test_mixed_per_row_now_both_sort_branches(uniform_now):
    """created_at gives rows their own now: the (row, now, index) sort;
    with every created_at equal the single-sort branch runs."""
    rng = np.random.default_rng(3)
    stream = []
    for w in range(4):
        base = NOW + 10_000 * w
        reqs = []
        for i in range(200):
            kid = int(rng.integers(0, 25))
            reqs.append(mk(
                key=f"m{kid}", algorithm=kid % 2, hits=int(rng.integers(0, 4)),
                limit=8 + kid % 5, burst=8 + kid % 5, duration=20_000,
                behavior=[0, 0, 0, RESET, DRAIN][int(rng.integers(0, 5))],
                created_at=base if uniform_now
                else base + int(rng.integers(0, 9_000))))
        stream.append((reqs, base))
    run_reqs(stream)


def _leaky_mixed_time(hits, burst, seed, n_keys=12):
    """Uniform-config leaky segments whose arrivals mix instants."""
    rng = np.random.default_rng(seed)
    batches = []
    for w in range(3):
        base = NOW + 40_000 * w
        kid = rng.integers(0, n_keys, B)
        now = base + np.sort(rng.integers(0, 30_000, B))
        batches.append((raw_batch(
            keyify(kid), algorithm=np.ones(B, np.int32),
            hits=np.full(B, hits), limit=np.full(B, 10),
            burst=np.full(B, burst), duration=np.full(B, 10_000),
            eff_ms=np.full(B, 10_000), now=now), base + 30_000))
    return batches


def test_leaky_mixed_time_segments_pass_the_speculation():
    outs = run_batches(_leaky_mixed_time(hits=1, burst=1_000, seed=4))
    assert all(int(o.over_count) == 0 for o in outs)


def test_leaky_mixed_time_segments_fail_the_speculation():
    outs = run_batches(_leaky_mixed_time(hits=4, burst=10, seed=5))
    assert sum(int(o.over_count) for o in outs) > 0


def test_leaky_scan_reaches_its_clamp():
    """hits × eff = 2^61 on every position: three denied positions sum
    below -2^62, where the scan's combine clamps (and is no longer
    associative); the JAX scan's tree is kept, so results still match."""
    eff = EFF_MAX
    big = TD_BOUND // eff
    rng = np.random.default_rng(6)
    batches = []
    for w in range(3):
        kid = rng.integers(0, 6, B)
        hits = np.where(kid % 3 == 0, 1, big)  # some segments allow
        now = NOW + 1_000 * w + np.sort(rng.integers(0, 900, B))
        batches.append((raw_batch(
            keyify(kid), algorithm=np.ones(B, np.int32), hits=hits,
            limit=np.full(B, big), burst=np.full(B, big),
            duration=np.full(B, eff), eff_ms=np.full(B, eff), now=now),
            NOW + 1_000 * w + 900))
    # the exact prefix sums of three deny steps pass the clamp
    assert 3 * -(big * eff - 1_000 * big) < -(1 << 62)
    outs = run_batches(batches)
    assert sum(int(o.over_count) for o in outs) > 0


def test_values_near_value_max():
    v = VALUE_MAX
    stream = [
        ([mk(key="a", limit=v, hits=v - 1), mk(key="b", limit=v - 1,
                                                hits=v // 2),
          mk(key="c", limit=v, hits=v), mk(key="d", limit=v, hits=v + 5),
          mk(key="e", algorithm=L, limit=v, burst=v, hits=v // 3,
             duration=1 << 40),
          mk(key="f", algorithm=L, limit=3, burst=v, hits=2,
             duration=EFF_MAX * 4)], NOW),
        ([mk(key="a", limit=v, hits=1), mk(key="b", limit=v, hits=v // 2),
          mk(key="c", limit=v, hits=0), mk(key="d", limit=1, hits=1),
          mk(key="e", algorithm=L, limit=v, burst=v, hits=v // 3,
             duration=1 << 40),
          mk(key="f", algorithm=L, limit=3, burst=v, hits=2,
             duration=EFF_MAX * 4)] * 3, NOW + 5_000),
    ]
    run_reqs(stream)


def test_keys_with_the_top_bit_set():
    top = np.uint64(1 << 63)
    keys = keyify(np.arange(60)) | top
    keys[::3] = (np.arange(20, dtype=np.uint64) << np.uint64(40)) | top \
        | np.uint64(7)  # shared low bits: same first probe slot
    assert (keys >> np.uint64(63) == 1).all()
    kid = np.random.default_rng(8).integers(0, 60, B)
    run_batches([(raw_batch(keys[kid], hits=np.full(B, 2),
                            limit=np.full(B, 9)), NOW + 100 * w)
                 for w in range(3)])


def test_probe_window_exhaustion_gives_err_rows():
    """More keys than the table holds: late inserts find their window
    full and come back as err rows, with zeroed outputs."""
    outs = run_batches([(raw_batch(keyify(np.arange(B * w, B * (w + 1)))),
                         NOW + w) for w in range(6)])
    assert sum(int(o.err.sum()) for o in outs) > 0
    assert all((o.remaining[o.err] == 0).all() for o in outs)


@pytest.mark.parametrize("seed", range(4))
def test_property_stream(seed):
    """Seeded stream: every flag combination, both algorithms, forced
    duplicates over 12 keys, mixed per-row now, padding rows."""
    rng = np.random.default_rng(100 + seed)
    beh = np.array([0, int(RESET), int(DRAIN), int(RESET | DRAIN)], np.int32)
    batches, now = [], NOW
    for _ in range(int(rng.integers(2, 6))):
        n = int(rng.integers(1, B + 1))
        dur = rng.integers(1, 50_001, n)
        row_now = now + rng.integers(0, 5_000, n) * (rng.random() < 0.5)
        batches.append((raw_batch(
            keyify(rng.integers(0, 12, n)), hits=rng.integers(0, 7, n),
            limit=rng.integers(0, 31, n), duration=dur, eff_ms=dur,
            behavior=beh[rng.integers(0, 4, n)],
            algorithm=rng.integers(0, 2, n), burst=rng.integers(1, 36, n),
            now=row_now), now + 5_000))
        now += int(rng.integers(0, 40_001))
    run_batches(batches)
