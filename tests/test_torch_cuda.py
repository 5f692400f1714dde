"""The kernels on the card against their plain versions: K1 on the
streams of test_torch_streams.py, K2 (the SoA sweep) and K3 (the probe
add), and the SoA step and the classic engine on CUDA against the same
on the CPU.  Marked ``gpu``: skips where no CUDA device is present.  On
a GPU machine (which need not have JAX, hence no conftest):

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from gubernator_tpu_torch.core.table import init_table
from gubernator_tpu_torch.ops import decide as dmod

from test_torch_streams import (DRAIN, NOW, RESET, STREAMS, in_bucket,
                                mk_batch, mk_leaky, property_stream,
                                to_torch)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def run_kernel_and_plain(dev, batches, nows, cap=1 << 12,
                         hot=dmod.HOT_SEGMENT):
    """Every batch through K1 (segments longer than ``hot`` on its hot
    path) and the plain version; returns K1's summed stats counters."""
    rows_k = init_table(cap, dev)
    rows_p = init_table(cap, dev)
    stats = torch.zeros(len(dmod.K1_STATS), dtype=torch.int64, device=dev)
    for b, now in zip(batches, nows):
        tb = to_torch(b)
        tb = type(tb)(*[c.to(dev) for c in tb])
        before = dmod.decide_cuda.launches
        ok = dmod.decide_cuda(rows_k, tb, now, hot=hot, stats=stats)
        op = dmod.decide_plain(rows_p, tb, now)
        torch.cuda.synchronize()
        assert dmod.decide_cuda.launches == before + 1
        for f in ok._fields:
            assert torch.equal(getattr(ok, f), getattr(op, f)), f
        assert torch.equal(rows_k, rows_p)
    return dict(zip(dmod.K1_STATS, stats.tolist()))


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(STREAMS))
def test_k1_equals_plain_on_stream(cuda, name):
    run_kernel_and_plain(cuda, *STREAMS[name]())


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(STREAMS))
def test_k1_hot_path_equals_plain_on_stream(cuda, name):
    """hot=0: every segment, however short, goes through a block."""
    st = run_kernel_and_plain(cuda, *STREAMS[name](), hot=0)
    assert st["cold"] == 0 and st["hot_segments"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(STREAMS))
def test_k1_cold_path_equals_plain_on_stream(cuda, name):
    """hot=2^20: every segment on a thread, no block on the hot
    path."""
    st = run_kernel_and_plain(cuda, *STREAMS[name](), hot=1 << 20)
    assert st["hot_segments"] == 0 and st["cold"] > 0


@pytest.mark.gpu
def test_k1_cold_segments_outlasting_the_hot_one(cuda):
    """499 cold segments of HOT_SEGMENT requests each and one hot
    segment of a uniform run (quick, in closed form): the outputs and
    the table read right after the launch hold the cold threads' work
    too."""
    h = dmod.HOT_SEGMENT
    cold = np.concatenate([np.repeat(in_bucket(b, [1]), h)
                           for b in range(1, 500)])
    keys = np.concatenate([np.repeat(in_bucket(0, [1]), h + 1), cold])
    st = run_kernel_and_plain(cuda, [mk_batch(keys)] * 3,
                              [NOW, NOW + 10, NOW + 20])
    assert st["hot_segments"] == 3 and st["cold"] == 3 * 499 * h


@pytest.mark.gpu
@pytest.mark.parametrize("seed", range(4))
def test_k1_equals_plain_on_property_stream(cuda, seed):
    run_kernel_and_plain(cuda, *property_stream(seed))
    run_kernel_and_plain(cuda, *property_stream(seed), hot=0)


def multi_tile_stream():
    """One bucket whose segment spans more than two shared-memory tiles:
    a hot key with long uniform TOKEN runs (per-request now, exhausting
    its limit, crossing its window end), broken by RESET / DRAIN / limit
    changes, queries among them, beside other keys and new keys that
    overflow the bucket's empty slots in the third tile."""
    rng = np.random.default_rng(41)
    n = 2 * dmod.K1_TILE + 300
    bucket = 55
    keys = np.repeat(in_bucket(bucket, [1]), n)
    late = np.arange(n) > 2 * dmod.K1_TILE
    others = in_bucket(bucket, range(2, 14))  # 12 keys, 7 empty slots
    pick = late & (rng.random(n) < 0.3)
    keys[pick] = others[rng.integers(0, 12, int(pick.sum()))]
    beh = np.zeros(n, np.int32)
    beh[rng.integers(0, n, 6)] = RESET
    beh[rng.integers(0, n, 6)] = DRAIN
    hits = np.where(rng.random(n) < 0.05, 0, 1)
    limit = np.where(np.arange(n) < n // 2, 150, 160)
    now = NOW + (4_000 * np.arange(n)) // n
    b = mk_batch(keys, hits=hits, limit=limit, burst=limit, behavior=beh,
                 duration=np.full(n, 1_500), eff_ms=np.full(n, 1_500),
                 now=now)
    leaky = mk_leaky(np.repeat(in_bucket(bucket + 1, [1]), n),
                     hits=hits, now=np.full(n, NOW + 4_000))
    return [b, leaky, b], [NOW + 4_000, NOW + 4_000, NOW + 9_000]


@pytest.mark.gpu
def test_k1_chain_longer_than_two_tiles(cuda):
    batches, nows = multi_tile_stream()
    st = run_kernel_and_plain(cuda, batches, nows)
    assert st["longest_chain"] > 2 * dmod.K1_TILE
    assert st["closed_form"] > 0 and st["serial"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("hot", [0, dmod.HOT_SEGMENT])
def test_k1_rows_of_an_algorithm_that_writes_nothing(cuda, hot):
    """Out of the serving domain (the engine masks such rows), but K1
    must still equal the plain version: a row of algorithm 2 answers
    zeros, flags an insert without filling the slot, and does not count
    as a key's first writer."""
    rng = np.random.default_rng(43)
    n = 3 * dmod.HOT_SEGMENT
    keys = in_bucket(9, range(1, 12))[rng.integers(0, 11, n)]
    alg = np.where(rng.random(n) < 0.3, 2, rng.integers(0, 2, n))
    b = mk_batch(keys, algorithm=alg, hits=rng.integers(0, 3, n))
    run_kernel_and_plain(cuda, [b, b], [NOW, NOW + 50], hot=hot)


@pytest.mark.gpu
def test_k1_hot_uniform_run_takes_the_closed_form(cuda):
    st = run_kernel_and_plain(
        cuda, *STREAMS["hot_token_run_exhausts"]())
    assert st["hot_segments"] == 2 and st["cold"] == 0
    assert st["serial"] == 2  # one head per batch
    assert st["closed_form"] == 2 * (3 * dmod.HOT_SEGMENT - 1)


@pytest.mark.gpu
def test_engine_serves_through_k1(cuda):
    from gubernator_tpu_torch.engine import BucketEngine
    from gubernator_tpu_torch.types import RateLimitRequest

    eng = BucketEngine(device=cuda, capacity=1 << 12, batch_rows=64)
    before = dmod.decide_cuda.launches
    out = eng.check_batch([RateLimitRequest(name="g", unique_key="k",
                                            limit=3, duration=5000)] * 5,
                          1_760_000_000_000)
    assert [r.remaining for r in out] == [2, 1, 0, 0, 0]
    assert dmod.decide_cuda.launches > before
    assert np.asarray([int(r.status) for r in out]).tolist() == \
        [0, 0, 0, 1, 1]


@pytest.mark.gpu
def test_degraded_serve_runs_through_k1(cuda):
    """A forward to a peer nothing listens on fails; its rows are served
    degraded on the card (one step through K1) and answer as the same
    serve on the CPU (the plain version), flagged with the peer."""
    import socket

    from gubernator_tpu_torch.config import Config
    from gubernator_tpu_torch.instance import V1Instance
    from gubernator_tpu_torch.proto import gubernator_pb2 as pb
    from gubernator_tpu_torch.types import PeerInfo, RateLimitRequest
    from gubernator_tpu_torch.wire import encode_get_rate_limits

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        dead = f"127.0.0.1:{sk.getsockname()[1]}"
    me = "127.0.0.1:1"
    got = []
    for dev in ("cuda", "cpu"):
        inst = V1Instance(Config(device=dev, cache_size=1 << 12,
                                 batch_rows=64, sweep_interval_ms=0,
                                 advertise_address=me))
        try:
            inst.set_peers([PeerInfo(grpc_address=me),
                            PeerInfo(grpc_address=dead)])
            keys = [f"k{i}" for i in range(300)
                    if inst.owner_of(f"dg_k{i}").info.grpc_address
                    == dead][:4]
            reqs = [RateLimitRequest(name="dg", unique_key=k, hits=h,
                                     limit=3, duration=60_000)
                    for k in keys for h in (1, 2, 1)]
            before = dmod.decide_cuda.launches
            out = pb.GetRateLimitsResp.FromString(inst.get_rate_limits_wire(
                encode_get_rate_limits(reqs), 1_760_000_000_000)).responses
            if dev == "cuda":
                assert dmod.decide_cuda.launches > before
            got.append([(r.status, r.remaining, r.reset_time, r.error,
                         dict(r.metadata)) for r in out])
        finally:
            inst.close()
    assert got[0] == got[1]
    assert all(m == {"degraded": "true", "degraded_peer": dead}
               for *_, m in got[0])
    assert [g[1] for g in got[0][:3]] == [2, 0, 0]


# ---- K2, K3, the SoA step and the classic engine -----------------------

def soa_table(dev, cap, seed):
    """A SoA table of any length (K2 takes any) with live, expired,
    at-now, empty and removed rows."""
    from gubernator_tpu_torch.core.table import TableState

    g = torch.Generator().manual_seed(seed)
    st = TableState(*[torch.zeros(cap, dtype=torch.int32 if f == "meta"
                                  else torch.int64)
                      for f in TableState._fields])
    st.key.copy_(torch.randint(-2 ** 62, 2 ** 62, (cap,), generator=g))
    st.expire_at.copy_(NOW_SOA + torch.randint(-50_000, 50_000, (cap,),
                                               generator=g))
    st.expire_at[::7] = NOW_SOA
    st.key[::5] = 0
    st.expire_at[::5] = 0
    return type(st)(*[c.to(dev) for c in st])


NOW_SOA = 1_760_000_000_000


@pytest.mark.gpu
@pytest.mark.parametrize("cap", [1, 64, 1000, 1 << 16, (1 << 20) + 3])
def test_k2_equals_plain(cuda, cap):
    from gubernator_tpu_torch.ops import sweep

    sk = soa_table(cuda, cap, cap)
    sp = type(sk)(*[c.clone() for c in sk])
    before = sweep.sweep_cuda.launches
    live_k = sweep.sweep_cuda(sk, NOW_SOA)
    live_p = sweep.sweep_plain(sp, NOW_SOA)
    torch.cuda.synchronize()
    assert sweep.sweep_cuda.launches == before + 1
    assert live_k.dim() == 0 and int(live_k) == int(live_p)
    for a, b in zip(sk, sp):
        assert torch.equal(a, b)


K2_MIN, K2_MAX = -2 ** 63, 2 ** 63 - 1


def k2_table(dev, n, kind="mixed", offsets=(0, 0), seed=0):
    """A SoA table of n rows whose key and expire_at are views
    ``offsets`` elements into columns of their own, with one guard row
    after each view.  Guards and pad rows are dead and not empty, so a
    stray write shows.  Kinds: ``mixed`` (live, expired, at now, empty
    rows; about half the keys with the top bit set), ``empty``,
    ``all_expired`` and ``none_expired``.  Returns (the table, the two
    whole columns)."""
    from gubernator_tpu_torch.core.table import TableState

    rng = np.random.default_rng(seed)
    key = rng.integers(K2_MIN, K2_MAX, n, dtype=np.int64, endpoint=True)
    exp = NOW_SOA + rng.integers(-50_000, 50_000, n)
    if kind == "mixed":
        exp[::7] = NOW_SOA
        key[::5] = 0
        exp[::5] = 0
        key[3::11] = 0  # empty key, live expire_at
    elif kind == "empty":
        key[:] = 0
        exp[:] = 0
    elif kind == "all_expired":
        exp = NOW_SOA - rng.integers(0, 50_000, n)
    elif kind == "none_expired":
        exp = NOW_SOA + rng.integers(1, 50_000, n)
    cols = []
    for c, off in zip((key, exp), offsets):
        whole = np.full(n + off + 1, 7, np.int64)
        whole[off:off + n] = c
        cols.append(torch.from_numpy(whole).to(dev))
    (kw, xw), (ko, xo) = cols, offsets
    cols[1][:xo] = NOW_SOA - 1
    cols[1][xo + n:] = NOW_SOA - 1
    others = {f: torch.from_numpy(rng.integers(-5, 1 << 40, n)).to(dev)
              for f in TableState._fields if f not in ("key", "expire_at")}
    others["meta"] = others["meta"].to(torch.int32)
    st = TableState(key=kw[ko:ko + n], expire_at=xw[xo:xo + n], **others)
    return st, (kw, xw)


def k2_against_plain(st, whole, now):
    """K2 on ``st`` and the plain sweep on a CPU copy: every column, the
    guard and pad rows and the live count bit for bit; returns the live
    count."""
    from gubernator_tpu_torch.ops import sweep

    sp = type(st)(*[c.cpu().clone() for c in st])
    wp = [w.cpu().clone() for w in whole]
    before = sweep.sweep_cuda.launches
    live_k = sweep.sweep_cuda(st, now)
    live_p = sweep.sweep_plain(sp, now)
    torch.cuda.synchronize()
    assert sweep.sweep_cuda.launches == before + 1
    assert live_k.dim() == 0 and live_k.dtype == torch.int64
    assert int(live_k) == int(live_p)
    for f, a, b in zip(st._fields, st, sp):
        assert torch.equal(a.cpu(), b), f
    for w, p, v in zip(whole, wp, (st.key, st.expire_at)):
        off = (v.data_ptr() - w.data_ptr()) // 8
        p[off:off + v.numel()] = v.cpu()
        assert torch.equal(w.cpu(), p), "a row outside the view changed"
    return int(live_k)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [0, 1, 2, 3, 31, 33, (1 << 16) - 1,
                               (1 << 16) + 1, (1 << 20) + 3])
@pytest.mark.parametrize("offsets", [(0, 0), (1, 0), (0, 1), (1, 1)])
def test_k2_lengths_and_bases(cuda, n, offsets):
    """Any length, with key and expire_at 0 or 8 bytes past a 16-byte
    boundary: alike (vectors, with a scalar head at 8) or not (row by
    row)."""
    st, whole = k2_table(cuda, n, offsets=offsets, seed=n)
    k2_against_plain(st, whole, NOW_SOA)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["empty", "all_expired", "none_expired",
                                  "mixed"])
@pytest.mark.parametrize("offsets", [(0, 0), (1, 1), (0, 1)])
def test_k2_table_kinds(cuda, kind, offsets):
    st, whole = k2_table(cuda, (1 << 16) + 5, kind, offsets)
    live = k2_against_plain(st, whole, NOW_SOA)
    if kind in ("empty", "all_expired"):
        assert live == 0
    if kind == "none_expired":
        assert live == int((st.key != 0).sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("now", [K2_MIN, K2_MAX])
@pytest.mark.parametrize("offsets", [(0, 0), (1, 0)])
def test_k2_now_at_the_int64_ends(cuda, now, offsets):
    """now = int64 min: only rows at int64 min are dead; now = int64
    max: every row is."""
    st, whole = k2_table(cuda, 4099, offsets=offsets)
    st.expire_at[::13] = K2_MIN
    st.expire_at[1::13] = K2_MAX
    live = k2_against_plain(st, whole, now)
    if now == K2_MAX:
        assert live == 0 and not bool(st.key.any())


@pytest.mark.gpu
def test_k2_keys_with_the_top_bit_set(cuda):
    st, whole = k2_table(cuda, 10_000)
    st.key.copy_(st.key | K2_MIN)  # every key negative as int64
    st.expire_at[::2] = NOW_SOA - 1
    live = k2_against_plain(st, whole, NOW_SOA)
    assert live == int((st.expire_at > NOW_SOA).sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("offsets", [(0, 0), (1, 1), (1, 0)])
def test_k2_second_sweep_reclaims_nothing(cuda, offsets):
    st, whole = k2_table(cuda, (1 << 16) + 1, offsets=offsets)
    first = k2_against_plain(st, whole, NOW_SOA)
    cols = [c.clone() for c in st]
    assert k2_against_plain(st, whole, NOW_SOA) == first
    assert all(torch.equal(a, b) for a, b in zip(st, cols))


@pytest.mark.gpu
def test_k2_one_launch_and_no_allocation_a_sweep(cuda):
    from gubernator_tpu_torch.ops import sweep

    st, _ = k2_table(cuda, 1 << 16)
    want = int(sweep.sweep_plain(type(st)(*[c.clone() for c in st]),
                                 NOW_SOA))
    sweep.sweep_cuda(st, NOW_SOA)  # the stream's counters, made once
    torch.cuda.synchronize()
    allocs = torch.cuda.memory_stats(cuda)["allocation.all.allocated"]
    before = sweep.sweep_cuda.launches
    counts = []
    for i in range(2 * sweep.RING + 3):
        counts.append(sweep.sweep_cuda(st, NOW_SOA))
        assert sweep.sweep_cuda.launches == before + i + 1
    torch.cuda.synchronize()
    assert torch.cuda.memory_stats(cuda)["allocation.all.allocated"] \
        == allocs
    assert [int(c) for c in counts[-sweep.RING + 1:]] == \
        [want] * (sweep.RING - 1)


@pytest.mark.gpu
def test_k2_count_outlives_the_next_sweeps(cuda):
    """A count read after RING - 2 later sweeps of another table on the
    same stream, and after a sweep on another stream, is its own; after
    RING - 1 it reads 0 and after RING the later sweep's count, as
    sweep_cuda's contract says."""
    from gubernator_tpu_torch.ops import sweep

    a, _ = k2_table(cuda, 5000, "none_expired", seed=1)
    b, _ = k2_table(cuda, 3000, "none_expired", seed=2)
    first = sweep.sweep_cuda(a, NOW_SOA)
    later = [sweep.sweep_cuda(b, NOW_SOA) for _ in range(sweep.RING - 2)]
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        c, _ = k2_table(cuda, 777, "none_expired", seed=3)
        on_side = sweep.sweep_cuda(c, NOW_SOA)
    torch.cuda.synchronize()
    assert int(first) == int((a.key != 0).sum()) > int(later[0])
    assert {int(x) for x in later} == {int((b.key != 0).sum())}
    assert int(on_side) == int((c.key != 0).sum())
    sweep.sweep_cuda(b, NOW_SOA)
    torch.cuda.synchronize()
    assert int(first) == 0
    sweep.sweep_cuda(b, NOW_SOA)
    torch.cuda.synchronize()
    assert int(first) == int((b.key != 0).sum())


@pytest.mark.gpu
def test_k3_equals_plain(cuda):
    from gubernator_tpu_torch.ops import probe

    g = torch.Generator().manual_seed(0)
    for shape in [(8, 128), (1 << 20,), (3, 5)]:
        x = torch.randint(-2 ** 31, 2 ** 31, shape, dtype=torch.int64,
                          generator=g).to(torch.int32)
        y = torch.randint(-2 ** 31, 2 ** 31, shape, dtype=torch.int64,
                          generator=g).to(torch.int32)
        got = probe.probe_add(x.to(cuda), y.to(cuda))
        assert torch.equal(got.cpu(), probe.probe_add_plain(x, y))
    x = torch.arange(8 * 128, dtype=torch.int32, device=cuda).reshape(8, 128)
    assert int(probe.probe_add(x, x).sum()) == 1_047_552


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 3, 4, 5, 1023, (1 << 20) + 7])
@pytest.mark.parametrize("offsets", [(0, 0), (1, 1), (3, 3), (1, 2), (0, 3)])
def test_k3_head_tail_and_unaligned_bases(cuda, n, offsets):
    """Views that start 0-3 elements past a 16-byte boundary, alike (the
    vector body with a scalar head) or not (element by element), and
    lengths with a ragged tail."""
    from gubernator_tpu_torch.ops import probe

    g = torch.Generator().manual_seed(n)
    base = [torch.randint(-2 ** 31, 2 ** 31, (n + 4,), dtype=torch.int64,
                          generator=g).to(torch.int32).to(cuda)
            for _ in range(2)]
    x, y = (b[o:o + n] for b, o in zip(base, offsets))
    before = probe.probe_add_cuda.launches
    got = probe.probe_add(x, y)
    torch.cuda.synchronize()
    assert probe.probe_add_cuda.launches == before + 1
    assert torch.equal(got, probe.probe_add_plain(x, y))


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(STREAMS))
def test_soa_step_on_cuda_equals_cpu(cuda, name):
    from gubernator_tpu_torch.core.step import decide_batch
    from gubernator_tpu_torch.core.table import init_soa_table

    sc, sg = init_soa_table(1 << 12, "cpu"), init_soa_table(1 << 12, cuda)
    batches, nows = STREAMS[name]()
    for b, now in zip(batches, nows):
        tb = to_torch(b)
        oc = decide_batch(sc, tb, now)
        og = decide_batch(sg, type(tb)(*[c.to(cuda) for c in tb]), now)
        for f in oc._fields:
            assert torch.equal(getattr(oc, f), getattr(og, f).cpu()), f
        for a, c in zip(sc, sg):
            assert torch.equal(a, c.cpu())


@pytest.mark.gpu
def test_classic_engine_on_cuda_equals_cpu(cuda):
    """Serving, the K2 sweep-retry, auto-grow, row ops and restore."""
    from gubernator_tpu_torch.ops import sweep
    from gubernator_tpu_torch.sharded import ShardedEngine
    from gubernator_tpu_torch.types import RateLimitRequest

    engs = [ShardedEngine(device=d, capacity=1024, batch_rows=64,
                          auto_grow_limit=4096) for d in ("cpu", cuda)]
    before = sweep.sweep_cuda.launches
    for w in range(4):
        reqs = [RateLimitRequest(name="c", unique_key=f"k{w}_{i % 700}",
                                 hits=1 + i % 3, limit=2 ** 40 if i % 9
                                 else 7, duration=1_000 + 60_000 * (w % 2),
                                 algorithm=i % 2) for i in range(900)]
        outs = [e.check_batch(reqs, NOW_SOA + 3_000 * w) for e in engs]
        assert [(int(r.status), r.remaining, r.reset_time, r.error)
                for r in outs[0]] == [(int(r.status), r.remaining,
                                       r.reset_time, r.error)
                                      for r in outs[1]]
        for a, c in zip(engs[0].state, engs[1].state):
            assert torch.equal(a, c.cpu())
    assert engs[1].cap_local > 1024  # grew
    assert sweep.sweep_cuda.launches > before
    snap = engs[0].snapshot()
    fresh = [ShardedEngine(device=d, capacity=4096, batch_rows=64)
             for d in ("cpu", cuda)]
    assert fresh[0].restore(snap) == fresh[1].restore(snap) > 0
    for a, c in zip(fresh[0].state, fresh[1].state):
        assert torch.equal(a, c.cpu())


def _tier_union(inst) -> dict:
    from gubernator_tpu_torch.tiering import ROW_COLS

    out = {}
    for arrays in (inst.engine.snapshot(), inst._tier.snapshot_arrays()):
        if arrays is None:
            continue
        for i, k in enumerate(np.asarray(arrays["key"]).tolist()):
            assert k not in out, "a key in both tiers"
            out[k] = tuple(int(arrays[f][i]) for f in ROW_COLS)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["", "xla"])
def test_tier_row_moves_on_cuda_equal_cpu(cuda, monkeypatch, engine):
    """A capped instance with the cold tier on the card and on the CPU:
    cold serves (object and wire lanes, out-of-domain rows on the bucket
    engine), then promotions and demotions through the engines' row API
    on the card; equal answers and an equal union of the tiers, with
    every row move's placement the same."""
    from gubernator_tpu_torch.config import Config
    from gubernator_tpu_torch.instance import V1Instance
    from gubernator_tpu_torch.types import RateLimitRequest
    from gubernator_tpu_torch.wire import encode_get_rate_limits

    monkeypatch.setenv("GUBER_ANALYTICS", "0")
    monkeypatch.setenv("GUBER_PIPELINE", "0")
    insts = [V1Instance(Config(cache_size=1024, batch_rows=64, device=d,
                               engine=engine, sweep_interval_ms=0,
                               tier_cold=True)) for d in ("cpu", "cuda")]
    try:
        for w in range(3):
            # the 2^40 rows on keys of their own: a key with a device
            # row answers table_full at 2^40 on the bucket engine
            reqs = [RateLimitRequest(
                name="big" if i % 50 == 0 else "t",
                unique_key=f"k{(i * 7 + w) % 2500}",
                hits=i % 3, limit=2 ** 40 if i % 50 == 0 else 9,
                duration=60_000, algorithm=i % 2) for i in range(900)]
            now = NOW + 1_000 * w
            a, b = [[(int(r.status), r.limit, r.remaining, r.reset_time,
                      r.error) for r in inst.get_rate_limits(reqs, now)]
                    for inst in insts]
            assert a == b and not any(x[4] for x in a)
            wa, wb = [inst.get_rate_limits_wire(
                encode_get_rate_limits(reqs[:500]), now + 1)
                for inst in insts]
            assert wa == wb
            assert _tier_union(insts[0]) == _tier_union(insts[1])
        cold = sorted(insts[0]._tier.snapshot_arrays()["key"].tolist())
        for inst in insts:
            tier = inst._tier
            tier.rank_fn = lambda kh: 1
            tier.rank_batch = lambda khs: [0] * len(khs)
            for kh in cold[:64]:
                tier.promote(inst.engine, kh, 10)
        assert insts[0]._tier.stats() == insts[1]._tier.stats()
        assert insts[1]._tier.stats()["promotions"] > 0
        assert _tier_union(insts[0]) == _tier_union(insts[1])
        if engine == "":
            assert torch.equal(insts[0].engine.rows, insts[1].engine.rows.cpu())
    finally:
        for inst in insts:
            inst.close()


@pytest.mark.gpu
def test_device_tap_folds_from_the_card(cuda):
    """The analytics worker copies a CUDA tap after the step's event, on
    its side stream: the sketch equals the CPU tap's."""
    from gubernator_tpu_torch.analytics import KeyAnalytics

    rng = np.random.default_rng(1)
    tap = torch.from_numpy(np.stack([
        rng.integers(1, 50, 8192), rng.integers(0, 4, 8192),
        rng.integers(0, 2, 8192), rng.integers(0, 2, 8192)]))
    docs = []
    for dev in ("cpu", "cuda"):
        ka = KeyAnalytics(k=16, width=64, clock=lambda: 1.0)
        try:
            for _ in range(3):
                assert ka.tap_device(tap.to(dev))
            assert ka.flush()
            docs.append(ka.topkeys_snapshot())
        finally:
            ka.close()
    assert docs[0] == docs[1] and docs[0]["waves_tapped"] == 3


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["", "xla"])
def test_occupancy_nowait_never_waits_on_the_stream(cuda, engine):
    """While the serving stream spins, a queued count has not landed:
    occupancy_nowait answers None (the memory ledger keeps its last
    sample) and returns at once; once the stream drains it reads the
    live rows."""
    import time

    from gubernator_tpu_torch.config import Config
    from gubernator_tpu_torch.instance import V1Instance
    from gubernator_tpu_torch.types import RateLimitRequest

    inst = V1Instance(Config(cache_size=1 << 14, engine=engine,
                             hot_set_capacity=0))
    try:
        inst.get_rate_limits([RateLimitRequest(
            name="occ", unique_key=f"k{i}", hits=1, limit=5,
            duration=60_000) for i in range(40)])
        torch.cuda.synchronize()
        eng = inst.engine
        assert eng.occupancy_nowait() is None  # the first count queued
        torch.cuda.synchronize()
        assert eng.occupancy_nowait() == 40
        torch.cuda._sleep(2_000_000_000)  # the stream spins ~1 s
        t0 = time.perf_counter()
        # the count queued before the spin may have landed; the one
        # queued now waits behind it
        assert eng.occupancy_nowait() in (40, None)
        assert eng.occupancy_nowait() is None
        assert eng.occupancy_nowait() is None
        assert time.perf_counter() - t0 < 0.1
        torch.cuda.synchronize()
        assert eng.occupancy_nowait() == 40
        led = inst.memledger.snapshot()["consumers"]["hot_table"]
        assert led["bytes"] == sum(t.nbytes for t in eng.table_tensors())
    finally:
        inst.close()
