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
