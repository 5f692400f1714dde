"""The port's decision step (plain PyTorch version of K1) against the JAX
package's Pallas kernel in interpret mode.

The same numpy request streams (those of test_pallas_step.py plus
seeded property streams) go through ``decide_batch_pallas(...,
interpret=True)`` and ``decide_plain`` from tables that start equal
(state.table_from_jax).  After every batch the outputs, the counters
AND every table word must be equal: tolerance 0, all integer.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gubernator_tpu.core.batch import RequestBatch as JaxBatch
from gubernator_tpu.ops.pallas_step import (decide_batch_pallas,
                                            init_pallas_table,
                                            pallas_qualifies,
                                            pallas_value_domain_mask)
from gubernator_tpu_torch.core.table import (EFF_BOUND, VALUE_BOUND, join64,
                                             split64)
from gubernator_tpu_torch.ops import decide as dmod
from gubernator_tpu_torch.state import table_from_jax, table_to_numpy

from test_torch_streams import (CAP, NOW, STREAMS, keyify, mk_batch,
                                property_stream, s_bucket_full, to_torch)

FIELDS = ("status", "remaining", "reset_time", "limit", "err")


def run_both(batches, nows, cap=CAP):
    """Every batch through both steps; everything equal after each."""
    pt = init_pallas_table(cap)
    rows = table_from_jax(np.asarray(pt.rows), "cpu")
    outs = []
    for i, (b, now) in enumerate(zip(batches, nows)):
        assert pallas_qualifies(JaxBatch(*b)) and dmod.qualifies(b)
        pt, po = decide_batch_pallas(
            pt, JaxBatch(*[jnp.asarray(c) for c in b]),
            jnp.asarray(now, jnp.int64), interpret=True)
        to = dmod.decide_plain(rows, to_torch(b), now)
        for f in FIELDS:
            a, c = np.asarray(getattr(po, f)), getattr(to, f).numpy()
            assert a.dtype == c.dtype, (i, f)
            assert (a == c).all(), (i, f, np.nonzero(a != c)[0][:5].tolist())
        assert int(po.over_count) == int(to.over_count), i
        assert int(po.insert_count) == int(to.insert_count), i
        diff = np.asarray(pt.rows) != table_to_numpy(rows)
        assert not diff.any(), (i, np.argwhere(diff)[:5].tolist())
        outs.append(to)
    return outs


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_stream_matches_jax_kernel(name):
    run_both(*STREAMS[name]())


def test_bucket_full_errs_and_survivors_serve():
    outs = run_both(*s_bucket_full())
    err = outs[0].err.numpy()
    assert err.sum() == 3  # 11 keys into 8 slots
    assert (outs[0].remaining.numpy()[~err] == 9).all()
    assert (outs[1].remaining.numpy()[~outs[1].err.numpy()] == 8).all()


@pytest.mark.parametrize("seed", range(12))
def test_property_stream_matches_jax_kernel(seed):
    run_both(*property_stream(seed), cap=1 << 9 if seed % 2 else CAP)


@pytest.mark.parametrize("seed", range(3))
def test_domain_mask_and_qualifier_match_jax(seed):
    rng = np.random.default_rng(seed)
    n = 64
    b = mk_batch(keyify(rng.integers(0, 8, n)),
                 algorithm=rng.integers(0, 3, n),
                 limit=rng.choice([0, 5, VALUE_BOUND - 1, VALUE_BOUND], n),
                 hits=rng.choice([-1, 0, 3], n),
                 eff_ms=rng.choice([0, 1, EFF_BOUND - 1, EFF_BOUND], n),
                 now=NOW + rng.integers(0, 3, n),
                 valid=rng.random(n) < 0.8)
    jb = JaxBatch(*b)
    assert (dmod.value_domain_mask(b) == pallas_value_domain_mask(jb)).all()
    assert dmod.qualifies(b) == pallas_qualifies(jb)
    ok = mk_batch(keyify(np.arange(8)))
    assert dmod.qualifies(ok) and pallas_qualifies(JaxBatch(*ok))


def test_split_join_wrap_like_numpy():
    x = np.array([0, 1, -1, 2 ** 31, -2 ** 31, 2 ** 32 - 1, 2 ** 62 + 12345,
                  -2 ** 63, 2 ** 63 - 1, 0x80000000FFFFFFFF - 2 ** 64],
                 np.int64)
    hi, lo = split64(torch.from_numpy(x))
    u = x.astype(np.uint64)
    assert (lo.numpy() == u.astype(np.uint32).astype(np.int32)).all()
    assert (hi.numpy() == (u >> np.uint64(32)).astype(np.uint32)
            .astype(np.int32)).all()
    assert (join64(hi, lo).numpy() == x).all()


def test_decide_picks_by_device():
    rows = torch.zeros((CAP, 32), dtype=torch.int32)
    b = to_torch(mk_batch(keyify(np.arange(8))))
    before = dmod.decide_cuda.launches
    out = dmod.decide(rows, b, NOW)  # CPU table: the plain version
    assert dmod.decide_cuda.launches == before
    assert (out.remaining.numpy() == 9).all()
    with pytest.raises(ValueError):
        dmod.decide_cuda(rows, b, NOW)  # the kernel never takes CPU
    with pytest.raises(ValueError):
        dmod.decide(rows.to("meta"), b, NOW)
