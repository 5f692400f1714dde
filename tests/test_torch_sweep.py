"""K2's plain version (ops/sweep.py › sweep_plain) against the JAX
package's sweep_expired + occupancy, and K3's plain version (ops/probe.py
› probe_add on the CPU) against numpy.

The JAX Pallas sweep cannot run here (this jax lacks
``jax.experimental.enable_x64``); sweep_expired + occupancy is the
reference the JAX engine itself uses off TPU.  Tolerance 0: integers.
"""
import numpy as np
import pytest
import torch

from gubernator_tpu.core.table import TableState as JaxTable
from gubernator_tpu.core.table import occupancy as jax_occupancy
from gubernator_tpu.core.table import sweep_expired as jax_sweep
from gubernator_tpu_torch.core.table import init_soa_table
from gubernator_tpu_torch.ops import probe, sweep
from gubernator_tpu_torch.state import soa_from_jax, soa_to_numpy

NOW = 1_760_000_000_000


def make_table(cap, kind, seed=0):
    """Host columns of a JAX TableState: ``empty``, ``all_expired``,
    ``none_expired`` or ``mixed`` (live, expired, at exactly now, empty
    and removed rows)."""
    rng = np.random.default_rng(seed)
    key = rng.integers(1, 2 ** 63, cap).astype(np.uint64)
    key[::5] |= np.uint64(1 << 63)  # top bit set
    exp = NOW + rng.integers(1, 100_000, cap)
    if kind == "empty":
        key[:] = 0
        exp[:] = 0
    elif kind == "all_expired":
        exp = NOW - rng.integers(0, 100_000, cap)
    elif kind == "mixed":
        r = rng.random(cap)
        exp = np.where(r < 0.3, NOW - rng.integers(1, 100_000, cap), exp)
        exp[r > 0.9] = NOW  # the boundary: expire_at == now is dead
        gone = (r > 0.4) & (r < 0.5)
        key[gone] = 0  # empty
        exp[gone] = 0
    cols = {f: rng.integers(-5, 1 << 40, cap) for f in JaxTable._fields}
    cols["meta"] = rng.integers(0, 4, cap).astype(np.int32)
    cols.update(key=key, expire_at=exp.astype(np.int64))
    return cols


@pytest.mark.parametrize("cap", [64, 1 << 12])
@pytest.mark.parametrize("kind", ["empty", "all_expired", "none_expired",
                                  "mixed"])
def test_sweep_plain_matches_jax(cap, kind):
    cols = make_table(cap, kind)
    js = JaxTable(**{f: np.asarray(cols[f]) for f in JaxTable._fields})
    js = jax_sweep(js, np.int64(NOW))
    want_live = int(jax_occupancy(js))
    ts = soa_from_jax(cols, "cpu")
    live = sweep.sweep(ts, NOW)  # the CPU table takes the plain version
    assert live.dim() == 0 and live.dtype == torch.int64
    assert int(live) == want_live
    got = soa_to_numpy(ts)
    for f in JaxTable._fields:
        assert (np.asarray(getattr(js, f)) == got[f]).all(), f
    if kind == "mixed":
        assert 0 < want_live < cap
        at_now = cols["expire_at"] == NOW
        assert at_now.any() and (got["key"][at_now] == 0).all()


def test_sweep_is_idempotent_and_counts_live_rows():
    ts = soa_from_jax(make_table(256, "mixed", seed=3), "cpu")
    first = int(sweep.sweep_plain(ts, NOW))
    before = soa_to_numpy(ts)
    assert int(sweep.sweep_plain(ts, NOW)) == first == int((ts.key != 0).sum())
    after = soa_to_numpy(ts)
    assert all((before[f] == after[f]).all() for f in before)


def test_fresh_table_sweeps_to_zero_live():
    ts = init_soa_table(128, "cpu")
    assert int(sweep.sweep_plain(ts, NOW)) == 0
    assert int(ts.eff_ms.min()) == 1  # untouched


def test_sweep_cuda_refuses_a_cpu_table():
    with pytest.raises(ValueError, match="CUDA"):
        sweep.sweep_cuda(init_soa_table(64, "cpu"), NOW)


@pytest.mark.parametrize("seed", range(3))
def test_probe_add_plain_wraps_like_numpy(seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-2 ** 31, 2 ** 31, 4096).astype(np.int32)
    y = rng.integers(-2 ** 31, 2 ** 31, 4096).astype(np.int32)
    x[:4] = [2 ** 31 - 1, -2 ** 31, 2 ** 31 - 1, -1]
    y[:4] = [1, -1, 2 ** 31 - 1, -2 ** 31]
    with np.errstate(over="ignore"):
        want = x + y  # int32: wraps
    got = probe.probe_add(torch.from_numpy(x), torch.from_numpy(y))
    assert got.dtype == torch.int32
    assert (got.numpy() == want).all()
    assert got.numpy()[:4].tolist() == [-2 ** 31, 2 ** 31 - 1, -2, 2 ** 31 - 1]


def test_probe_add_on_the_toy_input():
    """tools/pallas_probe.py's (8, 128) input: x + x sums to 1,047,552."""
    x = torch.arange(8 * 128, dtype=torch.int32).reshape(8, 128)
    assert int(probe.probe_add(x, x).sum()) == 1_047_552
