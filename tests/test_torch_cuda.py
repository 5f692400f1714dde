"""K1 on the card against its plain version, on the streams of
test_torch_streams.py.  Marked ``gpu``: skips where no CUDA device is
present.  On a GPU machine (which need not have JAX, hence no conftest):

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from gubernator_tpu_torch.core.table import init_table
from gubernator_tpu_torch.ops import decide as dmod

from test_torch_streams import STREAMS, property_stream, to_torch


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 has no CPU mode")
    return torch.device("cuda")


def run_kernel_and_plain(dev, batches, nows, cap=1 << 12):
    rows_k = init_table(cap, dev)
    rows_p = init_table(cap, dev)
    for b, now in zip(batches, nows):
        tb = to_torch(b)
        tb = type(tb)(*[c.to(dev) for c in tb])
        before = dmod.decide_cuda.launches
        ok = dmod.decide_cuda(rows_k, tb, now)
        op = dmod.decide_plain(rows_p, tb, now)
        torch.cuda.synchronize()
        assert dmod.decide_cuda.launches == before + 1
        for f in ok._fields:
            assert torch.equal(getattr(ok, f), getattr(op, f)), f
        assert torch.equal(rows_k, rows_p)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(STREAMS))
def test_k1_equals_plain_on_stream(cuda, name):
    run_kernel_and_plain(cuda, *STREAMS[name]())


@pytest.mark.gpu
@pytest.mark.parametrize("seed", range(4))
def test_k1_equals_plain_on_property_stream(cuda, seed):
    run_kernel_and_plain(cuda, *property_stream(seed))


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
