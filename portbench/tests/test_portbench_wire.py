"""The harness's wire codec against protobuf's own encoding."""
import numpy as np
import pytest

from gubernator_tpu_torch.proto import gubernator_pb2 as pb
from portbench.lib import wire


@pytest.mark.parametrize("seed", range(4))
def test_encoder_equals_protobuf(seed):
    rng = np.random.default_rng(seed)
    n = 200
    idx = rng.integers(0, 10 ** 8, n)
    hits = rng.choice([0, 1, 7, 300], n)
    limit = rng.choice([0, 1, 100, 127, 128, 10 ** 9, 1 << 40], n)
    dur = rng.choice([0, 1000, 3_600_000], n)
    alg = rng.choice([0, 1], n)
    beh = rng.choice([0, 2, 8, 34], n)
    burst = rng.choice([0, 5, 1 << 20], n)
    flat, ends = wire.encode_rows("pb", "k", idx, 8, hits, limit, dur,
                                  algorithm=alg, behavior=beh, burst=burst)
    want = pb.GetRateLimitsReq(requests=[pb.RateLimitReq(
        name="pb", unique_key=f"k{i:08d}", hits=int(h), limit=int(lim),
        duration=int(d), algorithm=int(a), behavior=int(b), burst=int(u))
        for i, h, lim, d, a, b, u in zip(idx, hits, limit, dur, alg, beh,
                                         burst)])
    assert flat.tobytes() == want.SerializeToString()
    calls = wire.split_calls(flat, ends, 50)
    assert len(calls) == 4 and b"".join(calls) == flat.tobytes()
    assert len(pb.GetRateLimitsReq.FromString(calls[1]).requests) == 50


def _resp(rows) -> bytes:
    return pb.GetRateLimitsResp(responses=[
        pb.RateLimitResp(**r) for r in rows]).SerializeToString()


@pytest.mark.parametrize("seed", range(3))
def test_decoder_equals_protobuf(seed):
    rng = np.random.default_rng(seed)
    calls = []
    for _ in range(5):
        n = int(rng.integers(0, 40))
        calls.append([{"status": int(rng.integers(0, 2)),
                       "limit": int(rng.choice([0, 100, 1 << 40])),
                       "remaining": int(rng.choice([0, 3, 99, 1 << 35])),
                       "reset_time": int(rng.choice([0, 1_760_003_600_000]))}
                      for _ in range(n)])
    cols, per_call = wire.decode_calls([_resp(c) for c in calls])
    assert per_call.tolist() == [len(c) for c in calls]
    flat = [r for c in calls for r in c]
    for f in ("status", "limit", "remaining", "reset_time"):
        assert cols[f].tolist() == [r[f] for r in flat]
    assert not cols["error"].any()


def test_decoder_reads_errors_and_metadata_plainly():
    a = _resp([{"status": 0, "limit": 5, "remaining": 4,
                "reset_time": 9}])
    b = pb.GetRateLimitsResp(responses=[
        pb.RateLimitResp(limit=5, error="rate limit table full"),
        pb.RateLimitResp(status=1, limit=5, reset_time=9,
                         metadata={"owner": "x"})]).SerializeToString()
    cols, per_call = wire.decode_calls([a, b])
    assert per_call.tolist() == [1, 2]
    assert cols["error"].tolist() == [False, True, False]
    assert cols["status"].tolist() == [0, 0, 1]
    assert cols["remaining"].tolist() == [4, 0, 0]
    assert cols["limit"].tolist() == [5, 5, 5]
