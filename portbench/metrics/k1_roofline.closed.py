"""K1's share of its roofline in the window, in %: the least time the
bytes its waves need take at the card's published HBM rate, over K1's
device time in the trace.

Bytes, as chip_smoke.py / chip_ab.py count them: each live request row
76 B of request columns in and 29 B of answers out; each distinct bucket
a wave touches read and written once, 8 slots of 16 used words.  Each
wave's rows and distinct buckets are the input shapes of the two host
operations of ``ops/decide.py › _plan`` that every K1 launch follows:
``torch.unique_consecutive`` over the wave's live rows sorted by bucket,
then ``torch.cumsum`` over its segments (one per distinct bucket).
Nothing is read where those calls and K1's launches in the window do
not pair up."""
import numpy as np

from portbench.lib.readers import HBM_BYTES_PER_S, kernel_s

REQ_BYTES = 76 + 29
BUCKET_BYTES = 2 * 8 * 16 * 4
UNIQUE, CUMSUM = "aten::unique_consecutive", "aten::cumsum"
HOST_OPS = (UNIQUE, CUMSUM)


def waves(host_ops: dict) -> tuple:
    """(live rows, distinct buckets) of each wave: each unique call's
    input length, and that of the first cumsum its thread starts after
    it ends."""
    after: dict = {}
    for tid, t0, _, shapes in host_ops.get(CUMSUM, []):
        after.setdefault(tid, []).append((t0, shapes[0][0] if shapes
                                          and shapes[0] else 0))
    for tid in after:
        after[tid] = np.array(sorted(after[tid]), np.int64).reshape(-1, 2)
    rows, buckets = [], []
    for tid, _, t1, shapes in host_ops.get(UNIQUE, []):
        cs = after.get(tid)
        if cs is None or not shapes or not shapes[0]:
            continue
        i = int(np.searchsorted(cs[:, 0], t1))
        if i < len(cs):
            rows.append(shapes[0][0])
            buckets.append(int(cs[i, 1]))
    return np.array(rows, np.int64), np.array(buckets, np.int64)


def read(run):
    t = kernel_s(run, "decide_kernel")
    if not t:
        return None
    rows, buckets = waves(run.trace.get("host_ops", {}))
    launches = kernel_s(run, "decide_kernel", "launches")
    # a launch or a plan cut at either edge of the window
    if not len(rows) or abs(len(rows) - launches) > 2:
        return None
    need = int(buckets.sum()) * BUCKET_BYTES + int(rows.sum()) * REQ_BYTES
    return 100.0 * need / HBM_BYTES_PER_S / t
