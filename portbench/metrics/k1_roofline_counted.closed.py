"""K1's share of its roofline in the window, in %, from the program's
own counts: the bytes of an average launch (its live rows 105 B each,
its distinct buckets 1,024 B each, the arithmetic of
``k1_roofline.closed``), taken from ``gubernator_k1_rows``,
``gubernator_k1_segments`` and ``gubernator_k1_launches`` over the
window, times K1's launches in the trace, at the card's published HBM
rate, over K1's device time in the trace.  It needs no operation
shapes of the profiler."""
from portbench.lib.program import window_sum
from portbench.lib.readers import HBM_BYTES_PER_S, kernel_s

REQ_BYTES = 76 + 29
BUCKET_BYTES = 2 * 8 * 16 * 4


def read(run):
    t = kernel_s(run, "decide_kernel")
    n = kernel_s(run, "decide_kernel", "launches")
    launches = window_sum(run, "gubernator_k1_launches_total")
    if not t or not n or not launches:
        return None
    rows = window_sum(run, "gubernator_k1_rows_total")
    segments = window_sum(run, "gubernator_k1_segments_total")
    per_launch = (rows * REQ_BYTES + segments * BUCKET_BYTES) / launches
    return 100.0 * per_launch * n / HBM_BYTES_PER_S / t
