"""The decision step over the bucketized table: K1's wrapper.

Replaces gubernator_tpu/ops/pallas_step.py › decide_batch_pallas_impl
(the TPU kernel ``_kernel`` and its wrapper).  Same contract: a wave of
requests applies to the table strictly in batch order, per key and per
bucket, TOKEN and LEAKY with RESET / DRAIN / Gregorian flags, and the
outputs, counters and table words equal the TPU kernel's bit for bit
inside its domain (``qualifies``: counters < 2^30, leaky eff in
[1, 2^31), per-key non-decreasing ``now``).

Requests interact only within a bucket, so the wrapper sorts the live
rows stably by bucket and hands each distinct bucket's segment, in
batch order, to one worker:

- ``decide_cuda`` launches K1 (csrc/decide.cu): a segment of at most
  ``HOT_SEGMENT`` requests is walked by one CUDA thread; a longer one by
  a block of 8 warps, one per slot, which takes runs of like requests
  in closed form;
- ``decide_plain`` is the same function in plain PyTorch: round j
  applies the j-th request of every segment at once, vectorized across
  segments.

``decide`` picks by the table's device: the plain version for a CPU
tensor, the kernel for a CUDA tensor.  Nothing falls back.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.batch import RequestBatch
from ..core.step import StepOutput
from ..core.table import (EFF_BOUND, SLOTS, VALUE_BOUND, W_ALG, W_DHI,
                          W_DLO, W_EHI, W_ELO, W_KHI, W_KLO, W_LIMIT, W_REM,
                          W_STATUS, W_TDHI, W_TDLO, W_THI, W_TLO, W_XHI,
                          W_XLO, WORDS, join64, split64)
from ..types import TD_BOUND, Behavior

_RESET = int(Behavior.RESET_REMAINING)
_DRAIN = int(Behavior.DRAIN_OVER_LIMIT)
_GREG = int(Behavior.DURATION_IS_GREGORIAN)

#: rows of the [N_REQ, B] int64 request matrix K1 reads (csrc/decide.cu
#: has the same enum).  hits/limit/behavior/algorithm/rate carry the
#: TPU kernel's int32 values; the rest are full int64.
(R_KEY, R_HITS, R_LIMIT, R_DUR, R_EFF, R_GREG, R_NOW, R_BEH, R_ALG,
 R_HTD, R_CAP, R_RST, R_RATE, R_GD) = range(14)
N_REQ = 14
#: rows of the [N_OUT, B] int64 raw output matrix
O_STATUS, O_REM, O_RESET, O_LIMIT, O_FLAGS = range(5)
N_OUT = 5
#: K1 gives a segment longer than this a block of its own (8 warps, one
#: per slot); shorter ones get a thread each.  On an H100 the launch on
#: the main path's waves is fastest at thresholds 8 and 16 and slower
#: from 32 up, where a thread's walk of a cold segment becomes the
#: longest path (PERF.md §6); the higher one needs fewer blocks: ~40 per
#: 8192-row Zipf(1.1) wave.  ``chip_ab.py`` times the launch against the
#: threshold.
HOT_SEGMENT = 16
#: requests K1's hot path stages in shared memory at a time
#: (csrc/decide.cu TILE); a longer segment is walked tile after tile
K1_TILE = 256
#: the counters K1 adds to when the wrapper is given a ``stats`` tensor
#: (csrc/decide.cu ST_*): hot segments, hot requests applied one by one,
#: hot requests taken in closed form, the longest slot chain of a hot
#: segment (a maximum), and requests walked by cold threads
K1_STATS = ("hot_segments", "serial", "closed_form", "longest_chain", "cold")


def value_domain_mask(batch: RequestBatch) -> np.ndarray:
    """Per-row value-domain mask (numpy bool[B]): True where the row's
    algorithm, counters and leaky eff fit the kernel's arithmetic."""
    alg = np.asarray(batch.algorithm)
    ok = (alg == 0) | (alg == 1)
    for col in (batch.hits, batch.limit, batch.burst):
        c = np.asarray(col)
        ok &= (c >= 0) & (c < VALUE_BOUND)
    eff = np.asarray(batch.eff_ms)
    ok &= (alg != 1) | ((eff >= 1) & (eff < EFF_BOUND))
    return ok


def qualifies(batch: RequestBatch) -> bool:
    """Batch-level domain check: every valid row in the value domain and
    per-key arrival times non-decreasing in batch order (the step
    applies requests strictly in batch order)."""
    v = np.asarray(batch.valid)
    if (v & ~value_domain_mask(batch)).any():
        return False
    if batch.now is not None:
        now = np.asarray(batch.now)
        if now.size and not (now == now.flat[0]).all():
            # invalid rows first: one between two same-key rows would
            # hide a time inversion from the neighbour check
            keys = np.asarray(batch.key)[v]
            now_v = now[v]
            order = np.argsort(keys, kind="stable")
            k_s, n_s = keys[order], now_v[order]
            same = k_s[1:] == k_s[:-1]
            if (same & (n_s[1:] < n_s[:-1])).any():
                return False
    return True


def batch_from_packed(a64: torch.Tensor, a32: torch.Tensor) -> RequestBatch:
    """Packed wave matrices ([8,B] i64, [3,B] i32, core/batch.py PACK64/
    PACK32) → a RequestBatch of tensors (key as the int64 bit-view)."""
    return RequestBatch(
        key=a64[0], hits=a64[1], limit=a64[2], duration=a64[3],
        eff_ms=a64[4], greg_end=a64[5], burst=a64[6], now=a64[7],
        behavior=a32[0], algorithm=a32[1], valid=a32[2] != 0)


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 → its low 32 bits as a signed value, still int64 (the
    TPU wrapper's astype(int32) on the columns it packs as one word)."""
    return ((x & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000


class _Plan(NamedTuple):
    req: torch.Tensor  # [N_REQ, B] int64
    valid: torch.Tensor  # [B] bool
    order: torch.Tensor  # [L] int64 live rows, stably sorted by bucket
    seg_bucket: torch.Tensor  # [S] int64 bucket index, longest first
    seg_start: torch.Tensor  # [S] int64 offset into order
    seg_len: torch.Tensor  # [S] int64


def _plan(rows: torch.Tensor, batch: RequestBatch, now) -> _Plan:
    """Request columns + the bucket segments, on the table's device."""
    i64 = torch.int64
    dev = rows.device
    n_buckets = rows.shape[0] // SLOTS
    key = batch.key.to(i64)
    B = key.shape[0]
    now_t = torch.as_tensor(int(now), dtype=i64, device=dev)
    if batch.now is None:
        now_col = now_t.expand(B)
    else:
        bn = batch.now.to(i64)
        now_col = torch.where(bn > 0, bn, now_t)
    valid = batch.valid.to(torch.bool) & (key != 0)

    # request-only leaky td products in real int64, eff masked to 1 on
    # token rows so huge token values cannot wrap the unused product
    alg = _i32(batch.algorithm.to(i64))
    eff = batch.eff_ms.to(i64)
    lim = batch.limit.to(i64)
    eff_l = torch.where(alg == 1, eff, torch.ones_like(eff))
    rate = torch.where(lim > 0, eff_l // lim.clamp(min=1), eff_l)
    req = torch.stack([
        key, _i32(batch.hits.to(i64)), _i32(lim), batch.duration.to(i64),
        eff, batch.greg_end.to(i64), now_col, _i32(batch.behavior.to(i64)),
        alg, batch.hits.to(i64) * eff_l, batch.burst.to(i64) * eff_l,
        lim * eff_l, _i32(rate), TD_BOUND // lim.clamp(min=1)])

    live = valid.nonzero().squeeze(1)
    sb, perm = torch.sort(key[live] & (n_buckets - 1), stable=True)
    order = live[perm]
    seg_bucket, seg_len = torch.unique_consecutive(sb, return_counts=True)
    seg_start = torch.cumsum(seg_len, 0) - seg_len
    # longest chains first: they bound the wave's serial depth
    seg_len, p = torch.sort(seg_len, descending=True, stable=True)
    return _Plan(req.contiguous(), valid, order, seg_bucket[p].contiguous(),
                 seg_start[p].contiguous(), seg_len.contiguous())


def _finish(plan: _Plan, out: torch.Tensor) -> StepOutput:
    """Raw kernel outputs → StepOutput: invalid and bucket-full rows
    zeroed, over-limit and insert counters."""
    flags = out[O_FLAGS]
    err = (flags & 1) != 0
    live = plan.valid & ~err
    zero = torch.zeros_like(flags)
    status = torch.where(live, out[O_STATUS], zero)
    return StepOutput(
        status=status.to(torch.int32),
        remaining=torch.where(live, out[O_REM], zero),
        reset_time=torch.where(live, out[O_RESET], zero),
        limit=torch.where(live, out[O_LIMIT], zero),
        err=plan.valid & err,
        over_count=(live & (status == 1)).sum(dtype=torch.int64),
        insert_count=((flags >> 1) & 1).sum(dtype=torch.int64))


# ---- the plain version --------------------------------------------------

def _transition(w: torch.Tensor, q: torch.Tensor):
    """Apply one request to each of A bucket copies.

    w: [A, SLOTS, WORDS] int32 bucket images; q: [N_REQ, A] int64.
    Returns (new images, [N_OUT, A] int64 raw outputs).  The same
    arithmetic as csrc/decide.cu › apply, written as tensor ops."""
    i64 = torch.int64
    A = w.shape[0]
    dev = w.device
    ar = torch.arange(A, device=dev)
    key, hits, r_lim = q[R_KEY], q[R_HITS], q[R_LIMIT]
    r_dur, r_eff, r_greg, now0 = q[R_DUR], q[R_EFF], q[R_GREG], q[R_NOW]
    beh, r_alg = q[R_BEH], q[R_ALG]
    khi, klo = split64(key)

    kw_lo, kw_hi = w[:, :, W_KLO], w[:, :, W_KHI]
    match = (kw_lo == klo[:, None]) & (kw_hi == khi[:, None])
    found = match.any(1)
    empty = (kw_lo == 0) & (kw_hi == 0)
    iota = torch.arange(SLOTS, device=dev)
    first_empty = torch.where(empty, iota, SLOTS).amin(1)
    has_empty = first_empty < SLOTS
    insert = ~found & has_empty
    err = ~found & ~has_empty
    slot = torch.where(found, match.to(torch.int8).argmax(1),
                       first_empty.clamp(max=SLOTS - 1))
    cur = w[ar, slot]  # [A, WORDS] the matched / claimed slot
    it = torch.where(err[:, None], torch.zeros_like(cur), cur).to(i64)

    def word64(whi, wlo):
        return join64(it[:, whi], it[:, wlo])

    it_rem, it_status, it_limit = it[:, W_REM], it[:, W_STATUS], it[:, W_LIMIT]
    it_alg = it[:, W_ALG]
    it_t, it_x = word64(W_THI, W_TLO), word64(W_XHI, W_XLO)
    it_eff, it_dur = word64(W_EHI, W_ELO), word64(W_DHI, W_DLO)
    it_td = word64(W_TDHI, W_TDLO)

    is_greg = (beh & _GREG) != 0
    reset = (beh & _RESET) != 0
    drain = (beh & _DRAIN) != 0
    is_query = hits == 0
    zero = torch.zeros_like(key)

    now1 = torch.maximum(now0, it_t)  # per-key monotonic clock
    fresh0 = ~found | (now1 >= it_x) | (it_alg != r_alg)

    # ---- TOKEN_BUCKET
    dur_change = ~fresh0 & (r_dur != it_dur)
    ne = torch.where(is_greg, r_greg, it_t + r_eff)
    x1 = torch.where(dur_change, ne, it_x)
    fresh = fresh0 | (dur_change & (now1 >= x1))
    xf = torch.where(is_greg, r_greg, now1 + r_eff)
    limit0 = torch.where(fresh, r_lim, it_limit)
    rem0 = torch.where(fresh, r_lim, it_rem)
    t_tok = torch.where(fresh, now1, it_t)
    x_tok = torch.where(fresh, xf, x1)
    status0 = torch.where(fresh, zero, it_status)
    e_tok = torch.where(fresh | dur_change, r_eff, it_eff)
    reset_live = reset & ~fresh
    rem0 = torch.where(reset_live, r_lim, rem0)
    status0 = torch.where(reset_live, zero, status0)
    limit_ar = torch.where(reset_live, r_lim, limit0)
    rem_adj = torch.minimum((rem0 + r_lim - limit_ar).clamp(min=0), r_lim)
    rem0 = torch.where(r_lim != limit_ar, rem_adj, rem0)
    ok = hits <= rem0
    rem_tok = torch.where(~is_query & ok, rem0 - hits, rem0)
    rem_tok = torch.where(~is_query & ~ok & drain, zero, rem_tok)
    st_tok = torch.where(is_query, status0,
                         torch.where(ok, zero, torch.ones_like(zero)))

    # ---- LEAKY_BUCKET (td = remaining × eff fixed point)
    r_htd, r_cap, r_rst = q[R_HTD], q[R_CAP], q[R_RST]
    r_rate, r_gd = q[R_RATE], q[R_GD]
    eff_change = ~fresh0 & (r_eff != it_eff)
    d_old = it_eff.clamp(min=1)
    whole, fracr = it_td // d_old, it_td % d_old
    resc = whole * r_eff + (fracr * r_eff) // d_old
    td0 = torch.where(eff_change, resc, it_td)
    td0 = torch.where(fresh0, r_cap, td0)
    status0 = torch.where(fresh0, zero, it_status)
    t0 = torch.where(fresh0, now1, it_t)
    reset_live = reset & ~fresh0
    td0 = torch.where(reset_live, r_rst, td0)
    status0 = torch.where(reset_live, zero, status0)
    el = now1 - t0
    over_g = el > r_gd
    ad = torch.where(over_g, r_gd, el) * r_lim
    s = td0 + ad
    rp = torch.where(over_g | (s >= r_cap), r_cap, s)
    ok = rp >= r_htd
    td2 = torch.where(~is_query & ok, rp - r_htd, rp)
    td2 = torch.where(~is_query & ~ok & drain, zero, td2)
    st_lk = torch.where(is_query, status0,
                        torch.where(ok, zero, torch.ones_like(zero)))
    rem_lk = td2 // r_eff.clamp(min=1)
    x_lk = now1 + r_eff
    rs_lk = now1 + r_rate

    # ---- write the slot back (unless the bucket was full)
    is_tok, is_lk = r_alg == 0, r_alg == 1
    fields = {
        W_KLO: klo, W_KHI: khi,
        W_REM: torch.where(is_tok, rem_tok, zero),
        W_STATUS: torch.where(is_tok, st_tok, st_lk),
        W_LIMIT: r_lim,
    }
    for (whi, wlo), tok, lk in (((W_THI, W_TLO), t_tok, now1),
                                ((W_XHI, W_XLO), x_tok, x_lk),
                                ((W_EHI, W_ELO), e_tok, r_eff),
                                ((W_DHI, W_DLO), r_dur, r_dur),
                                ((W_TDHI, W_TDLO), zero, td2)):
        hi, lo = split64(torch.where(is_tok, tok, lk))
        fields[whi], fields[wlo] = hi, lo
    fields[W_ALG] = torch.where(is_tok, zero, torch.ones_like(zero))
    new = cur.clone()
    for word, v in fields.items():
        new[:, word] = v.to(torch.int32)
    write = ~err & (is_tok | is_lk)
    w = w.clone()
    w[ar, slot] = torch.where(write[:, None], new, cur)

    dead = err
    out = torch.stack([
        torch.where(is_tok, st_tok, torch.where(is_lk, st_lk, zero)),
        torch.where(is_tok, rem_tok, torch.where(is_lk, rem_lk, zero)),
        torch.where(is_tok, x_tok, torch.where(is_lk, rs_lk, zero)),
        r_lim,
        torch.where(err, torch.ones_like(zero),
                    torch.where(insert, torch.full_like(zero, 2), zero)),
    ])
    out[:4] = torch.where(dead[None, :], torch.zeros_like(out[:4]), out[:4])
    return w, out


def decide_plain(rows: torch.Tensor, batch: RequestBatch, now
                 ) -> StepOutput:
    """The plain PyTorch version of K1: updates ``rows`` in place.

    Gathers every touched bucket once, then round j applies the j-th
    request of every segment at once (segments are sorted longest
    first, so round j works on a prefix), and scatters the buckets
    back."""
    plan = _plan(rows, batch, now)
    B = plan.req.shape[1]
    out = torch.zeros((N_OUT, B), dtype=torch.int64, device=rows.device)
    S = plan.seg_bucket.shape[0]
    if S:
        view = rows.view(-1, SLOTS, WORDS)
        w = view[plan.seg_bucket]
        lens = plan.seg_len.cpu().numpy()
        # active[j] = segments longer than j (a prefix: longest first)
        active = np.cumsum(np.bincount(lens, minlength=int(lens[0]) + 1)
                           [::-1])[::-1][1:]
        for j in range(int(lens[0])):
            k = int(active[j])
            r = plan.order[plan.seg_start[:k] + j]
            w_k, o = _transition(w[:k], plan.req[:, r])
            w[:k] = w_k
            out[:, r] = o
        view[plan.seg_bucket] = w
    return _finish(plan, out)


# ---- K1 -----------------------------------------------------------------

def decide_cuda(rows: torch.Tensor, batch: RequestBatch, now,
                hot: int = HOT_SEGMENT, stats: torch.Tensor | None = None
                ) -> StepOutput:
    """Launch K1 (csrc/decide.cu) on the current stream: updates ``rows``
    in place.  Segments longer than ``hot`` go to a block each.  Serving
    always passes ``HOT_SEGMENT``; other values are a seam for the tests
    (0: every segment on the block path) and for ``chip_ab.py``'s
    threshold sweep.  ``stats``, if given, is a CUDA int64 tensor of
    len(K1_STATS) counters that the launch adds to.  Raises on a refused
    launch; never falls back."""
    from .build import load_library

    if rows.device.type != "cuda":
        raise ValueError("decide_cuda takes a CUDA table")
    if rows.dtype != torch.int32 or rows.dim() != 2 \
            or rows.shape[1] != WORDS or not rows.is_contiguous():
        raise ValueError("table must be a contiguous [CAP, 32] int32 tensor")
    if any(c.device != rows.device for c in batch if c is not None):
        raise ValueError("batch columns must lie on the table's device")
    if hot < 0:
        raise ValueError("hot must be >= 0")
    if stats is not None and (stats.device != rows.device
                              or stats.dtype != torch.int64
                              or stats.shape != (len(K1_STATS),)
                              or not stats.is_contiguous()):
        raise ValueError(f"stats must be a contiguous int64 "
                         f"[{len(K1_STATS)}] tensor on the table's device")
    lib = load_library()
    plan = _plan(rows, batch, now)
    B = plan.req.shape[1]
    out = torch.zeros((N_OUT, B), dtype=torch.int64, device=rows.device)
    S = plan.seg_bucket.shape[0]
    if S:
        with torch.cuda.device(rows.device):
            rc = lib.guber_decide(
                rows.data_ptr(), plan.req.data_ptr(), plan.order.data_ptr(),
                plan.seg_bucket.data_ptr(), plan.seg_start.data_ptr(),
                plan.seg_len.data_ptr(), S, B, hot,
                None if stats is None else stats.data_ptr(), out.data_ptr(),
                torch.cuda.current_stream(rows.device).cuda_stream)
        if rc < 0:
            raise RuntimeError(
                f"K1 launch refused: {lib.guber_decide_smem()} B of dynamic "
                f"shared memory per hot block were not granted "
                f"(CUDA error {-rc}: {lib.guber_error_string(-rc).decode()})")
        if rc != 0:
            raise RuntimeError(f"K1 launch failed: CUDA error {rc} "
                               f"({lib.guber_error_string(rc).decode()})")
        decide_cuda.launches += 1
    return _finish(plan, out)


#: K1 launches since the last reset (chip_smoke.py proves the main path
#: went through the kernel with it)
decide_cuda.launches = 0


def decide(rows: torch.Tensor, batch: RequestBatch, now) -> StepOutput:
    """The decision step: the plain version for a CPU table, K1 for a
    CUDA table."""
    if rows.device.type == "cuda":
        return decide_cuda(rows, batch, now)
    if rows.device.type == "cpu":
        return decide_plain(rows, batch, now)
    raise ValueError(f"no decision step for device {rows.device}")


def fused_tap_columns(batch: RequestBatch, out: StepOutput) -> torch.Tensor:
    """[4, B] int64 heavy-hitter tap from the same step: (khash bit-
    viewed i64, hits, over_limit, served).  ``served`` gates padding,
    invalid and bucket-full rows out."""
    served = batch.valid.to(torch.bool) & ~out.err
    return torch.stack([batch.key.to(torch.int64),
                        batch.hits.to(torch.int64),
                        (out.status == 1).to(torch.int64),
                        served.to(torch.int64)])
