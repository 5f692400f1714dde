"""The SoA decision step: one wave of requests against the SoA table.

The counterpart of gubernator_tpu/core/step.py › decide_batch_impl, in
plain PyTorch.  The JAX step is plain XLA, not a Pallas kernel, so this
is the port of it, not a stand-in for a kernel.  It updates the table
in place (the JAX step returns a new one) and equals the JAX step bit
for bit: outputs, counters and all nine columns.

Hash-probe the key column → rows (claiming slots for misses), sort the
requests into per-row segments ordered by (row, now, index), then apply
each segment serially-equivalently: the head of every segment at once;
the closed form for uniform tails; the speculative associative scan for
uniform LEAKY tails with mixed arrival times; a loop over in-segment
positions, vectorized across segments, for everything else.  Write the
final per-segment state back and return the outputs in request order.

Three parts of the JAX step are not ported, because each is a way to
lower the step on a TPU or a JAX test hook and none changes a result:
the K-split scatter (``_scatter_rows`` with GUBER_KSPLIT), the cold-
column ``lax.cond`` (this step writes every column of the touched rows
in place, so there is no copy to save) and the scatter-invariant hooks.
``lax.cond`` becomes a Python ``if`` on a device scalar (either branch
gives the same result) and ``lax.while_loop`` a Python loop.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import torch

from ..types import FRAC_SAFE, TD_BOUND, Algorithm, Behavior
from .table import TableState

#: probe window per lookup (GUBER_PROBES overrides, as in the JAX step,
#: so both packages agree under one environment)
PROBES = int(os.environ.get("GUBER_PROBES", "8"))
INSERT_ROUNDS = 4  # slot-claim rounds per batch

_RESET = int(Behavior.RESET_REMAINING)
_DRAIN = int(Behavior.DRAIN_OVER_LIMIT)
_GREG = int(Behavior.DURATION_IS_GREGORIAN)
_LEAKY = int(Algorithm.LEAKY_BUCKET)

_I64 = torch.int64
_I64_MAX = torch.iinfo(torch.int64).max
#: bits kept of ``key >> 17``: a logical shift of the uint64 hash
_STRIDE_MASK = (1 << 47) - 1


class StepOutput(NamedTuple):
    """Per-request results in request order."""

    status: torch.Tensor  # int32 [B]
    remaining: torch.Tensor  # int64 [B]
    reset_time: torch.Tensor  # int64 [B]
    limit: torch.Tensor  # int64 [B]
    err: torch.Tensor  # bool [B]: table full (probe window exhausted)
    over_count: torch.Tensor  # int64 scalar
    insert_count: torch.Tensor  # int64 scalar


class _Item(NamedTuple):
    """Per-segment item state carried through in-segment positions."""

    alg: torch.Tensor
    status: torch.Tensor
    limit: torch.Tensor
    duration: torch.Tensor
    eff: torch.Tensor
    burst: torch.Tensor
    rem: torch.Tensor
    t: torch.Tensor
    exp: torch.Tensor


class _Req(NamedTuple):
    """One request's fields, vectorized across segments (all int64)."""

    hits: torch.Tensor
    limit: torch.Tensor
    duration: torch.Tensor
    eff: torch.Tensor
    greg_end: torch.Tensor
    behavior: torch.Tensor
    alg: torch.Tensor
    burst: torch.Tensor
    now: torch.Tensor


def _where(mask, a, b):
    """Field-wise select between two NamedTuples of the same kind."""
    return type(a)(*[torch.where(mask, x, y) for x, y in zip(a, b)])


def _first_true(m: torch.Tensor) -> torch.Tensor:
    """Index of the first True per row (0 when none), as jnp.argmax."""
    return m.to(torch.uint8).argmax(1)


def _probe_slots(key: torch.Tensor, cap: int) -> torch.Tensor:
    """[B, PROBES] int64 probe sequence (double hashing, odd stride).

    The JAX step computes ``(key + p * ((key >> 17) | 1)) & (cap - 1)``
    on uint64 with wrap.  On the int64 bit-view, ``>>`` is arithmetic and
    signed overflow is undefined, so the stride keeps the 47 bits a
    logical shift leaves and the sum is taken modulo ``cap``: only the
    low log2(cap) bits of a slot matter, so the slots are the same."""
    m = cap - 1
    stride = ((key >> 17) & _STRIDE_MASK) | 1
    p = torch.arange(PROBES, dtype=_I64, device=key.device)
    return ((key & m)[:, None] + ((p[None, :] * stride[:, None]) & m)) & m


def _lookup(tkey: torch.Tensor, slots: torch.Tensor, key: torch.Tensor):
    """(row int64[B] or -1, keys_at [B, P]): the first probe slot
    holding the key."""
    keys_at = tkey[slots]
    match = keys_at == key[:, None]
    row = slots.gather(1, _first_true(match)[:, None])[:, 0]
    return torch.where(match.any(1), row, -1), keys_at


def _insert(tkey: torch.Tensor, slots: torch.Tensor, key: torch.Tensor,
            valid: torch.Tensor, row: torch.Tensor):
    """Claim first-empty probe slots for missing keys, deterministically;
    writes the claimed keys into ``tkey`` in place.  Returns (row,
    claimed count).

    Per round: resolve matches (covers same-key losers of earlier
    rounds), pick each active miss's first empty slot, dedupe claims by
    slot (stable sort: the lowest request index wins), write winners."""
    cap = tkey.shape[0]
    B = key.shape[0]
    n_claimed = torch.zeros((), dtype=_I64, device=key.device)
    first = torch.ones(B, dtype=torch.bool, device=key.device)
    for _ in range(INSERT_ROUNDS):
        keys_at = tkey[slots]
        match = keys_at == key[:, None]
        frow = slots.gather(1, _first_true(match)[:, None])[:, 0]
        row = torch.where((row < 0) & valid & match.any(1), frow, row)

        active = valid & (row < 0)
        empty = keys_at == 0
        cand = slots.gather(1, _first_true(empty)[:, None])[:, 0]
        cand_eff = torch.where(active & empty.any(1), cand, cap)
        c_s, order = torch.sort(cand_eff, stable=True)
        first[1:] = c_s[1:] != c_s[:-1]
        winner = torch.empty_like(first)
        winner[order] = first & (c_s < cap)
        # winning slots are distinct: one writer per slot
        tkey[cand[winner]] = key[winner]
        row = torch.where(winner, cand, row)
        n_claimed = n_claimed + winner.sum()

    # final resolve for same-key losers of the last round
    keys_at = tkey[slots]
    match = keys_at == key[:, None]
    frow = slots.gather(1, _first_true(match)[:, None])[:, 0]
    row = torch.where((row < 0) & valid & match.any(1), frow, row)
    return row, n_claimed


def _apply_position(item: _Item, req: _Req):
    """One request applied to its item: the full transition, vectorized
    across segments, at the request's own arrival time, clamped per key
    never to run backward.  The same operations, in the same order, as
    the JAX step's ``_apply_position``."""
    zero = torch.zeros_like(req.hits)
    one = torch.ones_like(req.hits)
    now = torch.maximum(req.now, item.t)
    is_leaky = req.alg == _LEAKY
    is_greg = (req.behavior & _GREG) != 0
    reset = (req.behavior & _RESET) != 0
    drain = (req.behavior & _DRAIN) != 0

    # fresh: missing / expired / algorithm switch; a token duration
    # change recomputes the expiry from created_at
    fresh = (now >= item.exp) | (item.alg != req.alg)
    tok_dur_change = (~is_leaky) & (~fresh) & (req.duration != item.duration)
    new_exp_tok = torch.where(is_greg, req.greg_end, item.t + req.eff)
    exp1 = torch.where(tok_dur_change, new_exp_tok, item.exp)
    fresh = fresh | (tok_dur_change & (exp1 <= now))

    # adopt fresh or existing state; leaky td products multiply by eff
    # only on leaky rows, so a token value near VALUE_MAX cannot wrap
    eff_l = torch.where(is_leaky, req.eff, one)
    tok_exp_fresh = torch.where(is_greg, req.greg_end, now + req.eff)
    rem_fresh = torch.where(is_leaky, req.burst, req.limit) * eff_l
    limit0 = torch.where(fresh, req.limit, item.limit)
    eff0 = torch.where(fresh, req.eff, item.eff)
    rem0 = torch.where(fresh, rem_fresh, item.rem)
    t0 = torch.where(fresh, now, item.t)
    exp0 = torch.where(fresh, torch.where(is_leaky, now + req.eff,
                                          tok_exp_fresh), exp1)
    status0 = torch.where(fresh, zero, item.status)

    # leaky denominator change: rescale the td fixed point
    leaky_eff_change = is_leaky & (~fresh) & (req.eff != eff0)
    d0 = eff0.clamp(min=1)
    whole = torch.minimum(rem0 // d0, TD_BOUND // req.eff.clamp(min=1))
    frac = rem0 % d0
    frac_ok = (eff0 <= FRAC_SAFE) & (req.eff <= FRAC_SAFE)
    frac_term = (torch.where(frac_ok, frac, zero) * req.eff) // d0
    rem0 = torch.where(leaky_eff_change, whole * req.eff + frac_term, rem0)
    eff0 = torch.where(is_leaky, req.eff,
                       torch.where(tok_dur_change, req.eff, eff0))

    # RESET_REMAINING (existing items only)
    reset_live = reset & (~fresh)
    rem0 = torch.where(reset_live, req.limit * eff_l, rem0)
    status0 = torch.where(reset_live, zero, status0)
    limit_after_reset = torch.where(reset_live & (~is_leaky), req.limit,
                                    limit0)

    # token limit change in place
    tok_lim_change = (~is_leaky) & (req.limit != limit_after_reset)
    rem_adj = torch.minimum((rem0 + req.limit - limit_after_reset)
                            .clamp(min=0), req.limit)
    rem0 = torch.where(tok_lim_change, rem_adj, rem0)
    limit1 = req.limit

    # leaky replenish: elapsed × limit td, clamped to burst (exact guard)
    burst1 = torch.where(is_leaky, req.burst, limit1)
    elapsed = now - t0
    cap_td = burst1 * torch.where(is_leaky, eff0, zero)
    safe_el = TD_BOUND // limit1.clamp(min=1)
    rem_rep = torch.where(
        elapsed > safe_el, cap_td,
        torch.minimum(rem0 + torch.minimum(elapsed, safe_el) * limit1,
                      cap_td))
    rem0 = torch.where(is_leaky, rem_rep, rem0)
    t1 = torch.where(is_leaky, now, t0)

    rate = torch.where(limit1 > 0, eff0 // limit1.clamp(min=1), eff0)
    exp_out = torch.where(is_leaky, now + eff0, exp0)
    reset_time = torch.where(is_leaky, now + rate, exp_out)

    # hits
    cost = req.hits * torch.where(is_leaky, eff0, one)
    is_query = req.hits == 0
    ok = cost <= rem0
    rem2 = torch.where((~is_query) & ok, rem0 - cost, rem0)
    rem2 = torch.where((~is_query) & (~ok) & drain, zero, rem2)
    status1 = torch.where(is_query, status0, torch.where(ok, zero, one))

    out_rem = torch.where(is_leaky, rem2 // eff0.clamp(min=1), rem2)
    new_item = _Item(alg=req.alg, status=status1, limit=limit1,
                     duration=req.duration, eff=eff0, burst=burst1,
                     rem=rem2, t=t1, exp=exp_out)
    return new_item, (status1, out_rem, reset_time, limit1)


def _associative_scan(fn, elems):
    """Inclusive scan of ``elems`` (a list of [n] tensors) under the
    combine ``fn(left, right)``, with the same tree as
    jax.lax.associative_scan: pairs are combined, the half-length result
    is scanned recursively, and the even positions are filled in.  The
    leaky combine clamps at -2^62, where it is not associative, so the
    tree is kept exactly."""
    n = elems[0].shape[0]
    if n < 2:
        return elems
    reduced = fn([e[0:-1:2] for e in elems], [e[1::2] for e in elems])
    odd = _associative_scan(fn, reduced)
    if n % 2 == 0:
        even = fn([e[:-1] for e in odd], [e[2::2] for e in elems])
    else:
        even = fn(odd, [e[2::2] for e in elems])
    out = []
    for e, ev, od in zip(elems, even, odd):
        r = torch.empty_like(e)
        r[0] = e[0]
        r[2::2] = ev
        r[1::2] = od
        out.append(r)
    return out


def decide_batch(state: TableState, batch, now) -> StepOutput:
    """Apply one request wave to the SoA table, in place; returns the
    outputs in request order.

    ``batch`` is a RequestBatch of tensors on the table's device (key as
    the int64 bit-view, core/batch.py › PACK64/PACK32); ``now`` the
    scalar epoch ms that backs rows whose own ``now`` is 0."""
    cap = state.key.shape[0]
    dev = state.key.device
    key = batch.key.to(_I64)
    B = key.shape[0]
    zB = torch.zeros(B, dtype=_I64, device=dev)
    arangeB = torch.arange(B, dtype=_I64, device=dev)
    now = int(now)
    valid = batch.valid.to(torch.bool) & (key != 0)
    if batch.now is None:
        now_col = torch.full((B,), now, dtype=_I64, device=dev)
    else:
        bn = batch.now.to(_I64)
        now_col = torch.where(bn > 0, bn, now)

    # ---- probe / insert -------------------------------------------------
    slots = _probe_slots(key, cap)
    row, _ = _lookup(state.key, slots, key)
    row = torch.where(valid & (row >= 0), row, -1)
    miss = valid & (row < 0)
    if bool(miss.any()):
        row, insert_count = _insert(state.key, slots, key, valid, row)
    else:
        insert_count = torch.zeros((), dtype=_I64, device=dev)
    err = valid & (row < 0)  # probe window exhausted: table overfull
    row = torch.where(valid & (row >= 0), row, cap)  # cap: dropped

    # ---- sort into segments ordered by (row, now, index) ---------------
    if bool((now_col == now_col[0]).all()):
        _, perm = torch.sort(row, stable=True)
    else:
        _, p0 = torch.sort(now_col, stable=True)
        _, p1 = torch.sort(row[p0], stable=True)
        perm = p0[p1]
    r_s = row[perm]
    head = torch.ones(B, dtype=torch.bool, device=dev)
    head[1:] = r_s[1:] != r_s[:-1]
    seg_id = torch.cumsum(head, 0) - 1

    def seg_min(x):
        out = torch.full((B,), torch.iinfo(x.dtype).max, dtype=x.dtype,
                         device=dev)
        return out.scatter_reduce_(0, seg_id, x, "amin")

    def seg_max(x):
        out = torch.full((B,), torch.iinfo(x.dtype).min, dtype=x.dtype,
                         device=dev)
        return out.scatter_reduce_(0, seg_id, x, "amax")

    seg_start = seg_min(arangeB)
    seg_len = torch.zeros(B, dtype=_I64, device=dev).index_add_(
        0, seg_id, torch.ones(B, dtype=_I64, device=dev))
    seg_row = seg_min(r_s)
    exists = (seg_len > 0) & (seg_row < cap)

    sf = _Req(hits=batch.hits.to(_I64)[perm], limit=batch.limit.to(_I64)[perm],
              duration=batch.duration.to(_I64)[perm],
              eff=batch.eff_ms.to(_I64)[perm],
              greg_end=batch.greg_end.to(_I64)[perm],
              behavior=batch.behavior.to(_I64)[perm],
              alg=batch.algorithm.to(_I64)[perm],
              burst=batch.burst.to(_I64)[perm], now=now_col[perm])

    def uni(x):
        return seg_max(x) == seg_min(x)

    uniform_cfg = (uni(sf.hits) & uni(sf.limit) & uni(sf.duration)
                   & uni(sf.eff) & uni(sf.behavior) & uni(sf.alg)
                   & uni(sf.burst))
    uni_now = uni(sf.now)
    any_flag = seg_max(sf.behavior & (_RESET | _DRAIN)) > 0

    # ---- gather item state per segment ---------------------------------
    grow = torch.where(exists, seg_row, 0)

    def gcol(col, fill=0):
        return torch.where(exists, col[grow].to(_I64), fill)

    meta0 = gcol(state.meta)
    item0 = _Item(alg=meta0 & 1, status=(meta0 >> 1) & 1,
                  limit=gcol(state.limit), duration=gcol(state.duration),
                  eff=gcol(state.eff_ms, 1), burst=gcol(state.burst),
                  rem=gcol(state.remaining), t=gcol(state.t_ms),
                  exp=gcol(state.expire_at))
    idx0 = torch.where(exists, seg_start, 0)
    req0 = _Req(*[torch.where(exists, f[idx0], zB) for f in sf])

    item1, out0 = _apply_position(item0, req0)
    item1 = _where(exists, item1, item0)

    # ---- simple tails: closed form -------------------------------------
    is_leaky0 = req0.alg == _LEAKY
    time_safe = uni_now | ((~is_leaky0) & (seg_max(sf.now) < item1.exp))
    simple = exists & uniform_cfg & time_safe & (~any_flag)
    complex_seg = exists & (seg_len > 1) & (~simple)
    cost0 = req0.hits * torch.where(is_leaky0, item1.eff, 1)
    k_raw = torch.where(cost0 > 0, item1.rem // cost0.clamp(min=1),
                        _I64_MAX)
    tail_n = (seg_len - 1).clamp(min=0)
    k = torch.minimum(k_raw, tail_n)  # accepted tail requests
    s_rem_final = item1.rem - k * cost0.clamp(min=0)
    s_status_final = torch.where(cost0 > 0, (tail_n > k_raw).to(_I64),
                                 item1.status)
    simple_tail_seg = simple & (seg_len > 1)
    item_final = item1._replace(
        status=torch.where(simple_tail_seg, s_status_final, item1.status),
        rem=torch.where(simple_tail_seg, s_rem_final, item1.rem))

    sid = seg_id
    pos = arangeB - seg_start[sid]
    t_status = torch.where(cost0[sid] > 0, (pos > k_raw[sid]).to(_I64),
                           item1.status[sid])
    t_rem = item1.rem[sid] - torch.minimum(pos, k[sid]) \
        * cost0[sid].clamp(min=0)
    t_rem_out = torch.where(is_leaky0[sid],
                            t_rem // item1.eff[sid].clamp(min=1), t_rem)
    tail_mask = simple[sid] & (pos > 0)

    # sorted-order outputs: heads, then simple tails
    head_w = head & exists[sid]
    o_status = torch.where(head_w, out0[0][sid], 0)
    o_rem = torch.where(head_w, out0[1][sid], 0)
    o_reset = torch.where(head_w, out0[2][sid], 0)
    o_limit = torch.where(head_w, out0[3][sid], 0)
    o_status = torch.where(tail_mask, t_status, o_status)
    o_rem = torch.where(tail_mask, t_rem_out, o_rem)
    o_reset = torch.where(tail_mask, out0[2][sid], o_reset)
    o_limit = torch.where(tail_mask, out0[3][sid], o_limit)

    # ---- leaky mixed-time tails: speculative associative scan ----------
    # Each allowed tail position is the map x -> min(m, x + b); the maps
    # compose closedly, so a segmented scan gives every prefix.  The
    # speculation holds iff no position went negative (nothing denied);
    # segments where it fails take the loop below.
    lseg = (exists & uniform_cfg & (~any_flag) & is_leaky0 & (~uni_now)
            & (seg_len > 1))
    if bool(lseg.any()):
        INF = 1 << 62
        LOWC = -(1 << 62)
        now_s = sf.now
        T = item1.t[sid]  # the head's post-apply clock, per position
        e = torch.maximum(now_s, T)
        now_prev = torch.cat([now_s[:1], now_s[:-1]])
        e_prev = torch.where(pos > 0, torch.maximum(now_prev, T), T)
        d = (e - e_prev).clamp(min=0)
        L = sf.limit
        effp = sf.eff.clamp(min=1)
        lpos = lseg[sid]
        c = sf.hits * torch.where(lpos, effp, 1)
        cap_td = sf.burst * torch.where(lpos, effp, 1)
        safe_el = TD_BOUND // L.clamp(min=1)
        tail_sel = lpos & (pos > 0)
        m_el = torch.where(tail_sel, cap_td - c, INF)
        # d >= eff crosses the expiry: the bucket goes fresh (cap_td);
        # d > safe_el is the int64 overflow guard (the same arm)
        b_raw = torch.where((d >= effp) | (d > safe_el), cap_td - c,
                            torch.minimum(d, safe_el) * L - c)
        b_el = torch.where(tail_sel, b_raw.clamp(min=LOWC), 0)
        flag = pos == 1  # segment start, for the segmented combine

        def comb(lft, rgt):
            ml, bl, fl = lft
            mr, br, fr = rgt
            m = torch.minimum(mr, ml + br)
            b = torch.minimum((bl + br).clamp(min=LOWC), m)
            return [torch.where(fr, mr, m), torch.where(fr, br, b), fl | fr]

        M, Bc, _ = _associative_scan(comb, [m_el, b_el, flag])
        r = torch.minimum(M, item1.rem[sid] + Bc)
        min_r = seg_min(torch.where(tail_sel, r, _I64_MAX))
        ok_seg = lseg & (min_r >= 0)

        is_query = c == 0
        cs = torch.cumsum((tail_sel & (d >= effp)).to(_I64), 0)
        crossed = (cs - cs[seg_start[sid]]) > 0  # expiry crossed by here
        st_pos = torch.where(is_query, torch.where(crossed, 0,
                                                   item1.status[sid]), 0)
        rate = torch.where(L > 0, effp // L.clamp(min=1), effp)
        ap = ok_seg[sid] & tail_sel
        o_status = torch.where(ap, st_pos, o_status)
        o_rem = torch.where(ap, r // effp, o_rem)
        o_reset = torch.where(ap, e + rate, o_reset)
        o_limit = torch.where(ap, L, o_limit)

        # per-segment final item from the last tail position
        idxL = torch.where(ok_seg, seg_start + seg_len - 1, 0)
        last_e = e[idxL]
        item_scan = item1._replace(status=st_pos[idxL], rem=r[idxL],
                                   t=last_e, exp=last_e + item1.eff)
        item_final = _where(ok_seg, item_scan, item_final)
        complex_seg = complex_seg & (~ok_seg)

    # ---- complex tails: a loop over in-segment positions ----------------
    # only the complex segments take part; each step is the full
    # transition vectorized across them
    cidx = complex_seg.nonzero().squeeze(1)
    if cidx.numel():
        c_len = seg_len[cidx]
        c_start = seg_start[cidx]
        item = _Item(*[f[cidx] for f in item_final])
        for j in range(1, int(c_len.max())):
            m = j < c_len
            at = torch.where(m, c_start + j, 0)
            reqj = _Req(*[f[at] for f in sf])
            item2, outj = _apply_position(item, reqj)
            item = _where(m, item2, item)
            w = at[m]
            o_status[w] = outj[0][m]
            o_rem[w] = outj[1][m]
            o_reset[w] = outj[2][m]
            o_limit[w] = outj[3][m]
        item_final = _Item(*[f.index_put((cidx,), v)
                             for f, v in zip(item_final, item)])

    # ---- write back per-segment final state (one writer per row) -------
    wseg = exists.nonzero().squeeze(1)
    wrow = seg_row[wseg]
    fin = _Item(*[f[wseg] for f in item_final])
    state.meta[wrow] = ((fin.alg & 1) | ((fin.status & 1) << 1)).to(
        state.meta.dtype)
    state.limit[wrow] = fin.limit
    state.duration[wrow] = fin.duration
    state.eff_ms[wrow] = fin.eff
    state.burst[wrow] = fin.burst
    state.remaining[wrow] = fin.rem
    state.t_ms[wrow] = fin.t
    state.expire_at[wrow] = fin.exp

    # ---- back to request order -----------------------------------------
    inv = torch.empty_like(perm)
    inv[perm] = arangeB
    served = valid & (~err)
    status = torch.where(served, o_status[inv], 0)
    return StepOutput(
        status=status.to(torch.int32),
        remaining=torch.where(served, o_rem[inv], 0),
        reset_time=torch.where(served, o_reset[inv], 0),
        limit=torch.where(served, o_limit[inv], 0),
        err=err, over_count=(served & (status == 1)).sum(),
        insert_count=insert_count)
