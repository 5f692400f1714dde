"""The replicated hot set: GLOBAL rate limits answered from replicas and
folded once per sync tick (the port of gubernator_tpu/parallel/hotset.py).

A small table of pinned keys is held ``n`` times, one replica per
device (``[n, capacity]`` columns of core/table.py › TableState).  The
host pins a key to one slot, the same on every replica, routes requests
for it round-robin across the replicas, and on the sync tick folds every
replica's consumption into a new common base.  ``n`` stands where the
JAX mesh size stands: the instance passes its engine's device count (1
on one GPU); the tests pass 4 to hold the fold against a JAX mesh of
four.  The JAX ``psum`` is a sum over the replica axis here, ``pmax``
an amax; at n = 1 the fold changes nothing, as JAX elides it.

Scope (enforced by the instance): TOKEN_BUCKET or LEAKY_BUCKET keys
with a stable (algorithm, limit, duration, burst) and none of
RESET_REMAINING, DRAIN_OVER_LIMIT, Gregorian durations or MULTI_REGION.

Merge per slot, replicas starting equal at ``base``:

- TOKEN: a replica that re-created the bucket (``t != base.t``) counts
  its consumption from ``limit``, the others from ``base.rem``; the
  merged ``rem = clamp((limit if any refreshed else base.rem) - Σ d_i,
  0, limit)``.
- LEAKY: consumption is measured against the base replenished to each
  replica's own clock, ``rep(t) = min(base.rem + clamp(t - base.t) ×
  limit, burst × eff)``, ``d_i = max(rep(t_i) - rem_i, 0)``; merged at
  ``T = max t_i``: ``rem = clamp(rep(T) - Σ d_i, 0, burst × eff)``.

Between syncs the replicas together can admit up to (n - 1) × the
window's consumption beyond the limit: GLOBAL's documented window.

Each replica's step is core/step.py › decide_batch on its own sub-batch,
in place.  A wave is 2 uploads, n steps and 1 download.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .core.batch import (RequestBatch, clamp_config, empty_batch,
                         pack_requests, pack_wave_host)
from .core.step import PROBES, decide_batch
from .core.table import TableState, init_soa_table
from .ops.decide import batch_from_packed
from .sharded import resolve_device
from .types import EFF_MAX, RateLimitRequest, RateLimitResponse, Status

_I64 = torch.int64


def _cfg_of(req: RateLimitRequest) -> tuple:
    """(alg, limit, duration, burst) as the packers clamp them: the
    pinned row must agree with every packed request that hits it, or the
    step would see a config change and reset the row."""
    return clamp_config(req.algorithm, req.limit, req.duration, req.burst,
                        req.behavior)


def hot_sync(state: TableState, base_rem: torch.Tensor,
             base_t: torch.Tensor):
    """The fold over the replica axis (dim 0) of ``[n, cap]`` columns:
    returns (remaining, t_ms, expire_at) for every replica; the caller
    writes them back and takes remaining / t_ms as the new base."""
    limit = state.limit
    brem, bt = base_rem, base_t
    is_leaky = (state.meta & 1) == 1
    # token: refresh detection, consumption against the (refreshed) base
    refreshed = (~is_leaky) & (state.t_ms != bt)
    any_refresh = refreshed.any(0, keepdim=True)
    start = torch.where(refreshed, limit, brem)
    d_tok = torch.clamp_min(start - state.remaining, 0)
    # leaky: consumption against the base replenished to the replica's
    # clock; elapsed is clamped so elapsed × limit cannot wrap, and eff
    # is masked to 1 on token rows (their eff may reach 2^53)
    eff = torch.clamp_min(torch.where(is_leaky, state.eff_ms, 1), 1)
    cap_td = state.burst * eff
    el_max = cap_td // torch.clamp_min(limit, 1) + 1

    def rep_at(t):
        el = torch.minimum(torch.clamp_min(t - bt, 0), el_max)
        return torch.minimum(brem + el * limit, cap_td)

    d_leaky = torch.clamp_min(rep_at(state.t_ms) - state.remaining, 0)
    d = torch.where(is_leaky, d_leaky, d_tok)
    total = d.sum(0, keepdim=True)
    new_t = state.t_ms.amax(0, keepdim=True)
    merged_base = torch.where(any_refresh, limit, brem)
    new_rem_tok = torch.minimum(torch.clamp_min(merged_base - total, 0),
                                limit)
    new_rem_leaky = torch.minimum(
        torch.clamp_min(rep_at(new_t) - total, 0), cap_td)
    new_rem = torch.where(is_leaky, new_rem_leaky, new_rem_tok)
    new_exp = state.expire_at.amax(0, keepdim=True)
    return new_rem, new_t.expand_as(new_rem), new_exp.expand_as(new_rem)


class HotSetEngine:
    """Host-managed replicated hot set of ``n`` replicas on ``device``.

    The host pins keys to fixed slots (the same on every replica, which
    open addressing cannot give divergent replicas), serves pinned
    GLOBAL requests round-robin across replicas, and folds them on
    ``sync()``."""

    def __init__(self, n: int = 1, capacity: int = 1024,
                 batch_per_chip: int = 512, device="cuda"):
        self.n = int(n)
        self.capacity = capacity
        self.B = batch_per_chip
        self.device = resolve_device(device)
        self.slots: Dict[int, int] = {}  # key hash → slot
        #: key hash → (alg, limit, duration, burst), see _cfg_of
        self.pinned_cfg: Dict[int, tuple] = {}
        #: demoted keys keep their slot reserved and their row in place:
        #: clearing the key would let an in-flight hot request insert a
        #: fresh bucket, and a re-pin at another probe slot would be
        #: shadowed by the stale row
        self._retired: Dict[int, int] = {}
        self._occupied: set = set()
        self._mu = threading.Lock()
        #: serializes every read-modify-write of the state (steps, the
        #: sync tick, pins): a fold computed from pre-step state would
        #: overwrite a concurrent step's consumption
        self._state_mu = threading.Lock()
        base = init_soa_table(capacity, self.device)
        self.state = TableState(*[c.unsqueeze(0).repeat(
            (self.n,) + (1,) * c.dim()) for c in base])
        self.base_rem = torch.zeros((self.n, capacity), dtype=_I64,
                                    device=self.device)
        self.base_t = torch.zeros((self.n, capacity), dtype=_I64,
                                  device=self.device)
        self._rr = 0  # round-robin cursor across replicas
        self.sync_count = 0

    # ---- host slot management ------------------------------------------

    def _probe_slots_host(self, key_hash: int) -> List[int]:
        """The key's probe sequence; must equal core/step.py ›
        _probe_slots, which the step looks keys up by (a key pinned
        outside its window would be invisible)."""
        k = int(key_hash) & ((1 << 64) - 1)
        stride = (k >> 17) | 1
        return [(k + p * stride) & (self.capacity - 1)
                for p in range(PROBES)]

    def pin(self, req: RateLimitRequest, key_hash: int, now_ms: int,
            seed: Optional[dict] = None) -> bool:
        """Give the key a slot on its probe path and initialize its
        bucket on every replica.  ``seed`` carries the key's row from the
        engine's table (``remaining``, ``t_ms``, ``expire_at``,
        ``meta``), so hits consumed before the promotion carry over;
        without it the bucket starts fresh.  False when the key's probe
        window is full."""
        with self._mu:
            if key_hash in self.slots:
                return True
            if key_hash in self._retired:
                slot = self._retired.pop(key_hash)  # its row is there
            else:
                probes = self._probe_slots_host(key_hash)
                slot = next((s for s in probes
                             if s not in self._occupied), None)
                if slot is None:
                    # reclaim a retired slot in the window: its key was
                    # demoted (its state moved out), or promote / demote
                    # churn would exhaust the capacity
                    retired_by_slot = {s: k for k, s in
                                       self._retired.items()}
                    slot = next((s for s in probes
                                 if s in retired_by_slot), None)
                    if slot is None:
                        return False
                    del self._retired[retired_by_slot[slot]]
                else:
                    self._occupied.add(slot)
            self.slots[key_hash] = slot
            self.pinned_cfg[key_hash] = _cfg_of(req)
        alg, limit, dur, burst = _cfg_of(req)
        # the packers' effective denominator: at least 1, and leaky
        # clamps to EFF_MAX (Gregorian keys are never pinned)
        eff = max(int(dur), 1)
        if alg:
            eff = min(eff, EFF_MAX)
        # fresh leaky buckets start at burst × eff (td fixed point),
        # token buckets at limit
        rem0 = burst * eff if alg else limit
        row = {"key": int(np.uint64(key_hash).view(np.int64)),
               "meta": int(alg), "limit": int(limit), "duration": int(dur),
               "eff_ms": int(eff), "burst": int(burst),
               "remaining": int(rem0), "t_ms": int(now_ms),
               "expire_at": int(now_ms + eff)}
        if seed is not None:
            for f in ("remaining", "t_ms", "expire_at", "meta"):
                row[f] = int(seed[f])
        # one slot of every column, on every replica
        with self._state_mu:
            for f in TableState._fields:
                getattr(self.state, f)[:, slot] = row[f]
            self.base_rem[:, slot] = row["remaining"]
            self.base_t[:, slot] = row["t_ms"]
        return True

    def is_pinned(self, key_hash: int) -> bool:
        return key_hash in self.slots

    def matches_pinned(self, key_hash: int, req: RateLimitRequest) -> bool:
        return self.pinned_cfg.get(key_hash) == _cfg_of(req)

    def row_state(self, key_hash: int) -> Optional[dict]:
        """A pinned key's row on replica 0 (call ``sync()`` first: then
        every replica agrees): the value columns, to move the state back
        to the engine's table on demotion."""
        slot = self.slots.get(key_hash)
        if slot is None:
            return None
        fields = [f for f in TableState._fields if f != "key"]
        with self._state_mu:
            vals = torch.stack([getattr(self.state, f)[0, slot].to(_I64)
                                for f in fields]).cpu().numpy()
        return {f: (np.int32(v) if f == "meta" else np.int64(v))
                for f, v in zip(fields, vals.tolist())}

    def unpin(self, key_hash: int) -> None:
        """Stop routing a key here.  The slot stays reserved and the row
        in place (see ``_retired``): hits of requests already in flight
        land on the retired row and are lost, a window bounded by the
        demotion and within GLOBAL's eventual consistency."""
        with self._mu:
            slot = self.slots.pop(key_hash, None)
            self.pinned_cfg.pop(key_hash, None)
            if slot is not None:
                self._retired[key_hash] = slot

    def unpin_all(self) -> None:
        with self._mu:
            self.slots.clear()
            self.pinned_cfg.clear()
            self._retired.clear()
            self._occupied.clear()

    # ---- request path ---------------------------------------------------

    def _replica(self, i: int) -> TableState:
        """Replica ``i``'s columns as views: the step writes through."""
        return TableState(*[c[i] for c in self.state])

    def _run_hot_wave(self, glob: RequestBatch, now_ms: int):
        """One wave over the packed layout: 2 uploads, one step per
        replica on its block of B rows, 1 download.  ``glob`` holds
        [n·B] numpy columns in block order; returns (status, remaining,
        reset_time, limit, lost) arrays."""
        a64, a32 = pack_wave_host(glob)
        d64 = torch.from_numpy(a64).to(self.device)
        d32 = torch.from_numpy(a32).to(self.device)
        B = self.B
        outs = []
        with self._state_mu:
            for i in range(self.n):
                blk = slice(i * B, (i + 1) * B)
                out = decide_batch(self._replica(i),
                                   batch_from_packed(d64[:, blk],
                                                     d32[:, blk]), now_ms)
                outs.append(torch.stack([
                    out.status.to(_I64), out.remaining, out.reset_time,
                    out.limit, out.err.to(_I64)]))
            host = torch.cat(outs, dim=1).cpu().numpy()
        return host[0], host[1], host[2], host[3], host[4] != 0

    def check_batch(self, reqs: Sequence[RateLimitRequest],
                    key_hashes: Sequence[int], now_ms: int
                    ) -> List[RateLimitResponse]:
        """Serve pinned GLOBAL requests, spread across the replicas
        round-robin (any replica answers)."""
        n_req = len(reqs)
        responses: List[Optional[RateLimitResponse]] = [None] * n_req
        pending = list(range(n_req))
        while pending:
            wave, rest = pending[: self.n * self.B], pending[self.n * self.B:]
            # pack the whole wave once, then place it with one index
            packed, _ = pack_requests(
                [reqs[i] for i in wave], now_ms, size=len(wave),
                key_hashes=np.asarray([key_hashes[i] for i in wave],
                                      np.uint64))
            positions = np.empty(len(wave), np.int64)
            fill = [0] * self.n
            for j, _i in enumerate(wave):
                c = self._rr % self.n
                self._rr += 1
                # a replica with room (the wave is bounded, so one has)
                for _ in range(self.n):
                    if fill[c] < self.B:
                        break
                    c = (c + 1) % self.n
                positions[j] = c * self.B + fill[c]
                fill[c] += 1
            glob = empty_batch(self.n * self.B)
            for f in range(len(glob)):
                np.asarray(glob[f])[positions] = packed[f][:len(wave)]
            status, rem, rst, lim, err = self._run_hot_wave(glob, now_ms)
            for i, pos in zip(wave, positions.tolist()):
                responses[i] = RateLimitResponse(
                    status=Status(int(status[pos])), limit=int(lim[pos]),
                    remaining=int(rem[pos]), reset_time=int(rst[pos]),
                    error="hot-set row lost" if err[pos] else "")
            pending = rest
        return responses  # type: ignore[return-value]

    def check_columns(self, batch: RequestBatch, khash: np.ndarray,
                      now_ms: int) -> tuple:
        """The columnar twin of ``check_batch`` (the wire lane): numpy
        RequestBatch columns in; (status, remaining, reset_time, limit,
        row_lost) arrays out."""
        n_req = len(khash)
        status = np.zeros(n_req, np.int64)
        rem = np.zeros(n_req, np.int64)
        rst = np.zeros(n_req, np.int64)
        lim = np.zeros(n_req, np.int64)
        lost = np.zeros(n_req, bool)
        W = self.n * self.B
        # earliest requests take the earliest waves, so a key's time
        # stays monotone across waves
        by_time = np.argsort(np.asarray(batch.now), kind="stable")
        done = 0
        while done < n_req:
            m = min(W, n_req - done)
            idx = by_time[done:done + m]  # original indices, time order
            p = np.arange(m)
            chip = (self._rr + p) % self.n
            self._rr += m
            # fill order per replica → block positions [replica·B + row]
            order = np.argsort(chip, kind="stable")
            cs = chip[order]
            starts = np.searchsorted(cs, np.arange(self.n))
            rowin = np.empty(m, np.int64)
            rowin[order] = np.arange(m) - starts[cs]
            positions = chip * self.B + rowin
            glob = empty_batch(W)
            for f in range(len(glob)):
                np.asarray(glob[f])[positions] = np.asarray(batch[f])[idx]
            o_st, o_rem, o_rst, o_lim, o_err = self._run_hot_wave(
                glob, now_ms)
            status[idx] = o_st[positions]
            rem[idx] = o_rem[positions]
            rst[idx] = o_rst[positions]
            lim[idx] = o_lim[positions]
            lost[idx] = o_err[positions]
            done += m
        return status, rem, rst, lim, lost

    # ---- the tick -------------------------------------------------------

    def sync(self) -> None:
        """Fold every replica's consumption into the common base."""
        with self._state_mu:
            st = self.state
            rem, t, exp = hot_sync(st, self.base_rem, self.base_t)
            st.remaining.copy_(rem)
            st.t_ms.copy_(t)
            st.expire_at.copy_(exp)
            self.base_rem = rem.clone()
            self.base_t = t.clone()
        self.sync_count += 1
