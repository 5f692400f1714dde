"""The mesh-resident GLOBAL tier: GLOBAL keys reconciled by one
collective fold a tick (the port of gubernator_tpu/parallel/meshglobal.py,
``GUBER_GLOBAL_MODE=mesh``).

Every mesh device holds a full replica of a bounded GLOBAL counter
table (a core/table.py TableState of ``capacity`` rows on
``mesh.devices[d]``) and, beside it, a hit accumulator (``[capacity]``
int64, the applied hits a slot since the start).  Requests route to
their key's HOME shard, the one ``hashing.shard_of`` gives the sharded
table, so the home replica sees every hit and its row is always exact:
decisions equal the owner-sharded path's.  Serving decides on the home
replica and scatter-adds the applied hits into its accumulator; the
bucket engine does both inside its wave's launch (engine.py, the fused
mesh lane), the classic engine's lanes through ``check_columns``.

The reconcile tick replaces the hit-queue flush and owner broadcast of
the gRPC path with one fold:

- every value column adopts its home shard's row: the sum over replicas
  of home-masked columns (JAX's psum), written back to every replica;
- a copy of the accumulators, taken where JAX swaps its buffers, is the
  folded side of the conservation ledger (folded == injected is the
  oracle the tests and the smoke assert).

JAX retires one of two buffers at the tick and zeroes it in the fold.
Here the accumulators are never zeroed: the tick copies them (one op a
replica), and ``drain`` reads the last folded copy's sum.  A hit added
after the copy rides the next fold, and a fold that fails leaves every
hit in the accumulators, so nothing is undone.  The fold does not block
the host: at n = 1 it is that copy and its accounting (JAX elides the
psum); at n > 1 the sums and the gather run on ``devices[0]``, queued.

The fold waits for no serving wave: a wave changes only rows of its
replica's own home, and the fold writes each replica's rows of the other
homes (and its empty rows).  Under 8 callers each host call that
releases the GIL can wait tens of ms for it, so the fold makes as few
as it can.

Scope, enforced by the instance: TOKEN / LEAKY keys without
RESET_REMAINING, DRAIN_OVER_LIMIT, Gregorian durations or MULTI_REGION.
``XLA_EXEC_MU`` has no counterpart.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .core.batch import (RequestBatch, clamp_config, empty_batch,
                         pack_requests, pack_wave_host)
from .core.step import PROBES, StepOutput, _lookup, _probe_slots, decide_batch
from .core.table import TableState, init_soa_table
from .hashing import shard_of
from .mesh import Mesh
from .ops.decide import batch_from_packed
from .types import EFF_MAX, RateLimitRequest, RateLimitResponse, Status

_I64 = torch.int64

#: TableState value columns (all but ``key``): the fold adopts the home
#: shard's copy of each; keys never fold (pins write the key column
#: identically on every replica, and rows never move)
_VALUE_COLS = tuple(f for f in TableState._fields if f != "key")


def config_of(req: RateLimitRequest) -> tuple:
    """(alg, limit, duration, burst) exactly as the packers clamp them
    (the hot set's pinned-config contract)."""
    return clamp_config(req.algorithm, req.limit, req.duration, req.burst,
                        req.behavior)


def home_of_keys(key: torch.Tensor, n: int) -> torch.Tensor:
    """``shard_of`` on the device, over the int64 bit-view of the key
    hashes: ((h >> 32) * n) >> 32."""
    return (((key >> 32) & 0xFFFFFFFF) * n) >> 32


def mesh_fold(reps: Sequence[TableState], dev: torch.device) -> tuple:
    """The fold's arithmetic, on ``dev``: (each value column's folded
    [capacity] values, each row's home shard, the live-row mask)."""
    n = len(reps)
    key = reps[0].key.to(dev)
    home = home_of_keys(key, n)
    live = key != 0
    new = {}
    for f in _VALUE_COLS:
        tot = None
        for d, rep in enumerate(reps):
            col = getattr(rep, f).to(dev)
            part = torch.where((home == d) & live, col,
                               torch.zeros((), dtype=col.dtype, device=dev))
            tot = part if tot is None else tot + part
        new[f] = tot
    return new, home, live


class MeshGlobalEngine:
    """Host manager of the mesh-resident GLOBAL tier.

    Pins keys to fixed probe-path slots (the same on every replica, the
    hot set's discipline), routes each request to its HOME shard's
    replica, and runs the fold on the reconcile tick (the GLOBAL
    manager's mesh backend, driven by the instance)."""

    def __init__(self, mesh: Mesh, capacity: int = 4096,
                 batch_per_chip: int = 512):
        self.mesh = mesh
        self.devices = mesh.devices
        self.n = mesh.n
        self.capacity = capacity
        self.B = batch_per_chip
        #: serializes pin / unpin mutations of the slot maps (reads of
        #: the dicts are GIL-atomic snapshots)
        self._mu = threading.Lock()
        self.slots: Dict[int, int] = {}  # guarded-by: self._mu
        #: key hash → (alg, limit, duration, burst)
        self.pinned_cfg: Dict[int, tuple] = {}  # guarded-by: self._mu
        #: demoted keys keep their slot and replica row (clearing the key
        #: would let an in-flight request insert a fresh bucket)
        self._retired: Dict[int, int] = {}  # guarded-by: self._mu
        self._occupied: set = set()  # guarded-by: self._mu
        #: serializes the replicas' read-modify-writes: serving steps,
        #: pins and row reads (not the fold: see the module docstring)
        self._state_mu = threading.Lock()
        #: the fold's replica writes against pins (a pin lands in a row
        #: the fold may have read as empty)
        self._fold_mu = threading.Lock()
        #: the accumulator adds and the ledger
        self._acc_mu = threading.Lock()
        #: one ``drain`` at a time (it waits for the device outside
        #: _acc_mu)
        self._drain_mu = threading.Lock()
        #: replica d on devices[d]
        self.reps: List[TableState] = [init_soa_table(capacity, dev)
                                       for dev in self.devices]
        #: replica d's applied hits a slot since the start, on devices[d]
        self._acc = [torch.zeros(capacity, dtype=_I64, device=dev)
                     for dev in self.devices]  # lock-free: adds take _acc_mu, a fold's copy reads racily
        self.generation = 0  # guarded-by: self._acc_mu
        self.folded_hits = 0  # guarded-by: self._acc_mu
        self.injected_hits = 0  # guarded-by: self._acc_mu
        self.last_staleness_s = 0.0  # guarded-by: self._acc_mu
        self._first_unfolded_t: Optional[float] = None  # guarded-by: self._acc_mu
        #: the accumulators' copy the last fold took (drain sums it)
        self._folded_copy: Optional[list] = None  # guarded-by: self._acc_mu

    @property
    def fold_nbytes(self) -> int:
        """Bytes a replica's fold moves: every value column (as int64)
        and the retired accumulator (the cost model's feature)."""
        return (len(_VALUE_COLS) + 1) * self.capacity * 8

    def table_tensors(self) -> list:
        """The replicas, the accumulators and the last fold's copy of
        them (the memory ledger)."""
        return ([c for rep in self.reps for c in rep]
                + list(self._acc) + list(self._folded_copy or ()))

    def replica_columns(self, field: str) -> np.ndarray:
        """``field`` of every replica as an [n, capacity] host array."""
        with self._state_mu:
            return np.stack([getattr(rep, field).cpu().numpy()
                             for rep in self.reps])

    # ---- host slot management (the hot set's discipline) ---------------

    def _probe_slots_host(self, key_hash: int) -> List[int]:
        k = int(key_hash) & ((1 << 64) - 1)
        stride = (k >> 17) | 1
        return [(k + p * stride) & (self.capacity - 1)
                for p in range(PROBES)]

    def is_pinned(self, key_hash: int) -> bool:
        return key_hash in self.slots

    def has_room(self, key_hash: int) -> bool:
        """Whether a pin of ``key_hash`` would find a slot: its own
        retired one, or a free or retired slot in its probe window."""
        with self._mu:
            if key_hash in self._retired:
                return True
            retired = set(self._retired.values())
            return any(s not in self._occupied or s in retired
                       for s in self._probe_slots_host(key_hash))

    def probe_occupants(self, key_hash: int) -> List[int]:
        """Pinned keys whose slots lie in ``key_hash``'s probe window: a
        cap overflow demotes the coldest of them (by sketch rank)."""
        with self._mu:
            window = set(self._probe_slots_host(key_hash))
            return [k for k, s in self.slots.items() if s in window]

    def pin_many(self, entries: Sequence[tuple], now_ms: int) -> List[bool]:
        """Pin several keys in one upload set.  ``entries``: (req, key
        hash, seed or None); the seed carries the key's table row so
        hits consumed before the promotion survive it.  Returns each
        entry's success (False: probe window full; the request stays on
        the sharded path, which is always correct)."""
        ok = [False] * len(entries)
        placed: List[tuple] = []  # (slot, host row)
        with self._mu:
            for j, (req, kh, seed) in enumerate(entries):
                if kh in self.slots:
                    ok[j] = True
                    continue
                if kh in self._retired:
                    slot = self._retired.pop(kh)
                else:
                    probes = self._probe_slots_host(kh)
                    slot = next((s for s in probes
                                 if s not in self._occupied), None)
                    if slot is None:
                        retired_by_slot = {s: k for k, s in
                                           self._retired.items()}
                        slot = next((s for s in probes
                                     if s in retired_by_slot), None)
                        if slot is None:
                            continue  # window full: sharded path
                        del self._retired[retired_by_slot[slot]]
                    else:
                        self._occupied.add(slot)
                self.slots[kh] = slot
                self.pinned_cfg[kh] = config_of(req)
                placed.append((slot, self._fresh_row(req, kh, now_ms, seed)))
                ok[j] = True
        if not placed:
            return ok
        idx = torch.tensor([s for s, _ in placed], dtype=_I64)
        with self._state_mu, self._fold_mu:
            for f in TableState._fields:
                vals = torch.tensor([row[f] for _, row in placed],
                                    dtype=torch.int32 if f == "meta" else _I64)
                for d, rep in enumerate(self.reps):
                    dev = self.devices[d]
                    getattr(rep, f)[idx.to(dev)] = vals.to(dev)
        return ok

    def pin(self, req: RateLimitRequest, key_hash: int, now_ms: int,
            seed: Optional[dict] = None) -> bool:
        return self.pin_many([(req, key_hash, seed)], now_ms)[0]

    @staticmethod
    def _fresh_row(req: RateLimitRequest, key_hash: int, now_ms: int,
                   seed: Optional[dict]) -> dict:
        """A replica row for a new pin, with the packers' eff / burst
        arithmetic (the hot set's pin)."""
        alg, limit, dur, burst = config_of(req)
        eff = max(int(dur), 1)
        if alg:
            eff = min(eff, EFF_MAX)
        rem0 = burst * eff if alg else limit
        row = {"key": int(np.uint64(key_hash).view(np.int64)),
               "meta": int(alg), "limit": int(limit), "duration": int(dur),
               "eff_ms": int(eff), "burst": int(burst),
               "remaining": int(rem0), "t_ms": int(now_ms),
               "expire_at": int(now_ms + eff)}
        if seed is not None:
            for f in ("remaining", "t_ms", "expire_at", "meta"):
                row[f] = int(seed[f])
        return row

    def unpin(self, key_hash: int) -> None:
        with self._mu:
            slot = self.slots.pop(key_hash, None)
            self.pinned_cfg.pop(key_hash, None)
            if slot is not None:
                self._retired[key_hash] = slot

    def pinned_keys(self) -> List[int]:
        with self._mu:
            return list(self.slots)

    def row_state(self, key_hash: int) -> Optional[dict]:
        """The key's HOME replica row: exact without any fold (home
        routing means only the home copy ever moves), so demotion and
        the stand-down migrate state even when the fold is what broke."""
        slot = self.slots.get(key_hash)
        if slot is None:
            return None
        home = int(shard_of(int(key_hash), self.n))
        rep = self.reps[home]
        with self._state_mu:
            vals = torch.stack([getattr(rep, f)[slot].to(_I64)
                                for f in _VALUE_COLS]).cpu().tolist()
        return {f: (np.int32(v) if f == "meta" else np.int64(v))
                for f, v in zip(_VALUE_COLS, vals)}

    # ---- request path ---------------------------------------------------

    def decide_replica(self, shard: int, batch: RequestBatch,
                       now_ms: int) -> StepOutput:
        """The SoA step of one wave's block on replica ``shard``, in
        place (the caller holds the state lock)."""
        return decide_batch(self.reps[shard], batch, now_ms)

    def warmup(self, now_ms: int = 1) -> None:
        """Run the serving step and the fold once (an all-invalid wave,
        zero accumulators: no state change)."""
        self._run_wave(empty_batch(self.n * self.B), now_ms)
        self.fold(self.retire_accum())
        self.drain()

    def check_columns(self, batch: RequestBatch, khash: np.ndarray,
                      now_ms: int) -> tuple:
        """Serve pinned GLOBAL requests, HOME-shard routed: numpy
        RequestBatch columns in, (status, remaining, reset_time, limit,
        row_lost) columns out."""
        n_req = len(khash)
        status = np.zeros(n_req, np.int64)
        rem = np.zeros(n_req, np.int64)
        rst = np.zeros(n_req, np.int64)
        lim = np.zeros(n_req, np.int64)
        lost = np.zeros(n_req, bool)
        home = shard_of(np.asarray(khash, np.uint64), self.n)
        pending = np.argsort(np.asarray(batch.now), kind="stable").tolist()
        valid = np.asarray(batch.valid, bool)
        inj = int(np.maximum(np.asarray(batch.hits)[valid], 0).sum())
        while pending:
            fill = [0] * self.n
            wave, rest, positions = [], [], []
            for i in pending:
                h = int(home[i])
                if fill[h] < self.B:
                    positions.append(h * self.B + fill[h])
                    fill[h] += 1
                    wave.append(i)
                else:
                    rest.append(i)
            idx = np.asarray(wave, np.int64)
            pos = np.asarray(positions, np.int64)
            glob = empty_batch(self.n * self.B)
            for f in range(len(glob)):
                np.asarray(glob[f])[pos] = np.asarray(batch[f])[idx]
            o_st, o_rem, o_rst, o_lim, o_err = self._run_wave(glob, now_ms)
            status[idx] = o_st[pos]
            rem[idx] = o_rem[pos]
            rst[idx] = o_rst[pos]
            lim[idx] = o_lim[pos]
            lost[idx] = o_err[pos]
            pending = rest
        with self._acc_mu:
            self.injected_hits += inj
            if inj and self._first_unfolded_t is None:
                self._first_unfolded_t = time.monotonic()
        return status, rem, rst, lim, lost

    def check_batch(self, reqs: Sequence[RateLimitRequest],
                    key_hashes: Sequence[int], now_ms: int
                    ) -> List[RateLimitResponse]:
        """Object-lane wrapper over ``check_columns``."""
        khash = np.asarray(list(key_hashes), np.uint64)
        batch, _ = pack_requests(list(reqs), now_ms, size=len(reqs),
                                 key_hashes=khash)
        st, rem, rst, lim, lost = self.check_columns(batch, khash, now_ms)
        return [RateLimitResponse(
            status=Status(int(st[i])), limit=int(lim[i]),
            remaining=int(rem[i]), reset_time=int(rst[i]),
            error="mesh-global row lost" if lost[i] else "")
            for i in range(len(reqs))]

    def _run_wave(self, glob: RequestBatch, now_ms: int):
        """One [n·B] block wave: per replica, the SoA step on its block
        and the applied hits of its rows added into its active
        accumulator at the rows the step left them in (erred rows
        changed nothing and add nothing)."""
        a64, a32 = pack_wave_host(glob)
        B = self.B
        outs, adds = [], []
        with self._state_mu:
            for d, dev in enumerate(self.devices):
                bt = batch_from_packed(
                    torch.from_numpy(np.ascontiguousarray(
                        a64[:, d * B:(d + 1) * B])).to(dev),
                    torch.from_numpy(np.ascontiguousarray(
                        a32[:, d * B:(d + 1) * B])).to(dev))
                rep = self.reps[d]
                out = self.decide_replica(d, bt, now_ms)
                row, _ = _lookup(rep.key, _probe_slots(bt.key, self.capacity),
                                 bt.key)
                ok = bt.valid & (row >= 0) & ~out.err
                adds.append((torch.where(ok, row, 0),
                             torch.where(ok, torch.clamp_min(bt.hits, 0), 0)))
                outs.append(torch.stack([
                    out.status.to(_I64), out.remaining, out.reset_time,
                    out.limit, out.err.to(_I64)]))
        self._add_hits(adds)
        host = torch.cat([o.cpu() for o in outs], dim=1).numpy()
        return host[0], host[1], host[2], host[3], host[4] != 0

    def _add_hits(self, adds: Sequence[tuple]) -> None:
        """Add each replica's applied hits, (slots, hits) a replica, into
        its accumulator."""
        with self._acc_mu:
            for a, (idx, hits) in zip(self._acc, adds):
                a.index_add_(0, idx, hits)

    # ---- the fused lane's hooks (engine.py) ----------------------------

    def serve_rows(self, batches: Sequence[RequestBatch],
                   slots: Sequence[torch.Tensor], now_ms: int) -> tuple:
        """The mesh rows of one fused wave: per shard d, the SoA step of
        ``batches[d]`` (only its mesh rows valid) on replica d, in place,
        and each applied hit added into replica d's accumulator at the
        row's pinned slot ``slots[d]``.  Returns (each shard's
        StepOutput, each shard's applied hits)."""
        outs, adds = [], []
        with self._state_mu:
            for d, b in enumerate(batches):
                out = self.decide_replica(d, b, now_ms)
                ok = b.valid & ~out.err
                # rows that did not apply add 0 at slot 0: no effect
                adds.append((torch.where(ok, slots[d], 0).to(_I64),
                             torch.where(ok, torch.clamp_min(b.hits, 0), 0)))
                outs.append(out)
        self._add_hits(adds)
        return outs, [h for _, h in adds]

    def unfolded_age_s(self, now: float) -> Optional[float]:
        """Seconds since the oldest hit not yet folded was noted (the
        monotonic clock), or None when every noted hit is folded."""
        t = self._first_unfolded_t  # one racy read: a hint
        return None if t is None else now - t

    def note_injected(self, hits: int) -> None:
        """The fused waves' applied mesh hits (what their scatter added
        to the accumulators): the injected side of the ledger."""
        if hits <= 0:
            return
        with self._acc_mu:
            self.injected_hits += hits
            if self._first_unfolded_t is None:
                self._first_unfolded_t = time.monotonic()

    # ---- the reconcile fold ---------------------------------------------

    def retire_accum(self) -> list:
        """The hits to fold: a copy of every accumulator (JAX swaps its
        buffers here).  The caller fires the ``global_accum_swap``
        faultpoint before this and ``global_psum`` between this and
        ``fold``; a copy never folded is dropped, its hits still in the
        accumulators for the next fold."""
        return [a.clone() for a in self._acc]

    def fold(self, copy: list) -> None:
        """Fold: at n > 1 each replica adopts its home rows (queued on
        ``devices[0]``, nothing waited for); then the generation, the
        staleness and ``copy`` as the ledger's folded side, summed by
        ``drain``."""
        t0 = time.monotonic()
        if self.n > 1:
            with self._fold_mu:
                new, home, live = mesh_fold(self.reps, self.devices[0])
                for d, rep in enumerate(self.reps):
                    dev = self.devices[d]
                    # the rows of other homes and the empty rows: a wave
                    # on replica d writes only live rows of home d
                    idx = torch.nonzero(~((home == d) & live)).squeeze(1)
                    idx_d = idx.to(dev)
                    for f in _VALUE_COLS:
                        getattr(rep, f).index_copy_(
                            0, idx_d, new[f][idx].to(dev))
        with self._acc_mu:
            self.generation += 1
            stale = (t0 - self._first_unfolded_t
                     if self._first_unfolded_t is not None else 0.0)
            self.last_staleness_s = max(stale, 0.0)
            self._first_unfolded_t = None
            self._folded_copy = copy

    def drain(self) -> None:
        """Read the last fold's copy into ``folded_hits`` (waits for the
        device: call it off the serving path)."""
        with self._drain_mu:
            with self._acc_mu:
                copy = self._folded_copy
            if copy is None:
                return
            got = sum(int(c.sum()) for c in copy)
            with self._acc_mu:
                self.folded_hits = got

    def stats(self) -> dict:
        self.drain()
        with self._acc_mu:
            return {
                "generation": self.generation,
                "pinned_keys": len(self.slots),
                "capacity": self.capacity,
                "n_shards": self.n,
                "injected_hits": self.injected_hits,
                "folded_hits": self.folded_hits,
                "last_staleness_s": round(self.last_staleness_s, 6),
            }
