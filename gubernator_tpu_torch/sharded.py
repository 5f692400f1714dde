"""ShardedEngine: single-device serving over the SoA table.

The counterpart of gubernator_tpu/parallel/sharded.py › ShardedEngine at
one shard (n = 1), the engine that ``GUBER_ENGINE=xla`` selects: the
decision step is core/step.py (plain PyTorch, as the JAX step is plain
XLA) over the SoA table of core/table.py, and the expiry sweep is K2
(ops/sweep.py) on a CUDA table.  It serves the full value domain (limits
up to VALUE_MAX, 2^53) and grows its table on the device.

Serving: requests are put in arrival order and cut into waves that ride
the smallest wave bucket that holds them; each wave uploads two packed
matrices (core/batch.py › PACK64 / PACK32), runs one step and brings its
results back with one ``.cpu()``.  Rows whose probe window is full get
one retry after an expiry sweep, then (with ``auto_grow_limit``) retries
after each doubling of the table until the limit.

The bucket engine (engine.py) derives from this class and overrides the
table, the step, the domain gate, the sweep, the row ops and snapshot /
restore, so the wave routing and the retry loop exist once.

The wire lane: ``prepack_wire`` fills a pooled packed pair
(core/batch.py › WaveBufferPool) straight from GetRateLimitsReq bytes in
one C++ pass (ops/native.py), and ``check_prepacked`` runs it as one
wave, rows outside the engine's value domain gated out first.

The cold tier (tiering.py): with ``tier`` set, ``check_packed`` leaves
cold-resident rows out of the device wave and serves them, and the rows
still table-full after the retries, through ``tier.resolve``;
``launch_packed`` carries the cold rows' indices in its token and
``sync_packed`` re-runs them through ``check_packed`` under the engine
lock, as ``check_prepacked`` does with its ``cold_i`` rows.  On the
bucket engine the rows outside K1's domain take the same way (served
cold when the key has no device row), on every path.  ``restore`` puts
the rows the table cannot place into the tier, and
``probe_occupant_keys`` names a promotion's eviction candidates.
``XLA_EXEC_MU``,
``_restore_host_pin`` and the GUBER_PALLAS_SWEEP / GUBER_STEP_DONATE
knobs work around XLA or TPU behaviour and have no counterpart: on CUDA
the sweep is always K2, on the CPU always its plain version, and K2
takes any capacity.
"""
from __future__ import annotations

import contextlib
import logging
from typing import List, Optional, Sequence

import numpy as np
import torch

from .core.batch import (PACK32, PACK64, RequestBatch, WaveBufferPool,
                         empty_batch, lease_batch, pack_requests,
                         responses_from_columns)
from .core.step import (StepOutput, _first_true, _insert, _lookup,
                        _probe_slots, decide_batch)
from .core.table import TableState, init_soa_table, occupancy
from .hashing import hash_request_keys
from .ops import native as wire_native
from .ops.decide import batch_from_packed, fused_tap_columns
from .ops.sweep import sweep as sweep_table
from .state import soa_to_numpy
from .store import items_from_arrays
from .types import RateLimitRequest, RateLimitResponse

log = logging.getLogger("gubernator_tpu_torch.sharded")

#: TableState value columns addressable by the row ops (all but key)
VALUE_COLS = tuple(f for f in TableState._fields if f != "key")


class PrepackedWave:
    """One fused-ingest wave: a leased packed pair whose rows [0, n) the
    C++ pass already parsed, clamped and hashed, their mixed key hashes
    and the OR of their behaviors (what the lanes gate on).  The holder
    owns the lease until ``ShardedEngine.check_prepacked`` consumes it,
    or releases it itself on a fallback path.  (The JAX wave also keeps
    the raw hashes and request TLV ranges, for the peer and analytics
    slices.)"""

    __slots__ = ("lease", "n", "khash", "behavior_or")

    def __init__(self, lease, n, khash, behavior_or):
        self.lease = lease
        self.n = n
        self.khash = khash
        self.behavior_or = behavior_or


def resolve_device(device) -> torch.device:
    """The engine's device.  ``cuda`` (the default everywhere) raises
    when no GPU is present: the port never carries on quietly on the
    CPU; pass ``device="cpu"`` for that."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "run the plain PyTorch step on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def autogrow_limit_per_shard(total_rows: int, n_shards: int,
                             cap_local: int) -> int:
    """Config's cache_autogrow_max (total rows, an upper bound) → the
    per-shard ceiling the engine takes: rounded down to a power of two
    (a memory bound must never be exceeded), floored at the current
    capacity (a bound below it just disables growth)."""
    if total_rows <= 0:
        return 0
    agl = max(total_rows // n_shards, cap_local)
    return 1 << (agl.bit_length() - 1)


def _take(batch: RequestBatch, idx) -> RequestBatch:
    """Rows ``idx`` of a host batch (copies)."""
    return RequestBatch(*[None if c is None else np.asarray(c)[idx]
                          for c in batch])


class ShardedEngine:
    """Single-device serving engine over the SoA table."""

    #: the dispatcher taps this engine's waves on the host (the bucket
    #: engine taps in its step instead)
    fused_tap = False

    def __init__(self, device="cuda", capacity: int = 1 << 16,
                 batch_rows: int = 1024, auto_grow_limit: int = 0):
        self.device = resolve_device(device)
        self.cap_local = capacity
        self.B = batch_rows
        #: a wave rides the smallest bucket that holds it: a lone client
        #: batch takes the small launch, coalesced bursts the big one
        self.wave_buckets = (batch_rows, batch_rows * 8)
        #: capacity ceiling for on-device auto-grow (0 = disabled)
        self.auto_grow_limit = auto_grow_limit
        self.over_count = 0
        self.insert_count = 0
        self.sweep_count = 0
        self.live_rows = -1  # set by sweep
        self.dropped_rows = 0  # rows lost to grow / row placement
        #: optional callable taking each wave's [4, B] device tap, called
        #: right after the step is queued, only where ``fused_tap`` is set
        self.tap_sink = None
        #: set by the dispatcher around an object-lane wave, which it
        #: taps with the key names itself
        self._tap_mute = False  # lock-free: engine calls hold the engine lock
        #: the cold tier's controller (tiering.py), or None
        self.tier = None
        #: packed upload pairs of the wire lane (prepack_wire)
        self.wave_pool = WaveBufferPool()
        #: occupancy_nowait's queued count: (pinned buffer, event)
        self._occ_pending = None
        self._init_table()

    # ---- subclass hooks ------------------------------------------------

    def _init_table(self) -> None:
        self.state = init_soa_table(self.cap_local, self.device)

    def _decide(self, batch: RequestBatch, now_ms: int) -> StepOutput:
        """One wave's decision step on the device."""
        return decide_batch(self.state, batch, now_ms)

    def _mask_out_of_domain(self, batch: RequestBatch):
        """(batch, out-of-domain row indices or None): the SoA step
        serves the whole value domain."""
        return batch, None

    # ---- serving -------------------------------------------------------

    @staticmethod
    def _arrival_order(batch: RequestBatch) -> np.ndarray:
        """Request indices in arrival-time order (same-key requests split
        across waves then apply in time order); an already
        non-decreasing ``now`` column skips the sort."""
        now_col = np.asarray(batch.now)
        n = len(now_col)
        if n <= 1 or (now_col[1:] >= now_col[:-1]).all():
            return np.arange(n, dtype=np.int64)
        return np.argsort(now_col, kind="stable")

    def _build_waves(self, pending: np.ndarray):
        """Cut ``pending`` (in order) into waves of at most the largest
        bucket; each wave rides the smallest bucket that holds it.
        Returns [(idx, bw)]: the wave's request indices and width."""
        Bw = self.wave_buckets[-1]
        waves = []
        for a in range(0, len(pending), Bw):
            idx = pending[a:a + Bw]
            bw = next(b for b in self.wave_buckets if len(idx) <= b)
            waves.append((idx, bw))
        return waves

    @staticmethod
    def _fill_packed(batch: RequestBatch, idx: np.ndarray, bw: int):
        """The wave's requests into packed matrices ([8, bw] i64, [3, bw]
        i32); padding rows are empty_batch rows (eff_ms 1, invalid)."""
        n = len(idx)
        a64 = np.zeros((len(PACK64), bw), np.int64)
        a32 = np.zeros((len(PACK32), bw), np.int32)
        a64[PACK64.index("eff_ms")] = 1
        a64[0, :n] = np.asarray(batch.key).view(np.int64)[idx]
        for i, f in enumerate(PACK64[1:], start=1):
            a64[i, :n] = np.asarray(getattr(batch, f))[idx]
        for i, f in enumerate(PACK32):
            a32[i, :n] = np.asarray(getattr(batch, f))[idx]
        return a64, a32

    def _launch_arrays(self, a64: np.ndarray, a32: np.ndarray,
                       now_ms: int) -> torch.Tensor:
        """One wave: 2 uploads and the decision step, not waited on.
        Returns the device result vector (5 output rows + 2 counters).
        The uploads are blocking copies from pageable memory: the host
        arrays (a leased pair on the wire lane) are read when this
        returns, so the lease may go back to its pool."""
        batch = batch_from_packed(torch.from_numpy(a64).to(self.device),
                                  torch.from_numpy(a32).to(self.device))
        out = self._decide(batch, now_ms)
        if self.fused_tap and self.tap_sink is not None \
                and not self._tap_mute:
            self.tap_sink(fused_tap_columns(batch, out))
        return torch.cat([
            torch.stack([out.status.to(torch.int64), out.remaining,
                         out.reset_time, out.limit,
                         out.err.to(torch.int64)]).reshape(-1),
            out.over_count.reshape(1), out.insert_count.reshape(1)])

    def _finish_wave(self, packed: torch.Tensor):
        """One download for the wave; folds its counters.  Returns
        (status, remaining, reset, limit, table_full) host columns."""
        host = packed.cpu().numpy()
        B = (len(host) - 2) // 5
        o = host[:5 * B].reshape(5, B)
        self.over_count += int(host[-2])
        self.insert_count += int(host[-1])
        return o[0], o[1], o[2], o[3], o[4] != 0

    def _launch_waves(self, batch, pending, now_ms):
        launched = []
        for idx, bw in self._build_waves(pending):
            a64, a32 = self._fill_packed(batch, idx, bw)
            launched.append((idx, self._launch_arrays(a64, a32, now_ms)))
        return launched

    @staticmethod
    def _new_columns(n: int) -> list:
        """Zeroed (status, limit, remaining, reset_time, table_full)."""
        return [np.zeros(n, np.int32), np.zeros(n, np.int64),
                np.zeros(n, np.int64), np.zeros(n, np.int64),
                np.zeros(n, bool)]

    def _collect(self, launched, cols: list) -> np.ndarray:
        """Block on launched waves and write their outputs into ``cols``;
        returns the sorted indices of rows whose probe window was full
        (their outputs are zero)."""
        status, lim_o, rem_o, rst_o, _ = cols
        err_idx: List[np.ndarray] = []
        for idx, packed in launched:
            o_st, o_rem, o_rst, o_lim, o_err = self._finish_wave(packed)
            m = len(idx)
            status[idx] = o_st[:m]
            rem_o[idx] = o_rem[:m]
            rst_o[idx] = o_rst[:m]
            lim_o[idx] = o_lim[:m]
            err_idx.append(idx[o_err[:m]])
        return (np.sort(np.concatenate(err_idx)) if err_idx
                else np.empty(0, np.int64))

    @staticmethod
    def _merge_ood(cols, ood):
        """Out-of-domain rows come back as table_full, outputs zeroed."""
        if ood is not None:
            cols[4][ood] = True
        return tuple(cols)

    def _premask_cold(self, batch: RequestBatch, khash: np.ndarray):
        """(batch with its cold-resident rows invalid, their mask, the
        rows' valid-and-keyed mask), or (batch, None, None) without a
        tier."""
        tier = self.tier
        if tier is None:
            return batch, None, None
        kh = np.asarray(khash)
        orig_valid = np.asarray(batch.valid, bool) & (kh != 0)
        cold = tier.resident_mask(kh) & orig_valid
        if cold.any():
            batch = batch._replace(valid=np.asarray(batch.valid, bool)
                                   & ~cold)
        return batch, cold, orig_valid

    def _resolve_ood(self, batch, khash, now_ms: int, cols: tuple,
                     ood) -> tuple:
        """Out-of-domain rows whose key has no device row, served by the
        cold tier (a key with a device row keeps table_full: serving it
        cold would fork its state)."""
        kh = np.asarray(khash)
        found, _ = self.gather_rows(kh[ood])
        elig = ood[~found]
        if not len(elig):
            return cols
        need = np.zeros(len(kh), bool)
        need[elig] = True
        return self.tier.resolve(self, batch, khash, now_ms, cols, None,
                                 need)

    def check_packed(self, batch: RequestBatch, khash: np.ndarray,
                     now_ms: int) -> tuple:
        """Numpy request columns in, response columns out: (status i32,
        limit i64, remaining i64, reset_time i64, table_full bool).
        Invalid rows come back zeroed (the caller owns their errors).
        Rows whose probe window is full get one retry after an expiry
        sweep, then one after each auto-grow while under the limit.
        With a cold tier, cold-resident rows stay out of the waves and
        they, the rows still full and (bucket engine) the out-of-domain
        rows without a device row are served by ``tier.resolve``."""
        batch, ood = self._mask_out_of_domain(batch)
        batch, cold, orig_valid = self._premask_cold(batch, khash)
        cols = self._new_columns(len(khash))
        # no valid row (a re-run of cold rows alone): no wave to launch,
        # the rows answer from the tier below
        pending = (self._arrival_order(batch)
                   if np.asarray(batch.valid, bool).any()
                   else np.empty(0, np.int64))
        retried = False
        while len(pending):
            err = self._collect(self._launch_waves(batch, pending, now_ms),
                                cols)
            if len(err) and not retried:
                # probe windows clogged with expired rows: sweep once
                # and retry those requests
                retried = True
                self.sweep(now_ms)
                pending = err
            elif len(err) and self._try_auto_grow():
                pending = err
            else:
                cols[4][err] = True
                pending = err[:0]
        tier = self.tier
        if tier is not None:
            cols = tier.resolve(self, batch, khash, now_ms, tuple(cols),
                                cold, orig_valid)
        cols = self._merge_ood(list(cols), ood)
        if tier is not None and ood is not None:
            cols = self._resolve_ood(batch, khash, now_ms, cols, ood)
        return cols

    def launch_packed(self, batch: RequestBatch, khash: np.ndarray,
                      now_ms: int):
        """check_packed split in two: launch the waves without waiting
        and return a token for ``sync_packed``.  Cold-resident rows (and,
        with a tier, out-of-domain rows) ride the waves invalid and
        their indices ride the token: the sync re-runs them through
        check_packed under the engine lock, which serves each from the
        tier its key is in then (a promotion may land in between)."""
        batch, ood = self._mask_out_of_domain(batch)
        cold_idx = None
        if self.tier is not None:
            kh = np.asarray(khash)
            cm = self.tier.resident_mask(kh) & np.asarray(batch.valid, bool) \
                & (kh != 0)
            if ood is not None:
                cm[ood] = True
                ood = None
            if cm.any():
                cold_idx = np.nonzero(cm)[0]
                batch = batch._replace(
                    valid=np.asarray(batch.valid, bool) & ~cm)
        return (batch, khash, now_ms, ood, cold_idx, self._launch_waves(
            batch, self._arrival_order(batch), now_ms))

    def sync_packed(self, token, engine_lock=None) -> tuple:
        """Wait for launched waves and assemble check_packed's columns.
        Table-full rows and the token's cold rows re-run through
        check_packed (under ``engine_lock`` when given: it mutates the
        table)."""
        batch, khash, now_ms, ood, cold_idx, launched = token
        cols = self._new_columns(len(khash))
        err = self._collect(launched, cols)
        lock = (engine_lock if engine_lock is not None
                else contextlib.nullcontext())
        if len(err):
            with lock:
                r_cols = self.check_packed(_take(batch, err), khash[err],
                                           now_ms)
            for c, rc in zip(cols, r_cols):
                c[err] = rc
        if cold_idx is not None:
            sub = _take(batch, cold_idx)
            sub = sub._replace(valid=np.ones(len(cold_idx), bool))
            with lock:
                r_cols = self.check_packed(sub, khash[cold_idx], now_ms)
            for c, rc in zip(cols, r_cols):
                c[cold_idx] = rc
        return self._merge_ood(cols, ood)

    # ---- the fused wire lane (ops/native.py › pack_wire_wave) ----------

    def prepack_wire(self, data: bytes, now_ms: int):
        """One C++ pass from GetRateLimitsReq bytes into a leased packed
        pair of the smallest wave bucket that holds the request count:
        parse, validate, clamp (as pack_columns), key-hash and fill.
        Returns a PrepackedWave whose lease the caller owns (every path
        ends in check_prepacked or ``pre.lease.release()``), or None for
        what the pass does not model (protobuf framing, Gregorian rows,
        an empty message, more rows than the largest bucket): the caller
        then takes the parse or the protobuf lane."""
        cnt = wire_native.count_req_items(data)
        if not cnt:
            return None
        bw = next((b for b in self.wave_buckets if cnt <= b), None)
        if bw is None:
            return None
        lease = self.wave_pool.lease(bw)
        try:
            res = wire_native.pack_wire_wave(data, now_ms, lease.a64,
                                             lease.a32)
        except BaseException:
            lease.release()
            raise
        if res is None:
            lease.release()
            return None
        n, khash, _, behavior_or, _, _ = res
        return PrepackedWave(lease, n, khash, behavior_or)

    def check_prepacked(self, pre: PrepackedWave, now_ms: int) -> tuple:
        """Launch a prepacked wave and download it once; check_packed's
        columns over rows [0, pre.n) (wave order is request order).
        Rows outside the engine's value domain are gated out of the
        launch (their valid flag zeroed in the lease) and answered
        table_full, as check_packed answers them.  With a cold tier the
        cold-resident rows (``cold_i``) and the out-of-domain rows are
        gated out too and re-run through check_packed, which serves them
        from the tier.  Table-full rows copy out of the lease and retry
        through check_packed after a sweep (they changed no state).
        Releases the lease on every path."""
        n, lease = pre.n, pre.lease
        try:
            # views of the leased rows: the gate reads them in place
            _, ood = self._mask_out_of_domain(lease_batch(lease,
                                                          slice(0, n)))
            if ood is not None:
                lease.a32[2][ood] = 0
            cold_i = None
            if self.tier is not None:
                kh_n = np.asarray(pre.khash[:n], np.uint64)
                cm = (self.tier.resident_mask(kh_n) & (kh_n != 0)
                      & (lease.a32[2][:n] != 0))
                if ood is not None:
                    cm[ood] = True
                    ood = None
                if cm.any():
                    cold_i = np.nonzero(cm)[0]
                    lease.a32[2][cold_i] = 0
            o_st, o_rem, o_rst, o_lim, o_err = self._finish_wave(
                self._launch_arrays(lease.a64, lease.a32, now_ms))
            cols = [o_st[:n].astype(np.int32), o_lim[:n], o_rem[:n],
                    o_rst[:n], o_err[:n]]
            err = np.nonzero(cols[4])[0]
            if len(err) or cold_i is not None:
                ei = err
                if cold_i is not None:
                    lease.a32[2][cold_i] = 1  # valid again for the re-run
                    ei = np.union1d(err, cold_i)
                sub = lease_batch(lease, ei)
                lease.release()
                if len(err):  # a cold-only re-run needs no sweep
                    self.sweep(now_ms)
                for c, rc in zip(cols, self.check_packed(
                        sub, pre.khash[ei], now_ms)):
                    c[ei] = rc
            return self._merge_ood(cols, ood)
        finally:
            lease.release()

    def check_batch(self, reqs: Sequence[RateLimitRequest], now_ms: int
                    ) -> List[RateLimitResponse]:
        """Object-lane entry: pack, check_packed, build responses."""
        khash = hash_request_keys([r.name for r in reqs],
                                  [r.unique_key for r in reqs])
        batch, errs = pack_requests(reqs, now_ms, size=len(reqs),
                                    key_hashes=khash)
        return responses_from_columns(
            self.check_packed(batch, khash, now_ms), errs)

    def warmup(self, now_ms: int = 1) -> None:
        """Run every wave bucket once (all-invalid rows: no state
        change), so the first burst pays no first-use costs."""
        for bw in self.wave_buckets:
            self._collect(self._launch_waves(
                empty_batch(bw), np.arange(bw, dtype=np.int64), now_ms),
                self._new_columns(bw))

    # ---- sweep, grow, occupancy ----------------------------------------

    def sweep(self, now_ms: int) -> None:
        """Reclaim expired rows (K2 on a CUDA table) and count the live
        ones.  With auto-grow on, double the table once live rows pass
        60% of it: probe windows start to fill on unlucky keys well
        before the table is full, and the sweep tick is off the serving
        path, so requests do not pay for the grow."""
        self.live_rows = int(sweep_table(self.state, now_ms))
        self.sweep_count += 1
        if (self.auto_grow_limit
                and self.cap_local * 2 <= self.auto_grow_limit
                and self.live_rows > 0.6 * self.cap_local):
            dropped = self.grow(self.cap_local * 2)
            if dropped:
                log.warning("proactive grow to %d rows dropped %d live "
                            "rows", self.cap_local, dropped)

    def _try_auto_grow(self) -> bool:
        """Grow 2× if under auto_grow_limit.  Returns True when the
        caller should retry at the larger capacity."""
        if not self.auto_grow_limit \
                or self.cap_local * 2 > self.auto_grow_limit:
            return False
        dropped = self.grow(self.cap_local * 2)
        if dropped:
            # a dropped row is a silent counter reset: allowed by the
            # LRU-eviction contract, never allowed to be quiet
            log.warning("auto-grow to %d rows dropped %d live rows "
                        "(probe-window exhaustion)", self.cap_local,
                        dropped)
        return True

    def grow(self, new_capacity: int) -> int:
        """Re-place every live row into a fresh [new_capacity] table on
        the device, with the step's claim rounds (the JAX make_grow).
        Returns the rows dropped (their probe window in the new table
        was full or they lost every claim round; non-zero mostly when
        shrinking into high occupancy).  The old columns are replaced,
        not updated: hold no alias of them across a grow."""
        if new_capacity & (new_capacity - 1) or new_capacity <= 0:
            raise ValueError(
                f"capacity must be a power of two, got {new_capacity}")
        old = self.state
        key = old.key
        valid = key != 0
        fresh = init_soa_table(new_capacity, self.device)
        row, _ = _insert(fresh.key, _probe_slots(key, new_capacity), key,
                         valid, torch.full_like(key, -1))
        placed = valid & (row >= 0)
        wrow = row[placed]
        for f in VALUE_COLS:
            getattr(fresh, f)[wrow] = getattr(old, f)[placed]
        dropped = int((valid & ~placed).sum())
        self.state = fresh
        self.cap_local = new_capacity
        self.dropped_rows += dropped
        return dropped

    def occupancy(self) -> int:
        """Live (non-empty) rows right now."""
        return int(occupancy(self.state))

    def _live_count(self) -> torch.Tensor:
        """The live rows as a 0-d device tensor (queued, not read)."""
        return occupancy(self.state)

    def table_tensors(self) -> list:
        """The tensors that hold the table (the memory ledger's bytes)."""
        return list(self.state)

    def occupancy_nowait(self, lock=None) -> Optional[int]:
        """The live rows without waiting on the serving stream (the
        memory ledger's tick-cadence probe).  On CUDA a count is queued on
        the stream behind the waves, copied into a pinned host buffer, and
        an event recorded; a later call reads it only once the event has
        completed, and queues the next.  None while no count has
        completed: the caller reuses its last sample.  On the CPU the
        count runs in the caller's thread when ``lock`` (the lock the
        waves hold) is free, else None."""
        if self.device.type != "cuda":
            if lock is not None and not lock.acquire(blocking=False):
                return None
            try:
                return int(self._live_count())
            finally:
                if lock is not None:
                    lock.release()
        out = None
        pend = self._occ_pending
        if pend is not None:
            buf, ev = pend
            if not ev.query():
                return None
            out = int(buf[0])
        buf = (pend[0] if pend is not None
               else torch.empty(1, dtype=torch.int64, pin_memory=True))
        buf.copy_(self._live_count().reshape(1), non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        self._occ_pending = (buf, ev)
        return out

    # ---- row ops (cold path) -------------------------------------------

    def _keys_tensor(self, khash: np.ndarray) -> torch.Tensor:
        k = np.ascontiguousarray(np.asarray(khash, np.uint64)).view(np.int64)
        return torch.from_numpy(k.copy()).to(self.device)

    def _row_waves(self, m: int):
        """[a, b) ranges of the row-op waves: B keys each, in order."""
        return [(a, min(a + self.B, m)) for a in range(0, m, self.B)]

    def gather_rows(self, khash: np.ndarray) -> tuple[np.ndarray, dict]:
        """(found mask, value-column dict) for the given key hashes.  A
        key that is not found reads row 0's values, as the JAX gather
        does."""
        m = len(khash)
        found = np.zeros(m, bool)
        out = {f: np.zeros(m, np.int32 if f == "meta" else np.int64)
               for f in VALUE_COLS}
        for a, b in self._row_waves(m):
            keys = self._keys_tensor(khash[a:b])
            row, _ = _lookup(self.state.key,
                             _probe_slots(keys, self.cap_local), keys)
            f = (keys != 0) & (row >= 0)
            r = torch.where(f, row, 0)
            found[a:b] = f.cpu().numpy()
            for name in VALUE_COLS:
                out[name][a:b] = getattr(self.state, name)[r].cpu().numpy()
        return found, out

    def upsert_rows(self, khash: np.ndarray, cols: dict) -> int:
        """Find-or-insert rows, in waves of B keys with the step's claim
        rounds, and overwrite their values; returns the rows placed
        (others dropped: probe window full)."""
        st = self.state
        placed_total = 0
        for a, b in self._row_waves(len(khash)):
            keys = self._keys_tensor(khash[a:b])
            valid = keys != 0
            row, _ = _insert(st.key, _probe_slots(keys, self.cap_local),
                             keys, valid, torch.full_like(keys, -1))
            placed = valid & (row >= 0)
            wrow = row[placed]
            for f in VALUE_COLS:
                col = getattr(st, f)
                v = torch.from_numpy(np.ascontiguousarray(
                    np.asarray(cols[f][a:b]).astype(
                        np.int32 if f == "meta" else np.int64)))
                col[wrow] = v.to(self.device)[placed]
            placed_total += int(placed.sum())
        return placed_total

    def remove_rows(self, khash: np.ndarray) -> int:
        """Delete rows by key hash (key and expire_at → 0); returns the
        rows removed."""
        st = self.state
        removed = 0
        for a, b in self._row_waves(len(khash)):
            keys = self._keys_tensor(khash[a:b])
            row, _ = _lookup(st.key, _probe_slots(keys, self.cap_local),
                             keys)
            found = (keys != 0) & (row >= 0)
            w = row[found]
            st.key[w] = 0
            st.expire_at[w] = 0
            removed += int(found.sum())
        return removed

    def probe_occupant_keys(self, kh: int) -> np.ndarray:
        """The key hashes in ``kh``'s probe window (0 = a free slot): the
        tier's eviction candidates, any of which frees a slot ``kh`` can
        take once demoted."""
        keys = self._keys_tensor(np.array([kh], np.uint64))
        slots = _probe_slots(keys, self.cap_local)[0]
        return self.state.key[slots].cpu().numpy().view(np.uint64)

    def each(self):
        """The live rows as store.CacheItems (cache.go › Each), from one
        snapshot: admin and debug tooling."""
        yield from items_from_arrays(self.snapshot())

    # ---- checkpoint / resume (store.py column dict) --------------------

    def snapshot(self) -> dict:
        """Live rows as a store.py column dict (host; uint64 key)."""
        cols = soa_to_numpy(self.state)
        live = cols["key"] != 0
        return {f: c[live] for f, c in cols.items()}

    def restore(self, arrays: dict) -> int:
        """Insert snapshot rows (either package's ``snapshot()``) into
        the table.  Each row takes its first probe slot that is empty or
        holds its key, in row order, exactly as the JAX restore's host
        loop places them.  The rows whose probe window is full go to the
        cold tier when there is one, else they are dropped (as in the JAX
        restore); returns the rows placed in either tier.

        The placement runs on the table's device in rounds: a row is
        placed once no earlier unplaced row could still take its slot
        (the lowest unplaced row always can), so later rows never
        change what an earlier one finds."""
        n = len(arrays["key"])
        if n == 0:
            return 0
        st, cap, dev = self.state, self.cap_local, self.device
        keys = self._keys_tensor(np.asarray(arrays["key"]))
        vals = {f: torch.from_numpy(np.ascontiguousarray(
            np.asarray(arrays[f]).astype(
                np.int32 if f == "meta" else np.int64))).to(dev)
            for f in VALUE_COLS}
        slots = _probe_slots(keys, cap)
        pending = torch.arange(n, device=dev)
        placed = 0
        unplaced = []
        while pending.numel():
            ks, sl = keys[pending], slots[pending]
            at = st.key[sl]
            ok = (at == 0) | (at == ks[:, None])
            has = ok.any(1)
            cand = sl.gather(1, _first_true(ok)[:, None])[:, 0]
            # lowest pending row that may still take each slot
            owner = torch.full((cap,), n, dtype=torch.int64, device=dev)
            owner.scatter_reduce_(0, sl[ok],
                                  pending[:, None].expand_as(sl)[ok], "amin")
            safe = has & (owner[cand] == pending)
            rows, c = pending[safe], cand[safe]
            st.key[c] = ks[safe]
            for f in VALUE_COLS:
                getattr(st, f)[c] = vals[f][rows]
            placed += rows.numel()
            unplaced.append(pending[~has])
            pending = pending[has & ~safe]
        if self.tier is not None and unplaced:
            idx = torch.cat(unplaced).cpu().numpy()
            placed += self.tier.adopt_rows(arrays, np.sort(idx))
        return placed
