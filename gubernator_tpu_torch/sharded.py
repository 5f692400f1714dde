"""ShardedEngine: serving over the SoA table, range-sharded over a mesh.

The counterpart of gubernator_tpu/parallel/sharded.py › ShardedEngine,
the engine that ``GUBER_ENGINE=xla`` selects: the decision step is
core/step.py (plain PyTorch, as the JAX step is plain XLA) over the SoA
table of core/table.py, and the expiry sweep is K2 (ops/sweep.py) on a
CUDA table.  It serves the full value domain (limits up to VALUE_MAX,
2^53) and grows its table on the device.

The mesh (mesh.py): shard d owns the keys whose ``hashing.shard_of`` is
d, and its block of ``capacity`` rows lives on ``mesh.devices[d]``; the
global table is JAX's, shard d's block at rows [d·cap, (d+1)·cap), so a
snapshot equals the JAX engine's row for row.  Without a mesh the
engine runs one shard on ``device``.

Serving: requests are put in arrival order, stably sorted by shard and
cut into waves of JAX's [n·bw] block layout; each wave rides the
smallest wave bucket that holds its densest shard, uploads two packed
matrices (core/batch.py › PACK64 / PACK32), runs one step per shard on
the shard's device and brings its results back with one ``.cpu()`` per
device.  The step counters JAX psums over the mesh are summed over the
shards.  Rows whose probe window is full get one retry after an expiry
sweep, then (with ``auto_grow_limit``, per shard) retries after each
doubling of every shard until the limit.

The bucket engine (engine.py) derives from this class and overrides the
table, the step, the domain gate, the sweep, the row ops and snapshot /
restore, so the wave routing and the retry loop exist once.

The wire lane: ``prepack_wire`` fills a pooled packed pair
(core/batch.py › WaveBufferPool) straight from GetRateLimitsReq bytes in
one C++ pass (ops/native.py), and ``check_prepacked`` runs it as one
wave, rows outside the engine's value domain gated out first.  As in
JAX, only a one-shard engine takes it (request order is block order
there); at n > 1 ``prepack_wire`` returns None and the caller parses.

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
The row ops, grow, restore and the sweep run shard by shard (rows never
move across shards: ownership depends on n alone).
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
from .hashing import hash_request_keys, shard_of
from .mesh import Mesh
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
    """Serving engine over the SoA table, one block per mesh shard."""

    #: the dispatcher taps this engine's waves on the host (the bucket
    #: engine taps in its step instead)
    fused_tap = False

    def __init__(self, device="cuda", capacity: int = 1 << 16,
                 batch_rows: int = 1024, auto_grow_limit: int = 0,
                 mesh: Optional[Mesh] = None):
        if mesh is None:
            mesh = Mesh([resolve_device(device)])
        self.mesh = mesh
        self.devices = mesh.devices
        self.n = mesh.n
        #: shard 0's device (the one device at n = 1)
        self.device = self.devices[0]
        #: one upload serves every shard when the mesh has one device
        self._one_device = len(set(self.devices)) == 1
        #: rows per shard
        self.cap_local = capacity
        self.B = batch_rows
        #: a wave rides the smallest bucket that holds its densest shard:
        #: a lone client batch takes the small launch, coalesced bursts
        #: the big one
        self.wave_buckets = (batch_rows, batch_rows * 8)
        #: per-shard capacity ceiling for on-device auto-grow (0 = off)
        self.auto_grow_limit = auto_grow_limit
        self.over_count = 0
        self.insert_count = 0
        self.sweep_count = 0
        self.live_rows = -1  # set by sweep
        self.dropped_rows = 0  # rows lost to grow / row placement
        #: optional callable taking each wave's [4, n·bw] device tap,
        #: called right after the steps are queued, only where
        #: ``fused_tap`` is set
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
        #: shard d's block of the table, on devices[d]
        self.states = [init_soa_table(self.cap_local, dev)
                       for dev in self.devices]

    @property
    def state(self) -> TableState:
        """The table of a one-shard engine (``states`` holds one block
        per shard)."""
        if self.n != 1:
            raise RuntimeError("a sharded table has one block per shard: "
                               "read .states")
        return self.states[0]

    def _decide(self, shard: int, batch: RequestBatch,
                now_ms: int) -> StepOutput:
        """One shard's decision step of a wave, on its device."""
        return decide_batch(self.states[shard], batch, now_ms)

    def _mask_out_of_domain(self, batch: RequestBatch, mslot=None):
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

    def _build_waves(self, khash: np.ndarray, pending: np.ndarray):
        """Route ``pending`` (in order) into waves of JAX's block layout.
        Returns [(idx, slots, bw)]: the wave's request indices, their
        positions in the [n·bw] block (None at n = 1: the rows in
        order) and the bucket width.  The stable sort keeps request
        order inside a shard; waves split at the largest bucket per
        shard, and each rides the smallest bucket covering its own
        densest shard."""
        Bw = self.wave_buckets[-1]
        if self.n == 1:
            waves = []
            for a in range(0, len(pending), Bw):
                idx = pending[a:a + Bw]
                bw = next(b for b in self.wave_buckets if len(idx) <= b)
                waves.append((idx, None, bw))
            return waves
        shard = shard_of(np.asarray(khash, np.uint64)[pending], self.n)
        order = np.argsort(shard, kind="stable")
        s_sorted = shard[order]
        starts = np.searchsorted(s_sorted, np.arange(self.n), "left")
        posin = np.arange(len(pending)) - starts[s_sorted]
        wave_id = posin // Bw
        waves = []
        for w in range(int(wave_id.max()) + 1 if len(pending) else 0):
            m = wave_id == w
            wcnt = int(np.bincount(s_sorted[m], minlength=self.n).max())
            bw = next((b for b in self.wave_buckets if wcnt <= b), Bw)
            slots = s_sorted[m].astype(np.int64) * bw + posin[m] % Bw
            waves.append((pending[order[m]], slots, bw))
        return waves

    def _fill_packed(self, batch: RequestBatch, idx: np.ndarray, slots,
                     bw: int):
        """The wave's requests into packed matrices ([8, n·bw] i64,
        [3, n·bw] i32) at their block positions; padding rows are
        empty_batch rows (eff_ms 1, invalid)."""
        at = slice(0, len(idx)) if slots is None else slots
        a64 = np.zeros((len(PACK64), self.n * bw), np.int64)
        a32 = np.zeros((len(PACK32), self.n * bw), np.int32)
        a64[PACK64.index("eff_ms")] = 1
        a64[0, at] = np.asarray(batch.key).view(np.int64)[idx]
        for i, f in enumerate(PACK64[1:], start=1):
            a64[i, at] = np.asarray(getattr(batch, f))[idx]
        for i, f in enumerate(PACK32):
            a32[i, at] = np.asarray(getattr(batch, f))[idx]
        return a64, a32

    def _upload(self, a64: np.ndarray, a32: np.ndarray) -> list:
        """The packed pair onto the mesh: one RequestBatch of device
        tensors per shard (its [bw] block).  The uploads are blocking
        copies from pageable memory: the host arrays (a leased pair on
        the wire lane) are read when this returns.  A mesh of one device
        takes one upload and per-shard views of it."""
        bw = a64.shape[1] // self.n
        if self._one_device:
            d64 = torch.from_numpy(a64).to(self.device)
            d32 = torch.from_numpy(a32).to(self.device)
            return [batch_from_packed(d64[:, d * bw:(d + 1) * bw],
                                      d32[:, d * bw:(d + 1) * bw])
                    for d in range(self.n)]
        return [batch_from_packed(
            torch.from_numpy(np.ascontiguousarray(
                a64[:, d * bw:(d + 1) * bw])).to(dev),
            torch.from_numpy(np.ascontiguousarray(
                a32[:, d * bw:(d + 1) * bw])).to(dev))
            for d, dev in enumerate(self.devices)]

    @staticmethod
    def _result_vector(out: StepOutput, mesh_hits=None) -> torch.Tensor:
        """One shard's results as one int64 vector: 5 output rows, then
        the over / insert counters and the mesh lane's applied hits."""
        if mesh_hits is None:
            mesh_hits = out.over_count.new_zeros(())
        return torch.cat([
            torch.stack([out.status.to(torch.int64), out.remaining,
                         out.reset_time, out.limit,
                         out.err.to(torch.int64)]).reshape(-1),
            out.over_count.reshape(1), out.insert_count.reshape(1),
            mesh_hits.reshape(1)])

    def _deliver_tap(self, batches: list, outs: list) -> None:
        """The wave's [4, n·bw] heavy-hitter tap (block order) to
        ``tap_sink``, on shard 0's device, where ``fused_tap`` is set."""
        if not self.fused_tap or self.tap_sink is None or self._tap_mute:
            return
        taps = [fused_tap_columns(b, o) for b, o in zip(batches, outs)]
        self.tap_sink(taps[0] if self.n == 1 else torch.cat(
            [t.to(self.device) for t in taps], dim=1))

    def _launch_arrays(self, a64: np.ndarray, a32: np.ndarray,
                       now_ms: int, mblk=None) -> list:
        """One wave: the uploads and one decision step per shard, not
        waited on.  Returns the shards' device result vectors.  ``mblk``
        (the mesh-GLOBAL slot of each block row) is the bucket engine's
        operand: the classic engine is never handed mesh rows."""
        batches = self._upload(a64, a32)
        outs = [self._decide(d, b, now_ms) for d, b in enumerate(batches)]
        self._deliver_tap(batches, outs)
        return [self._result_vector(o) for o in outs]

    def _finish_wave(self, packed: list):
        """One download per device for the wave; folds its counters.
        Returns (status, remaining, reset, limit, table_full) host
        columns in [n·bw] block order."""
        if len(packed) == 1 or self._one_device:
            host = torch.cat(packed).cpu().numpy() if len(packed) > 1 \
                else packed[0].cpu().numpy()
        else:
            host = np.concatenate([p.cpu().numpy() for p in packed])
        host = host.reshape(self.n, -1)
        B = (host.shape[1] - 3) // 5
        o = (host[0, :5 * B].reshape(5, B) if self.n == 1 else
             host[:, :5 * B].reshape(self.n, 5, B).transpose(1, 0, 2)
             .reshape(5, self.n * B))
        self.over_count += int(host[:, -3].sum())
        self.insert_count += int(host[:, -2].sum())
        mh = int(host[:, -1].sum())
        if mh:
            self._on_mesh_hits(mh)
        return o[0], o[1], o[2], o[3], o[4] != 0

    def _launch_waves(self, batch, khash, pending, now_ms, mslot=None):
        launched = []
        for idx, slots, bw in self._build_waves(khash, pending):
            a64, a32 = self._fill_packed(batch, idx, slots, bw)
            mblk = None
            if mslot is not None:
                mblk = np.full(self.n * bw, -1, np.int32)
                mblk[slice(0, len(idx)) if slots is None else slots] = \
                    np.asarray(mslot)[idx]
            launched.append((idx, slots, self._launch_arrays(
                a64, a32, now_ms, mblk)))
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
        for idx, slots, packed in launched:
            o_st, o_rem, o_rst, o_lim, o_err = self._finish_wave(packed)
            at = slice(0, len(idx)) if slots is None else slots
            status[idx] = o_st[at]
            rem_o[idx] = o_rem[at]
            rst_o[idx] = o_rst[at]
            lim_o[idx] = o_lim[at]
            err_idx.append(idx[o_err[at]])
        return (np.sort(np.concatenate(err_idx)) if err_idx
                else np.empty(0, np.int64))

    @staticmethod
    def _merge_ood(cols, ood):
        """Out-of-domain rows come back as table_full, outputs zeroed."""
        if ood is not None:
            cols[4][ood] = True
        return tuple(cols)

    def _premask_cold(self, batch: RequestBatch, khash: np.ndarray,
                      mslot=None):
        """(batch with its cold-resident rows invalid, their mask, the
        rows' valid-and-keyed mask), or (batch, None, None) without a
        tier.  Mesh-pinned rows (mslot >= 0) are never cold: the pin's
        seed pops the cold copy."""
        tier = self.tier
        if tier is None:
            return batch, None, None
        kh = np.asarray(khash)
        orig_valid = np.asarray(batch.valid, bool) & (kh != 0)
        cold = tier.resident_mask(kh) & orig_valid
        if mslot is not None:
            cold &= np.asarray(mslot) < 0
        if cold.any():
            batch = batch._replace(valid=np.asarray(batch.valid, bool)
                                   & ~cold)
        return batch, cold, orig_valid

    def _resolve_ood(self, batch, khash, now_ms: int, cols: tuple,
                     ood, mslot=None) -> tuple:
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
                                 need, mslot=mslot)

    def check_packed(self, batch: RequestBatch, khash: np.ndarray,
                     now_ms: int, mslot=None) -> tuple:
        """Numpy request columns in, response columns out: (status i32,
        limit i64, remaining i64, reset_time i64, table_full bool).
        Invalid rows come back zeroed (the caller owns their errors).
        Rows whose probe window is full get one retry after an expiry
        sweep, then one after each auto-grow while under the limit.
        With a cold tier, cold-resident rows stay out of the waves and
        they, the rows still full and (bucket engine) the out-of-domain
        rows without a device row are served by ``tier.resolve``.
        ``mslot``: each row's mesh-GLOBAL replica slot, -1 for the
        table (the bucket engine with a bound mesh tier only)."""
        batch, ood = self._mask_out_of_domain(batch, mslot)
        batch, cold, orig_valid = self._premask_cold(batch, khash, mslot)
        cols = self._new_columns(len(khash))
        # no valid row (a re-run of cold rows alone): no wave to launch,
        # the rows answer from the tier below
        pending = (self._arrival_order(batch)
                   if np.asarray(batch.valid, bool).any()
                   else np.empty(0, np.int64))
        retried = False
        while len(pending):
            err = self._collect(self._launch_waves(
                batch, khash, pending, now_ms, mslot), cols)
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
                                cold, orig_valid, mslot=mslot)
        cols = self._merge_ood(list(cols), ood)
        if tier is not None and ood is not None:
            cols = self._resolve_ood(batch, khash, now_ms, cols, ood,
                                     mslot)
        return cols

    def launch_packed(self, batch: RequestBatch, khash: np.ndarray,
                      now_ms: int, mslot=None):
        """check_packed split in two: launch the waves without waiting
        and return a token for ``sync_packed``.  Cold-resident rows (and,
        with a tier, out-of-domain rows) ride the waves invalid and
        their indices ride the token: the sync re-runs them through
        check_packed under the engine lock, which serves each from the
        tier its key is in then (a promotion may land in between).
        ``mslot`` rides the token so the re-runs keep their lanes."""
        batch, ood = self._mask_out_of_domain(batch, mslot)
        cold_idx = None
        if self.tier is not None:
            kh = np.asarray(khash)
            cm = self.tier.resident_mask(kh) & np.asarray(batch.valid, bool) \
                & (kh != 0)
            if mslot is not None:
                cm &= np.asarray(mslot) < 0
            if ood is not None:
                cm[ood] = True
                ood = None
            if cm.any():
                cold_idx = np.nonzero(cm)[0]
                batch = batch._replace(
                    valid=np.asarray(batch.valid, bool) & ~cm)
        return (batch, khash, now_ms, ood, cold_idx, mslot,
                self._launch_waves(batch, khash, self._arrival_order(batch),
                                   now_ms, mslot))

    def sync_packed(self, token, engine_lock=None) -> tuple:
        """Wait for launched waves and assemble check_packed's columns.
        Table-full rows and the token's cold rows re-run through
        check_packed (under ``engine_lock`` when given: it mutates the
        table)."""
        batch, khash, now_ms, ood, cold_idx, mslot, launched = token
        cols = self._new_columns(len(khash))
        err = self._collect(launched, cols)
        lock = (engine_lock if engine_lock is not None
                else contextlib.nullcontext())
        if len(err):
            with lock:
                r_cols = self.check_packed(
                    _take(batch, err), khash[err], now_ms,
                    None if mslot is None else np.asarray(mslot)[err])
            for c, rc in zip(cols, r_cols):
                c[err] = rc
        if cold_idx is not None:
            sub = _take(batch, cold_idx)
            sub = sub._replace(valid=np.ones(len(cold_idx), bool))
            with lock:
                r_cols = self.check_packed(
                    sub, khash[cold_idx], now_ms,
                    None if mslot is None else np.asarray(mslot)[cold_idx])
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
        what the pass does not model (a mesh of more than one shard,
        protobuf framing, Gregorian rows, an empty message, more rows
        than the largest bucket): the caller then takes the parse or
        the protobuf lane."""
        if self.n != 1:
            return None
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
            a64, a32 = self._fill_packed(empty_batch(1), np.empty(0, np.int64),
                                         None, bw)
            self._finish_wave(self._launch_arrays(a64, a32, now_ms))

    # ---- sweep, grow, occupancy ----------------------------------------

    def sweep(self, now_ms: int) -> None:
        """Reclaim expired rows (K2 on a CUDA table, once per shard) and
        count the live ones, summed over the shards.  With auto-grow on,
        double every shard once live rows pass 60% of the table: probe
        windows start to fill on unlucky keys well before the table is
        full, and the sweep tick is off the serving path, so requests do
        not pay for the grow."""
        self.live_rows = sum(int(sweep_table(st, now_ms))
                             for st in self.states)
        self.sweep_count += 1
        if (self.auto_grow_limit
                and self.cap_local * 2 <= self.auto_grow_limit
                and self.live_rows > 0.6 * self.cap_local * self.n):
            dropped = self.grow(self.cap_local * 2)
            if dropped:
                log.warning("proactive grow to %d rows a shard dropped %d "
                            "live rows", self.cap_local, dropped)

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
            log.warning("auto-grow to %d rows a shard dropped %d live rows "
                        "(probe-window exhaustion)", self.cap_local,
                        dropped)
        return True

    def grow(self, new_capacity: int) -> int:
        """Re-place every shard's live rows into a fresh block of
        ``new_capacity`` rows on its device, with the step's claim rounds
        (the JAX make_grow; rows never cross shards).  Returns the rows
        dropped, summed over the shards (their probe window in the new
        block was full or they lost every claim round; non-zero mostly
        when shrinking into high occupancy).  The old columns are
        replaced, not updated: hold no alias of them across a grow."""
        if new_capacity & (new_capacity - 1) or new_capacity <= 0:
            raise ValueError(
                f"capacity must be a power of two, got {new_capacity}")
        dropped = 0
        for d, old in enumerate(self.states):
            key = old.key
            valid = key != 0
            fresh = init_soa_table(new_capacity, self.devices[d])
            row, _ = _insert(fresh.key, _probe_slots(key, new_capacity),
                             key, valid, torch.full_like(key, -1))
            placed = valid & (row >= 0)
            wrow = row[placed]
            for f in VALUE_COLS:
                getattr(fresh, f)[wrow] = getattr(old, f)[placed]
            dropped += int((valid & ~placed).sum())
            self.states[d] = fresh
        self.cap_local = new_capacity
        self.dropped_rows += dropped
        return dropped

    def occupancy(self) -> int:
        """Live (non-empty) rows right now, over every shard."""
        return sum(int(occupancy(st)) for st in self.states)

    def _live_count(self) -> torch.Tensor:
        """The live rows as a 0-d tensor on shard 0's device (queued,
        not read)."""
        counts = [occupancy(st) for st in self.states]
        return counts[0] if self.n == 1 else torch.stack(
            [c.to(self.device) for c in counts]).sum()

    def table_tensors(self) -> list:
        """The tensors that hold the table (the memory ledger's bytes)."""
        return [c for st in self.states for c in st]

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

    def _keys_tensor(self, khash: np.ndarray, shard: int = 0
                     ) -> torch.Tensor:
        k = np.ascontiguousarray(np.asarray(khash, np.uint64)).view(np.int64)
        return torch.from_numpy(k.copy()).to(self.devices[shard])

    def _by_shard(self, khash: np.ndarray):
        """[(shard, indices)] of the keys each shard owns, each in the
        keys' order (the JAX row programs' waves keep it)."""
        kh = np.asarray(khash, np.uint64)
        if self.n == 1:
            return [(0, np.arange(len(kh)))]
        shard = shard_of(kh, self.n)
        return [(d, np.nonzero(shard == d)[0]) for d in range(self.n)]

    def _row_waves(self, m: int):
        """[a, b) ranges of the row-op waves: B keys each, in order."""
        return [(a, min(a + self.B, m)) for a in range(0, m, self.B)]

    def gather_rows(self, khash: np.ndarray) -> tuple[np.ndarray, dict]:
        """(found mask, value-column dict) for the given key hashes.  A
        key that is not found reads its shard's row 0, as the JAX gather
        does."""
        khash = np.asarray(khash, np.uint64)
        m = len(khash)
        found = np.zeros(m, bool)
        out = {f: np.zeros(m, np.int32 if f == "meta" else np.int64)
               for f in VALUE_COLS}
        for d, sel in self._by_shard(khash):
            st = self.states[d]
            for a, b in self._row_waves(len(sel)):
                at = sel[a:b]
                keys = self._keys_tensor(khash[at], d)
                row, _ = _lookup(st.key, _probe_slots(keys, self.cap_local),
                                 keys)
                f = (keys != 0) & (row >= 0)
                r = torch.where(f, row, 0)
                found[at] = f.cpu().numpy()
                for name in VALUE_COLS:
                    out[name][at] = getattr(st, name)[r].cpu().numpy()
        return found, out

    def upsert_rows(self, khash: np.ndarray, cols: dict) -> int:
        """Find-or-insert rows, on each key's shard in waves of B keys
        with the step's claim rounds, and overwrite their values;
        returns the rows placed (others dropped: probe window full)."""
        khash = np.asarray(khash, np.uint64)
        placed_total = 0
        for d, sel in self._by_shard(khash):
            st = self.states[d]
            for a, b in self._row_waves(len(sel)):
                at = sel[a:b]
                keys = self._keys_tensor(khash[at], d)
                valid = keys != 0
                row, _ = _insert(st.key, _probe_slots(keys, self.cap_local),
                                 keys, valid, torch.full_like(keys, -1))
                placed = valid & (row >= 0)
                wrow = row[placed]
                for f in VALUE_COLS:
                    col = getattr(st, f)
                    v = torch.from_numpy(np.ascontiguousarray(
                        np.asarray(cols[f])[at].astype(
                            np.int32 if f == "meta" else np.int64)))
                    col[wrow] = v.to(self.devices[d])[placed]
                placed_total += int(placed.sum())
        return placed_total

    def remove_rows(self, khash: np.ndarray) -> int:
        """Delete rows by key hash (key and expire_at → 0); returns the
        rows removed."""
        khash = np.asarray(khash, np.uint64)
        removed = 0
        for d, sel in self._by_shard(khash):
            st = self.states[d]
            for a, b in self._row_waves(len(sel)):
                keys = self._keys_tensor(khash[sel[a:b]], d)
                row, _ = _lookup(st.key, _probe_slots(keys, self.cap_local),
                                 keys)
                found = (keys != 0) & (row >= 0)
                w = row[found]
                st.key[w] = 0
                st.expire_at[w] = 0
                removed += int(found.sum())
        return removed

    def probe_occupant_keys(self, kh: int) -> np.ndarray:
        """The key hashes in ``kh``'s probe window on its shard (0 = a
        free slot): the tier's eviction candidates, any of which frees a
        slot ``kh`` can take once demoted."""
        d = int(shard_of(int(kh), self.n))
        keys = self._keys_tensor(np.array([kh], np.uint64), d)
        slots = _probe_slots(keys, self.cap_local)[0]
        return self.states[d].key[slots].cpu().numpy().view(np.uint64)

    def each(self):
        """The live rows as store.CacheItems (cache.go › Each), from one
        snapshot: admin and debug tooling."""
        yield from items_from_arrays(self.snapshot())

    # ---- checkpoint / resume (store.py column dict) --------------------

    def snapshot(self) -> dict:
        """Live rows as a store.py column dict (host; uint64 key), in
        the global table's order: shard 0's block first."""
        parts = [soa_to_numpy(st) for st in self.states]
        cols = {f: np.concatenate([p[f] for p in parts]) for f in parts[0]}
        live = cols["key"] != 0
        return {f: c[live] for f, c in cols.items()}

    def restore(self, arrays: dict) -> int:
        """Insert snapshot rows (either package's ``snapshot()``, at any
        shard count) into the table.  Each row goes to the shard
        ``shard_of`` names at this engine's n and takes its first probe
        slot there that is empty or holds its key, in row order, exactly
        as the JAX restore's host loop places them.  The rows whose
        probe window is full go to the cold tier when there is one, else
        they are dropped (as in the JAX restore); returns the rows
        placed in either tier.

        The placement runs on each shard's device in rounds: a row is
        placed once no earlier unplaced row could still take its slot
        (the lowest unplaced row always can), so later rows never
        change what an earlier one finds."""
        n = len(arrays["key"])
        if n == 0:
            return 0
        khash = np.asarray(arrays["key"]).astype(np.uint64)
        placed = 0
        unplaced = []
        for d, sel in self._by_shard(khash):
            if not len(sel):
                continue
            p, u = self._restore_shard(d, khash[sel], arrays, sel)
            placed += p
            unplaced.append(sel[u])
        if self.tier is not None and unplaced:
            idx = np.concatenate(unplaced)
            if len(idx):
                placed += self.tier.adopt_rows(arrays, np.sort(idx))
        return placed

    def _restore_shard(self, d: int, khash: np.ndarray, arrays: dict,
                       sel: np.ndarray) -> tuple[int, np.ndarray]:
        """Place rows ``sel`` of ``arrays`` (keys ``khash``) into shard
        ``d``; returns (rows placed, positions in ``sel`` unplaced)."""
        n = len(sel)
        st, cap, dev = self.states[d], self.cap_local, self.devices[d]
        keys = self._keys_tensor(khash, d)
        vals = {f: torch.from_numpy(np.ascontiguousarray(
            np.asarray(arrays[f])[sel].astype(
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
        return placed, torch.cat(unplaced).cpu().numpy()
