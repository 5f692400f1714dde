"""BucketEngine: serving over the bucketized table, range-sharded over a
mesh.

The twin of gubernator_tpu/parallel/pallas_engine.py ›
PallasServingEngine with its fused serving (FusedServingMixin).  As
that class derives from the JAX ShardedEngine, this one derives from the
port's (sharded.py), whose mesh, wave routing and retry loop it shares:
requests are put in arrival order, routed to their shard's block of
JAX's [n·bw] layout, and each wave is ONE decision step per shard
(ops/decide.py: K1 on a CUDA table) whose outputs also make the wave's
[4, n·bw] heavy-hitter tap.  Shard d's bucket rows live on
``mesh.devices[d]``; a key's bucket within its shard takes the low bits
of its hash (the shard the top bits), as in JAX.  It overrides the
table, the step, the domain gate, the sweep, the row ops and snapshot /
restore.

The mesh lane (GUBER_GLOBAL_MODE=mesh): with a mesh-GLOBAL tier bound
(``bind_mesh``, meshglobal.py), a wave whose ``mslot`` column marks
pinned rows is the fused mesh launch: those rows leave K1's wave and
decide on their home replica with the SoA step (core/step.py, as JAX
uses ``decide_batch_impl`` there), their applied hits are scatter-added
into the replica's active accumulator, and the two lanes merge row by
row; ``mesh_fused_hits`` (and ``gubernator_pallas_mesh_fused_hits``)
count the hits it applied.

Domain: the step serves TOKEN and LEAKY rows whose counters are < 2^30
and (leaky) eff < 2^31.  Out-of-domain rows are scoped per row: left
out of the step and answered as table_full, never truncated into wrong
decisions and never failing the other rows of the wave, on every path
(``check_packed``, ``launch_packed`` and the wire lane's
``check_prepacked``, which all call ``_mask_out_of_domain``); the
classic engine (``GUBER_ENGINE=xla``) serves them, and so does the cold
tier (tiering.py) for keys with no device row.  A bucket-full row gets
one retry after an expiry sweep, then goes to the cold tier when there
is one; there is no grow.

Cold-tier hooks: ``tier_row_admissible`` keeps a cold row out of K1's
domain from being promoted (the upsert would drop it),
``probe_occupant_keys`` reads the 8 keys of a key's bucket (the
eviction candidates), and ``restore`` puts what the buckets or K1's
domain refuse into the tier.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.batch import RequestBatch, empty_batch
from .core.step import StepOutput
from .core.table import (EFF_BOUND, SLOTS, VALUE_BOUND, W_ALG, W_DHI,
                         W_DLO, W_EHI, W_ELO, W_KHI, W_KLO, W_LIMIT, W_REM,
                         W_STATUS, W_TDHI, W_TDLO, W_THI, W_TLO, W_XHI,
                         W_XLO, WORDS, init_table, join64, split64)
from .hashing import shard_of
from .ops.decide import K1Tally, decide, value_domain_mask
from .sharded import ShardedEngine
from .tracing import step

#: snapshot column → (lo word, hi word)
_I64_PAIRS = {"duration": (W_DLO, W_DHI),
              "eff_ms": (W_ELO, W_EHI),
              "t_ms": (W_TLO, W_THI),
              "expire_at": (W_XLO, W_XHI)}
_ROW_COLS = ("meta", "limit", "duration", "eff_ms", "burst", "remaining",
             "t_ms", "expire_at")


# ---- host-side row conversion (snapshot / restore / row ops) ----------

def _join_u64(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    return ((hi.astype(np.uint32).astype(np.uint64) << np.uint64(32))
            | lo.astype(np.uint32).astype(np.uint64))


def _join_i64(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    return _join_u64(hi, lo).astype(np.int64)


def _split_np(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    u = x.astype(np.uint64)
    return ((u >> np.uint64(32)).astype(np.uint32).astype(np.int32),
            u.astype(np.uint32).astype(np.int32))


def _rows_to_columns(rows: np.ndarray) -> dict:
    """[N, WORDS] int32 rows → store.py column dict of the live rows.
    ``burst`` is emitted as ``limit``: the table does not store burst
    (a leaky request overwrites it before every read)."""
    key = _join_u64(rows[:, W_KHI], rows[:, W_KLO])
    live = key != 0
    r = rows[live]
    key = key[live]
    alg = r[:, W_ALG].astype(np.int64)
    status = r[:, W_STATUS].astype(np.int64)
    limit = r[:, W_LIMIT].astype(np.int64)
    remaining = np.where(alg == 1, _join_i64(r[:, W_TDHI], r[:, W_TDLO]),
                         r[:, W_REM].astype(np.int64))
    out = {"key": key,
           "meta": (alg | ((status & 1) << 1)).astype(np.int32),
           "limit": limit, "burst": limit, "remaining": remaining}
    for name, (wlo, whi) in _I64_PAIRS.items():
        out[name] = _join_i64(r[:, whi], r[:, wlo])
    return out


def _columns_to_words_batch(arrays: dict, keys: np.ndarray
                            ) -> tuple[np.ndarray, np.ndarray]:
    """Snapshot rows → ([n, WORDS] int32 rows, [n] bool in-domain mask).

    Out of domain (dropped with a count by the caller): limit >= 2^30,
    token remaining >= 2^30, leaky eff outside [1, 2^31), or leaky
    remaining (td units) outside [0, 2^30 × eff)."""
    n = len(keys)
    meta = np.asarray(arrays["meta"], np.int64)
    alg = meta & 1
    limit = np.asarray(arrays["limit"], np.int64)
    rem = np.asarray(arrays["remaining"], np.int64)
    eff = np.asarray(arrays["eff_ms"], np.int64)
    leaky = alg == 1
    valid = limit < VALUE_BOUND
    valid &= ~leaky | ((eff >= 1) & (eff < EFF_BOUND))
    valid &= leaky | (rem < VALUE_BOUND)
    valid &= ~leaky | ((rem >= 0)
                       & (rem < VALUE_BOUND * np.maximum(eff, 1)))
    w = np.zeros((n, WORDS), np.int32)
    khi, klo = _split_np(keys.astype(np.uint64))
    w[:, W_KLO], w[:, W_KHI] = klo, khi
    w[:, W_STATUS] = ((meta >> 1) & 1).astype(np.int32)
    w[:, W_LIMIT] = np.where(valid, limit, 0).astype(np.int32)
    w[:, W_ALG] = alg.astype(np.int32)
    tdhi, tdlo = _split_np(np.where(valid & leaky, rem, 0))
    w[:, W_TDLO], w[:, W_TDHI] = tdlo, tdhi
    w[:, W_REM] = np.where(valid & ~leaky, rem, 0).astype(np.int32)
    for name, (wlo, whi) in _I64_PAIRS.items():
        hi, lo = _split_np(np.asarray(arrays[name], np.int64))
        w[:, wlo], w[:, whi] = lo, hi
    return w, valid


def _dedupe_last(keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(keep indices, occurrence counts): each key's LAST occurrence's
    values at its FIRST occurrence's position, as a sequential walk
    would leave them."""
    _, first_idx, counts = np.unique(keys, return_index=True,
                                     return_counts=True)
    _, last_rev = np.unique(keys[::-1], return_index=True)
    last_idx = len(keys) - 1 - last_rev  # aligned: both sorted by key
    order = np.argsort(first_idx)
    return last_idx[order], counts[order]


def _place_into_buckets(rows: torch.Tensor, keys: torch.Tensor,
                        words: torch.Tensor) -> torch.Tensor:
    """Insert-or-update distinct keys into the table, in place, on the
    table's device.  Existing keys overwrite their slot; new keys take
    their bucket's empty slots in caller order.  Returns the [n] bool
    mask of rows that found a slot.  Only the two key words of each
    bucket are gathered, so extra memory is O(n × SLOTS) words."""
    dev = rows.device
    n_buckets = rows.shape[0] // SLOTS
    bucket = keys & (n_buckets - 1)
    khi, klo = split64(keys)
    kw = rows.view(n_buckets, SLOTS, WORDS)[:, :, W_KLO:W_KHI + 1][bucket]
    hit = (kw[:, :, 0] == klo[:, None]) & (kw[:, :, 1] == khi[:, None])
    placed = hit.any(1)
    slot = hit.to(torch.int8).argmax(1)
    new = (~placed).nonzero().squeeze(1)
    if new.numel():
        sb, perm = torch.sort(bucket[new], stable=True)
        order = new[perm]
        pos = torch.arange(sb.numel(), device=dev)
        start = torch.ones_like(sb, dtype=torch.bool)
        start[1:] = sb[1:] != sb[:-1]
        run0 = torch.where(start, pos, torch.zeros_like(pos)).cummax(0).values
        rank = pos - run0
        empty = (kw[order, :, 0] == 0) & (kw[order, :, 1] == 0)
        # the row with rank r in its bucket takes the (r+1)-th empty slot
        sel = empty & (torch.cumsum(empty.to(torch.int64), 1)
                       == (rank + 1)[:, None])
        got = sel.any(1)
        placed[order[got]] = True
        slot[order[got]] = sel[got].to(torch.int8).argmax(1)
    # (bucket, slot) pairs are distinct: hits sit at distinct occupied
    # slots, new keys at distinct empties
    rows[bucket[placed] * SLOTS + slot[placed]] = words[placed]
    return placed


class BucketEngine(ShardedEngine):
    """Serving engine over the bucketized table, one block per mesh
    shard, with the fused mesh-GLOBAL lane."""

    #: the step emits the wave's heavy-hitter tap (fused_tap_columns)
    fused_tap = True

    def __init__(self, device="cuda", capacity: int = 1 << 16,
                 batch_rows: int = 1024, mesh=None):
        #: the bound mesh-GLOBAL tier (meshglobal.py), or None: one
        #: reference swap; a wave racing an unbind serves one more mesh
        #: wave, which the tier's state lock keeps exact
        self._mge = None
        #: mesh-GLOBAL hits the fused waves applied (the injected side
        #: of the tier's conservation ledger)
        self.mesh_fused_hits = 0  # lock-free: sync path, under the engine lock
        super().__init__(device=device, capacity=capacity,
                         batch_rows=batch_rows, mesh=mesh)

    # ---- the table, the step and the domain gate -----------------------

    def _init_table(self) -> None:
        if self.cap_local < SLOTS or self.cap_local & (self.cap_local - 1):
            raise ValueError(f"rows per shard must be a power of two "
                             f">= {SLOTS}")
        #: shard d's bucket rows, on devices[d]
        self.shard_rows = [init_table(self.cap_local, dev)
                           for dev in self.devices]

    @property
    def rows(self) -> torch.Tensor:
        """The bucket rows of a one-shard engine (``shard_rows`` holds
        one block per shard)."""
        if self.n != 1:
            raise RuntimeError("a sharded table has one block per shard: "
                               "read .shard_rows")
        return self.shard_rows[0]

    def _decide(self, shard: int, batch: RequestBatch,
                now_ms: int, tally: K1Tally | None = None) -> StepOutput:
        return decide(self.shard_rows[shard], batch, now_ms, tally)

    def _mask_out_of_domain(self, batch: RequestBatch, mslot=None):
        """Invalidate rows outside the step's value domain; returns
        (masked batch, their indices or None).  Mesh-GLOBAL rows (mslot
        >= 0) are exempt: they decide on the tier's SoA replica, which
        has the whole domain."""
        mask = value_domain_mask(batch)
        if mslot is not None:
            mask = mask | (np.asarray(mslot) >= 0)
        v = np.asarray(batch.valid)
        ood = v & ~mask
        if not ood.any():
            return batch, None
        return batch._replace(valid=v & mask), np.nonzero(ood)[0]

    # ---- the mesh-GLOBAL lane (meshglobal.py) --------------------------

    def bind_mesh(self, mge) -> None:
        """Attach the mesh-GLOBAL tier: a wave whose ``mslot`` column
        marks pinned rows serves them on the home replica and its
        accumulator in the same launch as K1's rows."""
        if mge.n != self.n:
            raise ValueError("the mesh-GLOBAL tier and the serving engine "
                             "must share the mesh")
        self._mge = mge

    def unbind_mesh(self) -> None:
        """Detach: later waves serve every row through K1."""
        self._mge = None

    @property
    def mesh_bound(self) -> bool:
        return self._mge is not None

    def warmup_mesh_fused(self, now_ms: int = 1) -> None:
        """Run the fused mesh launch once per wave bucket: an all-invalid
        wave whose one marked row is invalid (nothing moves)."""
        if self._mge is None:
            return
        for bw in self.wave_buckets:
            a64, a32 = self._fill_packed(empty_batch(1),
                                         np.empty(0, np.int64), None, bw)
            mblk = np.full(self.n * bw, -1, np.int32)
            mblk[0] = 0
            self._finish_wave(self._launch_arrays(a64, a32, now_ms, mblk))

    def _launch_arrays(self, a64: np.ndarray, a32: np.ndarray,
                       now_ms: int, mblk=None) -> tuple:
        """One wave; with the tier bound and mesh rows in it, the fused
        mesh launch: per shard, K1 over the rows whose ``mslot`` is -1,
        the SoA step over the mesh rows on the shard's (their home)
        replica, each applied hit scatter-added into the replica's
        active accumulator at its pinned slot, the two lanes merged row
        by row (the JAX make_fused_mesh_step_packed)."""
        mge = self._mge
        if mge is None or mblk is None or not (mblk >= 0).any():
            return super()._launch_arrays(a64, a32, now_ms)
        with step("wave.upload"):
            batches = self._upload(a64, a32)
        bw = a64.shape[1] // self.n
        tally = K1Tally(mesh=True)
        # the mesh rows' slots ride the launch (a copy of one row)
        with step("wave.launch"):
            masks, slots, k1_outs = [], [], []
            for d, b in enumerate(batches):
                ms = torch.from_numpy(mblk[d * bw:(d + 1) * bw]).to(
                    self.devices[d])
                masks.append(ms >= 0)
                slots.append(ms)
                # K1 over the table rows, outside the tier's locks
                k1_outs.append(self._decide(
                    d, b._replace(valid=b.valid & ~masks[d]), now_ms,
                    tally))
            mouts, hits = mge.serve_rows(
                [b._replace(valid=b.valid & m)
                 for b, m in zip(batches, masks)], slots, now_ms)
            outs = []
            for mesh_rows, out, mout in zip(masks, k1_outs, mouts):
                outs.append(StepOutput(
                    status=torch.where(mesh_rows, mout.status, out.status),
                    remaining=torch.where(mesh_rows, mout.remaining,
                                          out.remaining),
                    reset_time=torch.where(mesh_rows, mout.reset_time,
                                           out.reset_time),
                    limit=torch.where(mesh_rows, mout.limit, out.limit),
                    err=torch.where(mesh_rows, mout.err, out.err),
                    over_count=out.over_count + mout.over_count,
                    insert_count=out.insert_count + mout.insert_count))
            hits = [h.sum() for h in hits]
            self._deliver_tap(batches, outs)
            return [self._result_vector(o, h)
                    for o, h in zip(outs, hits)], tally

    def _on_mesh_hits(self, hits: int) -> None:
        """The fused waves' applied mesh hits: the injected side of the
        tier's folded == injected ledger."""
        self.mesh_fused_hits += hits
        mge = self._mge
        if mge is not None:
            mge.note_injected(hits)
        m = self.metrics_ref
        if m is not None:
            m.pallas_mesh_fused_hits.inc(hits)

    # ---- sweep, grow and occupancy -------------------------------------

    def sweep(self, now_ms: int) -> None:
        """Zero every live slot whose expire_at <= now (the whole row, so
        leaky td state cannot leak into a future occupant), shard by
        shard."""
        live_n = 0
        for r in self.shard_rows:
            live = (r[:, W_KLO] != 0) | (r[:, W_KHI] != 0)
            expired = live & (join64(r[:, W_XHI], r[:, W_XLO]) <= int(now_ms))
            r.masked_fill_(expired[:, None], 0)
            live_n += int((live & ~expired).sum())
        self.live_rows = live_n
        self.sweep_count += 1

    def grow(self, new_capacity: int) -> int:
        raise NotImplementedError(
            "the bucket engine has no on-device grow; size cache_size for "
            "peak keys up front (bucket-full rows err as table_full)")

    def occupancy_and_saturation(self) -> tuple[int, int, int]:
        """(live rows, full buckets, total buckets) over every shard, in
        one device pass a shard: a full 8-slot bucket turns every new
        key in it into table_full, so the full-bucket count is the
        capacity early warning."""
        occ = full = 0
        for r in self.shard_rows:
            live = (r[:, W_KLO] != 0) | (r[:, W_KHI] != 0)
            per_bucket = live.view(-1, SLOTS).sum(1)
            o, f = torch.stack([live.sum(),
                                (per_bucket == SLOTS).sum()]).cpu().tolist()
            occ += int(o)
            full += int(f)
        return occ, full, self.n * self.cap_local // SLOTS

    def occupancy(self) -> int:
        return self.occupancy_and_saturation()[0]

    def _live_count(self) -> torch.Tensor:
        counts = [((r[:, W_KLO] != 0) | (r[:, W_KHI] != 0)).sum()
                  for r in self.shard_rows]
        return counts[0] if self.n == 1 else torch.stack(
            [c.to(self.device) for c in counts]).sum()

    def table_tensors(self) -> list:
        return list(self.shard_rows)

    # ---- row ops (cold path) -------------------------------------------

    def _find(self, shard: int, keys: torch.Tensor):
        """(row index of each key's slot in shard ``shard``, found mask)
        on the shard's device."""
        n_buckets = self.cap_local // SLOTS
        bucket = keys & (n_buckets - 1)
        khi, klo = split64(keys)
        kw = self.shard_rows[shard].view(n_buckets, SLOTS, WORDS)[
            :, :, W_KLO:W_KHI + 1][bucket]
        hit = (kw[:, :, 0] == klo[:, None]) & (kw[:, :, 1] == khi[:, None])
        found = hit.any(1) & (keys != 0)
        return bucket * SLOTS + hit.to(torch.int8).argmax(1), found

    def gather_rows(self, khash: np.ndarray) -> tuple[np.ndarray, dict]:
        """(found mask, store.py value columns) for the given keys."""
        khash = np.asarray(khash, np.uint64)
        m = len(khash)
        found = np.zeros(m, bool)
        cols = {f: np.zeros(m, np.int64) for f in _ROW_COLS}
        cols["meta"] = cols["meta"].astype(np.int32)
        for d, sel in self._by_shard(khash):
            if not len(sel):
                continue
            idx, f = self._find(d, self._keys_tensor(khash[sel], d))
            f_host = f.cpu().numpy()
            got = self.shard_rows[d][idx[f]]
            cvt = _rows_to_columns(got.cpu().numpy())
            hit = sel[f_host]
            found[hit] = True
            for c in cols:
                cols[c][hit] = cvt[c]
        return found, cols

    def _prepared_rows(self, khash: np.ndarray, cols: dict):
        """Convert, drop (and count) out-of-domain rows, then dedupe the
        survivors last-write-wins with per-key occurrence counts."""
        keys = np.asarray(khash).astype(np.uint64)
        words, valid = _columns_to_words_batch(cols, keys)
        self.dropped_rows += int((~valid).sum())
        keys, words = keys[valid], words[valid]
        counts = np.ones(len(keys), np.int64)
        if keys.size:
            keep, counts = _dedupe_last(keys)
            if len(keep) != len(keys):
                keys, words = keys[keep], words[keep]
        return keys, words, counts

    def _place(self, keys: np.ndarray, words: np.ndarray) -> np.ndarray:
        """Place distinct keys into their shards' buckets; the [n] bool
        mask of the keys that found a slot."""
        placed = np.zeros(len(keys), bool)
        for d, sel in self._by_shard(keys):
            if len(sel):
                placed[sel] = _place_into_buckets(
                    self.shard_rows[d], self._keys_tensor(keys[sel], d),
                    torch.from_numpy(words[sel]).to(self.devices[d])
                ).cpu().numpy()
        return placed

    def upsert_rows(self, khash: np.ndarray, cols: dict) -> int:
        """Find-or-insert rows and overwrite their state; returns the
        rows placed (the rest: bucket full or out of domain, counted in
        ``dropped_rows``)."""
        if len(khash) == 0:
            return 0
        keys, words, counts = self._prepared_rows(khash, cols)
        if keys.size == 0:
            return 0
        placed = self._place(keys, words)
        self.dropped_rows += int(counts[~placed].sum())
        return int(counts[placed].sum())

    def remove_rows(self, khash: np.ndarray) -> int:
        """Delete rows by key hash; returns the rows removed."""
        khash = np.asarray(khash, np.uint64)
        removed = 0
        for d, sel in self._by_shard(khash):
            if not len(sel):
                continue
            idx, found = self._find(d, self._keys_tensor(khash[sel], d))
            self.shard_rows[d][idx[found]] = 0
            removed += int(found.sum())
        return removed

    # ---- checkpoint / resume -------------------------------------------

    def snapshot(self) -> dict:
        """Live rows as a store.py column dict (host), in the global
        table's order: shard 0's block first."""
        return _rows_to_columns(np.concatenate(
            [r.cpu().numpy() for r in self.shard_rows]))

    def restore(self, arrays: dict) -> int:
        """Insert snapshot rows (either package's ``snapshot()``, at any
        shard count), each into the shard ``shard_of`` names at this
        engine's n; the placement runs on the shards' devices.  Rows
        outside K1's domain and rows of a full bucket go to the cold
        tier when there is one, else they are dropped (counted in
        ``dropped_rows``).  Returns the rows restored in either tier."""
        n = len(arrays["key"])
        if n == 0:
            return 0
        keys = np.asarray(arrays["key"]).astype(np.uint64)
        words, refused = _columns_to_words_batch(arrays, keys)
        refused = ~refused
        vidx = np.nonzero(~refused)[0]
        placed_n = 0
        if vidx.size:
            keep, counts = _dedupe_last(keys[vidx])
            sel = vidx[keep]
            placed = self._place(keys[sel], words[sel])
            placed_n = int(counts[placed].sum())
            if len(sel) == len(vidx):  # no key repeats: one row a key
                refused[sel[~placed]] = True
            elif not placed.all():
                refused |= np.isin(keys, keys[sel][~placed])
        if self.tier is not None and refused.any():
            return placed_n + self.tier.adopt_rows(arrays,
                                                   np.nonzero(refused)[0])
        self.dropped_rows += int(refused.sum())
        return placed_n

    # ---- cold-tier hooks (tiering.py) ----------------------------------

    def tier_row_admissible(self, row) -> bool:
        """Whether a cold row (ROW_COLS order) lies in K1's domain: a row
        outside it stays cold, since the upsert would drop it."""
        cols = {f: np.array([v], np.int64) for f, v in zip(_ROW_COLS, row)}
        cols["meta"] = cols["meta"].astype(np.int32)
        _, valid = _columns_to_words_batch(cols, np.array([1], np.uint64))
        return bool(valid[0])

    def probe_occupant_keys(self, kh: int) -> np.ndarray:
        """The 8 key hashes of ``kh``'s bucket on its shard (0 = a free
        slot): the bucket is the key's probe window.  One small read."""
        d = int(shard_of(int(kh), self.n))
        n_buckets = self.cap_local // SLOTS
        b = int(np.uint64(kh) & np.uint64(n_buckets - 1))
        kw = self.shard_rows[d].view(n_buckets, SLOTS, WORDS)[
            b, :, W_KLO:W_KHI + 1].cpu().numpy()
        return _join_u64(kw[:, 1], kw[:, 0])
