"""Tiered key store: a host cold tier behind the device table (the port
of gubernator_tpu/tiering.py).

A key the device table cannot hold is not an error row: a host cold
tier (key hash → one packed row in ``ROW_COLS`` order, the snapshot
layout of store.py less the key) sits behind each engine, and a
sketch-rank admission controller moves rows between the tiers.

- A request whose key misses the device table (cold-resident, or new
  with its probe window or bucket full) is served exactly from the cold
  tier: ``_host_apply`` mirrors the device transition
  (core/step.py › _apply_position) in Python integers, bit for bit over
  the packed input domain, so decisions equal those of one uncapped
  table.  On the bucket engine, rows whose values lie outside K1's
  domain and have no device row are served here too.
- A cold key whose heavy-hitter rank (analytics.py) reaches the
  admission threshold moves to the device table, evicting the coldest
  resident row of its probe window (or bucket) to the host.  All eight
  value columns move verbatim, both ways.

Coherence: every membership change (serve, create, promote, demote)
runs inside the engine's ``check_packed`` resolve or under the
instance's engine lock, so at any decision a key is in exactly one
tier.  ``check_packed`` takes cold-resident rows out of the device wave
(a cold key reaching a table with room would be inserted fresh: a
second copy of its state) and serves them here on the way out; the
pipelined launch / sync lane and the fused wire lane re-enter
``check_packed`` for their cold rows, as their table-full retry does.

The cold store is the native open-addressed table of csrc/cold.cpp
(built with the host library at first use; a failed build raises).
GUBER_TIER_NATIVE=0 selects the plain dict store instead, as it does
in the JAX package.
"""
from __future__ import annotations

import logging
import os
import threading
import time
from typing import Callable, Dict, Optional

import numpy as np

from .types import FRAC_SAFE, TD_BOUND, Algorithm, Behavior

log = logging.getLogger("gubernator_tpu_torch.tiering")

#: cold-row column order: store.py's snapshot layout less the key, so
#: snapshot and restore stream cold rows with the device tier's columns
ROW_COLS = ("meta", "limit", "duration", "eff_ms", "burst", "remaining",
            "t_ms", "expire_at")

_LEAKY = int(Algorithm.LEAKY_BUCKET)
_GREG = int(Behavior.DURATION_IS_GREGORIAN)
_RESET = int(Behavior.RESET_REMAINING)
_DRAIN = int(Behavior.DRAIN_OVER_LIMIT)

#: the row a missing key adopts: the device's empty-row fill (zeros,
#: eff_ms 1)
_ZERO_ROW = (0, 0, 0, 1, 0, 0, 0, 0)


def _host_apply(row, hits, limit, duration, eff, greg_end, behavior,
                alg, burst, req_now):
    """One request applied to one cold row: the host mirror of the
    device transition (core/step.py › _apply_position) in Python
    integers over the same packed, clamped input domain (core/batch.py ›
    pack_columns keeps every td product <= TD_BOUND, so no intermediate
    here leaves int64 where the device's does not).

    ``row`` is an 8-tuple in ROW_COLS order (None = missing key).
    Returns (status, out_remaining, reset_time, out_limit, new_row).
    """
    if row is None:
        row = _ZERO_ROW
    meta, i_limit, i_duration, i_eff, i_burst, i_rem, i_t, i_exp = row
    i_alg = meta & 1
    i_status = (meta >> 1) & 1

    now = req_now if req_now > i_t else i_t
    is_leaky = alg == _LEAKY
    is_greg = (behavior & _GREG) != 0

    # fresh: missing, expired or an algorithm switch
    fresh = (now >= i_exp) or (i_alg != alg)
    tok_dur_change = (not is_leaky) and (not fresh) and (duration != i_duration)
    exp1 = i_exp
    if tok_dur_change:
        exp1 = greg_end if is_greg else i_t + eff
        if exp1 <= now:
            fresh = True

    # adopt the fresh state or the existing one
    eff_l = eff if is_leaky else 1
    if fresh:
        limit0 = limit
        eff0 = eff
        rem0 = (burst if is_leaky else limit) * eff_l
        t0 = now
        exp0 = now + eff if is_leaky else (greg_end if is_greg else now + eff)
        status0 = 0
    else:
        limit0 = i_limit
        eff0 = i_eff
        rem0 = i_rem
        t0 = i_t
        exp0 = exp1
        status0 = i_status

    # a leaky denominator change rescales the td fixed point
    if is_leaky and (not fresh) and eff != eff0:
        d = eff0 if eff0 > 1 else 1
        whole = rem0 // d
        frac = rem0 % d
        cap_whole = TD_BOUND // (eff if eff > 1 else 1)
        if whole > cap_whole:
            whole = cap_whole
        frac_ok = eff0 <= FRAC_SAFE and eff <= FRAC_SAFE
        rem0 = whole * eff + ((frac if frac_ok else 0) * eff) // d
    if is_leaky or tok_dur_change:
        eff0 = eff

    # RESET_REMAINING (existing items only)
    reset_live = (behavior & _RESET) != 0 and not fresh
    if reset_live:
        rem0 = limit * eff_l
        status0 = 0
    limit_after_reset = limit if (reset_live and not is_leaky) else limit0

    # a token limit change in place
    if (not is_leaky) and limit != limit_after_reset:
        rem0 = rem0 + limit - limit_after_reset
        if rem0 < 0:
            rem0 = 0
        elif rem0 > limit:
            rem0 = limit
    limit1 = limit

    # leaky replenish: elapsed × limit td, capped at the burst
    burst1 = burst if is_leaky else limit1
    if is_leaky:
        elapsed = now - t0
        cap_td = burst1 * eff0
        safe_el = TD_BOUND // (limit1 if limit1 > 1 else 1)
        if elapsed > safe_el:
            rem0 = cap_td
        else:
            rem0 = rem0 + elapsed * limit1
            if rem0 > cap_td:
                rem0 = cap_td
        t1 = now
    else:
        t1 = t0

    d0 = eff0 if eff0 > 1 else 1
    rate = eff0 // (limit1 if limit1 > 1 else 1) if limit1 > 0 else eff0
    exp_out = now + eff0 if is_leaky else exp0
    reset_time = now + rate if is_leaky else exp_out

    # the hits
    cost = hits * (eff0 if is_leaky else 1)
    if hits == 0:  # a query
        rem2, status1 = rem0, status0
    elif cost <= rem0:
        rem2, status1 = rem0 - cost, 0
    else:
        rem2 = 0 if (behavior & _DRAIN) != 0 else rem0
        status1 = 1

    out_rem = rem2 // d0 if is_leaky else rem2
    new_row = (alg | (status1 << 1), limit1, duration, eff0, burst1,
               rem2, t1, exp_out)
    return status1, out_rem, reset_time, limit1, new_row


class _DictColdStore:
    """The plain cold store: key hash → 8-tuple row (GUBER_TIER_NATIVE=0).
    Not thread-safe: TierController._mu serializes it."""

    native = False

    def __init__(self):
        self._d: Dict[int, tuple] = {}

    def __len__(self) -> int:
        return len(self._d)

    def get(self, kh: int):
        return self._d.get(kh)

    def put(self, kh: int, row) -> None:
        self._d[kh] = tuple(int(v) for v in row)

    def pop(self, kh: int):
        return self._d.pop(kh, None)

    def get_many(self, keys: np.ndarray) -> list:
        d = self._d
        return [d.get(k) for k in np.asarray(keys, np.uint64).tolist()]

    def put_many(self, keys: np.ndarray, rows: np.ndarray) -> None:
        for k, r in zip(np.asarray(keys, np.uint64).tolist(),
                        np.asarray(rows, np.int64).tolist()):
            self._d[k] = tuple(r)

    def contains_batch(self, khash: np.ndarray) -> np.ndarray:
        d = self._d
        return np.fromiter((k in d for k in
                            np.asarray(khash, np.uint64).tolist()),
                           bool, count=len(khash))

    def snapshot(self):
        """(keys u64[n], rows i64[n, 8]) in no particular order."""
        n = len(self._d)
        keys = np.fromiter(self._d.keys(), np.uint64, count=n)
        rows = np.array(list(self._d.values()), np.int64).reshape(
            n, len(ROW_COLS))
        return keys, rows


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


class _NativeColdStore:
    """csrc/cold.cpp's open-addressed table behind the same interface
    (key hash u64 → 8 × i64, linear probing, tombstone deletes, grown in
    C).  Not thread-safe: TierController._mu serializes it."""

    native = True

    def __init__(self):
        from .ops.build import load_wire_library

        self._lib = load_wire_library()
        self._h = self._lib.gc_new(1024)
        if not self._h:
            raise MemoryError("cold store allocation failed")
        self._row = np.zeros(len(ROW_COLS), np.int64)

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.gc_free(h)

    def __len__(self) -> int:
        return int(self._lib.gc_len(self._h))

    def get(self, kh: int):
        if not self._lib.gc_get(self._h, int(kh), _ptr(self._row)):
            return None
        return tuple(self._row.tolist())

    def put(self, kh: int, row) -> None:
        r = np.ascontiguousarray(row, np.int64)
        if self._lib.gc_put(self._h, int(kh), _ptr(r)) < 0:
            raise MemoryError("cold store grow failed")

    def pop(self, kh: int):
        if not self._lib.gc_pop(self._h, int(kh), _ptr(self._row)):
            return None
        return tuple(self._row.tolist())

    def get_many(self, keys: np.ndarray) -> list:
        k = np.ascontiguousarray(keys, np.uint64)
        n = len(k)
        found = np.zeros(n, np.uint8)
        rows = np.zeros((n, len(ROW_COLS)), np.int64)
        self._lib.gc_get_many(self._h, _ptr(k), n, _ptr(found), _ptr(rows))
        return [tuple(r) if f else None
                for f, r in zip(found.tolist(), rows.tolist())]

    def put_many(self, keys: np.ndarray, rows: np.ndarray) -> None:
        k = np.ascontiguousarray(keys, np.uint64)
        r = np.ascontiguousarray(rows, np.int64).reshape(len(k),
                                                         len(ROW_COLS))
        if self._lib.gc_put_many(self._h, _ptr(k), _ptr(r), len(k)) < 0:
            raise MemoryError("cold store grow failed")

    def contains_batch(self, khash: np.ndarray) -> np.ndarray:
        k = np.ascontiguousarray(khash, np.uint64)
        out = np.zeros(len(k), np.uint8)
        self._lib.gc_contains(self._h, _ptr(k), len(k), _ptr(out))
        return out != 0

    def snapshot(self):
        n = len(self)
        keys = np.zeros(n, np.uint64)
        rows = np.zeros((n, len(ROW_COLS)), np.int64)
        got = self._lib.gc_snapshot(self._h, _ptr(keys), _ptr(rows), n)
        return keys[:got], rows[:got]


def _make_store():
    """The native cold store, or the dict store under
    GUBER_TIER_NATIVE=0."""
    if os.environ.get("GUBER_TIER_NATIVE", "1") != "0":
        return _NativeColdStore()
    return _DictColdStore()


class TierController:
    """The admission / demotion controller and the cold tier's one front
    door; one per engine (``engine.tier`` points here).

    Locking: every membership change runs inside the engine's
    ``check_packed`` resolve or under the instance's engine lock, which
    orders them; ``self._mu`` (a leaf lock) also guards the store
    against readers off the serving path (stats, snapshot).  Never call
    an engine method while holding ``self._mu``.
    """

    def __init__(self, engine, rank_fn: Optional[Callable[[int], int]] = None,
                 promote_threshold: int = 8, metrics=None, recorder=None,
                 fault: Optional[Callable[[str], None]] = None,
                 skip_victim: Optional[Callable[[int], bool]] = None,
                 tap: Optional[Callable] = None,
                 rank_batch: Optional[Callable] = None):
        self._mu = threading.Lock()
        self._store = _make_store()  # guarded-by: self._mu
        self.rank_fn = rank_fn
        #: batched rank read (analytics.sketch_counts): victim selection
        #: reads a whole probe window per promotion
        self.rank_batch = rank_batch
        self.promote_threshold = max(int(promote_threshold), 1)
        self.metrics = metrics
        self.recorder = recorder
        self._fault = fault
        self._skip_victim = skip_victim
        #: rank feed for engines that tap on the device: their tap
        #: leaves out invalid rows, and cold rows ride the wave invalid,
        #: so without this feed a cold key would never gain rank
        self._tap = tap
        self.cold_served = 0  # guarded-by: self._mu
        self.promotions = 0  # lock-free: resolve path only (engine-lock serialized)
        self.demotions = 0  # lock-free: resolve path only (engine-lock serialized)
        self.migrations_aborted = 0  # lock-free: resolve path only (engine-lock serialized)
        #: seconds spent in resolve (the cold lane's Python loop)
        self.resolve_s = 0.0  # lock-free: resolve path only (engine-lock serialized)
        engine.tier = self

    # ---- membership reads ----------------------------------------------

    def resident_mask(self, khash: np.ndarray) -> np.ndarray:
        """bool[n]: which of ``khash`` are cold-resident now (the
        engine's pre-mask; under the engine lock it stays true until
        the same call's resolve)."""
        with self._mu:
            return self._store.contains_batch(khash)

    def cold_keys(self) -> int:
        with self._mu:
            return len(self._store)

    def mem_bytes(self) -> int:
        """Host bytes of the cold rows (the memory ledger's probe): an
        8-byte key and the ROW_COLS int64 columns a row, the native
        store's layout (the dict store's estimate uses the same)."""
        with self._mu:
            return len(self._store) * (len(ROW_COLS) + 1) * 8

    def stats(self) -> dict:
        with self._mu:
            return {"cold_keys": len(self._store),
                    "cold_served": self.cold_served,
                    "native": self._store.native,
                    "promotions": self.promotions,
                    "demotions": self.demotions,
                    "migrations_aborted": self.migrations_aborted}

    # ---- row handoff (snapshot, restore, admin) ------------------------

    def peek_row(self, kh: int):
        """The key's cold row as a {column: int} dict, or None."""
        with self._mu:
            row = self._store.get(int(kh))
        if row is None:
            return None
        return dict(zip(ROW_COLS, row))

    def pop_row(self, kh: int):
        """Remove and return the key's cold row ({column: int} or
        None)."""
        with self._mu:
            row = self._store.pop(int(kh))
        if row is None:
            return None
        return dict(zip(ROW_COLS, row))

    def put_row(self, kh: int, cols: dict) -> None:
        """Adopt one row the device table had no slot for."""
        with self._mu:
            self._store.put(int(kh), tuple(int(cols[f]) for f in ROW_COLS))
        self._gauge()

    def adopt_rows(self, arrays: dict, idx) -> int:
        """Adopt the snapshot rows ``idx`` (store.py columns) that the
        device table did not place: every restored row lands in exactly
        one tier.  Later rows of a key overwrite earlier ones."""
        idx = np.asarray(idx, np.int64)
        if not idx.size:
            return 0
        keys = np.asarray(arrays["key"]).astype(np.uint64)[idx]
        rows = np.stack([np.asarray(arrays[f]).astype(np.int64)[idx]
                         for f in ROW_COLS], axis=1)
        with self._mu:
            self._store.put_many(keys, rows)
        self._gauge()
        return int(idx.size)

    def snapshot_arrays(self) -> Optional[dict]:
        """The cold rows as store.py columns (key included), or None when
        the tier is empty."""
        with self._mu:
            keys, rows = self._store.snapshot()
        if not len(keys):
            return None
        out = {"key": keys}
        for j, f in enumerate(ROW_COLS):
            col = rows[:, j]
            out[f] = col.astype(np.int32) if f == "meta" else col
        return out

    # ---- the resolve path ----------------------------------------------

    def resolve(self, engine, batch, khash: np.ndarray, now_ms: int,
                cols: tuple, cold_mask, orig_valid, mslot=None) -> tuple:
        """Serve every cold-lane row of a resolved wave: the pre-masked
        cold-resident rows and the table-full rows left (new keys with
        their window full: found or created here).  Runs inside
        ``check_packed`` under the engine lock; writes the response
        columns in place and clears ``full``.

        A key's requests apply in (arrival time, index) order: the order
        the device's segment sort gives the device tier, so a batch that
        repeats a key keeps sequential parity."""
        status, lim_o, rem_o, rst_o, full = cols
        need = full & orig_valid if orig_valid is not None else full.copy()
        if cold_mask is not None:
            need = need | cold_mask
        if mslot is not None:
            need = need & (np.asarray(mslot) < 0)
        if not need.any():
            return cols
        t0 = time.perf_counter()
        idxs = np.nonzero(need)[0]
        h_hits = np.asarray(batch.hits)[idxs].tolist()
        h_lim = np.asarray(batch.limit)[idxs].tolist()
        h_dur = np.asarray(batch.duration)[idxs].tolist()
        h_eff = np.asarray(batch.eff_ms)[idxs].tolist()
        h_greg = np.asarray(batch.greg_end)[idxs].tolist()
        h_beh = np.asarray(batch.behavior)[idxs].tolist()
        h_alg = np.asarray(batch.algorithm)[idxs].tolist()
        h_bur = np.asarray(batch.burst)[idxs].tolist()
        now_col = (np.asarray(batch.now)[idxs] if batch.now is not None
                   else np.zeros(len(idxs), np.int64))
        h_now = np.where(now_col > 0, now_col, int(now_ms)).tolist()
        kh_sel = np.asarray(khash, np.uint64)[idxs]
        h_kh = kh_sel.tolist()
        # (arrival time, index) order; positions j index the columns
        order = sorted(range(len(idxs)), key=lambda j: (h_now[j], j))
        uniq = np.unique(kh_sel)
        st_o, rm_o, rs_o, lm_o = [0] * len(idxs), [0] * len(idxs), \
            [0] * len(idxs), [0] * len(idxs)
        with self._mu:
            rows = dict(zip(uniq.tolist(), self._store.get_many(uniq)))
            for j in order:
                kh = h_kh[j]
                st_o[j], rm_o[j], rs_o[j], lm_o[j], rows[kh] = _host_apply(
                    rows[kh], h_hits[j], h_lim[j], h_dur[j], h_eff[j],
                    h_greg[j], h_beh[j], h_alg[j], h_bur[j], h_now[j])
            self._store.put_many(
                uniq, np.array([rows[k] for k in uniq.tolist()], np.int64))
            self.cold_served += len(idxs)
        status[idxs] = st_o
        rem_o[idxs] = rm_o
        rst_o[idxs] = rs_o
        lim_o[idxs] = lm_o
        full[idxs] = False
        m = self.metrics
        if m is not None:
            m.tier_cold_serves.inc(len(idxs))
        self._gauge()
        if self._tap is not None:
            try:
                self._tap(kh_sel, np.asarray(batch.hits)[idxs],
                          status[idxs])
            except Exception:  # pragma: no cover - analytics only
                log.exception("tier rank-feed tap")
        self._admit(engine, [h_kh[j] for j in order])
        self.resolve_s += time.perf_counter() - t0
        return status, lim_o, rem_o, rst_o, full

    # ---- admission and migration ---------------------------------------

    def _admit(self, engine, khs) -> None:
        """Promote every just-served cold key whose sketch rank reaches
        the threshold.  No rank feed (analytics off): no admission;
        serving stays exact, on the host."""
        rank = self.rank_fn
        if rank is None or not khs:
            return
        thr = self.promote_threshold
        seen = set()
        for kh in khs:
            if kh in seen:
                continue
            seen.add(kh)
            try:
                r = rank(kh)
            except Exception:  # pragma: no cover - analytics only
                return
            if r >= thr:
                self.promote(engine, kh, r)

    def promote(self, engine, kh: int, rank: int) -> bool:
        """Move one cold row to the device tier, evicting the coldest
        resident row of its probe window to the host when no slot is
        free.  All eight value columns move verbatim (t_ms and expire_at
        too); runs under the engine lock, so no request sees the key
        between the tiers."""
        with self._mu:
            row = self._store.get(int(kh))
        if row is None:
            return False
        if not getattr(engine, "tier_row_admissible", _always)(row):
            return False  # outside the engine's step domain
        try:
            if self._fault is not None:
                self._fault("tier_promote")
        except Exception:  # FaultInjected: the row stays cold
            self.migrations_aborted += 1
            if self.metrics is not None:
                self.metrics.tier_migrations_aborted.inc()
            return False
        karr = np.array([kh], np.uint64)
        if not self._upsert(engine, karr, row):
            victim = self._pick_victim(engine, kh, rank)
            if victim is None:
                return False
            if not self.demote(engine, victim):
                return False
            if not self._upsert(engine, karr, row):
                # the freed slot is in kh's own window: unreachable, and
                # the row stays cold if it ever happens
                return False
        with self._mu:
            self._store.pop(int(kh))
        self.promotions += 1
        if self.metrics is not None:
            self.metrics.tier_promotions.inc()
        if self.recorder is not None:
            self.recorder.record("tier_promote", khash=f"0x{kh:016x}",
                                 rank=int(rank))
        self._gauge()
        return True

    def demote(self, engine, kh: int) -> bool:
        """Move one device row to the cold tier: gather it, adopt it
        cold, then clear its device slot.  Under the engine lock."""
        try:
            if self._fault is not None:
                self._fault("tier_demote")
        except Exception:  # FaultInjected: the eviction aborts
            self.migrations_aborted += 1
            if self.metrics is not None:
                self.metrics.tier_migrations_aborted.inc()
            return False
        karr = np.array([kh], np.uint64)
        found, vcols = engine.gather_rows(karr)
        if not found[0]:
            return False
        row = tuple(int(vcols[f][0]) for f in ROW_COLS)
        with self._mu:
            self._store.put(int(kh), row)
        engine.remove_rows(karr)
        self.demotions += 1
        if self.metrics is not None:
            self.metrics.tier_demotions.inc()
        if self.recorder is not None:
            self.recorder.record("tier_demote", khash=f"0x{kh:016x}")
        self._gauge()
        return True

    def _pick_victim(self, engine, kh: int, rank: int):
        """The coldest (least sketch rank) resident key of ``kh``'s probe
        window, strictly colder than the promotee, never one
        ``skip_victim`` pins."""
        probe = getattr(engine, "probe_occupant_keys", None)
        if probe is None or self.rank_fn is None:
            return None
        occ = probe(int(kh))
        skip = self._skip_victim
        cands = []
        for k in np.asarray(occ, np.uint64).tolist():
            if k == 0 or k == int(kh):
                continue
            if skip is not None and skip(k):
                continue
            cands.append(k)
        if not cands:
            return None
        if self.rank_batch is not None:  # one sketch-lock acquisition
            ranks = self.rank_batch(cands)
        else:
            ranks = [self.rank_fn(k) for k in cands]
        best = min(range(len(cands)), key=ranks.__getitem__)
        if ranks[best] >= rank:
            return None  # everything resident is at least as hot
        return cands[best]

    @staticmethod
    def _upsert(engine, karr: np.ndarray, row) -> bool:
        cols = {}
        for f, v in zip(ROW_COLS, row):
            cols[f] = np.array([v], np.int32 if f == "meta" else np.int64)
        return int(engine.upsert_rows(karr, cols)) > 0

    def _gauge(self) -> None:
        m = self.metrics
        if m is not None:
            with self._mu:
                n = len(self._store)
            m.tier_cold_keys.set(n)


def _always(_row) -> bool:
    return True
