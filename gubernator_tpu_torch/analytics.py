"""Key-level analytics: the heavy-hitter sketch and the per-phase
latency ledger (the port of the heavy-hitter half of
gubernator_tpu/analytics.py).

- ``HeavyHitterSketch``: a columnar Space-Saving ledger of ``width``
  counters (GUBER_SKETCH_WIDTH, default 4×K) reporting the top ``K``
  keys (GUBER_TOPK, default 256).  Exact while the key domain fits in
  ``width``; otherwise each reported count over-estimates by at most its
  ``err``, itself at most ``total_weight / width``.  Per key it tracks
  hits, OVER_LIMIT answers, the last-seen wall time and, when an
  object-lane wave carried one, the key's name.  Its rank
  (``sketch_count``) is the cold tier's admission signal (tiering.py).
- ``PhaseLedger``: per-phase durations (queue_wait, pack, device,
  resolve, restore, snapshot) for ``GET /debug/phases`` and the
  ``gubernator_phase_duration`` histogram.

``KeyAnalytics`` owns both and a bounded tap queue: the dispatcher and
the engines enqueue each resolved wave's columns and one worker thread
folds them, in paced batches (one fold per ``BATCH_INTERVAL_S``).  A
full queue drops the wave and counts it: analytics never holds back a
caller.  A CUDA engine's device tap (``tap_device``) carries the wave's
[4, B] tap tensor and an event recorded behind its step; the worker
waits for the event and copies the tensor to the host on a side stream,
so neither the serving thread nor later waves wait for that copy.

Not ported: the tenant ledger, the cost model and their taps
(``tap_wire_names``, ``tap_flag``, ``tap_cost``); tenant attribution is
off (``_tenants`` is None, a state the JAX package supports).
"""
from __future__ import annotations

import json
import logging
import os
import queue
import threading
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from .types import TD_BOUND, VALUE_MAX

log = logging.getLogger("gubernator_tpu_torch.analytics")

def _env_int(name: str, default: int, lo: int = 1) -> int:
    raw = os.environ.get(name, "")
    if raw:
        try:
            return max(int(raw), lo)
        except ValueError:
            pass  # malformed: keep the default
    return default


class HeavyHitterSketch:
    """Space-Saving heavy hitters over 64-bit key hashes, columnar.

    ``width`` counters total; ``topk()`` reports the heaviest ``k``.
    Storage is parallel numpy columns (count/err/over/last/khash) with
    a sorted-hash index rebuilt lazily per wave, so a whole wave folds
    in with vectorized ops — no per-key Python loop on the columnar
    path (the dict-of-slots + min-scan variant cost ~40 ms per
    1000-req Zipf wave; this is ~0.2 ms, which matters on small hosts
    where the worker thread competes with serving for cores).

    Admission when full follows EXACT sequential Space-Saving
    semantics (each newcomer evicts the then-minimum slot and inherits
    its count as the overestimate bound ``err``), simulated for a
    whole wave with a sorted-victims/FIFO merge instead of a heap —
    see the comment at the admission step.  The classic guarantees
    hold, all deterministic:

    - exact (every ``err`` == 0) while the observed key domain fits in
      ``width``;
    - per tracked key: ``true <= count`` and ``count - true <= err``;
    - tracked counts sum to ``total_weight`` exactly, hence
      ``err <= error_bound()`` (the current minimum)
      ``<= total_weight/width`` by pigeonhole — and any key whose true
      count exceeds ``total_weight/width`` is guaranteed tracked.

    NOT thread-safe: KeyAnalytics serializes access on its worker
    thread (snapshot readers take its lock).
    """

    def __init__(self, k: int = 256, width: Optional[int] = None):
        self.k = max(int(k), 1)
        self.width = max(int(width) if width else 4 * self.k, self.k)
        w = self.width
        self._cnt = np.zeros(w, np.int64)
        self._err = np.zeros(w, np.int64)
        self._over = np.zeros(w, np.int64)
        self._last = np.zeros(w, np.int64)
        self._kh = np.zeros(w, np.uint64)
        self._used = 0
        self._sorted_kh = np.empty(0, np.uint64)
        self._sorted_slot = np.empty(0, np.int64)
        self._dirty = False  # membership changed since last reindex
        self.total_weight = 0
        #: bounded khash → "name_unique_key" side table: names seen on
        #: object-lane waves resolve keys that later go hot through the
        #: columnar wire lanes (which only carry hashes)
        self._names: Dict[int, str] = {}
        self._names_cap = max(8 * self.width, 4096)

    def __len__(self) -> int:
        return self._used

    # ---- ingest ---------------------------------------------------------

    def _reindex(self) -> None:
        if self._dirty or self._sorted_kh.size != self._used:
            order = np.argsort(self._kh[:self._used])
            self._sorted_kh = self._kh[:self._used][order]
            self._sorted_slot = order.astype(np.int64)
            self._dirty = False

    def update(self, khash: np.ndarray, hits: np.ndarray,
               over: np.ndarray, t_ms: int,
               names: Optional[List[Optional[str]]] = None) -> None:
        """Fold one wave's columns in.  ``khash`` uint64, ``hits``
        weights (clamped >= 1 so hits=0 status queries still register
        presence), ``over`` truthy where the decision was OVER_LIMIT.
        ``names``, when given, aligns with ``khash``."""
        n = len(khash)
        if n == 0:
            return
        w = np.maximum(np.asarray(hits, np.int64), 1)
        kh = np.asarray(khash, np.uint64)
        ob = np.asarray(over, bool)
        # sort-and-reduceat aggregation (np.unique + ufunc.at is ~2×
        # slower; this update is the analytics worker's hot loop).
        # Weight-1 waves — the common columnar shape — skip the
        # argsort permutation entirely: counts are plain run lengths
        # of the sorted hashes, and the (sparse) over-limit rows
        # aggregate separately and scatter in by binary search.
        if names is None and int(w.max()) == 1:
            ks = np.sort(kh)
            starts = np.nonzero(np.concatenate(
                ([True], ks[1:] != ks[:-1])))[0]
            uniq = ks[starts]
            wsum = np.diff(np.append(starts, ks.size))
            osum = np.zeros(uniq.size, np.int64)
            if ob.any():
                kho = np.sort(kh[ob])
                so = np.nonzero(np.concatenate(
                    ([True], kho[1:] != kho[:-1])))[0]
                osum[np.searchsorted(uniq, kho[so])] = \
                    np.diff(np.append(so, kho.size))
        else:
            o = ob.astype(np.int64)
            sort = np.argsort(kh, kind="stable")
            ks = kh[sort]
            starts = np.nonzero(np.concatenate(
                ([True], ks[1:] != ks[:-1])))[0]
            uniq = ks[starts]
            wsum = np.add.reduceat(w[sort], starts)
            osum = np.add.reduceat(o[sort], starts)
            if names is not None:
                # object-lane waves only (small): remember each unique
                # key's name so columnar taps resolve it at report time
                rep = sort[starts]  # any occurrence names the key
                for j in range(uniq.size):
                    name = names[int(rep[j])]
                    if name is not None:
                        self._note_name(int(uniq[j]), name)
        self.total_weight += int(wsum.sum())
        # tracked keys: one sorted-membership probe, vectorized folds
        self._reindex()
        if self._sorted_kh.size:
            pos = np.minimum(np.searchsorted(self._sorted_kh, uniq),
                             self._sorted_kh.size - 1)
            tracked = self._sorted_kh[pos] == uniq
            slots = self._sorted_slot[pos[tracked]]
            self._cnt[slots] += wsum[tracked]
            self._over[slots] += osum[tracked]
            self._last[slots] = t_ms
        else:
            tracked = np.zeros(uniq.size, bool)
        m = int(uniq.size - tracked.sum())
        if m == 0:
            return
        new_kh = uniq[~tracked]
        new_w = wsum[~tracked]
        new_o = osum[~tracked]
        free = self.width - self._used
        if free > 0:
            take = min(free, m)
            sl = np.arange(self._used, self._used + take)
            self._kh[sl] = new_kh[:take]
            self._cnt[sl] = new_w[:take]
            self._err[sl] = 0
            self._over[sl] = new_o[:take]
            self._last[sl] = t_ms
            self._used += take
            self._dirty = True
            if take == m:
                return
            new_kh, new_w, new_o = (new_kh[take:], new_w[take:],
                                    new_o[take:])
            m -= take
        # EXACT sequential Space-Saving admission (each newcomer
        # evicts the then-minimum slot and inherits its count as the
        # error bound).  Arrival order within a wave is ours to
        # choose, so split by weight: the few heavy newcomers run the
        # exact two-way merge; the weight-1 tail — the dominant churn
        # shape — admits via closed-form water-filling with no
        # per-item loop at all.  Either way the counts sum to the
        # total observed weight, hence err <= min <= total/width.
        heavy = new_w > 1
        if heavy.any():
            self._admit_merge(new_kh[heavy], new_w[heavy],
                              new_o[heavy], t_ms)
        light = ~heavy
        if light.any():
            self._admit_level(new_kh[light], new_o[light], t_ms)

    def _admit_merge(self, new_kh, new_w, new_o, t_ms: int) -> None:
        """Sequential Space-Saving for arbitrary weights, simulated as
        a two-way merge: processing newcomers in ascending-weight
        order makes both the popped minima v_1 <= v_2 <= ... and the
        re-inserted values v_j + w_j nondecreasing, so the "heap" is
        just the sorted victim counts + a FIFO of intra-wave
        re-insertions.  A slot popped from the FIFO re-evicts an
        earlier newcomer of this same wave (its assignment is simply
        overwritten).  Evicted keys' over-limit tallies do NOT carry
        over, so `over` stays exact per tracked period."""
        order = np.argsort(new_w, kind="stable")
        new_kh, new_w, new_o = new_kh[order], new_w[order], new_o[order]
        sort_idx = np.argsort(self._cnt[: self._used])
        scnt = self._cnt[: self._used][sort_idx].tolist()
        sslot = sort_idx.tolist()
        ns = len(scnt)
        si = qi = 0
        qv: list = []  # FIFO as append-only lists + head index (qi):
        qs: list = []  # stays sorted, so no heap is ever needed
        assign: Dict[int, int] = {}  # slot → newcomer idx (last wins)
        inherited: Dict[int, int] = {}  # slot → evicted count
        for j, wj in enumerate(new_w.tolist()):
            if qi < len(qv) and (si >= ns or qv[qi] <= scnt[si]):
                v, slot = qv[qi], qs[qi]
                qi += 1
            else:
                v, slot = scnt[si], sslot[si]
                si += 1
            assign[slot] = j
            inherited[slot] = v
            qv.append(v + wj)
            qs.append(slot)
        slots = np.fromiter(assign.keys(), np.int64, len(assign))
        js = np.fromiter(assign.values(), np.int64, len(assign))
        vs = np.fromiter(inherited.values(), np.int64, len(inherited))
        self._kh[slots] = new_kh[js]
        self._cnt[slots] = vs + new_w[js]
        self._err[slots] = vs
        self._over[slots] = new_o[js]
        self._last[slots] = t_ms
        self._dirty = True

    def _admit_level(self, new_kh, new_o, t_ms: int) -> None:
        """Weight-1 newcomers via exact water-filling: s pops of
        "evict the minimum, reinsert min+1" ARE s increments of the
        global minimum, so the final counts are the level-fill of the
        sorted counts — raise the lowest t0 counts to a common level L
        (the first r of them to L+1) — computed in closed form.
        Raised slots take newcomer keys with err = count - 1; the
        s - raised singletons admitted-then-re-evicted inside the wave
        vanish, exactly as sequential processing would have them."""
        s = len(new_kh)
        used = self._used
        cnt = self._cnt[:used]
        order = np.argsort(cnt)
        c = cnt[order]
        csum = np.cumsum(c)
        # cost[i] = lifting slots 0..i to level c[i]; nondecreasing
        cost = (np.arange(1, used + 1) * c) - csum
        t0 = int(np.searchsorted(cost, s, side="right"))
        pool = s + int(csum[t0 - 1])
        level = pool // t0
        r = pool - level * t0
        newvals = np.full(t0, level, np.int64)
        newvals[:r] += 1
        changed = newvals > c[:t0]
        nraised = int(changed.sum())
        slots = order[:t0][changed]
        self._cnt[slots] = newvals[changed]
        self._err[slots] = newvals[changed] - 1
        self._kh[slots] = new_kh[:nraised]
        self._over[slots] = new_o[:nraised]
        self._last[slots] = t_ms
        self._dirty = True

    def _note_name(self, kh: int, name: str) -> None:
        names = self._names
        if kh not in names and len(names) >= self._names_cap:
            # bounded: drop an arbitrary half when full (plain dicts
            # pop in insertion order, so this sheds the oldest names)
            for old in list(names)[: self._names_cap // 2]:
                del names[old]
        names[kh] = name

    # ---- reporting ------------------------------------------------------

    def error_bound(self) -> int:
        """Worst-case overestimate for a newly admitted key: the
        current minimum tracked count (<= total_weight/width).  0
        while the ledger has free slots (everything exact)."""
        if self._used < self.width:
            return 0
        return int(self._cnt[: self._used].min())

    def count_of(self, khash: int) -> int:
        """Tracked count for one key hash (0 when untracked): the cold
        tier's admission rank.  An overestimate by at most the key's
        ``err``, which only makes promotion eager, never starved."""
        self._reindex()
        if not self._sorted_kh.size:
            return 0
        kh = np.uint64(khash)
        pos = int(np.searchsorted(self._sorted_kh, kh))
        if pos >= self._sorted_kh.size or self._sorted_kh[pos] != kh:
            return 0
        return int(self._cnt[self._sorted_slot[pos]])

    def topk(self, k: Optional[int] = None) -> List[dict]:
        k = self.k if k is None else max(int(k), 1)
        k = min(k, self._used)
        cnt = self._cnt[: self._used]
        if k < self._used:
            part = np.argpartition(cnt, self._used - k)[self._used - k:]
            order = part[np.argsort(cnt[part])[::-1]]
        else:
            order = np.argsort(cnt)[::-1]
        out = []
        for s in order[:k]:
            kh = int(self._kh[s])
            out.append({"khash": kh, "key": self._names.get(kh),
                        "hits": int(self._cnt[s]),
                        "err": int(self._err[s]),
                        "over_limit": int(self._over[s]),
                        "last_seen_ms": int(self._last[s])})
        return out

    # ---- merging another sketch's report --------------------------------

    def merge_entries(self, entries: List[dict],
                      total_weight: Optional[int] = None) -> None:
        """Fold another sketch's REPORTED rows (``topk()`` dicts, khash
        as int or ``0x…`` hex) into this one.  Reuses the exact two-way Space-Saving merge:
        tracked keys add counts AND error bounds; untracked keys fill
        free slots (keeping their remote ``err``) or run
        ``_admit_merge``, after which the remote ``err`` of each
        SURVIVING newcomer is added on top of the inherited eviction
        bound.  The merged sketch obeys the summed-stream guarantee:
        ``true <= count`` and ``count - true <= err`` against the union
        stream.  When both sides saw disjoint key sets that fit in
        ``width`` the merge is exact (all ``err`` unchanged)."""
        rows = []
        for e in entries:
            kh = e.get("khash")
            if isinstance(kh, str):
                kh = int(kh, 16)
            hits = int(e.get("hits", 0))
            if hits <= 0:
                continue
            rows.append((int(kh), hits, int(e.get("err", 0)),
                         int(e.get("over_limit", 0)),
                         int(e.get("last_seen_ms", 0)),
                         e.get("key")))
        if total_weight is not None:
            self.total_weight += int(total_weight)
        elif rows:
            self.total_weight += sum(r[1] for r in rows)
        if not rows:
            return
        kh = np.array([r[0] for r in rows], np.uint64)
        w = np.array([r[1] for r in rows], np.int64)
        er = np.array([r[2] for r in rows], np.int64)
        ov = np.array([r[3] for r in rows], np.int64)
        ls = np.array([r[4] for r in rows], np.int64)
        for r in rows:
            if r[5] is not None:
                self._note_name(r[0], r[5])
        # aggregate duplicate khashes (defensive: topk() never repeats
        # a hash, but merged docs from a retrying fetcher might)
        sort = np.argsort(kh, kind="stable")
        ks = kh[sort]
        starts = np.nonzero(np.concatenate(
            ([True], ks[1:] != ks[:-1])))[0]
        uniq = ks[starts]
        wsum = np.add.reduceat(w[sort], starts)
        ersum = np.add.reduceat(er[sort], starts)
        ovsum = np.add.reduceat(ov[sort], starts)
        lsmax = np.maximum.reduceat(ls[sort], starts)
        # tracked probe: counts add, error bounds add (both remotes'
        # overestimates can stack on the same key)
        self._reindex()
        if self._sorted_kh.size:
            pos = np.minimum(np.searchsorted(self._sorted_kh, uniq),
                             self._sorted_kh.size - 1)
            tracked = self._sorted_kh[pos] == uniq
            slots = self._sorted_slot[pos[tracked]]
            self._cnt[slots] += wsum[tracked]
            self._err[slots] += ersum[tracked]
            self._over[slots] += ovsum[tracked]
            np.maximum.at(self._last, slots, lsmax[tracked])
        else:
            tracked = np.zeros(uniq.size, bool)
        if int(tracked.sum()) == uniq.size:
            return
        new_kh = uniq[~tracked]
        new_w = wsum[~tracked]
        new_er = ersum[~tracked]
        new_o = ovsum[~tracked]
        new_ls = lsmax[~tracked]
        free = self.width - self._used
        if free > 0:
            take = min(free, len(new_kh))
            sl = np.arange(self._used, self._used + take)
            self._kh[sl] = new_kh[:take]
            self._cnt[sl] = new_w[:take]
            self._err[sl] = new_er[:take]  # keep the remote bound
            self._over[sl] = new_o[:take]
            self._last[sl] = new_ls[:take]
            self._used += take
            self._dirty = True
            if take == len(new_kh):
                return
            new_kh, new_w, new_er, new_o, new_ls = (
                new_kh[take:], new_w[take:], new_er[take:],
                new_o[take:], new_ls[take:])
        t_ms = int(new_ls.max())
        self._admit_merge(new_kh, new_w, new_o, t_ms)
        # surviving newcomers inherited an eviction bound from
        # _admit_merge; their remote err stacks on top (the remote
        # count they brought was itself an overestimate)
        self._reindex()
        pos = np.minimum(np.searchsorted(self._sorted_kh, new_kh),
                         self._sorted_kh.size - 1)
        alive = self._sorted_kh[pos] == new_kh
        slots = self._sorted_slot[pos[alive]]
        self._err[slots] += new_er[alive]
        np.maximum.at(self._last, slots, new_ls[alive])

    def canonical_bytes(self) -> bytes:
        """Deterministic byte form of the tracked state — khash-sorted
        ``(khash, cnt, err, over)`` rows as JSON.  ``last_seen_ms`` is
        a wall-clock artifact, not sketch state, so it is excluded;
        two sketches that tracked the same multiset of decisions
        byte-equal regardless of when they saw them."""
        u = self._used
        rows = sorted(zip(self._kh[:u].tolist(),
                          self._cnt[:u].tolist(),
                          self._err[:u].tolist(),
                          self._over[:u].tolist()))
        return json.dumps({"width": self.width, "k": self.k,
                           "total_weight": self.total_weight,
                           "rows": rows},
                          separators=(",", ":")).encode()


class NativeHeavyHitterSketch(HeavyHitterSketch):
    """The same sketch whose fold runs in the host library
    (csrc/sketch.cpp › gs_update, gs_admit_merge, gs_admit_level) on
    these very columns, with the GIL released: the serving threads run
    while the analytics worker folds.  Which of several equal counts an
    admission evicts follows numpy's argsort of the counts, taken here
    as the Python fold takes it, so after every fold the columns equal
    ``HeavyHitterSketch``'s (the plain version, which the tests hold it
    to) and the JAX package's.  Names are noted in Python, as there.  A
    host library that cannot be built raises."""

    def __init__(self, k: int = 256, width: Optional[int] = None):
        super().__init__(k, width)
        from .ops.build import load_wire_library

        self._lib = load_wire_library()

    def update(self, khash: np.ndarray, hits: np.ndarray,
               over: np.ndarray, t_ms: int,
               names: Optional[List[Optional[str]]] = None) -> None:
        n = len(khash)
        if n == 0:
            return
        kh = np.ascontiguousarray(khash, np.uint64)
        w = np.ascontiguousarray(hits, np.int64)
        ob = np.ascontiguousarray(over, bool).view(np.uint8)
        uniq = np.empty(n, np.uint64)
        rep = np.empty(n, np.int64)
        new_kh = np.empty(n, np.uint64)
        new_w = np.empty(n, np.int64)
        new_o = np.empty(n, np.int64)
        st = np.array([self._used, 0, 0], np.int64)  # used, weight, m
        used0 = self._used
        cols = (self._cnt, self._err, self._over, self._last, self._kh)
        lib = self._lib
        k = lib.gs_update(
            self.width, st.ctypes.data, st.ctypes.data + 8,
            *(c.ctypes.data for c in cols), kh.ctypes.data, w.ctypes.data,
            ob.ctypes.data, n, int(t_ms), uniq.ctypes.data,
            rep.ctypes.data, st.ctypes.data + 16, new_kh.ctypes.data,
            new_w.ctypes.data, new_o.ctypes.data)
        self._used = int(st[0])
        self.total_weight += int(st[1])
        if names is not None:
            for j in range(int(st[2])):
                name = names[int(rep[j])]
                if name is not None:
                    self._note_name(int(uniq[j]), name)
        if k:
            new_kh, new_w, new_o = new_kh[:k], new_w[:k], new_o[:k]
            heavy = new_w > 1
            if heavy.any():
                sort_idx = np.ascontiguousarray(
                    np.argsort(self._cnt[: self._used]), np.int64)
                hk, hw, ho = (np.ascontiguousarray(a[heavy])
                              for a in (new_kh, new_w, new_o))
                lib.gs_admit_merge(
                    self._used, *(c.ctypes.data for c in cols),
                    sort_idx.ctypes.data, hk.ctypes.data, hw.ctypes.data,
                    ho.ctypes.data, len(hk), int(t_ms))
            light = ~heavy
            if light.any():
                order = np.ascontiguousarray(
                    np.argsort(self._cnt[: self._used]), np.int64)
                lk, lo = (np.ascontiguousarray(a[light])
                          for a in (new_kh, new_o))
                lib.gs_admit_level(
                    self._used, *(c.ctypes.data for c in cols),
                    order.ctypes.data, lk.ctypes.data, lo.ctypes.data,
                    len(lk), int(t_ms))
        if k or self._used != used0:
            self._dirty = True  # membership changed: count_of re-sorts


class PhaseLedger:
    """Thread-safe per-phase durations: a cumulative count and sum plus a
    bounded window of recent samples for percentiles (a histogram cannot
    answer a percentile query)."""

    def __init__(self, maxlen: int = 4096):
        self._mu = threading.Lock()
        self._agg: Dict[str, list] = {}  # phase → [count, total_s]
        self._recent: Dict[str, deque] = {}
        self._maxlen = maxlen

    def observe(self, phase: str, seconds: float) -> None:
        with self._mu:
            a = self._agg.get(phase)
            if a is None:
                a = self._agg[phase] = [0, 0.0]
                self._recent[phase] = deque(maxlen=self._maxlen)
            a[0] += 1
            a[1] += seconds
            self._recent[phase].append(seconds)

    def mean(self, phase: str) -> Optional[float]:
        """Mean seconds per sample of one phase (None before any)."""
        with self._mu:
            a = self._agg.get(phase)
            return (a[1] / a[0]) if a and a[0] else None

    def recent_p99(self, phase: str) -> Optional[float]:
        """p99 seconds over the recent window of one phase (None before
        any sample)."""
        with self._mu:
            d = self._recent.get(phase)
            if not d:
                return None
            xs = np.asarray(d, float)
        return float(np.percentile(xs, 99))

    def snapshot(self) -> Dict[str, dict]:
        with self._mu:
            out = {}
            for phase, (count, total) in self._agg.items():
                xs = np.asarray(self._recent[phase], float)
                out[phase] = {
                    "count": count,
                    "total_ms": round(total * 1e3, 3),
                    "p50_ms": round(float(np.percentile(xs, 50)) * 1e3, 4),
                    "p99_ms": round(float(np.percentile(xs, 99)) * 1e3, 4),
                    "max_ms": round(float(xs.max()) * 1e3, 4),
                }
            return out


class _Flush:
    """Queue sentinel: the worker sets the event when it reaches it."""

    def __init__(self):
        self.done = threading.Event()


class KeyAnalytics:
    """The analytics subsystem: tap queue, worker, sketch and phases.

    ``tap_packed`` copies a wave's (khash, hits, status) columns and
    enqueues them; ``tap_named`` enqueues an object-lane wave's columns
    with its request lists, from which the worker names the keys the
    sketch has not named yet; ``tap_device`` enqueues a device tap.  A
    full queue DROPS the wave and counts it."""

    #: worker pacing: after folding a drained batch, rest this long; all
    #: that queued meanwhile folds in ONE update, which bounds the
    #: worker's share of the GIL
    BATCH_INTERVAL_S = 0.1

    #: top-K gauge refresh cadence: the label diff walks every tracked
    #: key, so it runs on this timer (and on flush), never per fold
    PUBLISH_INTERVAL_S = 2.0

    def __init__(self, metrics=None, k: Optional[int] = None,
                 width: Optional[int] = None, queue_cap: int = 512,
                 clock=time.time):
        self.metrics = metrics
        #: per-phase histogram children, resolved once
        self._phase_hist: Dict[str, object] = {}
        self._clock = clock
        k = k if k is not None else _env_int("GUBER_TOPK", 256)
        width = (width if width is not None
                 else _env_int("GUBER_SKETCH_WIDTH", 4 * k))
        self._mu = threading.Lock()  # guards the sketch and the counters
        self.sketch = NativeHeavyHitterSketch(k=k, width=width)  # guarded-by: self._mu
        self.phases = PhaseLedger()  # internally locked
        #: per-tenant ledger: not ported, attribution off
        self._tenants = None
        self._q: "queue.Queue" = queue.Queue(maxsize=queue_cap)
        self._waves = 0  # guarded-by: self._mu
        self._dropped = 0  # guarded-by: self._mu
        self._pub_mu = threading.Lock()  # serializes gauge refreshes
        self._published: Dict[str, float] = {}  # guarded-by: self._pub_mu
        self._last_publish = 0.0  # guarded-by: self._pub_mu
        #: the side stream of device-tap copies (worker thread only)
        self._copy_stream = None
        self._closing = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="key-analytics")
        self._thread.start()

    # ---- taps (serving path: a copy or a reference, never a wait) -------

    def tap_packed(self, khash, hits, status) -> bool:
        """Columnar wave tap: copies the three columns now (the caller's
        arrays may be pooled or shared result views) and enqueues them.
        False when the queue was full (the wave is dropped)."""
        item = ("cols",
                np.array(khash, np.uint64, copy=True),
                np.array(hits, np.int64, copy=True),
                np.array(np.asarray(status) == 1, bool),
                int(self._clock() * 1000))
        return self._put(item)

    def tap_named(self, khash, batch, cols, req_lists) -> bool:
        """Object-lane tap: the wave's key hashes, its packed RequestBatch
        and result columns (status, limit, remaining, reset, table_full)
        and its callers' request lists, all by reference: a list wave's
        columns are its own and only read once it resolved.  The worker
        folds the columns and names only the keys the sketch has not
        named, from the requests; the sketch equals the one the JAX list
        tap builds, after every wave."""
        if not len(khash):
            return True
        return self._put(("named", khash, batch, cols,
                          int(self._clock() * 1000), req_lists))

    def tap_device(self, tap) -> bool:
        """Device tap of an engine that taps in its step, called right
        after the step is queued: ``tap`` is the wave's [4, B] int64
        tensor (rows: khash bit-viewed, hits, over, served).  On a CUDA
        tensor a CUDA event is recorded here, on the stream behind the
        step; nothing is copied: the worker waits for the event and
        copies.  False when the queue was full."""
        event = None
        if tap.device.type == "cuda":
            import torch

            event = torch.cuda.Event()
            event.record()
        return self._put(("dev", tap, event, int(self._clock() * 1000)))

    def _dev_to_cols(self, item):
        """A device tap → a "cols" item on the worker thread: padding,
        invalid and table-full rows left out by its ``served`` row.  None
        when nothing was served or the copy failed (a dead device must
        not kill the worker)."""
        try:
            _, tap, event, t_ms = item
            if tap.device.type == "cuda":
                import torch

                if self._copy_stream is None:
                    self._copy_stream = torch.cuda.Stream(tap.device)
                with torch.cuda.stream(self._copy_stream):
                    # the copy runs after the wave's step and beside the
                    # waves launched since, not behind them
                    if event is not None:
                        self._copy_stream.wait_event(event)
                    arr = tap.to("cpu").numpy()
            else:
                arr = tap.numpy()
            served = arr[3] != 0
            if not served.any():
                return None
            return ("cols", arr[0][served].view(np.uint64),
                    arr[1][served], arr[2][served] != 0, int(t_ms))
        except Exception:  # pragma: no cover - analytics only
            log.exception("device tap copy")
            return None

    def _put(self, item) -> bool:
        try:
            self._q.put_nowait(item)
        except queue.Full:
            with self._mu:
                self._dropped += 1
            if self.metrics is not None:
                self.metrics.analytics_dropped.inc()
            return False
        return True

    # ---- phase attribution ---------------------------------------------

    def observe_phase(self, phase: str, seconds: float) -> None:
        """One phase sample → the histogram and /debug/phases."""
        seconds = max(seconds, 0.0)
        self.phases.observe(phase, seconds)
        m = self.metrics
        if m is not None:
            child = self._phase_hist.get(phase)
            if child is None:  # benign race: labels() is idempotent
                child = self._phase_hist[phase] = \
                    m.phase_duration.labels(phase=phase)
            child.observe(seconds)

    # ---- worker ---------------------------------------------------------

    def _run(self) -> None:
        q = self._q
        while True:
            item = q.get()
            cols: list = []
            while True:
                if item is None:
                    self._fold_cols(cols)
                    return
                if isinstance(item, _Flush):
                    self._fold_cols(cols)
                    cols = []
                    item.done.set()
                elif item[0] == "cols":
                    cols.append(item)
                elif item[0] == "dev":
                    # the device → host copy happens here, on the worker
                    c = self._dev_to_cols(item)
                    if c is not None:
                        cols.append(c)
                else:
                    # an object-lane (named) tap: fold the queued
                    # columns first, so the waves fold in order
                    self._fold_cols(cols)
                    cols = []
                    self._safe_apply(item)
                try:
                    item = q.get_nowait()
                except queue.Empty:
                    break
            self._fold_cols(cols)
            if not self._closing:
                time.sleep(self.BATCH_INTERVAL_S)

    def _fold_cols(self, cols: list) -> None:
        """Everything the drain window collected folds in ONE sketch
        update."""
        if not cols:
            return
        try:
            if len(cols) == 1:
                _, khash, hits, over, t_ms = cols[0]
            else:
                khash = np.concatenate([c[1] for c in cols])
                hits = np.concatenate([c[2] for c in cols])
                over = np.concatenate([c[3] for c in cols])
                t_ms = cols[-1][4]
            with self._mu:
                self.sketch.update(khash, hits, over, t_ms)
                self._waves += len(cols)
            if self.metrics is not None:
                self.metrics.analytics_waves.inc(len(cols))
            self._maybe_publish()
        except Exception:  # pragma: no cover - must never die
            log.exception("analytics fold")

    def _safe_apply(self, item) -> None:
        try:
            self._apply(item)
        except Exception:  # pragma: no cover - must never die
            log.exception("analytics tap apply")

    def _apply(self, item) -> None:
        """Fold a named tap: the columns in one update, then a name for
        each of the wave's keys the sketch has none for, in hash order
        (the order JAX's list tap notes them in).  The weight is the
        request's hits: the packed column holds it except on invalid
        rows (zeroed) and at the packer's clamp, which read the
        request."""
        _, khash, batch, cols, t_ms, req_lists = item
        over = (cols[0] == 1) & ~cols[4] & batch.valid
        hits = batch.hits
        cap = np.where(batch.algorithm == 1,
                       np.minimum(TD_BOUND // np.maximum(batch.eff_ms, 1),
                                  VALUE_MAX), VALUE_MAX)
        exact = np.nonzero(~batch.valid | (hits >= cap))[0]
        flat = None  # the wave's requests in row order, when needed
        if len(exact):
            flat = [r for rl in req_lists for r in rl]
            hits = np.array(hits, np.int64)
            for i in exact.tolist():
                hits[i] = int(flat[i].hits)
        uniq, first = np.unique(np.asarray(khash, np.uint64),
                                return_index=True)
        with self._mu:
            self.sketch.update(khash, hits, over, t_ms)
            # checked key by key: a name the bounded table evicts while
            # this wave's names go in is noted again, as the list tap did
            named = self.sketch._names
            note = self.sketch._note_name
            for k, i in zip(uniq.tolist(), first.tolist()):
                if k in named:
                    continue
                if flat is None:
                    flat = [r for rl in req_lists for r in rl]
                r = flat[i]
                note(k, f"{r.name}_{r.unique_key}")
            self._waves += 1
        if self.metrics is not None:
            self.metrics.analytics_waves.inc()
        self._maybe_publish()

    def _maybe_publish(self) -> None:
        now = time.monotonic()
        with self._pub_mu:
            due = now - self._last_publish >= self.PUBLISH_INTERVAL_S
            if due:
                self._last_publish = now
        if due:
            self._publish()

    def republish(self) -> None:
        """Scrape-time gauge refresh (the daemon's /metrics handler)."""
        with self._pub_mu:
            self._last_publish = time.monotonic()
        self._publish()

    def _publish(self) -> None:
        """Refresh gubernator_topkey_overlimit_total for the CURRENT
        top-K only: departed keys' labels are removed first, so the
        family never holds more than K labels."""
        if self.metrics is None:
            return
        with self._mu:
            top = self.sketch.topk()
        fresh = {}
        for e in top:
            label = e["key"] or f"0x{e['khash']:016x}"
            fresh[label] = float(e["over_limit"])
        gauge = self.metrics.topkey_overlimit
        with self._pub_mu:
            for label in list(self._published):
                if label not in fresh:
                    try:
                        gauge.remove(label)
                    except KeyError:  # pragma: no cover - already gone
                        pass
            for label, val in fresh.items():
                gauge.labels(key=label).set(val)
            self._published = fresh

    # ---- reporting ------------------------------------------------------

    def flush(self, timeout: float = 10.0) -> bool:
        """Block until every tap enqueued so far is folded (and the gauge
        republished): tests and snapshot callers."""
        f = _Flush()
        try:
            self._q.put(f, timeout=timeout)
        except queue.Full:
            return False
        ok = f.done.wait(timeout)
        if ok:
            self._publish()
        return ok

    def sketch_count(self, khash: int) -> int:
        """Tracked count of one key hash (0 when untracked): the cold
        tier's admission rank."""
        with self._mu:
            return self.sketch.count_of(khash)

    def sketch_counts(self, khashes) -> List[int]:
        """Batched :meth:`sketch_count` under one lock acquisition (the
        tier's victim pick reads a whole probe window)."""
        with self._mu:
            return [self.sketch.count_of(int(k)) for k in khashes]

    def stats(self) -> dict:
        with self._mu:
            return {"k": self.sketch.k, "width": self.sketch.width,
                    "waves_tapped": self._waves,
                    "taps_dropped": self._dropped,
                    "tracked_keys": len(self.sketch),
                    "queue_depth": self._q.qsize()}

    def rank_distribution(self, limit: int = 4096) -> List[int]:
        """The tracked counts, descending (rank r's count is the demand a
        table of r+1 rows would hold at the margin)."""
        with self._mu:
            used = len(self.sketch)
            cnt = np.sort(self.sketch._cnt[:used])[::-1]
        return [int(v) for v in cnt[:max(int(limit), 1)]]

    def topkeys_snapshot(self, limit: Optional[int] = None) -> dict:
        """The ``GET /debug/topkeys`` document (the daemon adds each
        key's owner)."""
        with self._mu:
            top = self.sketch.topk(limit)
            bound = self.sketch.error_bound()
            total = self.sketch.total_weight
        out = self.stats()
        out.update({"total_hits_observed": total,
                    "admission_error_bound": bound,
                    "keys": [dict(e, khash=f"0x{e['khash']:016x}")
                             for e in top]})
        return out

    def phases_snapshot(self) -> dict:
        return {"phases": self.phases.snapshot()}

    def close(self) -> None:
        self._closing = True
        try:
            self._q.put_nowait(None)
        except queue.Full:  # make room for the poison pill
            try:
                self._q.get_nowait()
            except queue.Empty:
                pass
            self._q.put(None)
        self._thread.join(timeout=5)
