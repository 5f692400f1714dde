"""Host-side request packing: wire requests → fixed-shape numpy columns.

The port's copy of the numpy packers of gubernator_tpu/core/batch.py
(``pack_requests`` / ``pack_columns`` and their clamps, the pooled wave
buffers ``WaveBufferPool`` / ``WaveLease``) plus the packed wave layout
and response assembly of gubernator_tpu/parallel/sharded.py
(``PACK64``/``PACK32``, ``pack_wave_host``, ``responses_from_columns``).
Everything calendar- or string-shaped happens here, on the host; the
device only ever sees integers.  Packed columns must stay bit-identical
to the JAX package's: the tests pack the same request lists through both.
"""
from __future__ import annotations

import threading
from typing import List, NamedTuple, Sequence

import numpy as np

from ..gregorian import gregorian_expiration, gregorian_rate_duration_ms
from ..hashing import hash_keys
from ..types import (DURATION_MAX, EFF_MAX, TD_BOUND, VALUE_MAX, Behavior,
                     RateLimitRequest, RateLimitResponse, Status)

#: Batch sizes are rounded up to one of these.
BATCH_BUCKETS = (64, 256, 1024, 4096)


def clamp_config(algorithm, limit, duration, burst, behavior=0):
    """Scalar mirror of the packer clamps for (alg, limit, duration,
    burst); must stay in lockstep with pack_requests/pack_columns."""
    alg = 1 if int(algorithm) == 1 else 0
    duration = min(int(duration), DURATION_MAX)
    if alg == 1:
        if int(behavior) & int(Behavior.DURATION_IS_GREGORIAN):
            eff = gregorian_rate_duration_ms(duration)
        else:
            eff = max(duration, 1)
        cap_v = min(TD_BOUND // min(eff, EFF_MAX), VALUE_MAX)
    else:
        cap_v = VALUE_MAX
    limit = min(max(int(limit), 0), cap_v)
    burst = min(int(burst), cap_v) if int(burst) > 0 else limit
    return alg, limit, duration, burst


class RequestBatch(NamedTuple):
    """Fixed-shape [B] view of a GetRateLimitsReq batch.

    Host batches hold numpy columns (``key`` uint64); device batches
    (ops/decide.py › batch_from_packed) hold torch tensors, with ``key``
    as the int64 bit-view of the hash.  ``now`` is the per-request
    arrival time (epoch ms, 0 = use the scalar ``now`` of the step)."""

    key: np.ndarray  # uint64, 0 = padding
    hits: np.ndarray  # int64, clamped ≥ 0
    limit: np.ndarray  # int64, clamped ≥ 0
    duration: np.ndarray  # int64, as given
    eff_ms: np.ndarray  # int64, ≥ 1
    greg_end: np.ndarray  # int64, calendar period end (0 if n/a)
    behavior: np.ndarray  # int32 flags
    algorithm: np.ndarray  # int32
    burst: np.ndarray  # int64, already defaulted to limit
    valid: np.ndarray  # bool
    now: np.ndarray | None = None  # int64 epoch ms, 0 = unset


def bucket_size(n: int) -> int:
    for b in BATCH_BUCKETS:
        if n <= b:
            return b
    return ((n + BATCH_BUCKETS[-1] - 1) // BATCH_BUCKETS[-1]) * BATCH_BUCKETS[-1]


def empty_batch(size: int) -> RequestBatch:
    return RequestBatch(
        key=np.zeros(size, np.uint64),
        hits=np.zeros(size, np.int64),
        limit=np.zeros(size, np.int64),
        duration=np.zeros(size, np.int64),
        eff_ms=np.ones(size, np.int64),
        greg_end=np.zeros(size, np.int64),
        behavior=np.zeros(size, np.int32),
        algorithm=np.zeros(size, np.int32),
        burst=np.zeros(size, np.int64),
        valid=np.zeros(size, bool),
        now=np.zeros(size, np.int64),
    )


def pack_requests(
    reqs: Sequence[RateLimitRequest],
    now_ms: int,
    size: int | None = None,
    key_hashes: np.ndarray | None = None,
) -> tuple[RequestBatch, List[str]]:
    """Pack wire requests into a padded RequestBatch.

    Returns (batch, errors) where errors[i] is a per-request error string
    ("" if OK).  Requests with errors (an invalid Gregorian ordinal) are
    marked invalid and skipped by the device.  ``key_hashes`` lets a
    caller that already hashed the keys skip re-hashing.
    """
    n = len(reqs)
    b = empty_batch(size if size is not None else bucket_size(n))
    errors = [""] * n
    b.key[:n] = key_hashes if key_hashes is not None else hash_keys(
        [r.key for r in reqs])
    GREG = int(Behavior.DURATION_IS_GREGORIAN)  # hot loop: plain-int flags
    b.now[:n] = now_ms
    for i, r in enumerate(reqs):
        if r.created_at:
            # caller's accepted-at clock: the request applies at ITS time
            b.now[i] = r.created_at
        behavior = int(r.behavior)
        leaky = int(r.algorithm) == 1
        duration = min(int(r.duration), DURATION_MAX)
        if behavior & GREG:
            try:
                b.greg_end[i] = gregorian_expiration(now_ms, duration)
                eff = gregorian_rate_duration_ms(duration)
            except (ValueError, KeyError):
                errors[i] = f"invalid gregorian duration ordinal: {duration}"
                b.key[i] = 0
                continue
        else:
            eff = max(duration, 1)
        # leaky td bounds: eff ≤ EFF_MAX, values ≤ TD_BOUND // eff;
        # token values ≤ VALUE_MAX
        if leaky:
            eff = min(eff, EFF_MAX)
            cap_v = min(TD_BOUND // eff, VALUE_MAX)
        else:
            cap_v = VALUE_MAX
        limit = min(max(int(r.limit), 0), cap_v)
        b.eff_ms[i] = eff
        b.hits[i] = min(max(int(r.hits), 0), cap_v)
        b.limit[i] = limit
        b.duration[i] = duration
        b.behavior[i] = behavior
        # any wire value other than 1 means TOKEN_BUCKET
        b.algorithm[i] = 1 if leaky else 0
        b.burst[i] = min(int(r.burst), cap_v) if int(r.burst) > 0 else limit
        b.valid[i] = True
    return b, errors


def pack_columns(
    khash: np.ndarray,
    hits: np.ndarray,
    limit: np.ndarray,
    duration: np.ndarray,
    algorithm: np.ndarray,
    behavior: np.ndarray,
    burst: np.ndarray,
    now_ms: int,
    created_at: np.ndarray | None = None,
) -> tuple[RequestBatch, dict]:
    """Vectorized pack of already-columnar requests → RequestBatch.

    Same clamps and semantics as ``pack_requests``, as array ops.
    Returns (batch, errors) where errors maps request index → error
    string (invalid Gregorian ordinals).  ``khash`` must already be
    mixed and zero-remapped.  ``created_at`` (optional i64[n], 0 =
    unset) gives rows their own ``now``; Gregorian period ends still
    derive from ``now_ms``.
    """
    n = len(khash)
    behavior32 = behavior.astype(np.int32)
    dur = np.minimum(np.asarray(duration, np.int64), DURATION_MAX)
    eff = np.maximum(dur, 1)
    greg_end = np.zeros(n, np.int64)
    valid = np.ones(n, bool)
    key_col = khash.astype(np.uint64).copy()
    errors: dict = {}
    greg = (behavior32 & int(Behavior.DURATION_IS_GREGORIAN)) != 0
    if greg.any():
        # a handful of distinct calendar ordinals per batch: compute each
        # period end once, broadcast to its requests
        for d in np.unique(dur[greg]):
            m = greg & (dur == d)
            try:
                greg_end[m] = gregorian_expiration(now_ms, int(d))
                eff[m] = gregorian_rate_duration_ms(int(d))
            except (ValueError, KeyError):
                valid[m] = False
                key_col[m] = 0
                msg = f"invalid gregorian duration ordinal: {int(d)}"
                for i in np.nonzero(m)[0]:
                    errors[int(i)] = msg
    leaky = np.asarray(algorithm) == 1
    eff = np.where(leaky, np.minimum(eff, EFF_MAX), eff)
    cap_v = np.where(leaky, np.minimum(TD_BOUND // eff, VALUE_MAX),
                     VALUE_MAX)
    lim = np.minimum(np.clip(np.asarray(limit, np.int64), 0, None), cap_v)
    now_col = np.full(n, now_ms, np.int64)
    if created_at is not None:
        created = np.asarray(created_at, np.int64)
        now_col = np.where(created > 0, created, now_col)
    b = RequestBatch(
        key=key_col,
        hits=np.minimum(np.clip(np.asarray(hits, np.int64), 0, None), cap_v),
        limit=lim,
        duration=dur.copy(),
        eff_ms=eff,
        greg_end=greg_end,
        behavior=behavior32,
        algorithm=leaky.astype(np.int32),
        burst=np.where(burst > 0, np.minimum(burst, cap_v), lim),
        valid=valid,
        now=now_col,
    )
    return b, errors


#: Packed wave layout: every int64 column rides one [8, B] int64 upload
#: (key bit-viewed; row 7 is the per-request arrival time), the int32/
#: bool columns one [3, B] int32 upload.
PACK64 = ("key", "hits", "limit", "duration", "eff_ms", "greg_end",
          "burst", "now")
PACK32 = ("behavior", "algorithm", "valid")


class WaveLease:
    """One leased pair of packed upload matrices (a64 [8, m] int64,
    a32 [3, m] int32) from a :class:`WaveBufferPool`.

    The holder calls :meth:`release` on every path (success, engine
    raise, fallback) once the wave's upload has read the buffers.  The
    engine uploads them with a blocking copy from pageable memory
    (sharded.py › _launch_arrays: no pinning, no ``non_blocking``), so
    the source has been read when the upload returns and the lease may
    go back to the pool right after the launch; no CUDA event is
    needed.  A lease dropped without release is counted as a leak by
    the pool, which takes the buffers back."""

    __slots__ = ("a64", "a32", "_pool", "_released", "__weakref__")

    def __init__(self, pool: "WaveBufferPool", a64, a32):
        self._pool = pool
        self.a64 = a64
        self.a32 = a32
        self._released = False

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        self._pool._return(self.a64, self.a32)

    def __del__(self):
        if not self._released:
            self._released = True
            self._pool._record_leak()
            self._pool._return(self.a64, self.a32)


class WaveBufferPool:
    """Reusable packed wave-upload pairs, keyed by wave width ``m``.

    ``lease(m)`` hands back a pooled pair zeroed to ``empty_batch``
    padding (all zeros; the caller re-fills the eff_ms row) or allocates
    one on a miss; ``WaveLease.release`` returns it.  Thread-safe; each
    width keeps at most ``MAX_PER_WIDTH`` free pairs, so a burst cannot
    grow the pool without bound.  ``metrics`` (a Metrics registry,
    bound by V1Instance) gets the hit / miss / leak counters."""

    #: free pairs kept per width
    MAX_PER_WIDTH = 4

    def __init__(self):
        self._mu = threading.Lock()
        #: m → [(a64, a32), ...]
        self._free: dict[int, list] = {}  # guarded-by: self._mu
        self.hits = 0  # guarded-by: self._mu
        self.misses = 0  # guarded-by: self._mu
        self.leaks = 0  # guarded-by: self._mu
        self.outstanding = 0  # guarded-by: self._mu
        self.metrics = None  # bound by V1Instance after construction

    def lease(self, m: int) -> WaveLease:
        """Lease a zeroed (a64 [8, m] int64, a32 [3, m] int32) pair."""
        with self._mu:
            ring = self._free.get(m)
            buf = ring.pop() if ring else None
            if buf is not None:
                self.hits += 1
            else:
                self.misses += 1
            self.outstanding += 1
        if buf is not None:
            a64, a32 = buf
            a64.fill(0)
            a32.fill(0)
            if self.metrics is not None:
                self.metrics.wave_buffer_pool_hit.inc()
        else:
            a64 = np.zeros((len(PACK64), m), np.int64)
            a32 = np.zeros((len(PACK32), m), np.int32)
            if self.metrics is not None:
                self.metrics.wave_buffer_pool_miss.inc()
        return WaveLease(self, a64, a32)

    def _return(self, a64, a32) -> None:
        m = a64.shape[1]
        with self._mu:
            self.outstanding -= 1
            ring = self._free.setdefault(m, [])
            if len(ring) < self.MAX_PER_WIDTH:
                ring.append((a64, a32))

    def _record_leak(self) -> None:
        with self._mu:
            self.leaks += 1
        if self.metrics is not None:
            self.metrics.wave_buffer_leaks.inc()

    def stats(self) -> dict:
        with self._mu:
            return {"hits": self.hits, "misses": self.misses,
                    "leaks": self.leaks, "outstanding": self.outstanding,
                    "pooled": sum(len(v) for v in self._free.values())}


def lease_batch(lease: WaveLease, idx) -> RequestBatch:
    """The leased rows ``idx`` as a RequestBatch of numpy columns, as
    numpy indexes: views into the lease for a slice, copies for an
    index array (what must outlive the lease: the table-full retry, a
    busy dispatcher's queued job).  ``valid`` is always a new array."""
    a64, a32 = lease.a64, lease.a32
    return RequestBatch(
        key=a64[0][idx].view(np.uint64), hits=a64[1][idx],
        limit=a64[2][idx], duration=a64[3][idx], eff_ms=a64[4][idx],
        greg_end=a64[5][idx], behavior=a32[0][idx],
        algorithm=a32[1][idx], burst=a64[6][idx],
        valid=a32[2][idx] != 0, now=a64[7][idx])


def pack_wave_host(b: RequestBatch) -> tuple[np.ndarray, np.ndarray]:
    """RequestBatch of numpy columns → ([8,B] i64, [3,B] i32)."""
    B = len(b.key)
    a64 = np.empty((len(PACK64), B), np.int64)
    a64[0] = np.asarray(b.key).view(np.int64)
    for i, f in enumerate(PACK64[1:], start=1):
        a64[i] = getattr(b, f)
    a32 = np.empty((len(PACK32), B), np.int32)
    a32[0] = b.behavior
    a32[1] = b.algorithm
    a32[2] = b.valid
    return a64, a32


def responses_from_columns(cols, errors=None) -> List[RateLimitResponse]:
    """(status, limit, remaining, reset, full) columns + optional
    per-request error strings → RateLimitResponse objects."""
    st, lim, rem, rst, full = cols
    # one bulk conversion to Python ints (per-element numpy scalar
    # indexing costs ~µs each and this loop runs per request)
    st_l = np.asarray(st).tolist()
    lim_l = np.asarray(lim).tolist()
    rem_l = np.asarray(rem).tolist()
    rst_l = np.asarray(rst).tolist()
    full_l = np.asarray(full).tolist()
    out: List[RateLimitResponse] = []
    for i in range(len(st_l)):
        if errors is not None and errors[i]:
            out.append(RateLimitResponse(error=errors[i]))
        elif full_l[i]:
            out.append(RateLimitResponse(error="rate limit table full"))
        else:
            out.append(RateLimitResponse(
                status=Status.OVER_LIMIT if st_l[i]
                else Status.UNDER_LIMIT,
                limit=lim_l[i], remaining=rem_l[i],
                reset_time=rst_l[i]))
    return out
