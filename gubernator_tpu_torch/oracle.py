"""The semantic oracle: the port's copy of gubernator_tpu/oracle.py.

Pure-Python, exact-integer implementation of the rate-limit behavior
contract (reference algorithms.go › tokenBucket / tokenBucketNewItem /
leakyBucket / leakyBucketNewItem).  The scenario lab's parity oracle
replays every schedule on an instance whose engine is ``OracleEngine``
and compares decision streams byte for byte.  It touches no device.

Contract summary (the JAX module's docstring has the full text)
----------------------------------------------------------------

All time is int64 epoch milliseconds.  Each key's state ("item"):
``algorithm``, ``limit``, ``duration`` (ms or Gregorian ordinal),
``burst`` (leaky; 0 → limit), ``t_ms`` (token: created_at; leaky:
updated_at), ``expire_at`` (token: reset boundary; leaky: sliding cache
TTL), ``remaining`` and ``status`` (stored; returned for hits=0
queries).

Token bucket: a missing or expired item starts fresh (remaining=limit,
expire = now+duration or the Gregorian period end); a duration change
recomputes expire from created_at (fresh when that expires it now);
``RESET_REMAINING`` forces remaining=limit; a limit change adjusts in
place (remaining = clamp(remaining + new-old, 0, new)); hits=0 is a pure
query; hits ≤ remaining decrements, else OVER_LIMIT with no decrement
(``DRAIN_OVER_LIMIT`` zeroes remaining); reset_time = expire_at.

Leaky bucket, in exact integer "token-duration" fixed point:
``remaining_td = remaining × duration_eff``, replenished by
``elapsed × limit`` (clamped to ``burst × duration_eff``); a request
costs ``hits × duration_eff``.  Gregorian ordinals use the fixed-width
approximation for the leak rate; a duration change rescales td; a limit
change does not adjust remaining; reset_time = now + duration_eff //
limit; expire_at = now + duration_eff (sliding TTL).

Input clamps (every request): hits < 0 → 0, limit < 0 → 0,
non-Gregorian duration < 1 → 1, burst ≤ 0 → limit; duration ≤
DURATION_MAX; token hits/limit ≤ VALUE_MAX; leaky eff ≤ EFF_MAX and
leaky hits/limit/burst ≤ TD_BOUND // eff (types.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .gregorian import gregorian_expiration, gregorian_rate_duration_ms
from .types import (
    DURATION_MAX,
    EFF_MAX,
    FRAC_SAFE,
    TD_BOUND,
    VALUE_MAX,
    Algorithm,
    Behavior,
    RateLimitRequest,
    RateLimitResponse,
    Status,
)


@dataclass
class Item:
    """Oracle-side mirror of one device table row."""

    __slots__ = (
        "algorithm",
        "limit",
        "duration",
        "eff_ms",
        "burst",
        "remaining",
        "t_ms",
        "expire_at",
        "status",
    )
    algorithm: int
    limit: int
    duration: int  # as given by the request (ms or Gregorian ordinal)
    eff_ms: int  # effective ms denominator the item was created/rescaled with
    burst: int
    remaining: int  # token: tokens; leaky: token-duration (td) units
    t_ms: int
    expire_at: int
    status: int


def _eff_duration_ms(duration: int, behavior: int) -> int:
    """Effective millisecond duration used for leak rate / td denominator."""
    if behavior & Behavior.DURATION_IS_GREGORIAN:
        return gregorian_rate_duration_ms(duration)
    return max(int(duration), 1)


def _token_expire(now_ms: int, created_ms: int, duration: int, behavior: int) -> int:
    if behavior & Behavior.DURATION_IS_GREGORIAN:
        return gregorian_expiration(now_ms, duration)
    return created_ms + max(int(duration), 1)


# Input clamps (the int64-safety contract; bounds live in types.py and
# are applied identically by the device packers, core/batch.py):
#
# - duration (ms) ≤ DURATION_MAX (2^53, ~285k years) — a 30-day or
#   multi-year window passes through un-truncated.
# - TOKEN_BUCKET hits/limit ≤ VALUE_MAX (2^53).
# - LEAKY_BUCKET: eff ≤ EFF_MAX (2^35, ~1.09y), then hits/limit/burst
#   ≤ TD_BOUND // eff so every td product stays ≤ 2^61.
#
# Two in-kernel guards complete the contract (mirrored bit-for-bit in
# core/step.py › _apply_position):
# - rescale-on-duration-change clamps whole tokens to TD_BOUND // new_eff
#   and keeps the sub-token fraction only when both denominators are
#   ≤ FRAC_SAFE (else floors to whole tokens — a < 1-token deviation);
# - replenish treats elapsed > TD_BOUND // limit as "bucket refilled to
#   burst" (exact: the true product already exceeds the burst cap).


def _clamp_token(req: RateLimitRequest) -> Tuple[int, int, int]:
    hits = min(max(int(req.hits), 0), VALUE_MAX)
    limit = min(max(int(req.limit), 0), VALUE_MAX)
    duration = min(int(req.duration), DURATION_MAX)
    return hits, limit, duration


def _clamp_leaky(req: RateLimitRequest) -> Tuple[int, int, int, int, int]:
    """(hits, limit, duration, burst, eff) under the leaky td bounds."""
    duration = min(int(req.duration), DURATION_MAX)
    eff = min(_eff_duration_ms(duration, int(req.behavior)), EFF_MAX)
    cap_v = min(TD_BOUND // eff, VALUE_MAX)
    hits = min(max(int(req.hits), 0), cap_v)
    limit = min(max(int(req.limit), 0), cap_v)
    burst = int(req.burst) if int(req.burst) > 0 else limit
    burst = min(burst, cap_v)
    return hits, limit, duration, burst, eff


def _new_token_item(req: RateLimitRequest, now_ms: int) -> Item:
    hits, limit, duration = _clamp_token(req)
    return Item(
        algorithm=Algorithm.TOKEN_BUCKET,
        limit=limit,
        duration=duration,
        eff_ms=_eff_duration_ms(duration, req.behavior),
        burst=limit,
        remaining=limit,
        t_ms=now_ms,
        expire_at=_token_expire(now_ms, now_ms, duration, req.behavior),
        status=Status.UNDER_LIMIT,
    )


def _new_leaky_item(req: RateLimitRequest, now_ms: int) -> Item:
    hits, limit, duration, burst, eff = _clamp_leaky(req)
    return Item(
        algorithm=Algorithm.LEAKY_BUCKET,
        limit=limit,
        duration=duration,
        eff_ms=eff,
        burst=burst,
        remaining=burst * eff,  # td units, starts full
        t_ms=now_ms,
        expire_at=now_ms + eff,
        status=Status.UNDER_LIMIT,
    )


def apply_token(item: Optional[Item], req: RateLimitRequest, now_ms: int
                ) -> Tuple[Item, RateLimitResponse]:
    hits, r_limit, r_duration = _clamp_token(req)
    behavior = int(req.behavior)

    if item is None or now_ms >= item.expire_at or item.algorithm != Algorithm.TOKEN_BUCKET:
        item = _new_token_item(req, now_ms)
    else:
        # Duration change → recompute expiry from created_at; if the new
        # duration means we are already expired, start fresh.
        if r_duration != item.duration:
            new_exp = _token_expire(now_ms, item.t_ms, r_duration, behavior)
            if new_exp <= now_ms:
                item = _new_token_item(req, now_ms)
            else:
                item.duration = r_duration
                item.expire_at = new_exp
        if behavior & Behavior.RESET_REMAINING:
            item.remaining = r_limit
            item.limit = r_limit
            item.status = Status.UNDER_LIMIT
        if r_limit != item.limit:
            item.remaining = min(max(item.remaining + (r_limit - item.limit), 0), r_limit)
            item.limit = r_limit

    resp = RateLimitResponse(limit=item.limit, reset_time=item.expire_at)
    if hits == 0:
        resp.status = Status(item.status)
        resp.remaining = item.remaining
        return item, resp

    if hits <= item.remaining:
        item.remaining -= hits
        item.status = Status.UNDER_LIMIT
    else:
        if behavior & Behavior.DRAIN_OVER_LIMIT:
            item.remaining = 0
        item.status = Status.OVER_LIMIT
    resp.status = Status(item.status)
    resp.remaining = item.remaining
    return item, resp


def apply_leaky(item: Optional[Item], req: RateLimitRequest, now_ms: int
                ) -> Tuple[Item, RateLimitResponse]:
    hits, r_limit, r_duration, r_burst, eff = _clamp_leaky(req)
    behavior = int(req.behavior)

    if item is None or now_ms >= item.expire_at or item.algorithm != Algorithm.LEAKY_BUCKET:
        item = _new_leaky_item(req, now_ms)
    else:
        if eff != item.eff_ms:
            # Duration (or its Gregorian interpretation) changed → rescale
            # td to the new denominator, using the denominator the item was
            # actually stored with.  Whole tokens clamp to the new bound
            # (they could not survive the burst cap anyway); the sub-token
            # fraction is kept only while frac × eff fits int64.
            whole, frac = divmod(item.remaining, item.eff_ms)
            whole = min(whole, TD_BOUND // eff)
            if item.eff_ms <= FRAC_SAFE and eff <= FRAC_SAFE:
                item.remaining = whole * eff + (frac * eff) // item.eff_ms
            else:
                item.remaining = whole * eff
            item.eff_ms = eff
        item.duration = r_duration
        if behavior & Behavior.RESET_REMAINING:
            item.remaining = r_limit * eff
            item.status = Status.UNDER_LIMIT
        item.limit = r_limit
        item.burst = r_burst
        # Replenish exactly: elapsed ms × limit td, clamped to burst.
        # When elapsed × limit would overflow int64 the true product
        # already exceeds the burst cap (cap ≤ TD_BOUND), so the bucket
        # is simply full — exact, not an approximation.
        elapsed = now_ms - item.t_ms
        cap = item.burst * eff
        if elapsed > TD_BOUND // max(item.limit, 1):
            item.remaining = cap
        else:
            item.remaining = min(item.remaining + elapsed * item.limit, cap)
        item.t_ms = now_ms

    rate = eff // item.limit if item.limit > 0 else eff
    item.expire_at = now_ms + eff
    resp = RateLimitResponse(limit=item.limit, reset_time=now_ms + rate)
    if hits == 0:
        resp.status = Status(item.status)
        resp.remaining = item.remaining // eff
        return item, resp

    hits_td = hits * eff
    if hits_td <= item.remaining:
        item.remaining -= hits_td
        item.status = Status.UNDER_LIMIT
    else:
        if behavior & Behavior.DRAIN_OVER_LIMIT:
            item.remaining = 0
        item.status = Status.OVER_LIMIT
    resp.status = Status(item.status)
    resp.remaining = item.remaining // eff
    return item, resp


class Oracle:
    """Sequential reference implementation over an unbounded key→Item
    map: the device path must produce identical responses for any
    request stream (the same ``now_ms`` fed to both)."""

    def __init__(self) -> None:
        self.items: Dict[str, Item] = {}

    def check(self, req: RateLimitRequest, now_ms: int) -> RateLimitResponse:
        key = req.key
        item = self.items.get(key)
        if int(req.algorithm) == Algorithm.LEAKY_BUCKET:
            item, resp = apply_leaky(item, req, now_ms)
        else:
            item, resp = apply_token(item, req, now_ms)
        self.items[key] = item
        return resp

    def check_batch(self, reqs: List[RateLimitRequest], now_ms: int
                    ) -> List[RateLimitResponse]:
        return [self.check(r, now_ms) for r in reqs]


class OracleEngine:
    """The Oracle behind the V1Instance engine interface (the object
    lane's subset): an injected ``engine=`` that runs the service layer
    (dispatcher coalescing, daemon listeners, wave telemetry) on pure
    Python, touching no device.  It has no packed or row-level
    interface, so a lane that needs one (the wire lanes, GLOBAL
    replicas, the cold tier, the Store's read-through) raises on it.
    Not thread-safe by itself: the dispatcher's engine lock serializes
    access as it does for the device engines.  Nothing picks it by
    default: it is the scenario lab's exact reference, not a serving
    engine."""

    def __init__(self, capacity: int = 1 << 16):
        self.oracle = Oracle()
        self.cap_local = capacity
        self.n = 1
        self.dropped_rows = 0

    def check_batch(self, reqs: List[RateLimitRequest], now_ms: int
                    ) -> List[RateLimitResponse]:
        return self.oracle.check_batch(list(reqs), now_ms)

    def occupancy(self) -> int:
        return len(self.oracle.items)

    def sweep(self, now_ms: int) -> None:
        self.oracle.items = {k: it for k, it in self.oracle.items.items()
                             if it.expire_at >= now_ms}

    def snapshot(self) -> dict:
        return {}
