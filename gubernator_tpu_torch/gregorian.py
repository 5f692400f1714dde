"""Calendar-period expiry for DURATION_IS_GREGORIAN (the port's copy of
gubernator_tpu/gregorian.py).

Host-side only: the device compares integer millisecond timestamps, the
host does calendars (SURVEY.md §7.3).  Mirrors the behavior of the
reference's holster gregorian helpers (algorithms.go › tokenBucket's
GregorianExpiration call — reconstructed): the bucket expires at the END
of the current calendar period in UTC, so every key resets at the period
boundary.
"""
from __future__ import annotations

import calendar
import datetime as _dt

from .types import GREGORIAN_APPROX_MS, GregorianDuration

_UTC = _dt.timezone.utc


def _from_ms(ms: int) -> _dt.datetime:
    return _dt.datetime.fromtimestamp(ms / 1000.0, tz=_UTC)


def _to_ms(dt: _dt.datetime) -> int:
    return int(dt.timestamp() * 1000)


def gregorian_expiration(now_ms: int, ordinal: int) -> int:
    """Epoch-ms of the end of the calendar period containing ``now_ms``.

    ``ordinal`` is a GregorianDuration value.  Raises ValueError on an
    unknown ordinal (the reference surfaces this as a per-request error).
    """
    d = GregorianDuration(ordinal)  # raises ValueError if out of range
    now = _from_ms(now_ms)
    if d == GregorianDuration.MINUTES:
        start = now.replace(second=0, microsecond=0)
        end = start + _dt.timedelta(minutes=1)
    elif d == GregorianDuration.HOURS:
        start = now.replace(minute=0, second=0, microsecond=0)
        end = start + _dt.timedelta(hours=1)
    elif d == GregorianDuration.DAYS:
        start = now.replace(hour=0, minute=0, second=0, microsecond=0)
        end = start + _dt.timedelta(days=1)
    elif d == GregorianDuration.WEEKS:
        day0 = now.replace(hour=0, minute=0, second=0, microsecond=0)
        start = day0 - _dt.timedelta(days=now.weekday())  # Monday start
        end = start + _dt.timedelta(weeks=1)
    elif d == GregorianDuration.MONTHS:
        ndays = calendar.monthrange(now.year, now.month)[1]
        start = now.replace(day=1, hour=0, minute=0, second=0, microsecond=0)
        end = start + _dt.timedelta(days=ndays)
    else:  # YEARS
        end = _dt.datetime(now.year + 1, 1, 1, tzinfo=_UTC)
    return _to_ms(end)


def gregorian_rate_duration_ms(ordinal: int) -> int:
    """Fixed-width ms used for leak-rate math when a Gregorian ordinal is
    given (actual expiry still follows the calendar)."""
    return GREGORIAN_APPROX_MS[GregorianDuration(ordinal)]
