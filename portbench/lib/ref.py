"""The plain reference: gubernator's TOKEN_BUCKET semantics in NumPy.

It imports nothing but NumPy and takes nothing the program made: the
keys, limits, durations and fill time come from the benchmark's own
set-up, and the program's answers are only judged.

A key restored full (``remaining = limit``) at ``t0`` with a duration
longer than the run answers its k-th hit of 1 with UNDER_LIMIT and
``remaining = limit - k`` while k <= limit, and with OVER_LIMIT and
``remaining = 0`` after; every answer carries the key's limit and
``reset_time = t0 + duration``.  Concurrent callers leave the order of
two calls open, never the multiset of answers, so a key is exact when
its UNDER answers read limit-1, limit-2, ... down to
limit - min(hits, limit), once each, and it answered OVER for the rest.
A read with 0 hits afterwards reads ``limit - min(hits, limit)``, and
OVER_LIMIT only where some hit was refused.
"""
from __future__ import annotations

import numpy as np

UNDER, OVER = 0, 1


def judge_hits(key, status, remaining, limit, reset_time, error,
               key_limit, key_reset) -> dict:
    """Counts of answers that break the semantics above, over the rows
    of every answered call (hits of 1 each); ``key`` indexes
    ``key_limit`` / ``key_reset``."""
    key = np.asarray(key, np.int64)
    out = {"rows": int(len(key)), "error_rows": int(np.sum(error))}
    lim = key_limit[key]
    out["wrong_limit"] = int(np.sum(limit != lim))
    out["wrong_reset"] = int(np.sum(reset_time != key_reset[key]))
    out["bad_status"] = int(np.sum((status != UNDER) & (status != OVER)))
    over = status == OVER
    out["over_with_remaining"] = int(np.sum(over & (remaining != 0)))
    # per key: the UNDER answers, largest remaining first, have to read
    # limit-1, limit-2, ...
    uk, ur = key[~over], remaining[~over]
    order = np.lexsort((-ur, uk))
    uk, ur = uk[order], ur[order]
    first = np.r_[True, uk[1:] != uk[:-1]] if len(uk) else np.zeros(0, bool)
    pos = np.arange(len(uk)) - np.maximum.accumulate(
        np.where(first, np.arange(len(uk)), 0)) if len(uk) else uk
    out["wrong_remaining"] = int(np.sum(ur != key_limit[uk] - 1 - pos))
    hits = np.bincount(key, minlength=len(key_limit))
    n_under = np.bincount(uk, minlength=len(key_limit))
    out["wrong_under_count"] = int(np.sum(
        n_under != np.minimum(hits, key_limit)))
    return out


def expected_reads(hits, key_limit):
    """(status, remaining) a read of 0 hits gives after ``hits`` hits of
    1 on keys restored full."""
    hits = np.asarray(hits, np.int64)
    return (np.where(hits > key_limit, OVER, UNDER),
            key_limit - np.minimum(hits, key_limit))


def judge_reads(key, status, remaining, limit, reset_time, error, hits,
                key_limit, key_reset) -> dict:
    """Counts of reads (0 hits, after the traffic) that break the
    semantics: ``hits`` is every hit sent to each key."""
    key = np.asarray(key, np.int64)
    want_s, want_r = expected_reads(hits[key], key_limit[key])
    return {"reads": int(len(key)),
            "read_errors": int(np.sum(error)),
            "read_wrong": int(np.sum((status != want_s)
                                     | (remaining != want_r)
                                     | (limit != key_limit[key])
                                     | (reset_time != key_reset[key])))}


def coalesced_answers(call_keys, key_limit):
    """The control: this reference put in the program's place with its
    exactness broken in the way a batching shortcut would break it.
    Calls apply one after another (in the order given), and the rows of
    one call that share a key are debited once and all read that one
    answer.  Returns (status, remaining) for the rows of every call, in
    order."""
    rem = key_limit.astype(np.int64).copy()
    st_out, rem_out = [], []
    for keys in call_keys:
        keys = np.asarray(keys, np.int64)
        uniq, inv = np.unique(keys, return_inverse=True)
        r = rem[uniq]
        ok = r >= 1
        r = np.where(ok, r - 1, r)
        rem[uniq] = r
        st_out.append(np.where(ok, UNDER, OVER)[inv])
        rem_out.append(np.where(ok, r, 0)[inv])
    return np.concatenate(st_out), np.concatenate(rem_out)
