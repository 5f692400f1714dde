"""Python face of the host wire library (csrc/wire.cpp, ctypes).

The functions of gubernator_tpu/ops/native.py that the wire lane, its
forward hop and the object lane's key hashing need, with the same names
and return shapes.  The library is built at
first use (ops/build.py › load_wire_library); a failed build raises, and
there is no numpy or protobuf substitute for these functions.  Each call
releases the GIL for its native part (ctypes does), so concurrent
callers parse and serialize in parallel; the key hashing reads Python
strings and keeps it.
"""
from __future__ import annotations

import numpy as np

from ..types import DURATION_MAX, EFF_MAX, TD_BOUND, VALUE_MAX
from .build import load_wire_library, load_wire_pylib

#: the answer to a row whose probe window stayed full (or, on the
#: bucket engine, whose values lie outside K1's domain)
TABLE_FULL = "rate limit table full"


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _as_bytes(data) -> bytes:
    return data if isinstance(data, bytes) else bytes(data)


def hash_keys(keys, mixed: bool = False) -> np.ndarray:
    """FNV-1a 64 of each key (str as UTF-8, or bytes) → uint64[n]: RAW
    (the JAX extension's ``hash_keys``) or, with ``mixed``, the table
    key hash (mix64, 0 → 1).  A sequence that is not a list or tuple is
    listed first."""
    if not isinstance(keys, (list, tuple)):
        keys = list(keys)
    out = np.empty(len(keys), "<u8")
    load_wire_pylib().gw_hash_keys(keys, _ptr(out), len(out), int(mixed))
    return out


def hash_pairs(names, unique_keys, mixed: bool = False) -> np.ndarray:
    """FNV-1a 64 of ``name + "_" + unique_key`` per pair, without
    joining the strings: RAW (the JAX extension's ``hash_pairs``) or,
    with ``mixed``, the table key hash (mix64, 0 → 1).  Raises
    ValueError when the lengths differ."""
    if not isinstance(names, (list, tuple)):
        names = list(names)
    if not isinstance(unique_keys, (list, tuple)):
        unique_keys = list(unique_keys)
    out = np.empty(len(names), "<u8")
    load_wire_pylib().gw_hash_pairs(names, unique_keys, _ptr(out),
                                    len(out), int(mixed))
    return out


def count_req_items(data: bytes):
    """Top-level TLV count of a GetRateLimitsReq, or None on framing the
    fast lane does not model.  Lets the fused ingest size its wave
    bucket (and lease the packed buffers) before the one full parse."""
    data = _as_bytes(data)
    n = load_wire_library().gw_count_req_items(data, len(data))
    return None if n < 0 else int(n)


def parse_get_rate_limits(data: bytes):
    """GetRateLimitsReq wire bytes → packed column dict, or None when the
    message needs the protobuf path (metadata, empty name or key, unknown
    fields, bad framing).  ``khash_raw`` is RAW FNV-1a64: apply
    hashing.mix64_np."""
    data = _as_bytes(data)
    lib = load_wire_library()
    n = lib.gw_count_req_items(data, len(data))
    if n < 0:
        return None
    cols = {"khash_raw": np.empty(n, "<u8"), "hits": np.empty(n, "<i8"),
            "limit": np.empty(n, "<i8"), "duration": np.empty(n, "<i8"),
            "algorithm": np.empty(n, "<i4"), "behavior": np.empty(n, "<i4"),
            "burst": np.empty(n, "<i8"), "tlv_off": np.empty(n, "<u8"),
            "tlv_len": np.empty(n, "<u8"), "created_at": np.empty(n, "<i8")}
    beh_or = np.zeros(1, "<u8")
    got = lib.gw_parse_get_rate_limits(
        data, len(data), n, *(_ptr(cols[k]) for k in (
            "khash_raw", "hits", "limit", "duration", "algorithm",
            "behavior", "burst", "tlv_off", "tlv_len", "created_at")),
        _ptr(beh_or))
    if got < 0:
        return None
    cols["n"] = int(got)
    cols["behavior_or"] = int(beh_or[0])
    return cols


def pack_wire_wave(data: bytes, now_ms: int, a64: np.ndarray,
                   a32: np.ndarray):
    """Fused wire ingest: parse, validate, clamp and key-hash (FNV-1a64,
    mix64, 0 → 1) one request message straight into a leased packed
    pair (``a64`` [8, m] int64, ``a32`` [3, m] int32, zeroed;
    core/batch.py › PACK64 / PACK32).

    Returns None (the caller releases the lease and takes another lane)
    for protobuf framing, more than m rows or any DURATION_IS_GREGORIAN
    row; else (n, khash u64[n] MIXED, khash_raw u64[n], behavior_or,
    tlv_off u64[n], tlv_len u64[n])."""
    data = _as_bytes(data)
    m = a64.shape[1]
    if (a64.dtype != np.int64 or a32.dtype != np.int32
            or a64.shape != (8, m) or a32.shape != (3, m)
            or not a64.flags.c_contiguous or not a32.flags.c_contiguous):
        raise ValueError("want C-contiguous a64 int64[8, m] and a32 "
                         "int32[3, m]")
    out = np.empty((4, m), "<u8")  # khash, khash_raw, tlv_off, tlv_len
    beh_or = np.zeros(1, "<u8")
    n = load_wire_library().gw_pack_wire_wave(
        data, len(data), int(now_ms), _ptr(a64), _ptr(a32), m,
        DURATION_MAX, VALUE_MAX, EFF_MAX, TD_BOUND,
        *(_ptr(out[i]) for i in range(4)), _ptr(beh_or))
    if n < 0:
        return None
    return (int(n), out[0, :n], out[1, :n], int(beh_or[0]), out[2, :n],
            out[3, :n])


def build_responses_from_columns(result_cols, row_lo: int, row_hi: int,
                                 errors=None) -> bytes:
    """Rows [row_lo, row_hi) of a wave's shared result columns →
    GetRateLimitsResp wire bytes, with no per-request Python object.

    ``result_cols`` is the dispatcher / engine 5-tuple (status i32,
    limit i64, remaining i64, reset i64, table_full bool); the bool
    column is ignored here (the caller folds it into ``errors``).
    ``errors``: optional sequence of str / bytes / None indexed relative
    to ``row_lo``."""
    st, lim, rem, rst = (np.ascontiguousarray(c, dt) for c, dt in zip(
        result_cols[:4], ("<i4", "<i8", "<i8", "<i8")))
    n = len(st)
    if len(lim) != n or len(rem) != n or len(rst) != n:
        raise ValueError("column length mismatch")
    if row_lo < 0 or row_hi < row_lo or row_hi > n:
        raise ValueError("row bounds out of range")
    rows, parts = [], []
    if errors is not None:
        for i, e in enumerate(errors):
            if e:
                rows.append(i)
                parts.append(e.encode() if isinstance(e, str) else bytes(e))
    lens = np.fromiter(map(len, parts), np.int64, len(parts))
    offs = np.zeros(len(parts), np.int64)
    np.cumsum(lens[:-1], out=offs[1:])
    err_rows = np.asarray(rows, np.int64)
    lib = load_wire_library()
    out = np.empty(lib.gw_resp_bound(row_hi - row_lo, len(parts),
                                     int(lens.sum())), np.uint8)
    size = lib.gw_build_responses(
        _ptr(st), _ptr(lim), _ptr(rem), _ptr(rst), row_lo, row_hi,
        _ptr(err_rows), _ptr(offs), _ptr(lens), len(parts), b"".join(parts),
        _ptr(out), len(out))
    if size < 0:
        raise RuntimeError("response buffer below its bound")
    return out[:size].tobytes()


def stamp_req_tlvs(data: bytes, tlv_off: np.ndarray, tlv_len: np.ndarray,
                   created_at: np.ndarray, stamp_ms: int) -> bytes:
    """Join the given request TLV slices of ``data``, appending
    ``created_at = stamp_ms`` (field 10) to every slice that carries no
    caller stamp (created_at[i] == 0): the forward hop's bulk
    caller-clock stamp (wire.tlv_with_created is the one-slice twin).
    Raises ValueError on a malformed slice."""
    data = _as_bytes(data)
    off = np.ascontiguousarray(tlv_off, "<i8")
    ln = np.ascontiguousarray(tlv_len, "<i8")
    created = np.ascontiguousarray(created_at, "<i8")
    n = len(off)
    if len(ln) != n or len(created) != n:
        raise ValueError("malformed request TLV slice")
    lib = load_wire_library()
    out = np.empty(lib.gw_stamp_bound(n, int(ln.sum())), np.uint8)
    size = lib.gw_stamp_req_tlvs(data, len(data), _ptr(off), _ptr(ln),
                                 _ptr(created), n, int(stamp_ms),
                                 _ptr(out), len(out))
    if size == -1:
        raise ValueError("malformed request TLV slice")
    if size < 0:
        raise RuntimeError("stamp buffer below its bound")
    return out[:size].tobytes()


def split_resp_items(data: bytes):
    """RateLimitResp-list wire bytes (GetRateLimitsResp or
    GetPeerRateLimitsResp: both carry the item on field 1) → (tlv_off
    u64[n], tlv_len u64[n], status i32[n]), or None on malformed
    input."""
    data = _as_bytes(data)
    lib = load_wire_library()
    n = lib.gw_count_req_items(data, len(data))
    if n < 0:
        return None
    off, ln = np.empty(n, "<u8"), np.empty(n, "<u8")
    st = np.empty(n, "<i4")
    got = lib.gw_split_resp_items(data, len(data), n, _ptr(off), _ptr(ln),
                                  _ptr(st))
    if got < 0:
        return None
    return off, ln, st
