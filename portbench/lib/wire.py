"""GetRateLimits bytes without protobuf, many rows at a time.

``encode_rows`` writes RateLimitReq TLVs (the ``requests`` field of a
GetRateLimitsReq) for whole arrays of rows at once: proto3's encoding,
fields in number order and zero fields left out, so the bytes equal
protobuf's own serialization.  A call's request bytes are the
concatenation of its rows' TLVs.

``decode_calls`` reads GetRateLimitsResp bytes back into columns.  The
served path answers a row with varint fields only (status, limit,
remaining, reset_time); such bytes are a sequence of (tag, varint)
pairs and are decoded as one array.  A call whose answers carry an
error or metadata string is read by the plain decoder instead.
"""
from __future__ import annotations

import numpy as np

#: RateLimitReq field numbers (gubernator.proto)
F_NAME, F_KEY, F_HITS, F_LIMIT, F_DURATION, F_ALGORITHM, F_BEHAVIOR, \
    F_BURST = range(1, 9)
#: RateLimitResp varint fields and their tags
RESP_FIELDS = {0x08: "status", 0x10: "limit", 0x18: "remaining",
               0x20: "reset_time"}
_ROW_TAG = 0x0A


def varint_columns(v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Varints of ``v`` (int64 or uint64; a negative int64 takes ten
    bytes, as protobuf writes it): an [n, 10] uint8 matrix and each
    row's length."""
    u = np.asarray(v).astype(np.int64).view(np.uint64)
    more = np.stack([(u >> np.uint64(7 * (k + 1))) != 0 for k in range(10)],
                    axis=1)
    lens = 1 + more[:, :9].sum(axis=1)
    out = np.stack([((u >> np.uint64(7 * k)) & np.uint64(0x7F))
                    .astype(np.uint8) for k in range(10)], axis=1)
    out |= np.where(more, 0x80, 0).astype(np.uint8)
    return out, lens


def _segment(n: int, const: bytes) -> tuple[np.ndarray, np.ndarray]:
    return (np.broadcast_to(np.frombuffer(const, np.uint8), (n, len(const))),
            np.full(n, len(const), np.int64))


def _int_field(field: int, v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """tag + varint, or nothing where the value is 0 (proto3)."""
    n = len(v)
    body, lens = varint_columns(v)
    mat = np.concatenate([np.full((n, 1), field << 3, np.uint8), body], 1)
    return mat, np.where(np.asarray(v) != 0, lens + 1, 0)


def _digits(idx: np.ndarray, width: int) -> np.ndarray:
    """[n, width] ASCII digits of ``idx``, zero-padded."""
    p = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
    return ((np.asarray(idx, np.int64)[:, None] // p) % 10
            + ord("0")).astype(np.uint8)


def encode_rows(name: str, key_prefix: str, key_idx: np.ndarray,
                key_width: int, hits, limit, duration, algorithm=0,
                behavior=0, burst=0) -> tuple[np.ndarray, np.ndarray]:
    """RateLimitReq TLVs of rows whose unique key is ``key_prefix``
    followed by ``key_idx`` in ``key_width`` zero-padded digits; the
    integer fields broadcast.  Returns the bytes of all rows back to
    back (uint8) and each row's end offset."""
    n = len(key_idx)
    if n and (np.min(key_idx) < 0 or np.max(key_idx) >= 10 ** key_width):
        raise ValueError("a key index does not fit its width")
    nb, kb = name.encode(), key_prefix.encode()
    klen = len(kb) + key_width
    if len(nb) > 127 or klen > 127:
        raise ValueError("names and keys are at most 127 bytes")
    col = lambda x: np.broadcast_to(np.asarray(x, np.int64), (n,))  # noqa
    key = np.concatenate([
        np.broadcast_to(np.frombuffer(bytes([F_KEY << 3 | 2, klen]) + kb,
                                      np.uint8), (n, 2 + len(kb))),
        _digits(key_idx, key_width)], 1)
    segs = [_segment(n, bytes([F_NAME << 3 | 2, len(nb)]) + nb),
            (key, np.full(n, key.shape[1], np.int64))]
    segs += [_int_field(f, col(x)) for f, x in (
        (F_HITS, hits), (F_LIMIT, limit), (F_DURATION, duration),
        (F_ALGORITHM, algorithm), (F_BEHAVIOR, behavior), (F_BURST, burst))]
    payload = sum(lens for _, lens in segs)
    head, hlen = varint_columns(payload)
    segs.insert(0, (np.concatenate(
        [np.full((n, 1), _ROW_TAG, np.uint8), head], 1), hlen + 1))
    mat = np.concatenate([m for m, _ in segs], 1)
    keep = np.concatenate([np.arange(m.shape[1])[None, :] < lens[:, None]
                           for m, lens in segs], 1)
    row_len = sum(lens for _, lens in segs)
    return mat[keep], np.cumsum(row_len)


def split_calls(flat: np.ndarray, ends: np.ndarray, rows_per_call: int
                ) -> list[bytes]:
    """The request bytes of consecutive calls of ``rows_per_call`` rows."""
    n = len(ends) // rows_per_call
    cut = np.r_[0, ends[rows_per_call - 1::rows_per_call][:n]]
    buf = flat.tobytes()
    return [buf[cut[i]:cut[i + 1]] for i in range(n)]


def _empty(n: int) -> dict:
    return {"status": np.zeros(n, np.int64), "limit": np.zeros(n, np.int64),
            "remaining": np.zeros(n, np.int64),
            "reset_time": np.zeros(n, np.int64),
            "error": np.zeros(n, bool)}


def _decode_pairs(buf: np.ndarray):
    """Columns of a response stream of varint fields only, or None where
    it holds anything else."""
    if not len(buf):
        return _empty(0), np.zeros(0, np.int64)
    term = buf < 0x80
    if not term[-1]:
        return None
    tok = np.cumsum(np.r_[0, term[:-1]])  # token of each byte
    starts = np.r_[0, np.nonzero(term)[0][:-1] + 1]
    shift = (np.arange(len(buf)) - starts[tok]) * 7
    if shift.max() > 63:
        return None
    part = (buf & 0x7F).astype(np.uint64) << shift.astype(np.uint64)
    vals = np.add.reduceat(part, starts)
    if len(vals) % 2:
        return None
    tags, v = vals[0::2], vals[1::2]
    rows = tags == _ROW_TAG
    if not rows[0] or not np.isin(tags, [_ROW_TAG, *RESP_FIELDS]).all():
        return None
    # each row's declared length has to end where the next row starts
    row_tok = np.nonzero(rows)[0] * 2
    head_end = np.r_[starts[1:], len(buf)][row_tok + 1]
    row_end = head_end + v[rows].astype(np.int64)
    if not np.array_equal(row_end, np.r_[starts[row_tok[1:]], len(buf)]):
        return None
    n = int(rows.sum())
    out = _empty(n)
    rid = np.cumsum(rows) - 1
    signed = v.view(np.int64)
    for tag, f in RESP_FIELDS.items():
        m = tags == tag
        out[f][rid[m]] = signed[m]
    return out, starts[row_tok]


def decode_plain(data: bytes) -> dict:
    """Any GetRateLimitsResp bytes → columns (``error`` True where the
    row carries an error string; metadata is skipped)."""

    def varint(i):
        v = shift = 0
        while True:
            b = data[i]
            i += 1
            v |= (b & 0x7F) << shift
            if b < 0x80:
                return v, i
            shift += 7

    rows, i, n = [], 0, len(data)
    while i < n:
        if data[i] != _ROW_TAG:
            raise ValueError(f"response tag {data[i]:#x}")
        ln, i = varint(i + 1)
        end = i + ln
        f = {"status": 0, "limit": 0, "remaining": 0, "reset_time": 0,
             "error": False}
        while i < end:
            tag, i = varint(i)
            if tag & 7 == 0:
                v, i = varint(i)
                if tag in RESP_FIELDS:
                    f[RESP_FIELDS[tag]] = v - (1 << 64) if v >= 1 << 63 \
                        else v
            elif tag & 7 == 2:
                sl, i = varint(i)
                if tag >> 3 == 5 and sl:
                    f["error"] = True
                i += sl
            else:
                raise ValueError(f"wire type {tag & 7}")
        if i != end:
            raise ValueError("a response overran its length")
        rows.append(f)
    out = _empty(len(rows))
    for k in out:
        out[k][:] = [r[k] for r in rows]
    return out


#: calls decoded together: enough to amortise NumPy's calls, few enough
#: that the per-byte arrays stay small
DECODE_CHUNK = 256


def decode_calls(answers: list[bytes]) -> tuple[dict, np.ndarray]:
    """Columns of every row of ``answers`` (one bytes object a call, in
    order) and the number of rows of each call."""
    if len(answers) > DECODE_CHUNK:
        parts = [_decode_chunk(answers[i:i + DECODE_CHUNK])
                 for i in range(0, len(answers), DECODE_CHUNK)]
        return ({k: np.concatenate([c[k] for c, _ in parts])
                 for k in parts[0][0]},
                np.concatenate([n for _, n in parts]))
    return _decode_chunk(answers)


def _decode_chunk(answers: list[bytes]) -> tuple[dict, np.ndarray]:
    buf = np.frombuffer(b"".join(answers), np.uint8)
    ends = np.cumsum([len(a) for a in answers])
    got = _decode_pairs(buf)
    if got is not None:
        cols, row_pos = got
        per_call = np.bincount(np.searchsorted(ends, row_pos, "right"),
                               minlength=len(answers))[:len(answers)]
        return cols, per_call
    parts, per_call = [], []
    for a in answers:
        one = _decode_pairs(np.frombuffer(a, np.uint8))
        cols = one[0] if one is not None else decode_plain(a)
        parts.append(cols)
        per_call.append(len(cols["status"]))
    return ({k: np.concatenate([p[k] for p in parts]) if parts
             else _empty(0)[k] for k in _empty(0)},
            np.asarray(per_call, np.int64))
