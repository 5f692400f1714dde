"""Dataclass ↔ wire converters: the port's copy of the helpers of
gubernator_tpu/wire.py that the wire lane, its forward hop and the gRPC
front door need, plus a protobuf-free request encoder.

The ``*_pb`` converters speak the generated classes of proto/ and import
protobuf when called.  ``req_to_tlv`` and ``encode_get_rate_limits``
write the wire bytes by hand (proto3: fields in number order, defaults
omitted), byte-equal to the protobuf serialization, so a load generator
or the card's smoke run can build request bytes without protobuf.
"""
from __future__ import annotations

from typing import Iterable, List

from .types import (HealthCheckResponse, RateLimitRequest,
                    RateLimitResponse, Status)

_U64 = (1 << 64) - 1


def _pb():
    from .proto import gubernator_pb2

    return gubernator_pb2


def req_to_pb(r: RateLimitRequest):
    m = _pb().RateLimitReq(
        name=r.name, unique_key=r.unique_key, hits=int(r.hits),
        limit=int(r.limit), duration=int(r.duration),
        algorithm=int(r.algorithm), behavior=int(r.behavior),
        burst=int(r.burst))
    for k, v in r.metadata.items():
        m.metadata[k] = v
    return m


def req_from_pb(m) -> RateLimitRequest:
    # plain ints, not enums: a behavior may combine flags
    return RateLimitRequest(
        name=m.name, unique_key=m.unique_key, hits=m.hits, limit=m.limit,
        duration=m.duration, algorithm=m.algorithm, behavior=m.behavior,
        burst=m.burst, metadata=dict(m.metadata) if m.metadata else {})


def resp_to_pb(r: RateLimitResponse):
    m = _pb().RateLimitResp(
        status=int(r.status), limit=int(r.limit),
        remaining=int(r.remaining), reset_time=int(r.reset_time))
    if r.error:
        m.error = r.error
    for k, v in r.metadata.items():
        m.metadata[k] = v
    return m


def resp_from_pb(m) -> RateLimitResponse:
    return RateLimitResponse(
        status=Status(m.status), limit=m.limit, remaining=m.remaining,
        reset_time=m.reset_time, error=m.error, metadata=dict(m.metadata))


def reqs_to_pb(reqs: List[RateLimitRequest]):
    m = _pb().GetRateLimitsReq()
    m.requests.extend(req_to_pb(r) for r in reqs)
    return m


def health_to_pb(h: HealthCheckResponse):
    return _pb().HealthCheckResp(status=h.status, message=h.message,
                                 peer_count=h.peer_count)


def _varint(v: int) -> bytes:
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _string(field: int, s: str) -> bytes:
    b = s.encode()
    return bytes([field << 3 | 2]) + _varint(len(b)) + b if b else b""


def _int(field: int, v: int) -> bytes:
    # negative int64 and enum values go out as 10-byte two's complement
    return bytes([field << 3]) + _varint(int(v) & _U64) if v else b""


def req_to_tlv(r: RateLimitRequest) -> bytes:
    """Request → one ``requests`` TLV (tag 0x0a, varint length, the
    RateLimitReq payload), without protobuf.  ``created_at`` rides as
    field 10, as the JAX package appends it."""
    payload = b"".join((
        _string(1, r.name), _string(2, r.unique_key), _int(3, r.hits),
        _int(4, r.limit), _int(5, r.duration), _int(6, r.algorithm),
        _int(7, r.behavior), _int(8, r.burst)))
    for k, v in r.metadata.items():
        entry = (b"\x0a" + _varint(len(k.encode())) + k.encode()
                 + b"\x12" + _varint(len(v.encode())) + v.encode())
        payload += b"\x4a" + _varint(len(entry)) + entry
    payload += _int(10, r.created_at)
    return b"\x0a" + _varint(len(payload)) + payload


def encode_get_rate_limits(reqs: Iterable[RateLimitRequest]) -> bytes:
    """A serialized GetRateLimitsReq, without protobuf."""
    return b"".join(map(req_to_tlv, reqs))


def _tlv_payload(tlv: bytes) -> bytes:
    """The RateLimitReq payload of one ``requests`` TLV (tag 0x0a,
    varint length, payload)."""
    i, shift, ln = 1, 0, 0
    while True:
        b = tlv[i]
        ln |= (b & 0x7F) << shift
        i += 1
        if not b & 0x80:
            break
        shift += 7
    return tlv[i:i + ln]


def _append_to_tlv(tlv: bytes, field_bytes: bytes) -> bytes:
    payload = _tlv_payload(tlv) + field_bytes
    return b"\x0a" + _varint(len(payload)) + payload


def req_from_tlv(tlv: bytes) -> RateLimitRequest:
    """A request object from one verbatim ``requests`` TLV: the deferred
    prototype of the GLOBAL queues, built at flush cadence, never on
    the request path.  ``created_at`` (field 10, which the generated
    classes do not declare) is read by hand."""
    payload = _tlv_payload(tlv)
    req = req_from_pb(_pb().RateLimitReq.FromString(payload))
    req.created_at = tlv_created_at_payload(payload)
    return req


def tlv_created_at_payload(payload: bytes) -> int:
    """``created_at`` (field 10 varint, last value wins) of a
    RateLimitReq payload; 0 when absent or on framing this scan does not
    model."""
    i, n, created = 0, len(payload), 0

    def varint():
        nonlocal i
        v, shift = 0, 0
        while i < n:
            b = payload[i]
            v |= (b & 0x7F) << shift
            i += 1
            if not b & 0x80:
                break
            shift += 7
        return v

    while i < n:
        tag = varint()
        field_no, wt = tag >> 3, tag & 7
        if wt == 0:
            v = varint()
            if field_no == 10:
                created = v
        elif wt == 2:
            ln = varint()  # read first: varint() moves i
            i += ln
        elif wt == 1:
            i += 8
        elif wt == 5:
            i += 4
        else:
            return 0
    return created


def tlv_with_hits(tlv: bytes, hits: int) -> bytes:
    """A request TLV with ``hits`` replaced, without parsing it: a field-3
    varint is appended (proto3: the last value wins, for protobuf and
    the C++ lane alike).  The GLOBAL flush sends per-key sums this way."""
    return _append_to_tlv(tlv, b"\x18" + _varint(int(hits)))


def tlv_with_created(tlv: bytes, created_ms: int) -> bytes:
    """A request TLV with ``created_at`` (field 10) appended: the
    caller's clock, so the owner applies the request at it
    (ops/native.py › stamp_req_tlvs is the bulk twin)."""
    return _append_to_tlv(tlv, b"\x50" + _varint(int(created_ms)))
