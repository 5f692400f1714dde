"""V1Instance: one daemon's request routing over the device engine.

The port of gubernator_tpu/instance.py for a daemon with no peers: every
request in a client batch is served locally, through the dispatcher, in
one device wave with whatever other callers sent meanwhile.
``Behavior.GLOBAL`` rows are served locally too, exactly as a solo JAX
daemon with no hot set serves them.  ``Config.engine`` picks the bucket
engine (K1) or the classic SoA engine (``xla``).  Building or launching
a kernel raises, and so does building an engine: there is no fallback
engine.

Two entries: ``get_rate_limits`` takes request objects (the HTTP
gateway), ``get_rate_limits_wire`` takes and returns GetRateLimits wire
bytes (the gRPC front door) through three lanes, each with the object
lane's answers:

- fused: one C++ pass from bytes into a leased packed wave
  (engine.prepack_wire), run inline when the dispatcher is idle, else
  coalesced; responses are written as bytes from the result columns;
- parse: the C++ parse into columns, pack_columns, the dispatcher;
  Gregorian and GLOBAL / MULTI_REGION rows and anything the fused pass
  refuses;
- protobuf: metadata, empty names or keys, unknown fields.

MULTI_REGION replication, clustered routing, analytics taps, metrics and
tracing wait for their slices.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import List, Optional, Sequence

import numpy as np

from .config import Config
from .core.batch import lease_batch, pack_columns
from .dispatcher import Dispatcher
from .engine import BucketEngine
from .hashing import mix64_np
from .ops import native as wire_native
from .sharded import ShardedEngine, autogrow_limit_per_shard
from .types import (MAX_BATCH_SIZE, Behavior, HealthCheckResponse,
                    RateLimitRequest, RateLimitResponse)

log = logging.getLogger("gubernator_tpu_torch.instance")


def clock_ms() -> int:
    return time.time_ns() // 1_000_000


def resolve_engine_kind(selector: str) -> str:
    """GUBER_ENGINE / Config.engine → "bucket" or "classic".

    ``""``, ``auto`` and ``pallas`` select the bucket engine (K1) on
    every device; ``xla`` and ``sharded`` the classic SoA engine.
    Unknown values raise: a typo must not silently serve a mode whose
    domain the operator believes is live."""
    sel = (selector or "").strip().lower()
    if sel in ("", "auto", "pallas"):
        return "bucket"
    if sel in ("xla", "sharded"):
        return "classic"
    raise ValueError(f"unknown GUBER_ENGINE {selector!r} (want auto, "
                     "pallas, xla or sharded)")


class V1Instance:
    """Device engine + dispatcher for one peerless daemon."""

    def __init__(self, config: Config):
        self.config = config
        # at least 1024 rows, a power of two (the JAX instance's
        # per-shard floor at one shard)
        cap = 1 << (max(config.cache_size, 1024) - 1).bit_length()
        self.engine = self._build_engine(
            resolve_engine_kind(config.engine), cap, config)
        self._engine_mu = threading.Lock()
        self.dispatcher = Dispatcher(
            self.engine, max_wave=self.engine.wave_buckets[-1],
            lock=self._engine_mu)
        self._last_sweep = clock_ms()
        self._closed = False

    @staticmethod
    def _build_engine(kind: str, cap: int, config: Config):
        """Construct the resolved engine kind; a failure raises."""
        if kind == "bucket":
            if config.cache_autogrow_max:
                log.warning(
                    "the bucket engine ignores cache_autogrow_max=%d: it "
                    "has no on-device grow; size cache_size for peak keys "
                    "up front", config.cache_autogrow_max)
            return BucketEngine(device=config.device, capacity=cap,
                                batch_rows=config.batch_rows)
        return ShardedEngine(
            device=config.device, capacity=cap,
            batch_rows=config.batch_rows,
            auto_grow_limit=autogrow_limit_per_shard(
                config.cache_autogrow_max, 1, cap))

    def get_rate_limits(self, reqs: Sequence[RateLimitRequest],
                        now_ms: Optional[int] = None
                        ) -> List[RateLimitResponse]:
        """Batch entry point (gubernator.go › GetRateLimits)."""
        if len(reqs) > MAX_BATCH_SIZE:
            raise ValueError(
                f"Requests.RateLimits list too large; max size is "
                f"{MAX_BATCH_SIZE}")
        now = clock_ms() if now_ms is None else now_ms
        return self._get_rate_limits(reqs, now)

    def _get_rate_limits(self, reqs, now) -> List[RateLimitResponse]:
        responses: List[Optional[RateLimitResponse]] = [None] * len(reqs)
        local_idx: List[int] = []
        for i, req in enumerate(reqs):
            if not req.unique_key:
                responses[i] = RateLimitResponse(
                    error="field 'unique_key' cannot be empty")
            elif not req.name:
                responses[i] = RateLimitResponse(
                    error="field 'name' cannot be empty")
            else:
                local_idx.append(i)
        if local_idx:
            local = self.dispatcher.check_batch(
                [reqs[i] for i in local_idx], now)
            for i, resp in zip(local_idx, local):
                responses[i] = resp
        self._maybe_sweep(now)
        return responses  # type: ignore[return-value]

    def _maybe_sweep(self, now: int) -> None:
        iv = self.config.sweep_interval_ms
        if iv > 0 and now - self._last_sweep >= iv:
            self._last_sweep = now
            with self._engine_mu:
                self.engine.sweep(now)

    def health_check(self) -> HealthCheckResponse:
        """reference: gubernator.go › HealthCheck.  A solo daemon with no
        async replication is healthy with an empty message, as the JAX
        instance answers; the table's occupancy stays with the engine
        (``occupancy`` / ``occupancy_and_saturation``)."""
        return HealthCheckResponse(status="healthy", message="",
                                   peer_count=0)

    # ---- the wire entry ------------------------------------------------

    def get_rate_limits_wire(self, data: bytes,
                             now_ms: Optional[int] = None) -> bytes:
        """Serialized GetRateLimitsReq in, serialized GetRateLimitsResp
        out, with the object lane's answers.  Takes the fused lane when
        the batch qualifies, else the parse lane, else the protobuf
        lane; a message protobuf cannot decode raises ValueError, and so
        does a batch of more than MAX_BATCH_SIZE requests on every
        lane."""
        data = bytes(data) if not isinstance(data, bytes) else data
        out = self._wire_client_fused(data, now_ms)
        if out is not None:
            return out
        parsed = wire_native.parse_get_rate_limits(data)
        if parsed is not None:
            if parsed["n"] > MAX_BATCH_SIZE:
                raise ValueError(
                    f"Requests.RateLimits list too large; max size is "
                    f"{MAX_BATCH_SIZE}")
            now = clock_ms() if now_ms is None else now_ms
            # GLOBAL with no hot set is the local path; MULTI_REGION
            # rows are decided locally (their replication is not ported)
            out = self._wire_check_columns(parsed, now)
            self._maybe_sweep(now)
            return out
        return self._wire_pb2(data, now_ms)

    #: behaviors the fused lane hands to the parse lane (JAX: their
    #: hot-set routing and replication queues need the parsed columns)
    _FUSED_EXCLUDED = Behavior.GLOBAL | Behavior.MULTI_REGION

    def _wire_client_fused(self, data: bytes,
                           now_ms: Optional[int]) -> Optional[bytes]:
        """The fused lane, or None when it cannot serve the batch."""
        now = clock_ms() if now_ms is None else now_ms
        pre = self.engine.prepack_wire(data, now)
        if pre is None:
            return None
        if pre.behavior_or & int(self._FUSED_EXCLUDED):
            pre.lease.release()
            return None
        if pre.n > MAX_BATCH_SIZE:
            pre.lease.release()
            raise ValueError(
                f"Requests.RateLimits list too large; max size is "
                f"{MAX_BATCH_SIZE}")
        out = self._run_fused(pre, now)
        self._maybe_sweep(now)
        return out

    def _run_fused(self, pre, now: int) -> bytes:
        """Run a prepacked wave and serialize its responses.  Idle: one
        inline wave in this thread.  Busy: the rows are copied out of the
        lease (the queued job outlives it) and coalesce with the other
        callers' waves."""
        disp, n = self.dispatcher, pre.n
        out = disp.run_inline_wave(
            lambda: self.engine.check_prepacked(pre, now))
        if out is not disp._BUSY:
            return self._columns_to_bytes(out, 0, n)
        try:
            # an index array copies: the rows outlive the lease
            batch = lease_batch(pre.lease, np.arange(n))
        finally:
            pre.lease.release()
        view = disp.check_packed_view(batch, pre.khash, now)
        return self._columns_to_bytes(view.cols, view.lo, view.hi)

    @staticmethod
    def _columns_to_bytes(cols, lo: int, hi: int, errs=None) -> bytes:
        """Rows [lo, hi) of result columns → response bytes; ``errs``
        maps a row (relative to lo) to its error, and table-full rows
        without one answer ``rate limit table full``."""
        full = np.nonzero(cols[4][lo:hi])[0]
        errors = None
        if errs or len(full):
            errors = [None] * (hi - lo)
            for i, msg in (errs or {}).items():
                errors[i] = msg
            for i in full.tolist():
                if errors[i] is None:
                    errors[i] = wire_native.TABLE_FULL
        return wire_native.build_responses_from_columns(cols, lo, hi,
                                                        errors)

    def _wire_check_columns(self, parsed: dict, now: int) -> bytes:
        """Parsed wire columns → pack → dispatcher → response bytes,
        written from the wave's shared columns in this thread."""
        kh = mix64_np(parsed["khash_raw"])
        kh = np.where(kh == 0, np.uint64(1), kh)
        batch, errs = pack_columns(
            kh, parsed["hits"], parsed["limit"], parsed["duration"],
            parsed["algorithm"], parsed["behavior"], parsed["burst"], now,
            created_at=parsed["created_at"])
        view = self.dispatcher.check_packed_view(batch, kh, now)
        return self._columns_to_bytes(view.cols, view.lo, view.hi, errs)

    def _wire_pb2(self, data: bytes, now_ms: Optional[int]) -> bytes:
        """The protobuf lane: decode, the object lane, encode."""
        from google.protobuf.message import DecodeError

        from .proto import gubernator_pb2 as pb
        from .wire import req_from_pb, resp_to_pb

        try:
            msg = pb.GetRateLimitsReq.FromString(data)
        except DecodeError as e:
            raise ValueError(f"invalid GetRateLimitsReq: {e}") from e
        resps = self.get_rate_limits([req_from_pb(m) for m in msg.requests],
                                     now_ms=now_ms)
        out = pb.GetRateLimitsResp()
        out.responses.extend(resp_to_pb(r) for r in resps)
        return out.SerializeToString()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.dispatcher.close()
