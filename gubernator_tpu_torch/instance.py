"""V1Instance: one daemon's request routing over the device engine (the
port of gubernator_tpu/instance.py; gubernator.go › V1Instance).

Alone (no peer but itself), every request in a client batch is served
locally, through the dispatcher, in one device wave with whatever other
callers sent meanwhile.  In a cluster (``set_peers``), keys belong to
daemons by a hash ring (peers.py): owned keys are decided locally,
other keys are forwarded to their owner over the peer wire
(peer_client.py), and ``Behavior.GLOBAL`` keys are answered from the
local replica, their hits queued to the owner, which broadcasts its
state back (global_manager.py).  The owner side is
``get_peer_rate_limits`` / ``get_peer_rate_limits_wire`` and
``update_peer_globals``.  ``Config.engine`` picks the bucket engine (K1)
or the classic SoA engine (``xla``).  Building or launching a kernel
raises, and so does building an engine: there is no fallback engine.

Two client entries: ``get_rate_limits`` takes request objects (the HTTP
gateway), ``get_rate_limits_wire`` takes and returns GetRateLimits wire
bytes (the gRPC front door) through these lanes, each with the object
lane's answers:

- fused (alone): one C++ pass from bytes into a leased packed wave
  (engine.prepack_wire), run inline when the dispatcher is idle, else
  coalesced; responses are written as bytes from the result columns;
- parse: the C++ parse into columns, pack_columns, the dispatcher;
  alone, Gregorian and GLOBAL / MULTI_REGION rows and anything the
  fused pass refuses; in a cluster, every batch: the ring split,
  verbatim TLV slices forwarded per remote owner while the owned rows
  take the device step, responses spliced back in request order;
- protobuf: metadata, empty names or keys, unknown fields.

A failed forward answers its rows with the error row the JAX instance
gives with ``peer_degraded_fallback=False``.

Each instance owns a ``Metrics`` registry and a ``FlightRecorder``
(served by the daemon at /metrics and /debug/events), shared with its
dispatcher, wave pool, peer clients and GLOBAL manager.  Every client
entry asks the dispatcher's admission control first, before any engine
work (``ResourceExhausted`` when it sheds), then counts its requests.
Degraded serves, the health-gated ring, the handover of moved rows,
MULTI_REGION replication, the GLOBAL hot set, analytics and tracing
wait for their slices.
"""
from __future__ import annotations

import logging
import os
import threading
import time
from concurrent.futures import Future
from dataclasses import replace
from typing import List, Optional, Sequence

import numpy as np

from .config import Config
from .core.batch import lease_batch, pack_columns
from .dispatcher import Dispatcher
from .engine import BucketEngine
from .global_manager import GlobalManager
from .gregorian import gregorian_rate_duration_ms
from .hashing import hash_keys, hash_request_keys, mix64_np
from .metrics import Metrics
from .ops import native as wire_native
from .peer_client import ErrCircuitOpen, ErrClosing, PeerClient
from .peers import ReplicatedConsistentHash
from .sharded import ShardedEngine, autogrow_limit_per_shard
from .telemetry import FlightRecorder, exc_text
from .types import (MAX_BATCH_SIZE, Algorithm, Behavior,
                    HealthCheckResponse, PeerInfo, RateLimitRequest,
                    RateLimitResponse, Status)

log = logging.getLogger("gubernator_tpu_torch.instance")

#: the "no rows match" mask when behavior_or proves a column scan needless
_NO_ROWS = np.zeros(0, bool)


def clock_ms() -> int:
    return time.time_ns() // 1_000_000


def created_at_fwd_enabled() -> bool:
    """GUBER_CREATED_AT_FWD=0 turns off caller-clock forwarding (the
    ``created_at`` stamp on forwarded TLVs and deferred GLOBAL hits), as
    it does in the JAX package, where it exists to show the cold-key
    loss the stamp prevents; never turn it off in production."""
    return os.environ.get("GUBER_CREATED_AT_FWD", "1") != "0"


def _req_stamped(req: RateLimitRequest, now: int) -> RateLimitRequest:
    """``req`` with ``created_at`` defaulted to ``now``: a deferred hit
    applies at the owner later, at the caller's time base."""
    if req.created_at or not created_at_fwd_enabled():
        return req
    return replace(req, created_at=now)


def _forward_fail_reason(e: Optional[BaseException]) -> str:
    """The low-cardinality reason label of gubernator_forward_failed."""
    if isinstance(e, ErrCircuitOpen):
        return "circuit_open"
    if isinstance(e, ErrClosing):
        return "closing"
    if isinstance(e, TimeoutError):
        return "timeout"
    if isinstance(e, RuntimeError) and "short" in (str(e) or ""):
        return "short_response"
    return "rpc_error"


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
        b = config.behaviors
        if b.peer_degraded_fallback or b.peer_health_gate:
            raise ValueError(
                "peer_degraded_fallback and peer_health_gate are not "
                "ported yet; set both to False")
        self.config = config
        self.metrics = Metrics()
        #: bounded structured-event ring: wave launches / stalls /
        #: timeouts, sheds, the drain, GLOBAL broadcasts and errors
        self.recorder = FlightRecorder()
        # at least 1024 rows, a power of two (the JAX instance's
        # per-shard floor at one shard)
        cap = 1 << (max(config.cache_size, 1024) - 1).bit_length()
        self.engine = self._build_engine(
            resolve_engine_kind(config.engine), cap, config)
        self.engine.wave_pool.metrics = self.metrics
        self._engine_mu = threading.Lock()
        self.dispatcher = self._make_dispatcher()
        self._last_sweep = clock_ms()
        self._closed = False
        self._picker = ReplicatedConsistentHash()  # guarded-by: self._peer_mu
        self._peer_mu = threading.Lock()
        self._self_addr = config.advertise_address
        self.global_manager: Optional[GlobalManager] = None
        self._gm_mu = threading.Lock()
        #: rows sent to their owners, and those whose forward failed
        self._fwd_mu = threading.Lock()
        self.forwarded_rows = 0  # guarded-by: self._fwd_mu
        self.forward_failures = 0  # guarded-by: self._fwd_mu

    def _make_dispatcher(self) -> Dispatcher:
        """A dispatcher over this instance's engine, lock, registry and
        recorder; the GUBER_* dispatcher knobs are read now."""
        return Dispatcher(self.engine,
                          max_wave=self.engine.wave_buckets[-1],
                          lock=self._engine_mu, metrics=self.metrics,
                          recorder=self.recorder)

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

    # ---- peers (gubernator.go › SetPeers) ------------------------------

    def set_peers(self, infos: Sequence[PeerInfo]) -> None:
        """Build a new ring from ``infos`` and swap it in, keeping the
        clients of peers that stay and draining those of peers that
        left.  Keys re-home silently and moved keys start afresh (the
        reference's behavior; the JAX package's optional handover of
        moved rows is not ported)."""
        with self._peer_mu:
            old = {p.info.grpc_address: p for p in self._picker.peers()}
            picker = self._picker.new()
            for info in infos:
                existing = old.pop(info.grpc_address, None)
                picker.add(existing if existing is not None else
                           PeerClient(info, self.config.behaviors,
                                      metrics=self.metrics))
            self._picker = picker
        for departed in old.values():
            threading.Thread(target=departed.shutdown, daemon=True,
                             name="peer-shutdown").start()

    def peers(self) -> List[PeerClient]:
        with self._peer_mu:
            return self._picker.peers()

    def owner_of(self, key: str) -> Optional[PeerClient]:
        """The owner of ``key`` (name + "_" + unique_key), None alone."""
        with self._peer_mu:
            if not self._picker.peers():
                return None
            return self._picker.get(key)

    def owner_by_raw_khash(self, khash_raw: int) -> Optional[PeerClient]:
        """The owner of a RAW (unmixed) FNV-1a key hash: the wire lanes'
        GLOBAL queue key."""
        with self._peer_mu:
            if not self._picker.peers():
                return None
            return self._picker.get_by_raw_hash(khash_raw)

    def is_self(self, peer: PeerClient) -> bool:
        return peer.info.grpc_address == self._self_addr

    def _clustered_picker(self):
        """The ring when a peer other than this daemon is on it, else
        None (alone, every key is local and GLOBAL broadcasts reach no
        one)."""
        with self._peer_mu:
            picker = self._picker
        if any(not self.is_self(p) for p in picker.peers()):
            return picker
        return None

    def _ensure_global_manager(self) -> GlobalManager:
        with self._gm_mu:
            if self.global_manager is None:
                self.global_manager = GlobalManager(
                    self, self.config.behaviors, self.metrics)
            return self.global_manager

    def _count_forward(self, rows: int, failed: int = 0) -> None:
        with self._fwd_mu:
            self.forwarded_rows += rows
            self.forward_failures += failed

    def _count_failed_forward(self, addr: str, err, rows: int) -> None:
        self.metrics.check_error_counter.labels(
            error="peer_forward").inc(rows)
        self.metrics.forward_failed.labels(
            peer_addr=addr, reason=_forward_fail_reason(err)).inc(rows)

    # ---- the object lane ------------------------------------------------

    def get_rate_limits(self, reqs: Sequence[RateLimitRequest],
                        now_ms: Optional[int] = None
                        ) -> List[RateLimitResponse]:
        """Batch entry point (gubernator.go › GetRateLimits).  Raises
        ResourceExhausted when admission control sheds the batch."""
        if len(reqs) > MAX_BATCH_SIZE:
            raise ValueError(
                f"Requests.RateLimits list too large; max size is "
                f"{MAX_BATCH_SIZE}")
        self.dispatcher.admit(len(reqs))
        now = clock_ms() if now_ms is None else now_ms
        return self._counted("api", len(reqs), None,
                             lambda: self._get_rate_limits(reqs, now))

    def _counted(self, calltype: str, n: int, lane: Optional[str], run):
        """``run()`` as one GetRateLimits call of ``n`` requests: counted
        by call type (and lane), timed, in the concurrent-checks gauge."""
        m = self.metrics
        m.getratelimit_counter.labels(calltype=calltype).inc(n)
        if lane is not None:
            m.wire_lane_counter.labels(lane=lane).inc(n)
        m.concurrent_checks.inc()
        try:
            with m.time_func("GetRateLimits"):
                return run()
        finally:
            m.concurrent_checks.dec()

    def _get_rate_limits(self, reqs, now) -> List[RateLimitResponse]:
        responses: List[Optional[RateLimitResponse]] = [None] * len(reqs)
        local_idx: List[int] = []
        glob_q: List[tuple] = []  # (request, we own it), after the step
        fwd: List[tuple] = []  # (request index, owner, request)
        picker = self._clustered_picker()
        GLOBAL = int(Behavior.GLOBAL)  # hot loop: plain-int flag tests
        for i, req in enumerate(reqs):
            if not req.unique_key:
                responses[i] = RateLimitResponse(
                    error="field 'unique_key' cannot be empty")
            elif not req.name:
                responses[i] = RateLimitResponse(
                    error="field 'name' cannot be empty")
            elif picker is None:
                local_idx.append(i)
            else:
                owner = picker.get(req.key)
                if int(req.behavior) & GLOBAL:
                    # answered from the local replica; reconciled later
                    local_idx.append(i)
                    glob_q.append((req, self.is_self(owner)))
                elif self.is_self(owner):
                    local_idx.append(i)
                else:
                    fwd.append((i, owner, req))
        # forwards first, so their RPCs overlap the device step
        futures = [(i, self._forward_one(peer, req, now),
                    peer.info.grpc_address) for i, peer, req in fwd]
        over = 0
        if local_idx:
            local = self.dispatcher.check_batch(
                [reqs[i] for i in local_idx], now)
            for i, resp in zip(local_idx, local):
                responses[i] = resp
                over += resp.status == Status.OVER_LIMIT
        if glob_q:
            # only now: a broadcast tick before the step above would
            # gather a row that does not exist yet and drop the update
            gm = self._ensure_global_manager()
            for req, own in glob_q:
                if own:
                    gm.queue_update(req)
                else:
                    gm.queue_hits(_req_stamped(req, now))
        b = self.config.behaviors
        timeout = (b.batch_timeout_ms + b.batch_wait_ms) / 1000.0 + 30.0
        failed = 0
        for i, f, addr in futures:
            try:
                responses[i] = f.result(timeout=timeout)
                over += responses[i].status == Status.OVER_LIMIT
            except Exception as e:  # noqa: BLE001 - the row's answer
                failed += 1
                self._count_failed_forward(addr, e, 1)
                responses[i] = RateLimitResponse(
                    error=f"while fetching rate limit from peer {addr}: "
                          f"{exc_text(e)}")
        self.metrics.over_limit_counter.inc(over)
        if futures:
            self._count_forward(len(futures), failed)
        self._maybe_sweep(now)
        return responses  # type: ignore[return-value]

    @staticmethod
    def _forward_one(peer: PeerClient, req: RateLimitRequest,
                     now: int) -> Future:
        """A future of ``req``'s answer from its owner: stamped with this
        daemon's clock (first hop wins), NO_BATCHING in a typed RPC of
        its own on a thread, the rest through the batching lane."""
        if not req.created_at and created_at_fwd_enabled():
            req = replace(req, created_at=now)
        f: Future = Future()
        if int(req.behavior) & int(Behavior.NO_BATCHING):
            def go():
                try:
                    f.set_result(peer.get_peer_rate_limit(req))
                except Exception as e:  # noqa: BLE001 - to the caller
                    f.set_exception(e)

            threading.Thread(target=go, daemon=True,
                             name="peer-forward-nobatch").start()
            return f
        try:
            return peer.enqueue(req)
        except Exception as e:  # noqa: BLE001 - circuit open, closing
            f.set_exception(e)
            return f

    def _maybe_sweep(self, now: int) -> None:
        iv = self.config.sweep_interval_ms
        if iv > 0 and now - self._last_sweep >= iv:
            self._last_sweep = now
            with self._engine_mu:
                self.engine.sweep(now)

    def health_check(self) -> HealthCheckResponse:
        """reference: gubernator.go › HealthCheck: healthy and the peer
        count, or unhealthy with the GLOBAL manager's last error (a
        failed hits flush or broadcast, for ERROR_TTL_S).  Refreshes the
        table gauges (live rows, capacity, dropped rows and, on the
        bucket engine, the share of full buckets) from one device
        reduction under the engine lock."""
        m = self.metrics
        with self._engine_mu:
            if hasattr(self.engine, "occupancy_and_saturation"):
                occ, full, total = self.engine.occupancy_and_saturation()
                m.bucket_saturation.set(full / max(total, 1))
            else:
                occ = self.engine.occupancy()
            m.cache_size.set(int(occ))
            m.dropped_rows.set(self.engine.dropped_rows)
            m.cache_capacity.set(self.engine.cap_local)
        gm = self.global_manager
        err = gm.last_error if gm is not None else ""
        return HealthCheckResponse(status="unhealthy" if err else "healthy",
                                   message=err,
                                   peer_count=len(self.peers()))

    # ---- the wire entry ------------------------------------------------

    def get_rate_limits_wire(self, data: bytes,
                             now_ms: Optional[int] = None) -> bytes:
        """Serialized GetRateLimitsReq in, serialized GetRateLimitsResp
        out, with the object lane's answers.  Takes the fused lane when
        the batch qualifies, else the parse lane, else the protobuf
        lane; a message protobuf cannot decode raises ValueError, and so
        does a batch of more than MAX_BATCH_SIZE requests on every
        lane.  Raises ResourceExhausted when admission control sheds
        the batch."""
        data = bytes(data) if not isinstance(data, bytes) else data
        picker = self._clustered_picker()
        if picker is None:
            out = self._wire_client_fused(data, now_ms)
            if out is not None:
                return out
        parsed = wire_native.parse_get_rate_limits(data)
        if parsed is not None:
            n = parsed["n"]
            if n > MAX_BATCH_SIZE:
                raise ValueError(
                    f"Requests.RateLimits list too large; max size is "
                    f"{MAX_BATCH_SIZE}")
            now = clock_ms() if now_ms is None else now_ms
            self.dispatcher.admit(n)
            if picker is not None:
                lane = "wire_clustered"
                run = lambda: self._wire_check_clustered(  # noqa: E731
                    parsed, data, now, picker)
            else:
                # alone, GLOBAL with no hot set is the local path;
                # MULTI_REGION rows are decided locally (their
                # replication is not ported)
                lane = "wire_local"
                run = lambda: self._wire_check_columns(  # noqa: E731
                    parsed, now)

            def run_and_sweep():
                out = run()
                self._maybe_sweep(now)
                return out

            return self._counted("api", n, lane, run_and_sweep)
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
        try:
            self.dispatcher.admit(pre.n)
        except BaseException:
            pre.lease.release()
            raise

        def run():
            out = self._run_fused(pre, now)
            self._maybe_sweep(now)
            return out

        return self._counted("api", pre.n, "wire_local", run)

    def _run_fused(self, pre, now: int) -> bytes:
        """Run a prepacked wave and serialize its responses.  Idle: one
        inline wave in this thread.  Busy: the rows are copied out of the
        lease (the queued job outlives it) and coalesce with the other
        callers' waves."""
        disp, n = self.dispatcher, pre.n
        out = disp.run_inline_wave(
            lambda: self.engine.check_prepacked(pre, now), nreq=n)
        if out is not disp._BUSY:
            return self._columns_to_bytes(out, 0, n)
        try:
            # an index array copies: the rows outlive the lease
            batch = lease_batch(pre.lease, np.arange(n))
        finally:
            pre.lease.release()
        view = disp.check_packed_view(batch, pre.khash, now)
        return self._columns_to_bytes(view.cols, view.lo, view.hi)

    def _columns_to_bytes(self, cols, lo: int, hi: int, errs=None) -> bytes:
        """Rows [lo, hi) of result columns → response bytes (their
        OVER_LIMIT rows counted); ``errs`` maps a row (relative to lo) to
        its error, and table-full rows without one answer ``rate limit
        table full``."""
        self.metrics.over_limit_counter.inc(
            int((cols[0][lo:hi] == Status.OVER_LIMIT).sum()))
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
        """Parsed wire columns → pack → dispatcher → response bytes."""
        kh = mix64_np(parsed["khash_raw"])
        kh = np.where(kh == 0, np.uint64(1), kh)
        return self._packed_check_to_bytes(kh, parsed, None, now)

    def _packed_check_to_bytes(self, kh: np.ndarray, parsed: dict, idx,
                               now: int) -> bytes:
        """Rows ``idx`` (None: all) of parsed wire columns, keyed by the
        mixed hashes ``kh`` → pack → dispatcher → response bytes,
        written from the wave's shared columns in this thread."""
        def col(name):
            c = parsed[name]
            return c if idx is None else c[idx]

        batch, errs = pack_columns(
            kh, col("hits"), col("limit"), col("duration"),
            col("algorithm"), col("behavior"), col("burst"), now,
            created_at=col("created_at"))
        view = self.dispatcher.check_packed_view(batch, kh, now)
        return self._columns_to_bytes(view.cols, view.lo, view.hi, errs)

    # ---- the clustered wire lane ----------------------------------------

    def _wire_check_clustered(self, parsed: dict, data: bytes, now: int,
                              picker) -> bytes:
        """C++ parse → batch hash → ring split by owner → each remote
        owner's rows forwarded as verbatim request TLV slices (stamped
        with this daemon's clock) → the device step for owned rows,
        overlapped with the RPCs → response TLVs spliced back in request
        order.  GLOBAL rows are answered from the local replica and never
        forwarded; their reconcile is queued per unique key as raw TLV
        prototypes, after the step.  A failed forward answers its rows
        with error rows, that sub-batch only."""
        n = parsed["n"]
        raw = mix64_np(parsed["khash_raw"])
        peer_list = picker.owner_peers()
        # before the zero remap, as picker.get(key) hashes
        owners = picker.owner_indices(raw)
        kh = np.where(raw == 0, np.uint64(1), raw)
        toff, tlen = parsed["tlv_off"], parsed["tlv_len"]
        created = parsed["created_at"]
        self_pi = [pi for pi, p in enumerate(peer_list) if self.is_self(p)]
        local_mask = np.isin(owners, self_pi)
        if parsed["behavior_or"] & int(Behavior.GLOBAL):
            glob_mask = (parsed["behavior"] & int(Behavior.GLOBAL)) != 0
        else:
            glob_mask = _NO_ROWS
        glob_queue: List[tuple] = []
        if glob_mask.any():
            for k, tlv, a, i in self._raw_queue_groups(
                    parsed, data, glob_mask, stamp_ms=now):
                glob_queue.append((k, tlv, a, int(owners[i]) in self_pi))
            local_mask = local_mask | glob_mask
        item_tlvs: List[Optional[bytes]] = [None] * n
        groups = []
        for pi in np.unique(owners[~local_mask]):
            idxs = np.nonzero((owners == pi) & ~local_mask)[0]
            if created_at_fwd_enabled():
                sub = wire_native.stamp_req_tlvs(
                    data, toff[idxs], tlen[idxs], created[idxs], now)
            else:
                sub = b"".join(data[int(toff[i]):int(toff[i] + tlen[i])]
                               for i in idxs)
            peer = peer_list[int(pi)]
            fut = send_err = None
            try:
                fut = peer.forward_raw(sub, int(idxs.size))
            except Exception as e:  # noqa: BLE001 - circuit open, closing
                send_err = e
            groups.append((idxs, fut, send_err, peer.info.grpc_address))
        local_idx = np.nonzero(local_mask)[0]
        if local_idx.size:
            lbytes = self._packed_check_to_bytes(kh[local_idx], parsed,
                                                 local_idx, now)
            self._splice(item_tlvs, local_idx, lbytes)
        if glob_queue:
            # the rows exist now: safe to queue the owner's broadcasts
            gm = self._ensure_global_manager()
            for k, tlv, a, own in glob_queue:
                if own:
                    gm.queue_update_raw(k, tlv)
                else:
                    gm.queue_hits_raw(k, tlv, a)
        b = self.config.behaviors
        # the lane's futures always resolve (RPC deadline, bounded
        # retries); this bound is that worst case plus slack
        fwd_wait = ((b.peer_retry_limit + 1)
                    * (b.batch_timeout_ms / 1000.0 + 60.0)
                    + b.peer_retry_limit * b.peer_retry_backoff_ms / 1000.0
                    + 5.0)
        forwarded = failed = 0
        for idxs, fut, err, addr in groups:
            forwarded += int(idxs.size)
            rbytes = None
            if fut is not None:
                try:
                    rbytes = fut.result(timeout=fwd_wait)
                except Exception as e:  # noqa: BLE001 - error rows below
                    err = e
            if rbytes is not None:
                sp = wire_native.split_resp_items(rbytes)
                if sp is not None and sp[0].size == idxs.size:
                    self._splice(item_tlvs, idxs, rbytes, sp)
                    self.metrics.over_limit_counter.inc(
                        int((sp[2] == Status.OVER_LIMIT).sum()))
                    continue
                err = RuntimeError("malformed or short peer response batch")
            failed += int(idxs.size)
            self._count_failed_forward(addr, err, int(idxs.size))
            m = int(idxs.size)
            zeros = np.zeros(m, np.int64)
            ebytes = wire_native.build_responses_from_columns(
                (np.zeros(m, np.int32), zeros, zeros, zeros), 0, m,
                [f"while fetching rate limit from peer {addr}: "
                 f"{exc_text(err)}"] * m)
            self._splice(item_tlvs, idxs, ebytes)
        if groups:
            self._count_forward(forwarded, failed)
        return b"".join(item_tlvs)  # type: ignore[arg-type]

    @staticmethod
    def _splice(item_tlvs: list, idxs, rbytes: bytes, sp=None) -> None:
        """Put the response TLVs of ``rbytes`` at rows ``idxs``."""
        off, ln, _ = sp if sp is not None else \
            wire_native.split_resp_items(rbytes)
        for j, i in enumerate(idxs):
            item_tlvs[int(i)] = rbytes[int(off[j]):int(off[j] + ln[j])]

    @staticmethod
    def _raw_queue_groups(parsed: dict, data: bytes, mask: np.ndarray,
                          stamp_ms: Optional[int] = None):
        """(raw key hash, the LAST occurrence's TLV, summed hits, its
        row) per unique masked key: the aggregation of the raw GLOBAL
        queues (the last occurrence wins, as a mid-batch config change
        must).  ``stamp_ms`` stamps ``created_at`` onto a TLV that has
        none: the hits apply at the owner later, at this time base."""
        from .wire import tlv_with_created

        idx = np.nonzero(mask)[0]
        if not idx.size:
            return
        toff, tlen = parsed["tlv_off"], parsed["tlv_len"]
        created = parsed["created_at"]
        w = np.maximum(parsed["hits"][idx], 0)
        uniq, inv = np.unique(parsed["khash_raw"][idx], return_inverse=True)
        acc = np.zeros(uniq.size, np.int64)  # exact int64, not float
        np.add.at(acc, inv, w)
        last = np.zeros(uniq.size, np.int64)
        last[inv] = np.arange(inv.size)
        stamping = created_at_fwd_enabled()
        for k, f, a in zip(uniq, last, acc):
            i = int(idx[int(f)])
            tlv = bytes(data[int(toff[i]):int(toff[i] + tlen[i])])
            if stamping and stamp_ms is not None and not int(created[i]):
                tlv = tlv_with_created(tlv, stamp_ms)
            yield int(k), tlv, int(a), i

    # ---- the peer service (owner side) ----------------------------------

    def get_peer_rate_limits(self, reqs: Sequence[RateLimitRequest],
                             now_ms: Optional[int] = None
                             ) -> List[RateLimitResponse]:
        """Apply a forwarded batch locally (gubernator.go ›
        GetPeerRateLimits); GLOBAL keys are marked for the next
        broadcast."""
        if len(reqs) > self.config.behaviors.batch_limit:
            raise ValueError(
                "'PeerRequest.rate_limits' list too large; max size is "
                f"{self.config.behaviors.batch_limit}")
        if not reqs:
            return []
        now = clock_ms() if now_ms is None else now_ms
        reqs = list(reqs)
        self.metrics.getratelimit_counter.labels(calltype="peer").inc(
            len(reqs))
        resps = self.dispatcher.check_batch(reqs, now)
        for req in reqs:
            if int(req.behavior) & int(Behavior.GLOBAL):
                self._ensure_global_manager().queue_update(req)
        return resps

    def get_peer_rate_limits_wire(self, data: bytes,
                                  now_ms: Optional[int] = None) -> bytes:
        """GetPeerRateLimits wire bytes in and out: the owner side of the
        forward hop (its items are field 1, as in GetRateLimitsReq, so
        the C++ lanes apply as they are).  Forwarded rows always apply
        locally; GLOBAL rows mark their keys for the next broadcast,
        after the step."""
        data = bytes(data) if not isinstance(data, bytes) else data
        out = self._wire_peer_fused(data, now_ms)
        if out is not None:
            return out
        parsed = wire_native.parse_get_rate_limits(data)
        if parsed is None:
            return self._wire_peer_pb2(data, now_ms)
        if parsed["n"] > self.config.behaviors.batch_limit:
            raise ValueError(
                "'PeerRequest.rate_limits' list too large; max size is "
                f"{self.config.behaviors.batch_limit}")
        now = clock_ms() if now_ms is None else now_ms
        self._count_peer_wire(parsed["n"])
        out = self._wire_check_columns(parsed, now)
        if parsed["behavior_or"] & int(Behavior.GLOBAL):
            glob = (parsed["behavior"] & int(Behavior.GLOBAL)) != 0
            gm = self._ensure_global_manager()
            for k, tlv, _a, _i in self._raw_queue_groups(parsed, data,
                                                         glob):
                gm.queue_update_raw(k, tlv)
        return out

    def _wire_peer_fused(self, data: bytes,
                         now_ms: Optional[int]) -> Optional[bytes]:
        """The fused lane for a forwarded batch, or None (GLOBAL /
        MULTI_REGION rows, Gregorian, protobuf framing)."""
        now = clock_ms() if now_ms is None else now_ms
        pre = self.engine.prepack_wire(data, now)
        if pre is None:
            return None
        if pre.behavior_or & int(self._FUSED_EXCLUDED):
            pre.lease.release()
            return None
        if pre.n > self.config.behaviors.batch_limit:
            pre.lease.release()
            raise ValueError(
                "'PeerRequest.rate_limits' list too large; max size is "
                f"{self.config.behaviors.batch_limit}")
        self._count_peer_wire(pre.n)
        return self._run_fused(pre, now)

    def _count_peer_wire(self, n: int) -> None:
        self.metrics.getratelimit_counter.labels(calltype="peer").inc(n)
        self.metrics.wire_lane_counter.labels(lane="peer_wire").inc(n)

    def _wire_peer_pb2(self, data: bytes, now_ms: Optional[int]) -> bytes:
        """The protobuf lane of a forwarded batch."""
        from google.protobuf.message import DecodeError

        from .proto import peers_pb2 as peers_pb
        from .wire import req_from_pb, resp_to_pb

        try:
            msg = peers_pb.GetPeerRateLimitsReq.FromString(data)
        except DecodeError as e:
            raise ValueError(f"invalid GetPeerRateLimitsReq: {e}") from e
        self.metrics.wire_lane_counter.labels(
            lane="peer_pb2_fallback").inc(len(msg.requests))
        resps = self.get_peer_rate_limits(
            [req_from_pb(m) for m in msg.requests], now_ms=now_ms)
        out = peers_pb.GetPeerRateLimitsResp()
        out.rate_limits.extend(resp_to_pb(r) for r in resps)
        return out.SerializeToString()

    # ---- GLOBAL broadcasts ----------------------------------------------

    def build_global_updates(self, reqs: Sequence[RateLimitRequest]):
        """Owner side: the authoritative rows of changed GLOBAL keys as
        UpdatePeerGlobal messages (a leaky row's remaining in whole
        tokens, its reset from the last update)."""
        from .proto import gubernator_pb2 as pb
        from .proto import peers_pb2 as peers_pb

        khash = hash_request_keys([r.name for r in reqs],
                                  [r.unique_key for r in reqs])
        with self._engine_mu:
            found, cols = self.engine.gather_rows(khash)
        out = []
        for j, req in enumerate(reqs):
            if not found[j]:
                continue
            meta = int(cols["meta"][j])
            alg = meta & 1
            eff = int(cols["eff_ms"][j])
            rem = int(cols["remaining"][j])
            if alg == int(Algorithm.LEAKY_BUCKET):
                rem_out = rem // max(eff, 1)
                reset = int(cols["t_ms"][j]) + (
                    eff // max(int(cols["limit"][j]), 1))
            else:
                rem_out = rem
                reset = int(cols["expire_at"][j])
            out.append(peers_pb.UpdatePeerGlobal(
                key=req.key,
                update=pb.RateLimitResp(
                    status=(meta >> 1) & 1, limit=int(cols["limit"][j]),
                    remaining=rem_out, reset_time=reset),
                algorithm=alg, duration=int(cols["duration"][j]),
                created_at=int(cols["t_ms"][j]),
                behavior=int(req.behavior), burst=int(cols["burst"][j])))
        return out

    def update_peer_globals(self, updates) -> None:
        """Replica side: overwrite local rows with the owner's state
        (gubernator.go › UpdatePeerGlobals).  A sender that holds only
        the key hash sends it as ``key_hash``, which takes precedence."""
        m = len(updates)
        if m == 0:
            return
        khash = hash_keys([g.key for g in updates])
        sent_kh = np.fromiter((g.key_hash for g in updates), np.uint64, m)
        khash = np.where(sent_kh != 0, sent_kh, khash)
        cols = {"meta": np.zeros(m, np.int32),
                "limit": np.zeros(m, np.int64),
                "duration": np.zeros(m, np.int64),
                "eff_ms": np.ones(m, np.int64),
                "burst": np.zeros(m, np.int64),
                "remaining": np.zeros(m, np.int64),
                "t_ms": np.zeros(m, np.int64),
                "expire_at": np.zeros(m, np.int64)}
        for j, g in enumerate(updates):
            alg = int(g.algorithm)
            if g.eff_ms > 0:
                eff = int(g.eff_ms)  # the sender's exact denominator
            elif g.behavior & int(Behavior.DURATION_IS_GREGORIAN):
                try:
                    eff = gregorian_rate_duration_ms(int(g.duration))
                except (ValueError, KeyError):
                    eff = 1
            else:
                eff = max(int(g.duration), 1)
            burst = int(g.burst) if g.burst > 0 else int(g.update.limit)
            if alg == int(Algorithm.LEAKY_BUCKET):
                # broadcasts carry whole tokens (× eff to the fixed
                # point); eff_ms senders carry the fixed point itself
                rem = (int(g.update.remaining) if g.eff_ms > 0
                       else int(g.update.remaining) * eff)
                expire = int(g.created_at) + eff
            else:
                rem = int(g.update.remaining)
                expire = int(g.update.reset_time)
            cols["meta"][j] = (alg & 1) | ((int(g.update.status) & 1) << 1)
            cols["limit"][j] = int(g.update.limit)
            cols["duration"][j] = int(g.duration)
            cols["eff_ms"][j] = eff
            cols["burst"][j] = burst
            cols["remaining"][j] = rem
            cols["t_ms"][j] = int(g.created_at)
            cols["expire_at"][j] = expire
        with self._engine_mu:
            self.engine.upsert_rows(khash, cols)

    def _wire_pb2(self, data: bytes, now_ms: Optional[int]) -> bytes:
        """The protobuf lane: decode, the object lane, encode."""
        from google.protobuf.message import DecodeError

        from .proto import gubernator_pb2 as pb
        from .wire import req_from_pb, resp_to_pb

        try:
            msg = pb.GetRateLimitsReq.FromString(data)
        except DecodeError as e:
            raise ValueError(f"invalid GetRateLimitsReq: {e}") from e
        self.metrics.wire_lane_counter.labels(
            lane="pb2_fallback").inc(len(msg.requests))
        resps = self.get_rate_limits([req_from_pb(m) for m in msg.requests],
                                     now_ms=now_ms)
        out = pb.GetRateLimitsResp()
        out.responses.extend(resp_to_pb(r) for r in resps)
        return out.SerializeToString()

    def close(self) -> None:
        """Flush the GLOBAL manager, drain the peer clients, then stop
        the dispatcher (the engine's one user)."""
        if self._closed:
            return
        self._closed = True
        if self.global_manager is not None:
            self.global_manager.close()
        for p in self.peers():
            p.shutdown()
        self.dispatcher.close()
