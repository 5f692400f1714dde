"""Peer transport: columnar send lanes with pipelined flushes (the port's
copy of gubernator_tpu/peer_client.py; peer_client.go › PeerClient).

Callers enqueue request TLV slices into a per-peer send buffer
(``_SendLane``).  A flusher thread drains it greedily, never past the
batch limit (the entry that would overflow leads the next flush), waits
a short straggler window when the backlog is drained, and ships each
flush as ONE raw-bytes RPC with up to ``BehaviorConfig.peer_inflight``
in flight; the RPCs resolve on grpc's callback threads, so the flusher
packs the next flush meanwhile.  A failed flush is re-sent with linear
backoff; after ``peer_circuit_threshold`` consecutive final failures the
peer's circuit opens and sends fail fast until the cooldown ends and one
flush half-opens it.

Object-lane forwards (``enqueue``) serialize to a TLV at once and ride
the same lane; GLOBAL hit flushes and owner broadcasts ride it too
(global_manager.py).  The JAX package keeps a legacy object-batching
flusher for when its C++ codec is not built; the port's wire library
always builds (or the build raises), so that flusher is not ported.
With a ``Metrics`` registry the lanes feed the send-buffer depth, the
flush size and wait, in-flight RPCs, retries, the circuit's opens and
state and ``batch_send_duration``.  With a ``FaultSet`` the lanes run
the ``peer_send``, ``peer_recv`` and ``peer_circuit`` faultpoints, tagged
with the peer's address.

Beside the circuit each client keeps its routing health for the
instance's health-gated ring (``route_healthy``): a circuit-open streak
that lasts ``peer_eject_after_ms`` ejects the peer, and it returns only
after staying recovered for ``peer_readmit_after_ms``.  ``probe`` sends
one empty globals flush, so an ejected peer (whose keys rehome and send
it no traffic) can close its circuit.  Each send carries its caller's
trace: ``forward_raw``, ``send_globals_raw`` and ``enqueue`` record a
``peer.forward`` hop span and queue its traceparent with the entry, and
a flush sends its first traced entry's as gRPC metadata.  With the
instance's analytics, each flush feeds the ``peer_flush`` phase and,
when it succeeded, the cost model.

Shutdown drains in-flight flushes before it closes the channel.
"""
from __future__ import annotations

import logging
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import List, Optional, Sequence

from .config import BehaviorConfig
from .grpc_api import PEERS_SERVICE, PeersV1Stub, dial_peer, raw_unary
from .ops import native as wire_native
from .telemetry import exc_text
from .tracing import hop_traceparent, outbound_metadata
from .types import Behavior, PeerInfo, RateLimitRequest, RateLimitResponse
from .wire import req_to_pb, req_to_tlv, resp_from_pb

log = logging.getLogger("gubernator_tpu_torch.peer")


class ErrClosing(Exception):
    """A send that arrives while the client drains
    (peer_client.go › ErrClosing)."""


class ErrCircuitOpen(Exception):
    """A send while the peer's circuit is open: a dead peer costs an
    immediate error, not a queue of callers waiting out its timeouts."""


class _Entry:
    """One send-buffer entry: ``n_items`` request TLVs in the lane's
    shared buffer; ``future`` resolves to this entry's contiguous slice
    of the response bytes; ``t_enq`` is when it was queued; ``trace``
    the caller's outbound traceparent (the flusher thread has none)."""

    __slots__ = ("nbytes", "n_items", "future", "t_enq", "trace")

    def __init__(self, nbytes: int, n_items: int, future: Future,
                 trace: Optional[str] = None):
        self.nbytes = nbytes
        self.n_items = n_items
        self.future = future
        self.t_enq = time.monotonic()
        self.trace = trace


class _SendLane:
    """Pooled send buffer + depth-K pipelined raw RPCs to one peer
    method.  ``split`` lanes (GetPeerRateLimits) resolve each entry with
    its response-TLV slice; the others (UpdatePeerGlobals) with the raw
    response bytes."""

    def __init__(self, client: "PeerClient", method: str,
                 max_items: int, rpc_timeout_s: float, split: bool):
        self.client = client
        self.method = method
        self.max_items = max(int(max_items), 1)
        self.rpc_timeout_s = rpc_timeout_s
        self.split = split
        b = client.behaviors
        self.window_s = max(int(b.peer_coalesce_us), 0) / 1e6
        self.depth = max(int(b.peer_inflight), 1)
        self.retries = max(int(b.peer_retry_limit), 0)
        self.backoff_s = max(int(b.peer_retry_backoff_ms), 0) / 1e3
        self._cond = threading.Condition()
        self._buf = bytearray()  # guarded-by: self._cond
        self._entries: "deque[_Entry]" = deque()  # guarded-by: self._cond
        self._queued_items = 0  # guarded-by: self._cond
        self._inflight = 0  # guarded-by: self._cond
        self._thread: Optional[threading.Thread] = None  # guarded-by: self._cond
        self._closing = False  # guarded-by: self._cond
        #: RPCs sent (first attempts) and their items; flushes that
        #: failed after their retries; re-sends
        self.flushes = 0  # guarded-by: self._cond
        self.items = 0  # guarded-by: self._cond
        self.failed = 0  # guarded-by: self._cond
        self.retried = 0  # guarded-by: self._cond

    # ---- producer side -------------------------------------------------

    def enqueue(self, data: bytes, n_items: int,
                traceparent: Optional[str] = None) -> Future:
        """Queue ``n_items`` request TLVs for the next flush; a flush
        carries its first traced entry's ``traceparent``.  Raises
        ErrClosing / ErrCircuitOpen instead of queuing."""
        if self.client._circuit_blocked():
            raise ErrCircuitOpen(
                f"peer {self.client.info.grpc_address} circuit open")
        fut: Future = Future()
        with self._cond:
            if self._closing:
                raise ErrClosing("peer client is closing")
            self._buf += data
            self._entries.append(_Entry(len(data), int(n_items), fut,
                                        traceparent))
            self._queued_items += int(n_items)
            depth = self._queued_items
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, daemon=True,
                    name=f"peer-lane-{self.method}-"
                         f"{self.client.info.grpc_address}")
                self._thread.start()
            self._cond.notify_all()
        m = self.client._metrics
        if m is not None:
            m.peer_send_buffer_depth.labels(
                peer_addr=self.client.info.grpc_address).set(depth)
        return fut

    # ---- flusher -------------------------------------------------------

    def _pop_locked(self, e: _Entry) -> bytes:
        """Take ``e`` (the head entry) and its bytes; caller holds
        _cond."""
        self._entries.popleft()
        data = bytes(memoryview(self._buf)[:e.nbytes])
        del self._buf[:e.nbytes]
        self._queued_items -= e.n_items
        return data

    def _take_locked(self) -> tuple:
        """Entries for one flush, greedy, never past max_items; caller
        holds _cond."""
        batch: List[_Entry] = []
        parts: List[bytes] = []
        items = 0
        while self._entries:
            e = self._entries[0]
            if batch and items + e.n_items > self.max_items:
                break
            parts.append(self._pop_locked(e))
            batch.append(e)
            items += e.n_items
            if items >= self.max_items:
                break
        return batch, parts, items

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._entries and not self._closing:
                    self._cond.wait(0.5)
                if not self._entries:
                    return  # closing and drained
                batch, parts, items = self._take_locked()
            # straggler window, only once the backlog is drained (a full
            # flush skips it); a racy read of _closing just skips it late
            if items < self.max_items and self.window_s > 0 \
                    and not self._closing:
                deadline = time.monotonic() + self.window_s
                with self._cond:
                    while items < self.max_items:
                        remain = deadline - time.monotonic()
                        if remain <= 0:
                            break
                        if not self._entries:
                            self._cond.wait(remain)
                            if not self._entries:
                                break
                        e = self._entries[0]
                        if items + e.n_items > self.max_items:
                            break
                        parts.append(self._pop_locked(e))
                        batch.append(e)
                        items += e.n_items
            with self._cond:
                while self._inflight >= self.depth and not self._closing:
                    self._cond.wait(0.2)
                self.flushes += 1
                self.items += items
                depth_now = self._queued_items
            m = self.client._metrics
            if m is not None:
                m.peer_send_buffer_depth.labels(
                    peer_addr=self.client.info.grpc_address).set(depth_now)
                m.peer_flush_size.observe(items)
                now = time.monotonic()
                for e in batch:
                    m.peer_flush_wait.observe(max(now - e.t_enq, 0.0))
            self._launch(batch, b"".join(parts), attempt=0)

    def _launch(self, entries: List[_Entry], data: bytes,
                attempt: int) -> None:
        client = self.client
        if attempt and (self._closing or client._closing.is_set()):
            # a retry timer outliving shutdown fails fast, never
            # re-dials a closed channel
            self._fail(entries, ErrClosing("peer client closed"))
            return
        if client._circuit_blocked():
            self._fail(entries, ErrCircuitOpen(
                f"peer {client.info.grpc_address} circuit open"))
            return
        t0 = time.perf_counter()
        try:
            # a faulted send takes the path of a real dial failure
            client._fault("peer_send")
            tp = next((e.trace for e in entries if e.trace), None)
            rpc = client._raw_call(self.method).future(
                data, timeout=self.rpc_timeout_s,
                metadata=[("traceparent", tp)] if tp else None)
        except Exception as e:  # noqa: BLE001 - incl. a closed channel
            self._on_done(None, entries, data, attempt, t0, err=e)
            return
        with self._cond:
            self._inflight += 1
        m = client._metrics
        if m is not None:
            m.peer_inflight_rpcs.labels(
                peer_addr=client.info.grpc_address).inc()
        rpc.add_done_callback(
            lambda f: self._rpc_done(f, entries, data, attempt, t0))

    def _rpc_done(self, f, entries, data, attempt, t0) -> None:
        """grpc callback thread: resolve the futures off the flusher."""
        with self._cond:
            self._inflight -= 1
            self._cond.notify_all()
        m = self.client._metrics
        if m is not None:
            m.peer_inflight_rpcs.labels(
                peer_addr=self.client.info.grpc_address).dec()
        try:
            rbytes = f.result()
            # a response lost after the RPC succeeded (the retry path's
            # idempotence)
            self.client._fault("peer_recv")
        except Exception as e:  # noqa: BLE001 - RpcError et al.
            self._on_done(None, entries, data, attempt, t0, err=e)
            return
        self._on_done(rbytes, entries, data, attempt, t0)

    def _on_done(self, rbytes, entries, data, attempt, t0,
                 err: Optional[BaseException] = None) -> None:
        client = self.client
        m = client._metrics
        dt = time.perf_counter() - t0
        if m is not None:
            m.batch_send_duration.labels(
                peer_addr=client.info.grpc_address).observe(dt)
        ana = client._analytics
        if ana is not None:
            # the forward hop's share of a request's time; a sent flush
            # is one point-to-point cost sample (a failed one measures
            # its deadline: left out)
            ana.observe_phase("peer_flush", dt)
            if err is None:
                ana.tap_cost("peer_flush", len(data), 2, dt)
        if err is not None:
            if (attempt < self.retries and not self._closing
                    and not client._circuit_blocked()):
                if m is not None:
                    m.peer_retry_counter.labels(
                        peer_addr=client.info.grpc_address).inc()
                log.warning("peer flush to %s failed (attempt %d/%d), "
                            "retrying: %s", client.info.grpc_address,
                            attempt + 1, self.retries + 1, exc_text(err))
                with self._cond:
                    self.retried += 1
                t = threading.Timer(self.backoff_s * (attempt + 1),
                                    self._launch,
                                    args=(entries, data, attempt + 1))
                t.daemon = True
                t.start()
                return
            client._record_failure()
            self._fail(entries, err)
            return
        client._record_success()
        self._resolve(entries, rbytes)

    def _resolve(self, entries: List[_Entry], rbytes: bytes) -> None:
        if not self.split:
            for e in entries:
                if not e.future.done():
                    e.future.set_result(rbytes)
            return
        sp = wire_native.split_resp_items(rbytes)
        if sp is None or sp[0].size != sum(e.n_items for e in entries):
            self._fail(entries, RuntimeError(
                "malformed or short peer response batch"))
            return
        off, ln, _st = sp
        i = 0
        for e in entries:
            if e.n_items == 0:
                payload = b""
            else:
                j = i + e.n_items - 1
                payload = rbytes[int(off[i]):int(off[j]) + int(ln[j])]
            i += e.n_items
            if not e.future.done():
                e.future.set_result(payload)

    def _fail(self, entries: List[_Entry], err: BaseException) -> None:
        log.warning("peer flush to %s failed (%d items): %s",
                    self.client.info.grpc_address,
                    sum(e.n_items for e in entries), exc_text(err))
        with self._cond:
            self.failed += 1
        for e in entries:
            if not e.future.done():
                e.future.set_exception(err)

    # ---- lifecycle -----------------------------------------------------

    def stats(self) -> dict:
        with self._cond:
            return {"queued_items": self._queued_items,
                    "queued_entries": len(self._entries),
                    "inflight": self._inflight, "flushes": self.flushes,
                    "items": self.items, "failed": self.failed,
                    "retried": self.retried}

    def close(self, timeout_s: float) -> None:
        """Flush the backlog, wait out in-flight RPCs, then fail whatever
        is still unresolved with ErrClosing."""
        with self._cond:
            self._closing = True
            self._cond.notify_all()
            t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=timeout_s)
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while self._inflight > 0 and time.monotonic() < deadline:
                self._cond.wait(0.1)
            leftovers, self._entries = list(self._entries), deque()
            self._buf = bytearray()
            self._queued_items = 0
        for e in leftovers:
            if not e.future.done():
                e.future.set_exception(ErrClosing("peer client closed"))


class PeerClient:
    """One gRPC channel + the columnar send lanes to a single peer."""

    def __init__(self, info: PeerInfo, behaviors: BehaviorConfig,
                 metrics=None, faults=None, tls_creds=None, analytics=None):
        self.info = info
        self.behaviors = behaviors
        #: the owning instance's KeyAnalytics (optional): the peer_flush
        #: phase and the cost model's samples
        self._analytics = analytics
        #: gRPC channel credentials of a TLS cluster (None: plaintext)
        self._tls = tls_creds
        #: the owning instance's Metrics registry (optional)
        self._metrics = metrics
        #: the owning instance's FaultSet (optional): the peer_send,
        #: peer_recv and peer_circuit points, tagged with this address
        self._faults = faults
        self._channel = None  # guarded-by: self._lock
        self._stub: Optional[PeersV1Stub] = None  # guarded-by: self._lock
        self._raw_calls: dict = {}  # guarded-by: self._lock
        self._closing = threading.Event()
        self._lock = threading.Lock()
        # circuit breaker, shared by both lanes: consecutive final flush
        # failures open it; one success closes it
        self._circ_mu = threading.Lock()
        self._consec_failures = 0  # guarded-by: self._circ_mu
        self._open_until = 0.0  # guarded-by: self._circ_mu
        self._circuit_opens = 0  # guarded-by: self._circ_mu
        # routing health: the start of the current circuit-open streak
        # (0 while healthy), when the last streak ended, and whether the
        # peer is out of the routing ring until the readmit window passes
        self._route_bad_since = 0.0  # guarded-by: self._circ_mu
        self._route_recovered_at = 0.0  # guarded-by: self._circ_mu
        self._route_ejected = False  # guarded-by: self._circ_mu
        #: typed GetPeerRateLimits calls (the NO_BATCHING forwards)
        self.single_calls = 0  # guarded-by: self._lock
        self._forward_lane = _SendLane(
            self, "GetPeerRateLimits", behaviors.batch_limit,
            behaviors.batch_timeout_ms / 1000.0 + 60.0, split=True)
        self._globals_lane = _SendLane(
            self, "UpdatePeerGlobals", behaviors.global_batch_limit,
            behaviors.global_timeout_ms / 1000.0, split=False)

    # ---- connection ----------------------------------------------------

    def _ensure_stub(self) -> PeersV1Stub:
        with self._lock:
            if self._stub is None:
                self._channel = dial_peer(self.info.grpc_address,
                                          self._tls)
                self._stub = PeersV1Stub(self._channel)
            return self._stub

    def _raw_call(self, method: str):
        """Bytes-in / bytes-out call handle on the peer service."""
        self._ensure_stub()
        with self._lock:
            call = self._raw_calls.get(method)
            if call is None:
                call = self._raw_calls[method] = raw_unary(
                    self._channel, method, service=PEERS_SERVICE)
            return call

    # ---- circuit breaker -----------------------------------------------

    def _fault(self, point: str) -> None:
        """Fire a faultpoint tagged with this peer's address (one
        attribute read while disarmed)."""
        f = self._faults
        if f is not None and f.armed:
            f.fire(point, self.info.grpc_address)

    def _circuit_blocked(self) -> bool:
        f = self._faults
        if (f is not None and f.armed
                and f.should("peer_circuit", self.info.grpc_address)):
            return True
        with self._circ_mu:
            return time.monotonic() < self._open_until

    def _record_failure(self) -> None:
        b = self.behaviors
        threshold = max(int(b.peer_circuit_threshold), 1)
        cooldown = max(int(b.peer_circuit_cooldown_ms), 0) / 1e3
        with self._circ_mu:
            self._consec_failures += 1
            if self._consec_failures < threshold:
                return
            now = time.monotonic()
            was_open = now < self._open_until
            self._open_until = now + cooldown
            self._circuit_opens += 1
            failures = self._consec_failures
            # the open streak starts at the FIRST open and survives
            # failed half-open probes; only a success ends it
            if self._route_bad_since == 0.0:
                self._route_bad_since = now
            self._route_recovered_at = 0.0
        if not was_open:
            log.warning("peer %s circuit OPEN after %d consecutive flush "
                        "failures; failing fast for %.1fs",
                        self.info.grpc_address, failures, cooldown)
            if self._metrics is not None:
                self._metrics.peer_circuit_open_counter.labels(
                    peer_addr=self.info.grpc_address).inc()
                self._metrics.peer_circuit_state.labels(
                    peer_addr=self.info.grpc_address).set(1)

    def _record_success(self) -> None:
        with self._circ_mu:
            was_open = self._open_until > 0
            self._consec_failures = 0
            self._open_until = 0.0
            if self._route_bad_since:
                self._route_bad_since = 0.0
                self._route_recovered_at = time.monotonic()
        if was_open:
            log.info("peer %s circuit closed (probe flush succeeded)",
                     self.info.grpc_address)
            if self._metrics is not None:
                self._metrics.peer_circuit_state.labels(
                    peer_addr=self.info.grpc_address).set(0)

    def circuit_open(self) -> bool:
        """The circuit's state as a sender sees it (deep health)."""
        return self._circuit_blocked()

    def route_healthy(self, eject_after_s: float,
                      readmit_after_s: float) -> bool:
        """Routing health with hysteresis: False ejects this peer from
        the health-gated ring.  A circuit-open streak must last
        ``eject_after_s`` before the peer is ejected (a blip moves no
        key); once ejected, it returns only after staying recovered for
        ``readmit_after_s``, so a peer flapping inside the window stays
        out and its keys rehome once per outage."""
        now = time.monotonic()
        with self._circ_mu:
            if self._route_bad_since:
                if now - self._route_bad_since >= eject_after_s:
                    self._route_ejected = True
                    return False
                return True
            if self._route_ejected:
                if (self._route_recovered_at
                        and now - self._route_recovered_at
                        >= readmit_after_s):
                    self._route_ejected = False
                    return True
                return False
            return True

    def probe(self) -> Optional[Future]:
        """One empty flush on the globals lane: the health prober's
        half-open probe of an ejected peer (an UpdatePeerGlobals of no
        items, which the peer answers trivially; a success closes the
        circuit and starts the readmit clock).  The flush's future, or
        None while closing or with the circuit open."""
        if self._closing.is_set():
            return None
        try:
            return self._globals_lane.enqueue(b"", 0)
        except (ErrClosing, ErrCircuitOpen):
            return None

    def lane_stats(self) -> dict:
        """Both send lanes' counters and the circuit's state."""
        with self._circ_mu:
            circ = {"open": time.monotonic() < self._open_until,
                    "consecutive_failures": self._consec_failures,
                    "opens": self._circuit_opens,
                    "route_ejected": self._route_ejected}
        with self._lock:
            single = self.single_calls
        return {"circuit": circ, "forward": self._forward_lane.stats(),
                "globals": self._globals_lane.stats(),
                "single_calls": single}

    # ---- forwarded checks ----------------------------------------------

    def get_peer_rate_limit(self, req: RateLimitRequest,
                            timeout_s: Optional[float] = None
                            ) -> RateLimitResponse:
        """Forward one request to its owner: one RPC of its own for
        NO_BATCHING, else through the batching lane."""
        if self._closing.is_set():
            raise ErrClosing("peer client is closing")
        if int(req.behavior) & int(Behavior.NO_BATCHING):
            return self.get_peer_rate_limits([req])[0]
        if timeout_s is None:
            timeout_s = (self.behaviors.batch_timeout_ms
                         + self.behaviors.batch_wait_ms) / 1000.0 + 30.0
        return self.enqueue(req).result(timeout=timeout_s)

    def enqueue(self, req: RateLimitRequest) -> Future:
        """Queue one request for the next flush of the forward lane (its
        TLV is made now; ``created_at`` rides as field 10); the future
        resolves to its RateLimitResponse."""
        if self._closing.is_set():
            raise ErrClosing("peer client is closing")
        inner = self._forward_lane.enqueue(
            req_to_tlv(req), 1,
            hop_traceparent("peer.forward",
                            attrs={"peer": self.info.grpc_address,
                                   "items": 1}))
        outer: Future = Future()

        def convert(f: Future) -> None:
            try:
                from .proto import gubernator_pb2 as pb

                msg = pb.GetRateLimitsResp.FromString(f.result())
                outer.set_result(resp_from_pb(msg.responses[0]))
            except Exception as e:  # noqa: BLE001 - the caller's error
                outer.set_exception(e)

        inner.add_done_callback(convert)
        return outer

    def forward_raw(self, data: bytes, n_items: int) -> Future:
        """The columnar forward hop: ``data`` is ``n_items`` request TLV
        slices (GetRateLimitsReq.requests framing, which is also
        GetPeerRateLimitsReq's).  The future resolves to this call's
        contiguous slice of response TLVs (exactly ``n_items``, counted).
        Concurrent callers forwarding to one peer share flush RPCs.
        Raises ErrClosing / ErrCircuitOpen.  The caller's trace rides
        the flush: a hop span is recorded here whose id the owner's
        handler parents under (``hop_traceparent``)."""
        if self._closing.is_set():
            raise ErrClosing("peer client is closing")
        return self._forward_lane.enqueue(
            data, n_items,
            hop_traceparent("peer.forward",
                            attrs={"peer": self.info.grpc_address,
                                   "items": int(n_items)}))

    def send_globals_raw(self, data: bytes, n_items: int) -> Future:
        """The owner broadcast's lane: ``data`` is ``n_items`` serialized
        UpdatePeerGlobalsReq.globals TLVs; the future resolves to the
        (empty) response bytes; the calling thread's trace rides it as
        ``forward_raw``'s does."""
        if self._closing.is_set():
            raise ErrClosing("peer client is closing")
        return self._globals_lane.enqueue(
            data, n_items,
            hop_traceparent("peer.forward",
                            attrs={"peer": self.info.grpc_address,
                                   "items": int(n_items),
                                   "lane": "globals"}))

    def get_peer_rate_limits(self, reqs: Sequence[RateLimitRequest],
                             timeout_s: Optional[float] = None
                             ) -> List[RateLimitResponse]:
        """One synchronous typed batch call (peers.proto ›
        GetPeerRateLimits); the generated classes carry no
        ``created_at``, so the owner applies these at its own clock."""
        from .proto import peers_pb2 as peers_pb

        stub = self._ensure_stub()
        msg = peers_pb.GetPeerRateLimitsReq()
        msg.requests.extend(req_to_pb(r) for r in reqs)
        if timeout_s is None:
            timeout_s = self.behaviors.batch_timeout_ms / 1000.0 + 60.0
        with self._lock:
            self.single_calls += 1
        resp = stub.GetPeerRateLimits(msg, timeout=timeout_s,
                                      metadata=outbound_metadata())
        return [resp_from_pb(m) for m in resp.rate_limits]

    def update_peer_globals(self, updates) -> None:
        """One synchronous typed UpdatePeerGlobals call."""
        from .proto import peers_pb2 as peers_pb

        stub = self._ensure_stub()
        msg = peers_pb.UpdatePeerGlobalsReq()
        msg.globals.extend(updates)
        stub.UpdatePeerGlobals(
            msg, timeout=self.behaviors.global_timeout_ms / 1000.0,
            metadata=outbound_metadata())

    # ---- lifecycle -----------------------------------------------------

    def shutdown(self) -> None:
        """Drain the lanes, then close the channel
        (peer_client.go › shutdown)."""
        self._closing.set()
        lane_timeout = self.behaviors.batch_timeout_ms / 1000.0 + 5
        for lane in (self._forward_lane, self._globals_lane):
            lane.close(lane_timeout)
        with self._lock:
            if self._channel is not None:
                self._channel.close()
                self._channel = self._stub = None
                self._raw_calls = {}
