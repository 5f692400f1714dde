"""GLOBAL behavior: hits reconciled to the owner, owner state broadcast
back (the port's copy of gubernator_tpu/global_manager.py;
global.go › globalManager).

Any daemon answers a GLOBAL request at once from its local replica of
the counter; the hits are queued here, aggregated per key, and flushed
to the key's owner every ``global_sync_wait_ms``.  The owner applies them
to its authoritative row, marks the key changed, and every
``global_broadcast_interval_ms`` sends the changed rows to every peer,
which overwrite their replicas.  Over-admission inside one window is
the documented cost of GLOBAL.

Both lanes queue here: the object lane request objects, the wire lane
verbatim request TLV slices keyed by their raw FNV-1a hash (prototypes
are parsed at flush cadence, off the request path).  A flush merges the
two in raw-hash space and ships one TLV per key, with the summed hits
appended, on the owners' forward lanes; a failed flush puts its
aggregates back on the queue, and an owner whose circuit is open has its
aggregates parked until a send can pass (they are not rebuilt every
tick).  The manager feeds the instance's
``Metrics`` (queue length, broadcast counter and duration, and
``check_error`` for failed flushes and sends) and records ``error`` and
``broadcast`` events in its flight recorder.  Hits that a degraded
serve queued (``degraded=True``: their owner was unreachable or their
key rehomed) ride the same queues and reconcile exactly once the owner
answers; they are counted apart (``hits_degraded``).  The instance's
``FaultSet`` may abort a tick at its start (``global_hits``,
``global_broadcast``), before any queue is popped, so nothing is lost.

The conservation audit (fleet.py › AuditTap, ``audit``; None with
GUBER_FLEET_AUDIT=0) counts hit weight injected at queue entry and
applied at the owner's acknowledgement or absorbed where this daemon is
the owner; the degraded share rides per key beside the queues (``_deg``,
``_deg_raw``, and in the parked entries), so ``queued_hits`` reports it.
Each tick runs in a trace of its own (``global.hits_flush``,
``global.broadcast``), whose hop spans the owners' handlers parent
under; a clean broadcast feeds the analytics' cost model.
"""
from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import Future
from contextlib import contextmanager, nullcontext
from typing import Dict, List, Tuple

import numpy as np

from .config import BehaviorConfig
from .fleet import AuditTap, audit_enabled
from .hashing import fnv1a64
from .interval import IntervalLoop
from .telemetry import exc_text
from .types import RateLimitRequest
from .wire import _varint, req_from_tlv, req_to_tlv, tlv_with_hits

log = logging.getLogger("gubernator_tpu_torch.global")

#: slack beyond global_timeout_ms for the lane futures of one tick (the
#: lanes' own retries and backoff fit inside it)
FLUSH_SLACK_S = 30.0


def _failed_future(e: BaseException) -> Future:
    f: Future = Future()
    f.set_exception(e)
    return f


class GlobalManager:
    #: an error older than this no longer marks the daemon unhealthy
    #: (the loops retry every tick)
    ERROR_TTL_S = 60.0

    def __init__(self, instance, behaviors: BehaviorConfig, metrics):
        self.instance = instance
        self.behaviors = behaviors
        self.metrics = metrics
        self._mu = threading.Lock()
        #: arrival order across both lanes: on a merge the prototype with
        #: the highest seq wins ("latest config wins")
        self._seq = 0  # guarded-by: self._mu
        #: key → (request prototype, summed hits, seq): non-owner side
        self._hits: Dict[str, Tuple[RateLimitRequest, int, int]] = {}  # guarded-by: self._mu
        #: key → (seq, request prototype): owner side, changed keys
        self._updates: Dict[str, Tuple[int, RateLimitRequest]] = {}  # guarded-by: self._mu
        #: raw key hash → (request TLV, summed hits, seq): the wire lane
        self._hits_raw: Dict[int, Tuple[bytes, int, int]] = {}  # guarded-by: self._mu
        #: raw key hash → (seq, request TLV): the wire lane, owner side
        self._updates_raw: Dict[int, Tuple[int, bytes]] = {}  # guarded-by: self._mu
        #: the degraded share of the queued hits, keyed as the queues
        self._deg: Dict[str, int] = {}  # guarded-by: self._mu
        self._deg_raw: Dict[int, int] = {}  # guarded-by: self._mu
        #: owner address → {raw key hash: (prototype, hits, seq,
        #: degraded share)}: the aggregates held back while that owner's
        #: circuit is open
        self._parked: Dict[str, Dict[int, tuple]] = {}  # guarded-by: self._mu
        #: the conservation audit's sender-side ledger (own leaf lock,
        #: touched outside self._mu)
        self.audit = AuditTap() if audit_enabled() else None
        #: totals since start: hits queued, hits the owners acknowledged,
        #: hits absorbed (this daemon owns the key), hit flushes that
        #: failed, broadcasts sent and those that failed
        self.stats = {"hits_queued": 0, "hits_degraded": 0,
                      "hits_flushed": 0,
                      "hits_absorbed": 0, "flush_failures": 0,
                      "broadcasts": 0, "broadcast_keys": 0,
                      "broadcast_failures": 0}  # guarded-by: self._mu
        self._err_mu = threading.Lock()
        self._last_error = ""  # guarded-by: self._err_mu
        self._last_error_at = 0.0  # guarded-by: self._err_mu
        self._hits_loop = IntervalLoop(
            behaviors.global_sync_wait_ms, self._hits_tick,
            name="global-async-hits")
        self._bcast_loop = IntervalLoop(
            behaviors.global_broadcast_interval_ms, self._broadcast_tick,
            name="global-broadcasts")

    # ---- producers (the request path) ----------------------------------

    def queue_hits(self, req: RateLimitRequest,
                   degraded: bool = False) -> None:
        """Add ``req``'s hits to its key's aggregate for the next flush
        to the owner (global.go › QueueHits); ``degraded`` marks hits
        a degraded serve queued."""
        inc = max(int(req.hits), 0)
        with self._mu:
            self._seq += 1
            _, acc, _ = self._hits.get(req.key, (req, 0, 0))
            self._hits[req.key] = (req, acc + inc, self._seq)
            self.stats["hits_queued"] += inc
            if degraded:
                self.stats["hits_degraded"] += inc
                if inc:
                    self._deg[req.key] = self._deg.get(req.key, 0) + inc
            n = len(self._hits) + len(self._hits_raw)
        if self.audit is not None:
            self.audit.inject(inc, degraded)
        self.metrics.queue_length.set(n)
        if n >= self.behaviors.global_batch_limit:
            self._hits_loop.poke()

    def queue_update(self, req: RateLimitRequest) -> None:
        """Mark a GLOBAL key changed on its owner, for the next broadcast
        (global.go › QueueUpdate)."""
        with self._mu:
            self._seq += 1
            self._updates[req.key] = (self._seq, req)
            n = len(self._updates) + len(self._updates_raw)
        if n >= self.behaviors.global_batch_limit:
            self._bcast_loop.poke()

    def queue_hits_raw(self, khash: int, tlv: bytes, hits: int,
                       degraded: bool = False) -> None:
        """The wire lane's ``queue_hits``: ``khash`` is the key's raw
        FNV-1a hash, ``tlv`` its latest request TLV (the prototype; a
        hits=0 entry refreshes it too)."""
        inc = max(int(hits), 0)
        with self._mu:
            self._seq += 1
            _, acc, _ = self._hits_raw.get(khash, (tlv, 0, 0))
            self._hits_raw[khash] = (tlv, acc + inc, self._seq)
            self.stats["hits_queued"] += inc
            if degraded:
                self.stats["hits_degraded"] += inc
                if inc:
                    self._deg_raw[khash] = self._deg_raw.get(khash, 0) + inc
            n = len(self._hits_raw) + len(self._hits)
        if self.audit is not None:
            self.audit.inject(inc, degraded)
        self.metrics.queue_length.set(n)
        if n >= self.behaviors.global_batch_limit:
            self._hits_loop.poke()

    def queue_update_raw(self, khash: int, tlv: bytes) -> None:
        """The wire lane's ``queue_update``."""
        with self._mu:
            self._seq += 1
            self._updates_raw[khash] = (self._seq, tlv)
            n = len(self._updates_raw) + len(self._updates)
        if n >= self.behaviors.global_batch_limit:
            self._bcast_loop.poke()

    def queued(self) -> dict:
        """What waits for the next ticks: keys and hits to flush, keys to
        broadcast."""
        with self._mu:
            parked = [e for q in self._parked.values() for e in q.values()]
            return {"hit_keys": len(self._hits) + len(self._hits_raw)
                    + len(parked),
                    "hits": (sum(a for _, a, _ in self._hits.values())
                             + sum(a for _, a, _ in
                                   self._hits_raw.values())
                             + sum(e[1] for e in parked)),
                    "update_keys": len(self._updates)
                    + len(self._updates_raw)}

    def queued_hits(self) -> Tuple[int, int]:
        """(hit weight queued, its degraded share) across both lanes and
        the parked owners: the audit vector's live-queue leg."""
        with self._mu:
            parked = [e for q in self._parked.values() for e in q.values()]
            q = (sum(a for _, a, _ in self._hits.values())
                 + sum(a for _, a, _ in self._hits_raw.values())
                 + sum(e[1] for e in parked))
            d = (sum(self._deg.values()) + sum(self._deg_raw.values())
                 + sum(e[3] for e in parked))
        return q, d

    def _requeue_hits(self, entries) -> None:
        """Put a failed flush's aggregates back (an unreachable owner
        must not lose hits): entries are (key or raw hash, prototype,
        hits, seq, degraded share), merged with whatever was queued
        since.  Not a new injection: the audit counted them queued."""
        with self._mu:
            for k, proto, acc, seq, deg in entries:
                raw = isinstance(proto, bytes)
                q = self._hits_raw if raw else self._hits
                p0, a0, s0 = q.get(k, (proto, 0, 0))
                q[k] = (proto if seq >= s0 else p0, a0 + acc, max(s0, seq))
                if deg:
                    dq = self._deg_raw if raw else self._deg
                    dq[k] = dq.get(k, 0) + deg
            n = len(self._hits) + len(self._hits_raw)
        self.metrics.queue_length.set(n)

    def _fault_tick(self, point: str, stage: str) -> bool:
        """The loops' faultpoint: True aborts this tick (its queues are
        not popped yet, so nothing is lost); the error reads as the
        tick's own."""
        f = self.instance.faults
        if not f.armed:
            return False
        try:
            f.fire(point)
        except Exception as e:  # noqa: BLE001 - incl. FaultInjected
            msg = f"{stage}: {exc_text(e)}"
            log.warning(msg)
            self._record([msg])
            return True
        return False

    # ---- the hits loop (global.go › runAsyncHits) ----------------------

    @staticmethod
    def _merge_into(dst: dict, src: dict) -> None:
        """Merge raw-hash-space aggregates (prototype, hits, seq,
        degraded share): the prototype of the later arrival wins, hits
        and shares add up."""
        for kh, (proto, acc, seq, deg) in src.items():
            cur = dst.get(kh)
            if cur is None:
                dst[kh] = (proto, acc, seq, deg)
            else:
                p0, a0, s0, d0 = cur
                dst[kh] = (proto if seq >= s0 else p0, a0 + acc,
                           max(s0, seq), d0 + deg)

    def _tick_context(self, name: str):
        """A tick's own trace (no caller request on this thread): a root
        span named after it, under which the lanes' sends record their
        hops, so the owners' handlers stitch back to the tick."""
        rec = getattr(self.instance, "span_recorder", None)
        if rec is None:
            return nullcontext()
        from .tracing import request_context, span

        @contextmanager
        def cm():
            with request_context(None, recorder=rec), span(name):
                yield

        return cm()

    def _hits_tick(self) -> None:
        """Flush every key's aggregate to its owner: both lanes' queues
        merge in raw-hash space, one TLV per key with the summed hits,
        per-owner payloads on the owners' forward lanes.

        The aggregates of an owner whose circuit is open are parked
        instead of built into a payload that would fail at once and be
        requeued: a dead owner's backlog (every degraded serve's hits)
        then costs its new arrivals, not its whole size, every tick.
        They rejoin the flush as soon as the circuit lets a send through
        (its half-open probe), and the tick still reports the failure as
        a refused send would."""
        with self._tick_context("global.hits_flush"):
            self._hits_tick_traced()

    def _hits_tick_traced(self) -> None:
        if self._fault_tick("global_hits", "global hits flush"):
            return
        with self._mu:
            hits, self._hits = self._hits, {}
            hits_raw, self._hits_raw = self._hits_raw, {}
            deg, self._deg = self._deg, {}
            deg_raw, self._deg_raw = self._deg_raw, {}
            parked = self._parked
        # lock-free: only this tick's thread adds or removes parked owners
        self.metrics.queue_length.set(sum(len(v) for v in parked.values()))
        inst = self.instance
        tap = self.audit
        peers = {p.info.grpc_address: p for p in inst.peers()}
        merged: Dict[int, tuple] = {
            kh: (tlv, acc, seq, deg_raw.get(kh, 0))
            for kh, (tlv, acc, seq) in hits_raw.items()}
        self._merge_into(merged, {
            fnv1a64(key.encode("utf-8")): (req, acc, seq, deg.get(key, 0))
            for key, (req, acc, seq) in hits.items()})
        for addr in list(parked):
            p = peers.get(addr)
            if p is None or not p._circuit_blocked():
                with self._mu:
                    back = self._parked.pop(addr)
                self._merge_into(merged, back)
        if not merged and not parked:
            return
        keys = np.fromiter(merged.keys(), np.uint64, len(merged))
        owners = inst.owners_by_raw_khash(keys)
        by_owner: Dict[str, Tuple[object, List[bytes], List[tuple]]] = {}
        to_park: Dict[str, dict] = {}
        blocked: Dict[str, bool] = {}
        absorbed = absorbed_deg = 0
        for j, (kh, (proto, acc, seq, d)) in enumerate(merged.items()):
            if acc <= 0:
                continue
            peer = None if owners is None else owners[0][owners[1][j]]
            if peer is None or inst.is_self(peer):
                absorbed += acc  # the owner: applied already
                absorbed_deg += d
                continue
            addr = peer.info.grpc_address
            b = blocked.get(addr)
            if b is None:
                b = blocked[addr] = (addr in parked
                                     or peer._circuit_blocked())
            if b:
                to_park.setdefault(addr, {})[kh] = (proto, acc, seq, d)
                continue
            if isinstance(proto, bytes):
                tlv = tlv_with_hits(proto, acc)
                entry = (kh, proto, acc, seq, d)
            else:
                # the JAX flush builds these from the prototype's
                # fields, so its created_at does not ride along
                tlv = req_to_tlv(RateLimitRequest(
                    name=proto.name, unique_key=proto.unique_key, hits=acc,
                    limit=proto.limit, duration=proto.duration,
                    algorithm=proto.algorithm, behavior=proto.behavior,
                    burst=proto.burst))
                entry = (proto.key, proto, acc, seq, d)
            slot = by_owner.setdefault(addr, (peer, [], []))
            slot[1].append(tlv)
            slot[2].append(entry)
        if tap is not None:
            tap.apply(absorbed, absorbed_deg, absorbed=True)
        futs = []
        limit = self.behaviors.global_batch_limit
        for addr, (peer, tlvs, entries) in by_owner.items():
            for i in range(0, len(tlvs), limit):
                chunk = tlvs[i:i + limit]
                try:
                    fut = peer.forward_raw(b"".join(chunk), len(chunk))
                except Exception as e:  # noqa: BLE001 - circuit open or
                    # closing: requeued below
                    fut = _failed_future(e)
                futs.append((addr, fut, entries[i:i + limit]))
        errors = []
        flushed = failures = 0
        with self._mu:
            for addr, entries in to_park.items():
                self._merge_into(self._parked.setdefault(addr, {}), entries)
            held = sorted(self._parked)
        for addr in held:
            # what forward_raw would have raised for this owner
            failures += 1
            self._flush_error(errors, addr, f"peer {addr} circuit open")
        deadline = (time.monotonic() + self.behaviors.global_timeout_ms
                    / 1000.0 + FLUSH_SLACK_S)
        for addr, fut, ent in futs:
            try:
                fut.result(timeout=max(deadline - time.monotonic(), 0.1))
            except Exception as e:  # noqa: BLE001 - requeue: the hits
                # apply once the owner is reachable
                self._requeue_hits(ent)
                failures += 1
                self._flush_error(errors, addr, exc_text(e))
                continue
            flushed += sum(e[2] for e in ent)
            if tap is not None:
                # the owner acknowledged this chunk
                tap.apply(sum(e[2] for e in ent), sum(e[4] for e in ent))
        with self._mu:
            self.stats["hits_absorbed"] += absorbed
            self.stats["hits_flushed"] += flushed
            self.stats["flush_failures"] += failures
        self._record(errors)

    def _flush_error(self, errors: list, addr: str, text: str) -> None:
        errors.append(f"global hits sync to {addr}: {text}")
        self.metrics.check_error_counter.labels(
            error="global_hits_sync").inc()
        log.warning(errors[-1])
        self._record_event("error", stage="global_hits_sync",
                           error=errors[-1])

    # ---- the broadcast loop (global.go › runBroadcasts) ----------------

    def _broadcast_tick(self) -> None:
        """Owner side: send the changed keys' authoritative rows to every
        other peer (UpdatePeerGlobals), each message serialized once."""
        with self._tick_context("global.broadcast"):
            self._broadcast_tick_traced()

    def _broadcast_tick_traced(self) -> None:
        if self._fault_tick("global_broadcast", "global broadcast"):
            return
        with self._mu:
            updates, self._updates = self._updates, {}
            updates_raw, self._updates_raw = self._updates_raw, {}
        for khash, (seq, tlv) in updates_raw.items():
            try:
                req = req_from_tlv(tlv)
            except Exception:  # noqa: BLE001 - a corrupt queued TLV can
                # only come from a parser bug: drop it, not the tick
                log.warning("dropping unparseable queued TLV for key "
                            "hash %d", khash)
                continue
            cur = updates.get(req.key)
            if cur is None or seq > cur[0]:
                updates[req.key] = (seq, req)
        if not updates:
            return
        t0 = time.perf_counter()
        inst = self.instance
        msgs = inst.build_global_updates([r for _, r in updates.values()])
        if not msgs:
            return
        peers = [p for p in inst.peers() if not inst.is_self(p)]
        tlvs = []
        for m in msgs:
            payload = m.SerializeToString()
            tlvs.append(b"\x0a" + _varint(len(payload)) + payload)
        limit = self.behaviors.global_batch_limit
        chunks = [(b"".join(tlvs[i:i + limit]), len(tlvs[i:i + limit]))
                  for i in range(0, len(tlvs), limit)]
        futs = []
        for peer in peers:
            for chunk, n in chunks:
                try:
                    fut = peer.send_globals_raw(chunk, n)
                except Exception as e:  # noqa: BLE001 - fail fast
                    fut = _failed_future(e)
                futs.append((peer.info.grpc_address, fut))
        errors = []
        failed = set()
        deadline = (time.monotonic() + self.behaviors.global_timeout_ms
                    / 1000.0 + FLUSH_SLACK_S)
        for addr, fut in futs:
            try:
                fut.result(timeout=max(deadline - time.monotonic(), 0.1))
            except Exception as e:  # noqa: BLE001
                if addr not in failed:
                    failed.add(addr)
                    errors.append(f"global broadcast to {addr}: "
                                  f"{exc_text(e)}")
                    self.metrics.check_error_counter.labels(
                        error="global_broadcast").inc()
                    log.warning(errors[-1])
        with self._mu:
            self.stats["broadcasts"] += 1
            self.stats["broadcast_keys"] += len(msgs)
            self.stats["broadcast_failures"] += len(failed)
        self._record(errors)
        self.metrics.global_broadcast_counter.inc()
        dt = time.perf_counter() - t0
        self.metrics.broadcast_duration.observe(dt)
        disp = getattr(inst, "dispatcher", None)
        if disp is not None:
            disp._obs_phase("broadcast", dt)
            ana = disp.analytics
            if ana is not None and peers and not errors:
                # one broadcast fans the serialized updates out to every
                # peer; a failed round measures its deadline: left out
                ana.tap_cost("broadcast",
                             sum(m.ByteSize() for m in msgs) * len(peers),
                             len(peers) + 1, dt)
        self._record_event("broadcast", keys=len(msgs), peers=len(peers),
                           errors=len(errors),
                           error=("; ".join(errors) or None))

    # ---- errors (health_check) -----------------------------------------

    def _record_event(self, kind: str, **fields) -> None:
        """An event in the instance's flight recorder."""
        self.instance.recorder.record(kind, **fields)

    def _record(self, errors) -> None:
        """A tick's errors: a clean tick clears, a failing one stamps."""
        with self._err_mu:
            if errors:
                self._last_error = "; ".join(errors)
                self._last_error_at = time.monotonic()
            else:
                self._last_error = ""

    @property
    def last_error(self) -> str:
        with self._err_mu:
            if (self._last_error and time.monotonic() - self._last_error_at
                    > self.ERROR_TTL_S):
                return ""
            return self._last_error

    def snapshot_stats(self) -> dict:
        with self._mu:
            return dict(self.stats)

    def poke(self) -> None:
        """Run both loops now."""
        self._hits_loop.poke()
        self._bcast_loop.poke()

    def close(self) -> None:
        """Stop both loops; each runs a final tick."""
        self._hits_loop.close()
        self._bcast_loop.close()
