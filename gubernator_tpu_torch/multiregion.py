"""MULTI_REGION: asynchronous hit replication across regions (the port
of gubernator_tpu/multiregion.py; mutliregion.go, the upstream
spelling).

A request flagged MULTI_REGION is decided at once by its owner in the
local region; that owner queues the hits here, and every
``multi_region_sync_wait_ms`` the hits summed per key are sent to the
same key's owner in every OTHER region (``instance.region_pickers()``),
so the regions' counters converge.  The copy sent drops the
MULTI_REGION flag, so the receiving region does not send the hits back.

The object lane queues request objects (``queue_hits``), the wire lanes
the request's TLV bytes per key hash (``queue_hits_raw``), read back
with ``wire.req_from_tlv`` when a tick sends them; per key the latest
request's config wins across both queues.  The ``mr_sync`` faultpoint
aborts a tick before the queues are taken, so an injected failure loses
no hit.  A send that fails is recorded (``last_error``, for health) and
its hits are not queued again, as in the JAX package.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Dict, Tuple

from .config import BehaviorConfig
from .interval import IntervalLoop
from .types import Behavior, RateLimitRequest

log = logging.getLogger("gubernator_tpu_torch.multiregion")


class MultiRegionManager:
    #: a failed send marks the daemon unhealthy for this long after the
    #: last failure (the loop retries every tick; a stale error must not
    #: fail readiness probes forever)
    ERROR_TTL_S = 60.0

    def __init__(self, instance, behaviors: BehaviorConfig):
        self.instance = instance
        self.behaviors = behaviors
        self._mu = threading.Lock()
        #: arrival order across both queues: the highest wins the
        #: flush-time merge (the latest config)
        self._seq = 0  # guarded-by: self._mu
        #: key → (request, summed hits, seq)
        self._hits: Dict[str, Tuple[RateLimitRequest, int, int]] = {}  # guarded-by: self._mu
        #: raw key hash → (request TLV bytes, summed hits, seq)
        self._hits_raw: Dict[int, Tuple[bytes, int, int]] = {}  # guarded-by: self._mu
        self._err_mu = threading.Lock()
        self._last_error = ""  # guarded-by: self._err_mu
        self._last_error_at = 0.0  # guarded-by: self._err_mu
        self._loop = IntervalLoop(behaviors.multi_region_sync_wait_ms,
                                  self._run_async_reqs,
                                  name="multi-region-sync")

    @property
    def last_error(self) -> str:
        with self._err_mu:
            if (self._last_error and time.monotonic() - self._last_error_at
                    > self.ERROR_TTL_S):
                return ""
            return self._last_error

    def _record(self, errors) -> None:
        with self._err_mu:
            if errors:
                self._last_error = "; ".join(errors)
                self._last_error_at = time.monotonic()
            else:
                self._last_error = ""

    def queue_hits(self, req: RateLimitRequest) -> None:
        """mutliregion.go › QueueHits: add ``req``'s hits to its key."""
        with self._mu:
            self._seq += 1
            _, acc, _ = self._hits.get(req.key, (req, 0, 0))
            self._hits[req.key] = (req, acc + max(int(req.hits), 0),
                                   self._seq)
            n = len(self._hits) + len(self._hits_raw)
        if n >= self.behaviors.multi_region_batch_limit:
            self._loop.poke()

    def queue_hits_raw(self, khash: int, tlv: bytes, hits: int) -> None:
        """The wire lanes' ``queue_hits``: a request TLV and the summed
        hits per key hash.  An entry of 0 hits still replaces the
        request, so a config change wins the merge as on the object
        lane."""
        with self._mu:
            self._seq += 1
            _, acc, _ = self._hits_raw.get(khash, (tlv, 0, 0))
            self._hits_raw[khash] = (tlv, acc + max(hits, 0), self._seq)
            n = len(self._hits) + len(self._hits_raw)
        if n >= self.behaviors.multi_region_batch_limit:
            self._loop.poke()

    def queued(self) -> dict:
        """The keys waiting in each queue and their summed hits."""
        with self._mu:
            return {"keys": len(self._hits) + len(self._hits_raw),
                    "hits": sum(a for _, a, _ in self._hits.values())
                    + sum(a for _, a, _ in self._hits_raw.values())}

    def _fault_tick(self) -> bool:
        """The ``mr_sync`` faultpoint: True aborts this tick before the
        queues are taken, so the hits go out on the next clean tick."""
        f = getattr(self.instance, "faults", None)
        if f is None or not f.armed:
            return False
        try:
            f.fire("mr_sync")
        except Exception as e:  # noqa: BLE001 - FaultInjected included
            msg = f"multi-region sync tick: {e!r}"
            log.warning(msg)
            self._record([msg])
            return True
        return False

    def _run_async_reqs(self) -> None:
        """Send the summed hits to each other region's key owner
        (mutliregion.go › runAsyncReqs)."""
        if self._fault_tick():
            return
        with self._mu:
            hits, self._hits = self._hits, {}
            hits_raw, self._hits_raw = self._hits_raw, {}
        from .wire import req_from_tlv

        for khash, (tlv, acc, seq) in hits_raw.items():
            try:
                req = req_from_tlv(tlv)
            except Exception:  # noqa: BLE001 - a parser fault drops one key
                log.warning("dropping an unparseable queued TLV for key "
                            "hash %d", khash)
                continue
            proto, a0, s0 = hits.get(req.key, (req, 0, seq))
            hits[req.key] = (req if seq >= s0 else proto, a0 + acc,
                             max(s0, seq))
        if not hits:
            return  # nothing sent: the error state stands (its TTL ends it)
        local_dc = self.instance.config.data_center
        errors = []
        for dc, picker in self.instance.region_pickers().items():
            if dc == local_dc:
                continue
            by_peer: Dict[str, Tuple[object, list]] = {}
            for key, (req, acc, _seq) in hits.items():
                if acc <= 0:
                    continue
                try:
                    peer = picker.get(key)
                except RuntimeError:
                    continue  # the region has no peers now
                copy = RateLimitRequest(
                    name=req.name, unique_key=req.unique_key, hits=acc,
                    limit=req.limit, duration=req.duration,
                    algorithm=req.algorithm,
                    # the receiving region must not send these back
                    behavior=Behavior(int(req.behavior)
                                      & ~int(Behavior.MULTI_REGION)),
                    burst=req.burst)
                by_peer.setdefault(peer.info.grpc_address,
                                   (peer, []))[1].append(copy)
            limit = self.behaviors.multi_region_batch_limit
            for addr, (peer, reqs) in by_peer.items():
                try:
                    for i in range(0, len(reqs), limit):
                        peer.get_peer_rate_limits(
                            reqs[i:i + limit],
                            timeout_s=self.behaviors.multi_region_timeout_ms
                            / 1000.0)
                except Exception as e:  # noqa: BLE001 - recorded, next tick
                    errors.append(f"multi-region sync {dc}/{addr}: {e}")
                    log.warning(errors[-1])
        self._record(errors)

    def poke(self) -> None:
        self._loop.poke()

    def close(self) -> None:
        self._loop.close()
