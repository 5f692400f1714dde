"""V1Instance: one daemon's request routing over the device engine.

The port of gubernator_tpu/instance.py for a daemon with no peers: every
request in a client batch is served locally, through the dispatcher, in
one device wave with whatever other callers sent meanwhile.
``Behavior.GLOBAL`` rows are served locally too, exactly as a solo JAX
daemon with no hot set serves them.  ``Config.engine`` picks the bucket
engine (K1) or the classic SoA engine (``xla``).  Building or launching
a kernel raises, and so does building an engine: there is no fallback
engine.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import List, Optional, Sequence

from .config import Config
from .dispatcher import Dispatcher
from .engine import BucketEngine
from .sharded import ShardedEngine, autogrow_limit_per_shard
from .types import (MAX_BATCH_SIZE, HealthCheckResponse, RateLimitRequest,
                    RateLimitResponse)

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
        """Healthy, with the table's occupancy in the message (and the
        full-bucket count where the engine has buckets)."""
        with self._engine_mu:
            if hasattr(self.engine, "occupancy_and_saturation"):
                occ, full, total = self.engine.occupancy_and_saturation()
                msg = f"rows={occ} full_buckets={full}/{total}"
            else:
                msg = (f"rows={self.engine.occupancy()} "
                       f"capacity={self.engine.cap_local}")
        return HealthCheckResponse(status="healthy", message=msg,
                                   peer_count=0)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.dispatcher.close()
