"""V1Instance: one daemon's request routing over the device engine.

The port of gubernator_tpu/instance.py for a daemon with no peers: every
request in a client batch is served locally, through the dispatcher, in
one device wave with whatever other callers sent meanwhile.
``Behavior.GLOBAL`` rows are served locally too, exactly as a solo JAX
daemon with no hot set serves them.  Building or launching the kernel
raises: there is no fallback engine.
"""
from __future__ import annotations

import threading
import time
from typing import List, Optional, Sequence

from .config import Config
from .dispatcher import Dispatcher
from .engine import BucketEngine
from .types import (MAX_BATCH_SIZE, HealthCheckResponse, RateLimitRequest,
                    RateLimitResponse)


def clock_ms() -> int:
    return time.time_ns() // 1_000_000


class V1Instance:
    """Device engine + dispatcher for one peerless daemon."""

    def __init__(self, config: Config):
        self.config = config
        self.engine = BucketEngine(device=config.device,
                                   capacity=config.cache_size,
                                   batch_rows=config.batch_rows)
        self._engine_mu = threading.Lock()
        self.dispatcher = Dispatcher(
            self.engine, max_wave=self.engine.wave_buckets[-1],
            lock=self._engine_mu)
        self._last_sweep = clock_ms()
        self._closed = False

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
        """Healthy, with the table's occupancy in the message."""
        with self._engine_mu:
            occ, full, total = self.engine.occupancy_and_saturation()
        return HealthCheckResponse(
            status="healthy",
            message=f"rows={occ} full_buckets={full}/{total}",
            peer_count=0)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.dispatcher.close()
