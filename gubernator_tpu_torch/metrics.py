"""Prometheus metrics (the port's copy of gubernator_tpu/metrics.py).

Each family has the JAX package's name, type, help, labels and buckets,
so dashboards and OBSERVABILITY.md's catalog cover the port as they
cover the JAX daemon.  Each instance gets its own CollectorRegistry (a
cluster runs several daemons in one process).

Registered: the families of the subsystems the port has (serving
counters, table gauges, the wire lane, the hot set, the dispatcher's
waves, stall watchdog and pipeline, the wave pool, admission and drain,
the peer lanes and circuit, forwards, GLOBAL queue and broadcasts,
degraded serves, the health-gated ring, fault injection, the
heavy-hitter analytics, the cold tier).  The JAX families of subsystems
not ported yet (fused Pallas counters, compile ledger, scenarios,
mesh-GLOBAL, tenants, SLO, fleet, memory ledger) are not registered;
ROADMAP lists them beside their subsystems.
"""
from __future__ import annotations

import time
from contextlib import contextmanager

from prometheus_client import (CollectorRegistry, Counter, Gauge, Histogram,
                               generate_latest)

_BUCKETS = (.0005, .001, .0025, .005, .01, .025, .05, .1, .25, .5, 1.0, 2.5)

#: a wave that waits on a first-use kernel build or a wedged device runs
#: long: the histogram resolves that tail instead of clipping it at 2.5 s
_WAVE_DURATION_BUCKETS = _BUCKETS + (10.0, 30.0, 60.0, 120.0, 300.0, 600.0)

#: requests per coalesced wave: 1 (idle inline) up to max_wave and beyond
_WAVE_SIZE_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 1024, 4096,
                      16384, 65536)


class Metrics:
    def __init__(self) -> None:
        r = self.registry = CollectorRegistry()
        # ---- serving counters and table gauges ----
        self.getratelimit_counter = Counter(
            "gubernator_getratelimit", "GetRateLimits calls",
            ["calltype"], registry=r)
        self.over_limit_counter = Counter(
            "gubernator_over_limit", "OVER_LIMIT decisions", registry=r)
        self.check_error_counter = Counter(
            "gubernator_check_error", "errors while checking rate limits",
            ["error"], registry=r)
        self.func_duration = Histogram(
            "gubernator_func_duration", "handler durations (s)",
            ["name"], buckets=_BUCKETS, registry=r)
        self.cache_size = Gauge(
            "gubernator_cache_size", "live rows in the counter table",
            registry=r)
        self.cache_access_count = Counter(
            "gubernator_cache_access_count", "table lookups",
            ["type"], registry=r)
        self.concurrent_checks = Gauge(
            "gubernator_concurrent_checks_counter",
            "in-flight GetRateLimits batches", registry=r)
        self.cache_capacity = Gauge(
            "gubernator_cache_capacity",
            "total counter-table rows (grows under auto-grow)", registry=r)
        self.dropped_rows = Gauge(
            "gubernator_cache_dropped_rows",
            "live rows lost to grow/restore re-placement (each is a "
            "counter reset, the LRU-eviction analog)", registry=r)
        self.bucket_saturation = Gauge(
            "gubernator_pallas_bucket_saturation",
            "fraction of 8-slot buckets that are FULL (pallas serving "
            "mode; new keys hashing into a full bucket are unservable)",
            registry=r)
        # ---- the wire lane ----
        self.wire_lane_counter = Counter(
            "gubernator_wire_lane_requests",
            "requests by serving lane (wire-columnar vs pb2 fallback)",
            ["lane"], registry=r)
        self.hot_demotion_counter = Counter(
            "gubernator_hotset_demotions",
            "hot-set pinned keys demoted back to the sharded path",
            ["reason"], registry=r)
        # ---- dispatcher waves, watchdog, pipeline ----
        self.wave_size = Histogram(
            "gubernator_dispatcher_wave_size",
            "requests per coalesced device wave",
            buckets=_WAVE_SIZE_BUCKETS, registry=r)
        self.wave_queue_wait = Histogram(
            "gubernator_dispatcher_queue_wait",
            "job wait from submit to its wave launching (s)",
            buckets=_BUCKETS, registry=r)
        self.wave_duration = Histogram(
            "gubernator_dispatcher_wave_duration",
            "device wave duration, launch to resolve (s); the tail "
            "buckets exist for cold compiles",
            buckets=_WAVE_DURATION_BUCKETS, registry=r)
        self.waves_in_flight = Gauge(
            "gubernator_dispatcher_waves_in_flight",
            "waves currently executing on the device (incl. pipelined "
            "launches awaiting sync)", registry=r)
        self.wave_timeout_counter = Counter(
            "gubernator_dispatcher_wave_timeouts",
            "caller waits that hit RESULT_TIMEOUT_S", registry=r)
        self.dispatcher_stalled = Gauge(
            "gubernator_dispatcher_stalled",
            "1 while any wave has been in flight longer than the stall "
            "threshold (a cold compile shows here minutes before "
            "callers time out)", registry=r)
        self.stall_event_counter = Counter(
            "gubernator_dispatcher_stall_events",
            "waves flagged stalled by the watchdog", registry=r)
        self.first_wave_duration = Gauge(
            "gubernator_dispatcher_first_wave_seconds",
            "duration of this dispatcher's FIRST wave (includes any "
            "cold compile the warmup did not cover)", registry=r)
        self.pipeline_depth = Gauge(
            "gubernator_dispatcher_pipeline_depth",
            "configured depth of the overlapped wave pipeline (0 = "
            "pipeline off: CPU default or capability-less engine)",
            registry=r)
        self.phase_duration = Histogram(
            "gubernator_phase_duration",
            "request time attributed per serving phase (s): ingest, "
            "pack, queue_wait, device, resolve, build, peer_flush — "
            "pack+device+resolve partition wave_duration",
            ["phase"], buckets=_BUCKETS, registry=r)
        # ---- the wave pool ----
        self.wave_buffer_pool_hit = Counter(
            "gubernator_wave_buffer_pool_hits",
            "wave upload-buffer leases served from the pool",
            registry=r)
        self.wave_buffer_pool_miss = Counter(
            "gubernator_wave_buffer_pool_misses",
            "wave upload-buffer leases that allocated fresh matrices",
            registry=r)
        self.wave_buffer_leaks = Counter(
            "gubernator_wave_buffer_leaks",
            "wave buffer leases dropped without release (reclaimed by "
            "the GC hook; must stay 0 — asserted by the soak tests)",
            registry=r)
        # ---- admission and drain ----
        self.admission_shed = Counter(
            "gubernator_admission_shed",
            "requests shed at ingress with RESOURCE_EXHAUSTED, by "
            "reason (queue_full, deadline, draining)",
            ["reason"], registry=r)
        self.draining = Gauge(
            "gubernator_draining",
            "1 while the daemon is in its shutdown drain window "
            "(shallow /healthz returns 503 'draining')", registry=r)
        # ---- peer lanes, circuit, forwards ----
        self.batch_send_duration = Histogram(
            "gubernator_batch_send_duration",
            "peer batch flush durations (s)", ["peer_addr"],
            buckets=_BUCKETS, registry=r)
        self.peer_send_buffer_depth = Gauge(
            "gubernator_peer_send_buffer_depth",
            "request TLVs queued in a peer's send buffer awaiting a "
            "flush", ["peer_addr"], registry=r)
        self.peer_flush_size = Histogram(
            "gubernator_peer_flush_size",
            "request TLVs per peer flush RPC",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 4096),
            registry=r)
        self.peer_flush_wait = Histogram(
            "gubernator_peer_flush_wait",
            "entry wait from send-buffer enqueue to its flush RPC "
            "launching (s)", buckets=_BUCKETS, registry=r)
        self.peer_inflight_rpcs = Gauge(
            "gubernator_peer_inflight_rpcs",
            "peer flush RPCs currently in flight (depth-K pipelined)",
            ["peer_addr"], registry=r)
        self.peer_retry_counter = Counter(
            "gubernator_peer_retries",
            "peer flush RPCs re-sent after a failure (backoff applies)",
            ["peer_addr"], registry=r)
        self.peer_circuit_open_counter = Counter(
            "gubernator_peer_circuit_opens",
            "times a peer's circuit opened (consecutive flush failures "
            "crossed peer_circuit_threshold)", ["peer_addr"],
            registry=r)
        self.peer_circuit_state = Gauge(
            "gubernator_peer_circuit_state",
            "1 while a peer's circuit is open (sends fail fast)",
            ["peer_addr"], registry=r)
        self.forward_failed = Counter(
            "gubernator_forward_failed",
            "forwarded sub-batches that failed, by peer and reason "
            "(circuit_open, closing, rpc_error, short_response, "
            "send_error) — counts requests, whether they degraded to "
            "local answers or became error rows",
            ["peer_addr", "reason"], registry=r)
        # ---- GLOBAL queue and broadcasts ----
        self.queue_length = Gauge(
            "gubernator_global_queue_length",
            "pending GLOBAL hit aggregations", registry=r)
        self.broadcast_duration = Histogram(
            "gubernator_broadcast_duration", "GLOBAL broadcast durations (s)",
            buckets=_BUCKETS, registry=r)
        self.global_broadcast_counter = Counter(
            "gubernator_broadcast", "GLOBAL broadcasts sent", registry=r)
        # ---- the failure path: degraded serves, the gated ring, faults ----
        self.degraded_served = Counter(
            "gubernator_degraded_served",
            "requests answered locally in degraded mode while their "
            "owner was unreachable or their keys were rehomed "
            "(response carries metadata degraded=true; hits reconcile "
            "to the owner through the GLOBAL hit-flush queues)",
            ["peer_addr"], registry=r)
        self.ring_generation = Gauge(
            "gubernator_ring_generation",
            "monotonic generation of the health-gated routing ring; "
            "bumps when a peer is ejected or readmitted (flap detector: "
            "one outage should cost exactly two bumps)", registry=r)
        self.ring_ejected_peers = Gauge(
            "gubernator_ring_ejected_peers",
            "peers currently ejected from the routing ring by the "
            "health gate (their keys are rehomed until readmit)",
            registry=r)
        self.fault_injected = Counter(
            "gubernator_fault_injected",
            "times an armed faultpoint fired (faults.py; 0 in healthy "
            "operation — nonzero means a chaos run is active)",
            ["point"], registry=r)
        # ---- key analytics: the top-K gauge's labels are the current
        # top-K only (analytics.py › KeyAnalytics._publish removes
        # departed keys first), so its cardinality stays at GUBER_TOPK
        self.topkey_overlimit = Gauge(
            "gubernator_topkey_overlimit_total",
            "OVER_LIMIT decisions observed for each CURRENT top-K key "
            "while tracked (bounded labels: departed keys are removed)",
            ["key"], registry=r)
        self.analytics_waves = Counter(
            "gubernator_analytics_waves_tapped",
            "resolved waves folded into the heavy-hitter sketch",
            registry=r)
        self.analytics_dropped = Counter(
            "gubernator_analytics_tap_dropped",
            "wave taps dropped because the analytics queue was full "
            "(analytics never applies backpressure to serving)",
            registry=r)
        # ---- the host cold tier (tiering.py) ----
        self.tier_cold_keys = Gauge(
            "gubernator_tier_cold_keys",
            "keys resident in the host cold tier (device-table misses "
            "served exactly from host memory)", registry=r)
        self.tier_cold_serves = Counter(
            "gubernator_tier_cold_serves",
            "requests served from the host cold tier (device miss or "
            "table overflow; byte-exact with the device step)",
            registry=r)
        self.tier_promotions = Counter(
            "gubernator_tier_promotions",
            "cold rows migrated into the device table after their "
            "sketch rank cleared GUBER_TIER_PROMOTE", registry=r)
        self.tier_demotions = Counter(
            "gubernator_tier_demotions",
            "device rows evicted to the host cold tier (promotion "
            "victims and table-full writebacks; created_at-preserving, "
            "conservation-exact)", registry=r)
        self.tier_migrations_aborted = Counter(
            "gubernator_tier_migrations_aborted",
            "tier migrations abandoned at the tier_promote/tier_demote "
            "faultpoints (the row stays in its source tier — no state "
            "is lost)", registry=r)

    @contextmanager
    def time_func(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.func_duration.labels(name=name).observe(
                time.perf_counter() - t0)

    def render(self) -> bytes:
        """Text exposition for the /metrics endpoint."""
        return generate_latest(self.registry)
