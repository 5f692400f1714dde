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
heavy-hitter analytics, the cold tier, tenants, the SLO engine, the
fleet audit, the memory ledger, the mesh-GLOBAL tier, the scenario
lab).  The JAX families of subsystems the port has no counterpart of
(the fused Pallas wave counter, the compile ledger) are not registered;
ROADMAP gives the reasons.  The scenario lab's help text leaves out
the tag of the JAX project's change log that ends JAX's.

The port adds families of its own (``PORT_FAMILIES``): thread CPU time
per phase and wave step, K1's launches, live rows and segments, the
collector's pauses (``gubernator_gc_pause_seconds``, fed once
``install_gc_pauses()`` ran in the process) and, read at scrape time,
each serving thread's CPU seconds (``gubernator_thread_cpu_seconds``).
"""
from __future__ import annotations

import bisect
import gc
import os
import threading
import time
import weakref
from contextlib import contextmanager

from prometheus_client import (CollectorRegistry, Counter, Gauge, Histogram,
                               generate_latest)
from prometheus_client.core import (CounterMetricFamily,
                                     HistogramMetricFamily)
from prometheus_client.utils import floatToGoString

_BUCKETS = (.0005, .001, .0025, .005, .01, .025, .05, .1, .25, .5, 1.0, 2.5)

#: a wave that waits on a first-use kernel build or a wedged device runs
#: long: the histogram resolves that tail instead of clipping it at 2.5 s
_WAVE_DURATION_BUCKETS = _BUCKETS + (10.0, 30.0, 60.0, 120.0, 300.0, 600.0)

#: requests per coalesced wave: 1 (idle inline) up to max_wave and beyond
_WAVE_SIZE_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 1024, 4096,
                      16384, 65536)

#: a collection of the young generations takes tens of microseconds, a
#: full one of a large heap up to seconds
_GC_BUCKETS = (1e-5, 5e-5, 1e-4, 5e-4, .001, .005, .01, .05, .1, .5, 1.0)

#: the families the port registers beyond the JAX package's
PORT_FAMILIES = frozenset({
    "gubernator_phase_cpu_seconds", "gubernator_k1_launches",
    "gubernator_k1_rows", "gubernator_k1_segments",
    "gubernator_gc_pause_seconds", "gubernator_thread_cpu_seconds"})


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
        # ---- the scenario lab (scenarios.py) ----
        self.scenario_runs = Counter(
            "gubernator_scenario_runs",
            "scenario-lab runs by verdict (scenarios.py)",
            ["verdict"], registry=r)
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
        self.phase_cpu_seconds = Counter(
            "gubernator_phase_cpu_seconds",
            "thread CPU time per serving phase and wave step (s): the "
            "caller's ingest and build, the worker's wave.* steps "
            "(time.thread_time, exclusive of nested steps)",
            ["phase"], registry=r)
        # ---- K1's launches (ops/decide.py), counted on the host ----
        self.k1_launches = Counter(
            "gubernator_k1_launches",
            "decision-step launches of K1 (its plain version on a CPU "
            "table)", registry=r)
        self.k1_rows = Counter(
            "gubernator_k1_rows",
            "live request rows K1's launches applied", registry=r)
        self.k1_segments = Counter(
            "gubernator_k1_segments",
            "distinct buckets (segments) K1's launches walked",
            registry=r)
        # ---- the host runtime ----
        #: gubernator_gc_pause_seconds, fed by the collector's callback
        self.gc_pause = _GcPauses()
        r.register(self.gc_pause)
        _GC_SINKS.add(self.gc_pause)
        #: name → thread for gubernator_thread_cpu_seconds (the instance
        #: sets it: a callable returning the dict, read at scrape time)
        self.cpu_threads = None
        r.register(_ThreadCpu(self))
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
        # ---- tenants, SLO, fleet audit, memory ledger ----
        self.tenant_requests = Gauge(
            "gubernator_tenant_requests",
            "rows attributed to this tenant (tenant = key-name prefix "
            "up to GUBER_TENANT_DELIM; overflow folds into __other__)",
            ["tenant"], registry=r)
        self.tenant_hits = Gauge(
            "gubernator_tenant_hits",
            "hit weight attributed to this tenant", ["tenant"],
            registry=r)
        self.tenant_over_limit = Gauge(
            "gubernator_tenant_over_limit",
            "OVER_LIMIT rows attributed to this tenant", ["tenant"],
            registry=r)
        self.tenant_errors = Gauge(
            "gubernator_tenant_errors",
            "error rows attributed to this tenant", ["tenant"],
            registry=r)
        self.tenant_degraded = Gauge(
            "gubernator_tenant_degraded",
            "degraded-mode serves attributed to this tenant",
            ["tenant"], registry=r)
        self.tenant_shed = Gauge(
            "gubernator_tenant_shed",
            "admission-shed rows attributed to the tenant that "
            "triggered the shed", ["tenant"], registry=r)
        self.slo_burn = Gauge(
            "gubernator_slo_burn",
            "fast-window burn rate per SLO (error-budget spend "
            "multiple; breach latches when fast AND slow exceed the "
            "threshold — see GET /debug/slo); tenant label empty for "
            "instance-level SLOs", ["slo", "tenant"], registry=r)
        self.fleet_conservation_drift = Gauge(
            "gubernator_fleet_conservation_drift",
            "conservation drift this daemon contributes to the fleet "
            "fold: GLOBAL hits injected minus applied across both "
            "backends (nonzero while flushes fail or are in flight; "
            "held nonzero past the flush-window bound it burns the "
            "fleet_conservation SLO — see GET /debug/audit)",
            registry=r)
        self.memledger_bytes = Gauge(
            "gubernator_memledger_bytes",
            "live bytes per memory-ledger consumer (host-side "
            "consumers report host bytes — see GET /debug/memory)",
            ["consumer"], registry=r)
        self.memledger_rows = Gauge(
            "gubernator_memledger_rows",
            "memory-ledger rows per consumer: state=capacity is the "
            "allocated row budget, state=occupied the live occupancy",
            ["consumer", "state"], registry=r)
        # ---- the mesh-GLOBAL tier (GUBER_GLOBAL_MODE=mesh) ----
        self.pallas_mesh_fused_hits = Counter(
            "gubernator_pallas_mesh_fused_hits",
            "mesh-GLOBAL hits scatter-added by the fused serving "
            "program (the injected side of the mesh conservation "
            "ledger for fused waves)", registry=r)
        self.mesh_global_folds = Counter(
            "gubernator_mesh_global_folds",
            "mesh-GLOBAL reconcile collectives completed (one "
            "all-reduce fold per generation)", registry=r)
        self.mesh_global_fold_errors = Counter(
            "gubernator_mesh_global_fold_errors",
            "mesh-GLOBAL reconcile ticks that failed (accumulators "
            "swap back — no hit is lost; consecutive failures past "
            "GUBER_MESH_FALLBACK_AFTER stand the tier down)",
            registry=r)
        self.mesh_global_staleness = Gauge(
            "gubernator_mesh_global_staleness_seconds",
            "measured coherence staleness at the last mesh-GLOBAL "
            "fold: age of the oldest hit the collective folded "
            "(bounded by the reconcile interval when ticks are "
            "healthy)", registry=r)
        self.mesh_global_degraded = Gauge(
            "gubernator_mesh_global_degraded",
            "1 while the mesh-GLOBAL tier is stood down (keys demoted "
            "to the owner-sharded path; reconcile rides the gRPC "
            "queues until the fold recovers)", registry=r)
        self.mesh_global_keys = Gauge(
            "gubernator_mesh_global_keys",
            "keys currently pinned in the mesh-GLOBAL replica table",
            registry=r)

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


def _proc_cpu_s(path: str) -> float:
    """utime + stime of a /proc stat file, in seconds."""
    with open(path, "rb") as f:
        fields = f.read().rsplit(b")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / _CLK_TCK


_CLK_TCK = os.sysconf("SC_CLK_TCK") if hasattr(os, "sysconf") else 100


class _ThreadCpu:
    """``gubernator_thread_cpu_seconds{thread}``, read from /proc at
    scrape time (the serving path pays nothing): each thread named by
    ``Metrics.cpu_threads()``, and ``other``, the rest of the process
    (its exited threads included)."""

    def __init__(self, metrics: Metrics):
        self._m = weakref.ref(metrics)

    def describe(self):
        return [CounterMetricFamily(
            "gubernator_thread_cpu_seconds", _THREAD_CPU_HELP,
            labels=["thread"])]

    def collect(self):
        fam = CounterMetricFamily("gubernator_thread_cpu_seconds",
                                  _THREAD_CPU_HELP, labels=["thread"])
        m = self._m()
        named = m.cpu_threads() if m is not None and m.cpu_threads else {}
        try:
            total = _proc_cpu_s("/proc/self/stat")
        except OSError:  # no /proc: nothing to report
            return [fam]
        for name, t in named.items():
            tid = getattr(t, "native_id", None)
            if tid is None or not t.is_alive():
                continue
            try:
                s = _proc_cpu_s(f"/proc/self/task/{tid}/stat")
            except OSError:  # the thread ended since
                continue
            fam.add_metric([name], s)
            total -= s
        fam.add_metric(["other"], max(total, 0.0))
        return [fam]


_THREAD_CPU_HELP = ("CPU seconds (user + system) of the daemon's serving "
                    "threads: the dispatcher's worker, the analytics "
                    "worker, and the rest of the process (other)")

_GC_HELP = ("the Python collector's pauses by generation (s): every "
            "thread of the process stops for them")


class _GcPauses:
    """``gubernator_gc_pause_seconds{generation}``: bucket counts and
    sums in plain lists, which the collector's callback adds to, laid
    out as a histogram at scrape time.  The callback takes no lock: it
    runs on whichever thread the collection interrupted, a scrape's
    too, and one that waited there on a lock that thread holds would
    stop the collector for the rest of the process."""

    __slots__ = ("counts", "sums", "__weakref__")

    def __init__(self):
        self.counts = {g: [0] * (len(_GC_BUCKETS) + 1) for g in "012"}
        self.sums = dict.fromkeys("012", 0.0)

    def add(self, gen: str, seconds: float) -> None:
        counts = self.counts.get(gen)
        if counts is not None:
            counts[bisect.bisect_left(_GC_BUCKETS, seconds)] += 1
            self.sums[gen] += seconds

    def describe(self):
        return [HistogramMetricFamily("gubernator_gc_pause_seconds",
                                      _GC_HELP, labels=["generation"])]

    def collect(self):
        fam = HistogramMetricFamily("gubernator_gc_pause_seconds",
                                    _GC_HELP, labels=["generation"])
        for gen, counts in self.counts.items():
            total, sum_s = list(counts), self.sums[gen]
            buckets, n = [], 0
            for bound, k in zip(_GC_BUCKETS + (float("inf"),), total):
                n += k
                buckets.append((floatToGoString(bound), n))
            fam.add_metric([gen], buckets, sum_s)
        return [fam]


#: every live Metrics' _GcPauses: the collector's callback (one per
#: process) adds each pause to each
_GC_SINKS: "weakref.WeakSet" = weakref.WeakSet()
_gc_t0 = [0.0]
_gc_installed = threading.Lock()


def _gc_callback(phase: str, info: dict) -> None:
    if phase == "start":
        _gc_t0[0] = time.perf_counter()
        return
    dt = time.perf_counter() - _gc_t0[0]
    gen = str(info.get("generation", ""))
    for sink in list(_GC_SINKS):
        sink.add(gen, dt)


def install_gc_pauses() -> None:
    """Time the collector's pauses into ``gubernator_gc_pause_seconds``
    from now on: one ``gc.callbacks`` hook per process, however many
    daemons it runs."""
    with _gc_installed:
        if _gc_callback not in gc.callbacks:
            gc.callbacks.append(_gc_callback)


def observe_with_exemplar(hist, value: float, exemplar=None) -> None:
    """Histogram observe with a best-effort exemplar (``{"trace_id":
    ...}`` from SpanRecorder.exemplar()), linking the bucket to one
    sampled trace in the OpenMetrics exposition; a client that rejects
    it gets a plain observe."""
    if exemplar:
        try:
            hist.observe(value, exemplar)
            return
        except (TypeError, ValueError):
            pass
    hist.observe(value)
