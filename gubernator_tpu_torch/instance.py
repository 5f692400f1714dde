"""V1Instance: one daemon's request routing over the device engine (the
port of gubernator_tpu/instance.py; gubernator.go › V1Instance).

Alone (no peer but itself), every request in a client batch is served
locally, through the dispatcher, in one device wave with whatever other
callers sent meanwhile.  In a cluster (``set_peers``), keys belong to
daemons by a hash ring (peers.py): owned keys are decided locally,
other keys are forwarded to their owner over the peer wire
(peer_client.py), and ``Behavior.GLOBAL`` keys are answered from the
local replica, their hits queued to the owner, which broadcasts its
state back (global_manager.py).  With ``Config.data_center`` set the
ring is per region (peers.py › RegionPeerPicker): keys resolve in the
local region, and the local owner of a ``Behavior.MULTI_REGION`` key
queues its hits for the key's owner in every other region
(multiregion.py), on both lanes and on the owner side of a forward.
The owner side is ``get_peer_rate_limits`` /
``get_peer_rate_limits_wire`` and ``update_peer_globals``.
``Config.engine`` picks the bucket engine (K1) or the classic SoA engine
(``xla``), over the instance's mesh (mesh.py: the caller's ``mesh``, else
every visible GPU on ``cuda``, as JAX's ``make_mesh()`` takes every local
device), ``cache_size / n`` rows a shard.  Building or launching a kernel
raises, and so does building an engine: there is no fallback engine.

``Config.global_mode`` / GUBER_GLOBAL_MODE ``mesh`` (anything but
``grpc`` or ``mesh`` raises): a daemon alone serves qualifying GLOBAL
keys from the mesh-resident tier (meshglobal.py), pinned on first touch
with their table row as seed, on both lanes (the bucket engine decides
them in its wave's launch, ``mslot``); the GLOBAL manager's hits tick
runs ``_mesh_reconcile_tick`` (the ``global_accum_swap`` and
``global_psum`` faultpoints, the fold, its cost sample); failed folds
past GUBER_MESH_FALLBACK_AFTER stand the tier down (every key demoted
exactly) until a fold succeeds after a cooldown.  A flagged request or
a new config demotes a key, and so do a peer joining, a snapshot and
``remove``.  Mesh mode builds no hot set.

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

The failure path (the JAX package's defaults):

- **Degraded serves** (``peer_degraded_fallback``): a failed forward's
  eligible rows (no RESET_REMAINING, DRAIN_OVER_LIMIT or MULTI_REGION)
  are answered from the local shard, flagged ``metadata.degraded`` /
  ``degraded_peer``, and their hits queued per key to the true owner on
  the GLOBAL hit queues (reconciled once it answers); ineligible rows
  answer error rows naming the peer.  The degraded response build uses
  protobuf (the C++ response build has no metadata lane); it runs only for
  such rows.
- **The health-gated ring** (``peer_health_gate``): requests route by
  the membership ring less the peers whose circuit stayed open for
  ``peer_eject_after_ms`` (``_routing_picker``; the membership ring
  itself while nothing is ejected).  Rows rehomed to this daemon serve
  degraded, on both lanes and on the owner side of a forward.  Ejected
  peers are probed every ``peer_circuit_cooldown_ms`` and readmitted
  after staying recovered for ``peer_readmit_after_ms``.  Reconcile
  targets (``owner_of``, ``owners_by_raw_khash``) stay on the membership
  ring.
- **Handover** (``handover_on_reshard``): on a membership change or a
  gate flip, rows this daemon owned whose routing owner moved are sent
  to the new owner (UpdatePeerGlobals with ``key_hash`` and ``eff_ms``)
  and dropped here; a failed delivery leaves the row in place.
- **Faults**: a per-instance ``FaultSet`` (faults.py) from GUBER_FAULT,
  shared with the dispatcher, the peer clients and the GLOBAL manager;
  ``wire_ingest`` fires before the C++ parse.

State beyond the device table (the JAX package's defaults):

- **Analytics** (GUBER_ANALYTICS, on by default): a ``KeyAnalytics``
  (analytics.py) on the dispatcher, fed by every wave; on the bucket
  engine the step's device tap goes straight to it (``tap_sink``).
- **Cold tier** (GUBER_TIER_COLD / ``Config.tier_cold``): a
  ``TierController`` (tiering.py) bound as ``engine.tier``, its rank the
  sketch's (no analytics: no promotion).
- **Loader** (``Config.loader``; the daemon's GUBER_SNAPSHOT_PATH): the
  table, both tiers, restored at start and saved at close, each with
  its faultpoint (``restore``, ``snapshot``) and phase sample.  A
  FileLoader moves columns (``load_arrays`` / ``save_arrays``), any
  other Loader items.
- **Store** (``Config.store``): read-through of device misses before the
  object lane's step and write-through of its answers after it (the
  peer object lane too); with a Store set the wire lanes take the
  protobuf path, so every answer passes the Store.
- **remove**: the device row, the cold row and the Store's item.

Each instance owns a ``Metrics`` registry and a ``FlightRecorder``
(served by the daemon at /metrics and /debug/events), shared with its
dispatcher, wave pool, peer clients and GLOBAL manager.  Every client
entry asks the dispatcher's admission control first, before any engine
work (``ResourceExhausted`` when it sheds), then counts its requests.
The replicated hot set (hotset.py, JAX's default ``hot_set_capacity``
of 1024): a daemon alone answers its hottest GLOBAL keys from the hot
set's replicas on the engine's device instead of the table.  A GLOBAL
key without RESET_REMAINING, DRAIN_OVER_LIMIT, MULTI_REGION or a
Gregorian duration is promoted once its hits (or its sketch count) reach
``hot_promote_threshold``, seeded from its table row after the batch's
step; the sync loop folds the replicas every ``global_sync_wait_ms``.
A pinned key is demoted, its merged row written back to the table (or
the cold tier), by a flagged request or a new config on it, by a peer
joining, by a snapshot and by ``remove``, each counted in
``gubernator_hotset_demotions{reason}``.  The wire lane serves a lone
daemon's GLOBAL batches through the same routing in columns (lane
``wire_hotset``).

Observability (the JAX package's defaults, all on):

- **Traces**: a ``SpanRecorder`` (tracing.py; GUBER_TRACE_SAMPLE,
  GUBER_TRACE_SPANS) shared with the dispatcher, armed per request by
  the daemon's handlers; degraded serves force their trace's sample.
- **Tenants**: the analytics' tenant ledger learns the wire lanes' keys
  from their bytes (``tap_wire_names``) and counts the fused lane's
  table-full rows, degraded serves and sheds (``tap_flag``).
- **Memory ledger** (memledger.py, GUBER_MEM_LEDGER): the table's
  tensors, the hot set's, the wave pool, the sketch and the cold store
  enroll with probes that read live attributes; the table's occupancy
  comes from ``occupancy_nowait``, which never waits on the serving
  stream.
- **Conservation audit** (fleet.py, GUBER_FLEET_AUDIT): ``audit_doc``.
- **SLO engine** (slo.py, GUBER_SLO): every SLO the JAX instance
  registers, ticked by an IntervalLoop (GUBER_SLO_TICK).
- ``close()`` writes the event ring, the SLO verdicts and the spans as
  JSONL under GUBER_DEBUG_DUMP_DIR when it is set.
"""
from __future__ import annotations

import logging
import os
import threading
import time
from concurrent.futures import Future
from contextlib import contextmanager, nullcontext
from dataclasses import replace
from typing import Dict, List, Optional, Sequence

import numpy as np

from .config import Config
from .core.batch import lease_batch, pack_columns
from .dispatcher import Dispatcher
from .engine import BucketEngine
from .faults import FaultSet
from .fleet import ConservationAuditor
from .global_manager import GlobalManager
from .hotset import HotSetEngine
from .gregorian import gregorian_rate_duration_ms
from .hashing import (hash_key, hash_keys, hash_request_keys, mix64_np,
                      mixed_fnv1a64)
from .interval import IntervalLoop
from .memledger import MemoryLedger
from .mesh import Mesh, make_mesh
from .meshglobal import MeshGlobalEngine, config_of as _mesh_cfg_of
from .metrics import Metrics
from .multiregion import MultiRegionManager
from .ops import native as wire_native
from .peer_client import ErrCircuitOpen, ErrClosing, PeerClient
from .peers import RegionPeerPicker, ReplicatedConsistentHash
from .sharded import ShardedEngine, autogrow_limit_per_shard
from .store import CacheItem, arrays_from_items, items_from_arrays
from .telemetry import FlightRecorder, exc_text
from .tracing import SpanRecorder, current_span_id, force_sample, step
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


class _MeshChanges(Exception):
    """A wire batch's GLOBAL keys need pins or demotions before it can
    route: ``keys`` maps each key hash to (its config for the mesh tier
    or None, a request of it), as ``_mesh_apply`` takes them."""

    def __init__(self, keys: dict):
        super().__init__("mesh-GLOBAL keys to pin or demote")
        self.keys = keys


class _Gate:
    """A shared / exclusive gate that prefers its exclusive holder: once
    one waits, new shared holders wait behind it, so a stream of shared
    holders cannot starve it.  Neither side is reentrant."""

    def __init__(self):
        self._cv = threading.Condition()
        self._shared = 0  # guarded-by: self._cv
        self._exclusive = False  # guarded-by: self._cv
        self._waiting = 0  # guarded-by: self._cv

    @contextmanager
    def shared(self):
        with self._cv:
            while self._exclusive or self._waiting:
                self._cv.wait()
            self._shared += 1
        try:
            yield
        finally:
            with self._cv:
                self._shared -= 1
                if not self._shared:
                    self._cv.notify_all()

    @contextmanager
    def exclusive(self):
        with self._cv:
            self._waiting += 1
            while self._exclusive or self._shared:
                self._cv.wait()
            self._waiting -= 1
            self._exclusive = True
        try:
            yield
        finally:
            with self._cv:
                self._exclusive = False
                self._cv.notify_all()


class V1Instance:
    """One daemon: its device engine, dispatcher, peers and GLOBAL
    manager."""

    def __init__(self, config: Config, peer_tls_creds=None,
                 mesh: Optional[Mesh] = None, engine=None):
        # the GLOBAL reconcile backend: "grpc" keeps the hit queues and
        # broadcasts; "mesh" serves a lone daemon's GLOBAL keys from the
        # mesh-resident replica tier (meshglobal.py), folded once a tick;
        # a typo must not silently serve the wrong coherence model
        global_mode = (os.environ.get("GUBER_GLOBAL_MODE")
                       or config.global_mode or "grpc")
        if global_mode not in ("grpc", "mesh"):
            raise ValueError(f"unknown global_mode {global_mode!r} (want "
                             "'grpc' or 'mesh')")
        self.config = config
        #: the peer clients' gRPC credentials in a TLS cluster
        self._peer_tls = peer_tls_creds
        self.metrics = Metrics()
        #: bounded structured-event ring: wave launches / stalls /
        #: timeouts, sheds, the drain, GLOBAL broadcasts and errors, ring
        #: ejections, degraded serves, handovers, armed faults
        self.recorder = FlightRecorder()
        #: this instance's faultpoints (GUBER_FAULT, POST /debug/faults)
        self.faults = FaultSet.from_env()
        self.faults.metrics = self.metrics
        self.faults.recorder = self.recorder
        # the trace plane: a bounded ring of completed spans, armed per
        # request by the daemon's handlers; head-sampled at
        # GUBER_TRACE_SAMPLE (0: only forced samples record)
        try:
            sample = float(os.environ.get("GUBER_TRACE_SAMPLE") or 0.0)
        except ValueError:
            sample = 0.0
        try:
            tcap = int(os.environ.get("GUBER_TRACE_SPANS") or 2048)
        except ValueError:
            tcap = 2048
        self.span_recorder = SpanRecorder(capacity=max(tcap, 1),
                                          sample=sample)
        # the memory ledger (GUBER_MEM_LEDGER=0 turns it off)
        self.memledger: Optional[MemoryLedger] = None
        #: the table occupancy's last sample (occupancy_nowait)
        self._memledger_live = 0
        if os.environ.get("GUBER_MEM_LEDGER", "1") != "0":
            self.memledger = MemoryLedger(recorder=self.recorder)
        if engine is None:
            # the mesh: the caller's, else every visible GPU for "cuda"
            # (as JAX's make_mesh() takes every local device), else the
            # one device named
            if mesh is None:
                mesh = (make_mesh() if config.device == "cuda"
                        else Mesh([config.device]))
            # rows per shard: at least 1024, a power of two (the JAX
            # instance's split of cache_size)
            cap = max(config.cache_size // mesh.n, 1024)
            cap = 1 << (cap - 1).bit_length()
            engine = self._build_engine(
                resolve_engine_kind(config.engine), cap, config, mesh)
        # an injected engine (``engine=``, e.g. oracle.OracleEngine) is
        # served as its type allows: one without a packed interface
        # takes the dispatcher's list lane, and the lanes that need the
        # packed or row interface raise on it
        self.engine = engine
        if hasattr(engine, "wave_pool"):
            engine.wave_pool.metrics = self.metrics
        if isinstance(engine, BucketEngine):
            engine.metrics_ref = self.metrics
        self._engine_mu = threading.Lock()
        # key analytics: the heavy-hitter sketch and the phase ledger,
        # fed off the serving path (GUBER_ANALYTICS=0 turns it off)
        self._analytics = None
        if os.environ.get("GUBER_ANALYTICS", "1") != "0":
            from .analytics import KeyAnalytics

            self._analytics = KeyAnalytics(metrics=self.metrics)
        self.dispatcher = self._make_dispatcher()
        analytics = self._analytics
        self.metrics.cpu_threads = self._serving_threads
        fused_tap = getattr(self.engine, "fused_tap", False)
        if fused_tap and analytics is not None:
            # the bucket engine taps in its step: its device tap goes
            # straight to the analytics, set once before serving
            self.engine.tap_sink = analytics.tap_device
        # the cold tier: engine.tier, ranked by the sketch; the victim
        # filter is the JAX hook for replica-pinned keys
        self._tier = None
        tier_cold = os.environ.get("GUBER_TIER_COLD")
        if (tier_cold == "1" if tier_cold is not None
                else config.tier_cold):
            if not self._row_engine():
                raise ValueError(
                    f"the cold tier needs an engine with row operations; "
                    f"{type(self.engine).__name__} has none")
            from .tiering import TierController

            thr = int(os.environ.get("GUBER_TIER_PROMOTE")
                      or config.tier_promote_threshold)
            self._tier = TierController(
                self.engine,
                rank_fn=(analytics.sketch_count
                         if analytics is not None else None),
                promote_threshold=thr, metrics=self.metrics,
                recorder=self.recorder, fault=self._fault_point,
                skip_victim=self._tier_victim_pinned,
                # an engine tapping in its step leaves out the cold rows,
                # which ride its waves invalid: the tier feeds them
                tap=(analytics.tap_packed
                     if fused_tap and analytics is not None else None),
                rank_batch=(analytics.sketch_counts
                            if analytics is not None else None))
        self._enroll_memledger()
        self.store = config.store
        self.loader = config.loader
        if self.loader is not None:
            try:
                self._load_from_loader()
            except BaseException:
                # a failed restore (the restore faultpoint) leaks no thread
                self.dispatcher.close()
                if analytics is not None:
                    analytics.close()
                raise
        self._last_sweep = clock_ms()
        self._closed = False
        # with a region set, one ring per region (region_picker.go)
        self._picker = (RegionPeerPicker(config.data_center)
                        if config.data_center
                        else ReplicatedConsistentHash())  # guarded-by: self._peer_mu
        self._peer_mu = threading.Lock()
        self._self_addr = config.advertise_address
        self.global_manager: Optional[GlobalManager] = None
        self.mr_manager: Optional[MultiRegionManager] = None
        self._gm_mu = threading.Lock()
        #: rows sent to their owners, and those whose forward failed
        self._fwd_mu = threading.Lock()
        self.forwarded_rows = 0  # guarded-by: self._fwd_mu
        self.forward_failures = 0  # guarded-by: self._fwd_mu
        # the health gate: the peers ejected from routing, the routing
        # ring built without them (None: the membership ring), its
        # generation, and the loop probing ejected peers
        self._gate_bad: frozenset = frozenset()  # guarded-by: self._peer_mu
        self._gate_picker = None  # guarded-by: self._peer_mu
        self._ring_gen = 0  # guarded-by: self._peer_mu
        self._probe_loop: Optional[IntervalLoop] = None  # guarded-by: self._gm_mu
        # handover passes: one at a time; a newer generation supersedes
        self._handover_mu = threading.Lock()
        self._handover_gen_mu = threading.Lock()
        self._handover_gen = 0  # guarded-by: self._handover_gen_mu
        self._global_mode = global_mode
        self._meshglobal: Optional[MeshGlobalEngine] = None  # guarded-by: self._gm_mu
        #: the reconcile tick's state: the failed folds in a row, set by
        #: whichever thread folds (the tick or a caller) and read by the
        #: tick for the stand-down
        self._mesh_fail_streak = 0  # lock-free: set under _mesh_tick_mu
        #: one swap and fold at a time: the tick's, or a serving
        #: thread's when the tick is late (_mesh_fold_if_late)
        self._mesh_tick_mu = threading.Lock()
        #: monotonic stamp of the last fold tried
        self._mesh_last_try = 0.0  # lock-free: set under _mesh_tick_mu
        #: set and cleared with the mesh gate exclusive, read by the
        #: batches holding it shared
        self._mesh_degraded = False  # guarded-by: self._mesh_gate
        self._mesh_down_until = 0.0  # lock-free: a single racy float
        #: monotonic stamp of the last fold that succeeded (the staleness
        #: SLO ages against it)
        self._mesh_last_fold_ok: Optional[float] = None  # lock-free: tick thread writes, SLO tick reads
        # the replicated hot set: built at the first promotion (never in
        # mesh mode: two replica tiers for one key would double-count)
        self._hotset: Optional[HotSetEngine] = None  # guarded-by: self._gm_mu
        self._hot_mu = threading.Lock()
        #: promotion counts by key hash, halved on the sweep tick
        self._hot_counts: dict = {}  # guarded-by: self._hot_mu
        self._hot_sync_loop: Optional[IntervalLoop] = None  # guarded-by: self._gm_mu
        #: (request, key hash) to pin after the batch's step
        self._promote_pending: List[tuple] = []  # guarded-by: self._hot_mu
        #: held shared by a batch from its GLOBAL routing through its
        #: steps, exclusive by the pins (_drain_promotions)
        self._promote_gate = _Gate()
        #: the mesh tier's key set changes only with this held exclusive
        #: (pins, demotions, the stand-down, a peer joining); a batch
        #: with GLOBAL rows holds it shared from its routing through its
        #: steps, so a demotion reads a row no routed wave still owes
        self._mesh_gate = _Gate()
        if self._mesh_mode():
            # the fold rides the GLOBAL manager's hits tick: start it
            # now; run the tier's step, its fold and the fused mesh
            # launch once before serving
            self._ensure_global_manager()
            self._ensure_meshglobal().warmup()
            if hasattr(self.engine, "warmup_mesh_fused"):
                self.engine.warmup_mesh_fused()
        # the conservation audit over the GLOBAL lanes' own accounting
        self.auditor = ConservationAuditor(self)
        # the SLO engine (GUBER_SLO=0 turns it off)
        self.slo = None
        self._slo_loop: Optional[IntervalLoop] = None
        if os.environ.get("GUBER_SLO", "1") != "0":
            self._build_slo()

    def _make_dispatcher(self) -> Dispatcher:
        """A dispatcher over this instance's engine, lock, registry,
        recorder and faultpoints; the GUBER_* dispatcher knobs are read
        now."""
        buckets = getattr(self.engine, "wave_buckets", None)
        kw = {"max_wave": buckets[-1]} if buckets else {}
        d = Dispatcher(self.engine, **kw,
                       lock=self._engine_mu, metrics=self.metrics,
                       recorder=self.recorder, faults=self.faults,
                       analytics=self._analytics)
        d.span_recorder = self.span_recorder
        return d

    @property
    def analytics(self):
        """The KeyAnalytics (None when off); it lives on the dispatcher,
        so detaching that one reference darkens every host tap."""
        return self.dispatcher.analytics

    def _serving_threads(self) -> dict:
        """The threads gubernator_thread_cpu_seconds names: the
        dispatcher's worker and the analytics worker."""
        out = {"dispatcher": self.dispatcher._thread}
        ana = self.analytics
        if ana is not None:
            out["analytics"] = ana._thread
        return out

    # ---- persistence (store.go › Loader, Store) -------------------------

    def _load_from_loader(self) -> None:
        """Restore the Loader's snapshot: rows the device table cannot
        hold go to the cold tier when there is one."""
        self._fault_point("restore")
        t0 = time.perf_counter()
        load_arrays = getattr(self.loader, "load_arrays", None)
        if load_arrays is not None:
            arrays = load_arrays()
            n = 0 if arrays is None else len(arrays["key"])
        else:
            items = list(self.loader.load())
            n = len(items)
            arrays = arrays_from_items(items) if items else None
        if n:
            placed = self.engine.restore(arrays)
            log.info("loader: restored %d/%d rows", placed, n)
        self.dispatcher._obs_phase("restore", time.perf_counter() - t0)

    def _save_to_loader(self) -> None:
        """Save both tiers through the Loader."""
        if self.loader is None:
            return
        self._fault_point("snapshot")
        t0 = time.perf_counter()
        # hot-set and mesh-tier rows live outside the table: fold them
        # back in first
        self._demote_all()
        with self._mesh_gate.exclusive():
            self._mesh_demote_all()
        arrays = self.engine.snapshot()
        if self._tier is not None:
            # cold rows are state too: restore puts back in the cold
            # tier whatever the device table cannot hold
            cold = self._tier.snapshot_arrays()
            if cold is not None:
                arrays = {f: np.concatenate([arrays[f], cold[f]])
                          for f in arrays}
        save_arrays = getattr(self.loader, "save_arrays", None)
        if save_arrays is not None:
            save_arrays(arrays)
        else:
            self.loader.save(iter(items_from_arrays(arrays)))
        self.dispatcher._obs_phase("snapshot", time.perf_counter() - t0)

    def _read_through(self, reqs) -> None:
        """Seed device-table misses from the Store before the step
        (store.go › Store.Get on a miss).  The gather, the gets and the
        upsert hold the engine lock: a request inserting the same key
        in between would have its hits overwritten by the Store's
        copy.

        With the cold tier a cold-resident key is no miss, and an item
        the device table refuses lands cold (``restore``): every key
        stays in exactly one tier.  JAX's read-through consults the
        device table alone (ROADMAP §C.3)."""
        if self.store is None or not reqs:
            return
        khash = hash_request_keys([r.name for r in reqs],
                                  [r.unique_key for r in reqs])
        with self._engine_mu:
            found, _ = self.engine.gather_rows(khash)
            if self._tier is not None:
                found = found | self._tier.resident_mask(khash)
            items = []
            for j, req in enumerate(reqs):
                if found[j]:
                    continue
                item = self.store.get(req)
                if item is not None:
                    if not item.key and not item.key_hash:
                        item.key = req.key
                    items.append(item)
            if items:
                arrays = arrays_from_items(items)
                if self._tier is not None:
                    self.engine.restore(arrays)
                else:
                    self.engine.upsert_rows(arrays.pop("key"), arrays)

    def _after_local(self, reqs, resps) -> None:
        """Store write-through of each non-error answer (the JAX item:
        ``remaining`` and ``expire_at`` from the response)."""
        if self.store is None:
            return
        for req, resp in zip(reqs, resps):
            if resp.error:
                continue
            self.store.on_change(req, CacheItem(
                key=req.key, algorithm=int(req.algorithm),
                limit=resp.limit, duration=int(req.duration),
                remaining=resp.remaining, expire_at=resp.reset_time,
                status=int(resp.status)))

    def remove(self, name: str, unique_key: str) -> bool:
        """Delete one rate limit's state: its device row, its cold row
        and its Store item.  True when a row existed."""
        kh = hash_key(name, unique_key)
        if self._hotset is not None and self._hotset.is_pinned(kh):
            # uncounted, as in JAX: the row is deleted next
            self._demote(kh)
        mge = self._meshglobal
        if mge is not None and mge.is_pinned(kh):
            with self._mesh_gate.exclusive():
                self._mesh_demote(kh)
        with self._engine_mu:
            n = self.engine.remove_rows(np.array([kh], np.uint64))
            if self._tier is not None \
                    and self._tier.pop_row(kh) is not None:
                n += 1  # the row lived in the cold tier
        if self.store is not None:
            self.store.remove(f"{name}_{unique_key}")
        return n > 0

    def _tier_victim_pinned(self, kh: int) -> bool:
        """The tier's eviction filter: a hot-set or mesh-tier pinned
        key's table row is the home of its state, which moving it cold
        while the pin serves would fork."""
        hs = self._hotset
        if hs is not None and hs.is_pinned(kh):
            return True
        mge = self._meshglobal
        return mge is not None and mge.is_pinned(kh)

    def owner_addr_by_khash(self, khash: int) -> Optional[str]:
        """The owner's address of a mixed table key hash (the sketch's
        key space): /debug/topkeys' owner column.  None alone, on a
        picker with another hash, or on an emptied ring."""
        with self._peer_mu:
            picker = self._picker
        if not picker.peers() or not self._uses_default_hash(picker):
            return None
        try:
            peers = picker.owner_peers()
            return peers[int(picker.owner_indices(
                np.array([khash], np.uint64))[0])].info.grpc_address
        except RuntimeError:  # the ring emptied meanwhile
            return None

    def _fault_point(self, point: str, tag: Optional[str] = None) -> None:
        """An instance-level faultpoint (one attribute read while
        disarmed)."""
        f = self.faults
        if f.armed:
            f.fire(point, tag)

    @staticmethod
    def _build_engine(kind: str, cap: int, config: Config, mesh: Mesh):
        """Construct the resolved engine kind over ``mesh`` with ``cap``
        rows a shard; a failure raises."""
        if kind == "bucket":
            if config.cache_autogrow_max:
                log.warning(
                    "the bucket engine ignores cache_autogrow_max=%d: it "
                    "has no on-device grow; size cache_size for peak keys "
                    "up front", config.cache_autogrow_max)
            return BucketEngine(capacity=cap, batch_rows=config.batch_rows,
                                mesh=mesh)
        return ShardedEngine(
            capacity=cap, batch_rows=config.batch_rows,
            auto_grow_limit=autogrow_limit_per_shard(
                config.cache_autogrow_max, mesh.n, cap), mesh=mesh)

    # ---- peers (gubernator.go › SetPeers) ------------------------------

    def set_peers(self, infos: Sequence[PeerInfo]) -> None:
        """Build a new ring from ``infos`` and swap it in, keeping the
        clients of peers that stay and draining those of peers that
        left; the health gate starts afresh.  Keys re-home and moved
        keys start afresh (the reference's behavior), unless
        ``handover_on_reshard`` hands their rows to the new owners."""
        have_others = any(info.grpc_address != self._self_addr
                          for info in infos)
        # in mesh mode the ring changes and the tier's keys leave it with
        # the gate exclusive: no batch routes by one and steps by the other
        with (self._mesh_gate.exclusive() if self._mesh_mode()
              else nullcontext()):
            old_picker, old = self._swap_picker(infos)
            if have_others:
                # the hot set and the mesh tier serve a daemon alone: their
                # keys go back to the table with their consumption
                self._demote_all()
                self._mesh_demote_all()
        for departed in old.values():
            threading.Thread(target=departed.shutdown, daemon=True,
                             name="peer-shutdown").start()
        if self.config.handover_on_reshard and have_others:
            self._start_handover(old_picker, "handover")

    def _swap_picker(self, infos: Sequence[PeerInfo]) -> tuple:
        """Swap in a ring of ``infos``; returns (the old ring, the clients
        of the peers that left)."""
        with self._peer_mu:
            old_picker = self._picker  # immutable: the handover's "before"
            old = {p.info.grpc_address: p for p in self._picker.peers()}
            picker = self._picker.new()
            for info in infos:
                existing = old.pop(info.grpc_address, None)
                picker.add(existing if existing is not None else
                           PeerClient(info, self.config.behaviors,
                                      metrics=self.metrics,
                                      faults=self.faults,
                                      tls_creds=self._peer_tls,
                                      analytics=self._analytics))
            self._picker = picker
            # a membership change invalidates the gated view: the next
            # routing lookup derives it again from live health
            self._gate_bad = frozenset()
            self._gate_picker = None
            self._ring_gen += 1
            gen = self._ring_gen
        self.metrics.ring_generation.set(gen)
        self.metrics.ring_ejected_peers.set(0)
        return old_picker, old

    def peers(self) -> List[PeerClient]:
        with self._peer_mu:
            return self._picker.peers()

    def owner_of(self, key: str) -> Optional[PeerClient]:
        """The owner of ``key`` (name + "_" + unique_key), None alone."""
        with self._peer_mu:
            if not self._picker.peers():
                return None
            return self._picker.get(key)

    def owners_by_raw_khash(self, khash_raw: np.ndarray):
        """The membership owners of RAW (unmixed) FNV-1a key hashes, the
        wire lanes' GLOBAL queue keys: (the ring's peers, an index into
        them per hash), or None alone."""
        with self._peer_mu:
            picker = self._picker
        if not picker.peers():
            return None
        return picker.owner_peers(), picker.owner_indices(mix64_np(
            np.asarray(khash_raw, np.uint64)))

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

    # ---- the health-gated routing ring ----------------------------------

    def _routing_picker(self):
        """The ring requests route by: the membership ring less the peers
        whose circuit stayed open for ``peer_eject_after_ms`` (their keys
        rehome to the next ring point, as on a ring built without them),
        readmitted after ``peer_readmit_after_ms`` recovered.  It never
        empties the ring, and while nothing is ejected it is the
        membership ring itself (one lock and one health read a peer).  A
        flip bumps the generation and emits ``ring_ejected`` /
        ``ring_readmitted`` off the lock."""
        b = self.config.behaviors
        if not b.peer_health_gate:
            with self._peer_mu:
                return self._picker
        eject_s = max(int(b.peer_eject_after_ms), 0) / 1e3
        readmit_s = max(int(b.peer_readmit_after_ms), 0) / 1e3
        with self._peer_mu:
            picker = self._picker
            peers = picker.peers()
            if not peers:
                return picker
            bad = frozenset(
                p.info.grpc_address for p in peers
                if not self.is_self(p)
                and not p.route_healthy(eject_s, readmit_s))
            if len(bad) >= len(peers):
                # every peer unhealthy: the membership ring is the
                # least wrong answer
                bad = frozenset()
            if bad == self._gate_bad:
                return (self._gate_picker
                        if self._gate_picker is not None else picker)
            old_bad = self._gate_bad
            old_routing = (self._gate_picker
                           if self._gate_picker is not None else picker)
            gated = None
            if bad:
                gated = picker.new()
                for p in peers:
                    if p.info.grpc_address not in bad:
                        gated.add(p)
            self._gate_bad = bad
            self._gate_picker = gated
            self._ring_gen += 1
            gen = self._ring_gen
        self.metrics.ring_generation.set(gen)
        self.metrics.ring_ejected_peers.set(len(bad))
        for addr in sorted(bad - old_bad):
            log.warning("ring: peer %s EJECTED from routing (circuit open "
                        "> %.1fs); its keys rehome until readmit", addr,
                        eject_s)
            self.recorder.record("ring_ejected", peer=addr, generation=gen)
        for addr in sorted(old_bad - bad):
            log.info("ring: peer %s readmitted to routing (recovered "
                     "> %.1fs)", addr, readmit_s)
            self.recorder.record("ring_readmitted", peer=addr,
                                 generation=gen)
        if bad:
            self._ensure_probe_loop()
        if self.config.handover_on_reshard:
            # keys moved between live daemons: their rows follow them
            self._start_handover(old_routing, "handover-rehome")
        return gated if gated is not None else picker

    def _route_owner_of(self, key: str) -> Optional[PeerClient]:
        """``owner_of`` through the health-gated ring (where a request
        for ``key`` goes); reconcile targets keep ``owner_of``."""
        picker = self._routing_picker()
        if not picker.peers():
            return None
        return picker.get(key)

    def _ensure_probe_loop(self) -> None:
        with self._gm_mu:
            if self._probe_loop is None and not self._closed:
                iv = max(int(self.config.behaviors.peer_circuit_cooldown_ms),
                         100)
                self._probe_loop = IntervalLoop(
                    iv, self._probe_ejected, name="ring-health-probe")

    def _probe_ejected(self) -> None:
        """One empty flush to every ejected peer, so a recovered peer's
        circuit can close (its rehomed keys send it no traffic); a
        failure keeps the circuit open."""
        with self._peer_mu:
            bad = self._gate_bad
            peers = list(self._picker.peers())
        for p in peers:
            if p.info.grpc_address in bad:
                try:
                    p.probe()
                except Exception:  # noqa: BLE001 - best effort
                    pass

    # ---- handover of moved rows ------------------------------------------

    @staticmethod
    def _uses_default_hash(picker) -> bool:
        """Routing by table key hash is valid only on the default hash
        pipeline (the table's keys ARE mixed FNV-1a of the identity);
        a region picker needs it in every region."""
        pickers = (list(picker.regions.values())
                   if isinstance(picker, RegionPeerPicker) else [picker])
        return all(getattr(pk, "_hash", None) is mixed_fnv1a64
                   for pk in pickers)

    def _start_handover(self, old_picker, name: str) -> None:
        with self._handover_gen_mu:
            self._handover_gen += 1
            gen = self._handover_gen
        threading.Thread(target=self._handover_moved_rows,
                         args=(old_picker, gen), daemon=True,
                         name=name).start()

    def _handover_superseded(self, gen: int) -> bool:
        with self._handover_gen_mu:
            return self._handover_gen != gen

    def _handover_moved_rows(self, old_picker, gen: int) -> None:
        """Send every live row this daemon OWNED under ``old_picker`` and
        no longer owns on the routing ring to its new owner
        (UpdatePeerGlobals with ``key_hash`` and ``eff_ms``, so a leaky
        row's fixed point moves losslessly), then drop it here.  Rows
        held only as another owner's replicas stay.  The moved rows are
        picked by ``owner_indices`` over the snapshot's whole key
        column.  A delivery that fails three times leaves its rows in
        place (the new owner then serves a fresh bucket, the
        reference's reset).  A newer pass (``gen``) supersedes this one
        before its next chunk."""
        picker = self._routing_picker()
        if not self._uses_default_hash(picker) or (
                old_picker.peers()
                and not self._uses_default_hash(old_picker)):
            log.warning("handover_on_reshard needs the default picker "
                        "hash; skipping handover")
            return
        with self._handover_mu:
            if self._handover_superseded(gen):
                return
            with self._engine_mu:
                snap = self.engine.snapshot()
            keys = np.asarray(snap["key"], np.uint64)
            if not keys.size:
                return
            try:
                moved = np.ones(keys.size, bool)
                if old_picker.peers():
                    # only rows we owned may move (alone we owned all)
                    old_self = [i for i, p in enumerate(
                        old_picker.owner_peers()) if self.is_self(p)]
                    moved &= np.isin(old_picker.owner_indices(keys),
                                     old_self)
                new_peers = picker.owner_peers()
                new_owner = picker.owner_indices(keys)
            except RuntimeError:
                return  # the ring emptied meanwhile
            new_self = [i for i, p in enumerate(new_peers)
                        if self.is_self(p)]
            moved &= ~np.isin(new_owner, new_self)
            if not moved.any():
                return
            limit = self.config.behaviors.global_batch_limit
            sent = 0
            targets = np.unique(new_owner[moved])
            for pi in targets.tolist():
                peer = new_peers[pi]
                addr = peer.info.grpc_address
                rows = np.nonzero(moved & (new_owner == pi))[0]
                for a in range(0, rows.size, limit):
                    if self._handover_superseded(gen):
                        log.info("handover superseded after %d rows", sent)
                        return
                    chunk = rows[a:a + limit]
                    if self._deliver_rows(peer, addr, snap, chunk):
                        with self._engine_mu:
                            self.engine.remove_rows(keys[chunk])
                        sent += int(chunk.size)
            log.info("handover: moved %d rows to %d peers", sent,
                     targets.size)
            self.recorder.record("handover", rows=sent,
                                 peers=int(targets.size))

    def _deliver_rows(self, peer, addr: str, snap: dict, rows) -> bool:
        """Snapshot ``rows`` as UpdatePeerGlobal messages to ``peer``;
        three attempts (the upsert is idempotent), True once delivered.
        ``remaining`` is the raw value (a leaky row's fixed point): the
        receiver sees ``eff_ms`` and does not rescale it."""
        from .proto import gubernator_pb2 as pb
        from .proto import peers_pb2 as peers_pb

        col = {f: np.asarray(snap[f])[rows].tolist()
               for f in ("key", "meta", "eff_ms", "duration", "t_ms",
                         "burst", "limit", "remaining", "expire_at")}
        batch = [peers_pb.UpdatePeerGlobal(
            key_hash=k, eff_ms=max(eff, 1), algorithm=meta & 1,
            duration=dur, created_at=t, burst=burst,
            update=pb.RateLimitResp(status=(meta >> 1) & 1, limit=lim,
                                    remaining=rem, reset_time=exp))
            for k, meta, eff, dur, t, burst, lim, rem, exp in zip(
                col["key"], col["meta"], col["eff_ms"], col["duration"],
                col["t_ms"], col["burst"], col["limit"], col["remaining"],
                col["expire_at"])]
        for attempt in range(3):
            try:
                peer.update_peer_globals(batch)
                return True
            except Exception as e:  # noqa: BLE001 - retried, then left
                log.warning("handover to %s failed (attempt %d/3): %s",
                            addr, attempt + 1, exc_text(e))
                self.recorder.record_error("handover_error", e, peer=addr,
                                           attempt=attempt + 1)
                time.sleep(0.5 * (attempt + 1))
        return False

    def _ensure_global_manager(self) -> GlobalManager:
        with self._gm_mu:
            if self.global_manager is None:
                self.global_manager = GlobalManager(
                    self, self.config.behaviors, self.metrics)
            return self.global_manager

    def _ensure_mr_manager(self) -> MultiRegionManager:
        with self._gm_mu:
            if self.mr_manager is None:
                self.mr_manager = MultiRegionManager(
                    self, self.config.behaviors)
            return self.mr_manager

    def region_pickers(self) -> dict:
        """The ring of each region (region_picker.go); without a region
        the one ring, under this daemon's (empty) region name."""
        with self._peer_mu:
            if isinstance(self._picker, RegionPeerPicker):
                return dict(self._picker.regions)
            return {self.config.data_center: self._picker}

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
        self.dispatcher.admit(
            len(reqs), tenant_cb=lambda: self._tenant_of_reqs(reqs))
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
        if self._mesh_mode():
            with self._mesh_routing(reqs, now) as served:
                out = self._get_rate_limits_routed(reqs, now, served)
            if served:
                self._mesh_fold_if_late()
            return out
        return self._get_rate_limits_routed(reqs, now, None)

    def _get_rate_limits_routed(self, reqs, now, mesh_served
                                ) -> List[RateLimitResponse]:
        """The object lane's routing and steps; ``mesh_served`` maps the
        request indices the mesh tier serves to their key hashes (None
        outside mesh mode)."""
        responses: List[Optional[RateLimitResponse]] = [None] * len(reqs)
        local_idx: List[int] = []
        hot: List[tuple] = []  # (request index, key hash): the hot set
        meshl: List[tuple] = []  # (request index, key hash): mesh tier
        glob_q: List[tuple] = []  # (request, we own it), after the step
        fwd: List[tuple] = []  # (request index, owner, request)
        deg_local: List[tuple] = []  # (request index, membership owner)
        membership = self._clustered_picker()
        # the routing ring, hoisted out of the loop; beside the
        # membership ring it tells a rehomed row (a degraded serve)
        rpick = (self._routing_picker() if membership is not None
                 else None)
        gate_active = rpick is not None and rpick is not membership
        GLOBAL = int(Behavior.GLOBAL)  # hot loop: plain-int flag tests
        MULTI_REGION = int(Behavior.MULTI_REGION)
        EXCL = int(self._DEGRADED_EXCLUDED)
        # alone, GLOBAL keys may ride the mesh tier (mesh mode) or else
        # the hot set
        mesh_on = membership is None and bool(mesh_served)
        hot_on = (membership is None and self.config.hot_set_capacity > 0
                  and self._row_engine()
                  and self._global_mode != "mesh")
        # a batch that may send a GLOBAL key to the table holds the
        # promotion gate from routing through its step: a pin then
        # waits for it, so its seed row holds every hit routed
        # before (JAX's promotion may read the row before them)
        with (self._promote_gate.shared() if hot_on else nullcontext()):
            for i, req in enumerate(reqs):
                if not req.unique_key:
                    responses[i] = RateLimitResponse(
                        error="field 'unique_key' cannot be empty")
                elif not req.name:
                    responses[i] = RateLimitResponse(
                        error="field 'name' cannot be empty")
                elif int(req.behavior) & GLOBAL:
                    if mesh_on and i in mesh_served:
                        meshl.append((i, mesh_served[i]))
                        continue
                    if hot_on and self._hot_route(req, hot, i):
                        continue
                    # answered from the local replica; reconciled later
                    # with the membership owner (GLOBAL takes precedence
                    # over MULTI_REGION)
                    local_idx.append(i)
                    if membership is not None:
                        glob_q.append(
                            (req, self.is_self(membership.get(req.key))))
                elif membership is None:
                    local_idx.append(i)
                    if int(req.behavior) & MULTI_REGION:
                        self._ensure_mr_manager().queue_hits(
                            _req_stamped(req, now))
                else:
                    owner = rpick.get(req.key)
                    # beside the gate, a row's membership owner tells
                    # whether the gate rehomed it
                    mowner = (membership.get(req.key) if gate_active
                              else owner)
                    if not self.is_self(owner):
                        fwd.append((i, owner, req, mowner is not owner))
                        continue
                    local_idx.append(i)
                    if (gate_active and not int(req.behavior) & EXCL
                            and not self.is_self(mowner)):
                        deg_local.append((i, mowner.info.grpc_address))
                    # the local region's owner replicates to the others
                    if int(req.behavior) & MULTI_REGION:
                        self._ensure_mr_manager().queue_hits(
                            _req_stamped(req, now))
            # forwards first, so their RPCs overlap the device step
            futures = self._forward_rows(fwd, now)
            over = 0
            if meshl:
                m_reqs = [reqs[i] for i, _ in meshl]
                m_resps = self._meshglobal.check_batch(
                    m_reqs, [h for _, h in meshl], now)
                for (i, _), resp in zip(meshl, m_resps):
                    responses[i] = resp
                    over += resp.status == Status.OVER_LIMIT
                # the Store's write-through covers mesh keys too (home
                # replica values are exact)
                self._after_local(m_reqs, m_resps)
            if hot:
                hot_reqs = [reqs[i] for i, _ in hot]
                hot_resps = self._hotset.check_batch(
                    hot_reqs, [h for _, h in hot], now)
                for (i, _), resp in zip(hot, hot_resps):
                    responses[i] = resp
                    over += resp.status == Status.OVER_LIMIT
                # the Store's write-through covers hot keys too (replica
                # values; the next fold supersedes them)
                self._after_local(hot_reqs, hot_resps)
            if local_idx:
                local_reqs = [reqs[i] for i in local_idx]
                self._read_through(local_reqs)
                local = self.dispatcher.check_batch(local_reqs, now)
                for i, resp in zip(local_idx, local):
                    responses[i] = resp
                    over += resp.status == Status.OVER_LIMIT
                self._after_local(local_reqs, local)
        if deg_local:
            # rows rehomed here by an ejection: flagged, and their hits
            # reconciled to the membership owner once it is back
            gm = self._ensure_global_manager()
            for i, addr in deg_local:
                resp = responses[i]
                if resp.error:
                    continue
                self._flag_degraded(resp, addr)
                gm.queue_hits(_req_stamped(reqs[i], now), degraded=True)
                self.metrics.degraded_served.labels(peer_addr=addr).inc()
                self._note_degraded(addr, 1, name=reqs[i].name, log=False)
        if glob_q:
            # only now: a broadcast tick before the step above would
            # gather a row that does not exist yet and drop the update
            gm = self._ensure_global_manager()
            for req, own in glob_q:
                if own:
                    gm.queue_update(req)
                else:
                    gm.queue_hits(_req_stamped(req, now))
        if self._promote_pending:
            self._drain_promotions(now)
        b = self.config.behaviors
        timeout = (b.batch_timeout_ms + b.batch_wait_ms) / 1000.0 + 30.0
        failed = 0
        deg_failed: List[tuple] = []  # (request index, request, owner)
        for i, f, addr, req in futures:
            try:
                responses[i] = f.result(timeout=timeout)
                over += responses[i].status == Status.OVER_LIMIT
            except Exception as e:  # noqa: BLE001 - the row's answer
                failed += 1
                self._count_failed_forward(addr, e, 1)
                if (b.peer_degraded_fallback
                        and not int(req.behavior) & EXCL):
                    deg_failed.append((i, req, addr))
                else:
                    responses[i] = RateLimitResponse(
                        error=f"while fetching rate limit from peer "
                              f"{addr}: {exc_text(e)}")
        if deg_failed:
            over += self._degrade_failed_objects(deg_failed, responses, now)
        self.metrics.over_limit_counter.inc(over)
        if futures:
            self._count_forward(len(futures), failed)
        self._maybe_sweep(now)
        return responses  # type: ignore[return-value]

    def _degrade_failed_objects(self, deg_failed, responses, now) -> int:
        """The object lane's failed forwards served degraded: one local
        step, the answers flagged and their hits queued to the owner;
        returns the OVER_LIMIT answers.  If the step fails the rows
        answer error rows."""
        try:
            dresps = self.dispatcher.check_batch(
                [req for _, req, _ in deg_failed], now)
        except Exception as e:  # noqa: BLE001 - error rows, not a failed batch
            for i, _req, addr in deg_failed:
                responses[i] = RateLimitResponse(
                    error=f"while fetching rate limit from peer {addr}: "
                          f"{exc_text(e)}")
            return 0
        gm = self._ensure_global_manager()
        over = flagged = 0
        for (i, req, addr), resp in zip(deg_failed, dresps):
            if not resp.error:
                self._flag_degraded(resp, addr)
                gm.queue_hits(_req_stamped(req, now), degraded=True)
                self.metrics.degraded_served.labels(peer_addr=addr).inc()
                over += resp.status == Status.OVER_LIMIT
                flagged += 1
            responses[i] = resp
        self._note_degraded(deg_failed[0][2], flagged,
                            name=deg_failed[0][1].name,
                            rows=len(deg_failed))
        return over

    def _note_degraded(self, peer: str, flagged: int, khash=None,
                       name=None, log: bool = True, **ev) -> None:
        """The tenant, trace and event of a degraded serve of
        ``flagged`` rows (those counted in gubernator_degraded_served):
        the tenant ledger's ``degraded`` rows, the trace force-sampled,
        and (``log``) a ``degraded`` event naming the tenant and span."""
        ana = self.analytics
        tenant = None
        if ana is not None:
            tenant = ana.tenant_hint(khash=khash, name=name)
            if flagged:
                ana.tap_flag("degraded", flagged, khash=khash,
                             tenant=None if khash is not None else tenant)
        force_sample("degraded")
        if not log:
            return
        ev.setdefault("rows", flagged)
        if tenant is not None:
            ev["tenant"] = tenant
        sid = current_span_id()
        if sid is not None:
            ev["span_id"] = sid
        self.recorder.record("degraded", peer=peer, **ev)

    def _tenant_of_reqs(self, reqs) -> Optional[str]:
        """A shed's tenant on the object lane (run only when it sheds)."""
        ana = self.analytics
        if ana is None or not reqs:
            return None
        return ana.tenant_hint(name=reqs[0].name)

    def _tenant_of_wire(self, data: bytes) -> Optional[str]:
        """A shed's tenant on the wire lanes: the first request's name,
        walked in Python (run only when it sheds)."""
        ana = self.analytics
        if ana is None:
            return None
        try:
            from .analytics import iter_wire_names

            pairs = iter_wire_names(data)
        except Exception:  # noqa: BLE001 - a hint only
            return None
        return ana.tenant_hint(name=pairs[0][0]) if pairs else None

    @staticmethod
    def _flag_degraded(resp: RateLimitResponse, addr: str) -> None:
        resp.metadata["degraded"] = "true"
        resp.metadata["degraded_peer"] = addr

    def _forward_rows(self, fwd, now: int) -> list:
        """The object lane's forwards, ``fwd`` = [(request index, owner,
        request, whether this daemon's gate rehomed it)]: [(request
        index, future of its answer, owner address, request)].  An
        owner's batched rows ride one entry of its forward lane (its
        rehome lane for the rehomed rows: a key's rows are all or none),
        in the batch's order, so the owner applies a key's rows as the
        caller sent them (JAX forwards one entry a row, and two of one
        key may ride concurrent flushes in either order: ROADMAP §C.2);
        NO_BATCHING rows go one RPC each."""
        out, groups = [], {}
        for i, peer, req, rehomed in fwd:
            addr = peer.info.grpc_address
            if int(req.behavior) & int(Behavior.NO_BATCHING):
                out.append((i, self._forward_one(peer, req, now, rehomed),
                            addr, req))
            else:
                groups.setdefault((addr, rehomed), (peer, []))[1].append(
                    (i, req))
        for (addr, rehomed), (peer, rows) in groups.items():
            sent = [_req_stamped(req, now) for _, req in rows]
            try:
                whole = peer.enqueue_many(sent, rehomed=rehomed)
            except Exception as e:  # noqa: BLE001 - circuit open, closing
                whole = Future()
                whole.set_exception(e)
            parts = [Future() for _ in rows]

            def split(f: Future, parts=parts) -> None:
                try:
                    for part, resp in zip(parts, f.result()):
                        part.set_result(resp)
                except Exception as e:  # noqa: BLE001 - every row's error
                    for part in parts:
                        part.set_exception(e)

            whole.add_done_callback(split)
            out.extend((i, part, addr, req)
                       for (i, req), part in zip(rows, parts))
        return out

    @staticmethod
    def _forward_one(peer: PeerClient, req: RateLimitRequest, now: int,
                     rehomed: bool = False) -> Future:
        """A future of a NO_BATCHING ``req``'s answer from its owner,
        stamped with this daemon's clock (first hop wins), in a typed RPC
        of its own on a thread (marked when this daemon's gate
        ``rehomed`` it)."""
        req = _req_stamped(req, now)
        f: Future = Future()

        def go():
            try:
                f.set_result(peer.get_peer_rate_limit(req,
                                                      rehomed=rehomed))
            except Exception as e:  # noqa: BLE001 - to the caller
                f.set_exception(e)

        threading.Thread(target=go, daemon=True,
                         name="peer-forward-nobatch").start()
        return f

    def _maybe_sweep(self, now: int) -> None:
        iv = self.config.sweep_interval_ms
        if iv > 0 and now - self._last_sweep >= iv:
            self._last_sweep = now
            with self._engine_mu:
                self.engine.sweep(now)
            self._hot_decay()

    # ---- the replicated hot set (hotset.py) -----------------------------

    _HOT_EXCLUDED = (Behavior.RESET_REMAINING | Behavior.DRAIN_OVER_LIMIT
                     | Behavior.DURATION_IS_GREGORIAN | Behavior.MULTI_REGION)

    def _hot_route(self, req: RateLimitRequest, hot, i) -> bool:
        """Route a GLOBAL request of a daemon alone to the hot set if its
        key is pinned, else count it toward promotion.  True when
        routed.  A flagged request or a new config on a pinned key
        demotes it first (counted), so the table serves the live row."""
        qualifies = not int(req.behavior) & int(self._HOT_EXCLUDED)
        kh = hash_key(req.name, req.unique_key)
        hs = self._hotset
        if hs is not None and hs.is_pinned(kh):
            if not qualifies or not hs.matches_pinned(kh, req):
                self.metrics.hot_demotion_counter.labels(
                    reason="flagged" if not qualifies
                    else "config_change").inc()
                self._demote(kh)
                return False
            hot.append((i, kh))
            return True
        if qualifies:
            self._count_toward_promotion(kh, max(int(req.hits), 1), req)
        return False

    def _count_toward_promotion(self, kh: int, weight: int,
                                req: RateLimitRequest) -> None:
        """Promotion bookkeeping by key hash: the decayed counter, raised
        to the sketch's count when analytics is on (the sketch sees every
        lane's waves; the counter keeps a shed tap from starving
        promotion).  ``req`` carries the config the pin adopts."""
        ana = self.analytics
        with self._hot_mu:
            c = self._hot_counts.get(kh, 0) + weight
            self._hot_counts[kh] = c
            if ana is not None:
                c = max(c, ana.sketch_count(kh))
            if c >= self.config.hot_promote_threshold:
                # pinned after this batch's step, so the seed row holds
                # this request's own hits
                self._promote_pending.append((req, kh))
                self._hot_counts.pop(kh, None)
            elif len(self._hot_counts) > 100_000:
                self._decay_counts_locked()

    def _drain_promotions(self, now: int) -> None:
        """Pin the keys promoted by this batch, each seeded from its
        table (or cold) row; ``now`` is the batch's clock.  The caller
        holds no gate."""
        with self._hot_mu:
            pending, self._promote_pending = self._promote_pending, []
        if not pending:
            return
        # no batch is between its routing and its step meanwhile: every
        # hit routed to the table before the pin is in its seed row
        with self._promote_gate.exclusive():
            for req, kh in pending:
                hs = self._ensure_hotset()
                if hs.pin(req, kh, now, seed=self._seed_row(kh)):
                    self._seed_commit(kh)

    def _seed_row(self, kh: int) -> Optional[dict]:
        """The key's row (``remaining``, ``t_ms``, ``expire_at``,
        ``meta``) in the table or else the cold tier, None when it has
        none.  A successful pin is followed by ``_seed_commit``."""
        fields = ("remaining", "t_ms", "expire_at", "meta")
        with self._engine_mu:
            found, cols = self.engine.gather_rows(np.array([kh], np.uint64))
            if not found[0] and self._tier is not None:
                cold = self._tier.peek_row(kh)
                if cold is not None:
                    return {f: cold[f] for f in fields}
        if not found[0]:
            return None
        return {f: int(cols[f][0]) for f in fields}

    def _seed_commit(self, kh: int) -> None:
        """The hot set took the key's state: drop a cold copy, which
        would shadow the row written back at demotion."""
        if self._tier is not None:
            self._tier.pop_row(kh)

    def _demote(self, key_hash: int) -> None:
        """Fold the replicas, write the key's merged row back to the
        table (the cold tier when its bucket is full) and release its
        slot: consumption survives both ways."""
        hs = self._hotset
        if hs is None:
            return
        hs.sync()
        row = hs.row_state(key_hash)
        if row is not None:
            cols = {f: np.array([row[f]]) for f in row}
            with self._engine_mu:
                placed = self.engine.upsert_rows(
                    np.array([key_hash], np.uint64), cols)
                if not placed and self._tier is not None:
                    self._tier.put_row(key_hash,
                                       {f: int(row[f]) for f in row})
        hs.unpin(key_hash)

    def _demote_all(self) -> None:
        """Demote every pinned key: one fold, one batched write-back
        (counted as ``membership_change``, as JAX counts it)."""
        hs = self._hotset
        if hs is None:
            return
        khs = list(hs.slots.keys())
        if not khs:
            return
        self.metrics.hot_demotion_counter.labels(
            reason="membership_change").inc(len(khs))
        hs.sync()
        rows = [(kh, hs.row_state(kh)) for kh in khs]
        rows = [(kh, r) for kh, r in rows if r is not None]
        if rows:
            karr = np.array([kh for kh, _ in rows], np.uint64)
            cols = {f: np.array([r[f] for _, r in rows])
                    for f in rows[0][1]}
            with self._engine_mu:
                placed = self.engine.upsert_rows(karr, cols)
                if placed < len(rows) and self._tier is not None:
                    found, _ = self.engine.gather_rows(karr)
                    for j, (kh, r) in enumerate(rows):
                        if not found[j]:
                            self._tier.put_row(
                                kh, {f: int(r[f]) for f in r})
        for kh in khs:
            hs.unpin(kh)

    # lock-free: the caller holds self._hot_mu
    def _decay_counts_locked(self) -> None:
        """Halve the promotion counters and drop the zeros."""
        self._hot_counts = {k: v // 2 for k, v in self._hot_counts.items()
                            if v // 2 > 0}

    def _hot_decay(self) -> None:
        """Counter decay on the sweep tick: bounds the counters and ages
        out cold keys."""
        with self._hot_mu:
            self._decay_counts_locked()

    def _ensure_hotset(self) -> HotSetEngine:
        """The hot set, one replica on each of the engine's mesh
        devices, and its sync loop, built at the first promotion."""
        with self._gm_mu:
            if self._hotset is None:
                cap = 1 << (self.config.hot_set_capacity - 1).bit_length()
                self._hotset = HotSetEngine(capacity=cap,
                                            mesh=self.engine.mesh)
                self._hot_sync_loop = IntervalLoop(
                    self.config.behaviors.global_sync_wait_ms,
                    self._hotset.sync, name="hotset-sync")
                if self.memledger is not None:
                    self.memledger.enroll("hotset", self._probe_hotset)
            return self._hotset

    # ---- the mesh-resident GLOBAL tier (meshglobal.py) ------------------

    def _mesh_mode(self) -> bool:
        """Whether the mesh reconcile backend is selected, on an engine
        with a mesh (an injected engine may have none: JAX's rule)."""
        return (self._global_mode == "mesh"
                and getattr(self.engine, "mesh", None) is not None)

    def _row_engine(self) -> bool:
        """Whether the engine has the row interface (gather / upsert /
        remove) that the hot set, the cold tier and the GLOBAL replicas
        read and write: the port's engines do, an injected list engine
        (oracle.OracleEngine) does not."""
        return hasattr(self.engine, "gather_rows")

    def _require_packed(self) -> None:
        """The wire lanes step packed columns: an engine without
        ``check_packed`` (an injected list engine) cannot serve them."""
        if not hasattr(self.engine, "check_packed"):
            raise NotImplementedError(
                f"the wire lanes need an engine with a packed interface; "
                f"{type(self.engine).__name__} has none")

    def _mesh_routable(self) -> bool:
        """Mesh routing serves a daemon alone (the hot set's rule: no
        peer but itself) and stands down while the fold is degraded;
        then the owner-sharded path serves, always correct."""
        if not self._mesh_mode() or self._mesh_degraded:
            return False
        peers = self.peers()
        return not peers or all(self.is_self(p) for p in peers)

    def _ensure_meshglobal(self) -> MeshGlobalEngine:
        """The mesh tier over the engine's mesh, enrolled with the memory
        ledger and bound to the bucket engine's fused launch."""
        with self._gm_mu:
            if self._meshglobal is None:
                raw = os.environ.get("GUBER_MESH_GLOBAL_CAP", "")
                try:
                    cap = int(raw) if raw else 4096
                except ValueError:
                    cap = 4096
                cap = 1 << max((cap - 1).bit_length(), 4)
                self._meshglobal = MeshGlobalEngine(
                    self.engine.mesh, capacity=cap,
                    batch_per_chip=self.config.batch_rows)
                if self.memledger is not None:
                    self.memledger.enroll("mesh_global",
                                          self._probe_meshglobal,
                                          advisable=True)
                # the bucket engine decides the tier's rows in its wave's
                # launch; routing still gates on _mesh_routable()
                if hasattr(self.engine, "bind_mesh"):
                    self.engine.bind_mesh(self._meshglobal)
            return self._meshglobal

    @staticmethod
    def _mesh_fallback_after() -> int:
        raw = os.environ.get("GUBER_MESH_FALLBACK_AFTER", "")
        try:
            return max(int(raw), 1) if raw else 3
        except ValueError:
            return 3

    def _mesh_batch_keys(self, reqs) -> tuple:
        """A batch's GLOBAL requests as (their (index, key hash) pairs,
        each key's config for the tier or None).  A key's config is None
        when one of its requests is flagged (RESET_REMAINING, DRAIN,
        Gregorian, MULTI_REGION) or two ask different configs: the tier
        then serves none of its rows in this batch."""
        GLOBAL, EXCL = int(Behavior.GLOBAL), int(self._HOT_EXCLUDED)
        rows: List[tuple] = []
        keys: Dict[int, tuple] = {}  # key hash → (config or None, request)
        for i, req in enumerate(reqs):
            if not (int(req.behavior) & GLOBAL and req.name
                    and req.unique_key):
                continue
            kh = hash_key(req.name, req.unique_key)
            rows.append((i, kh))
            cfg = None if int(req.behavior) & EXCL else _mesh_cfg_of(req)
            have = keys.get(kh)
            if have is None:
                keys[kh] = (cfg, req)
            elif have[0] != cfg:
                keys[kh] = (None, have[1])
        return rows, keys

    def _mesh_change(self, mge: MeshGlobalEngine, kh: int,
                     cfg: Optional[tuple]) -> Optional[str]:
        """What the tier must do for a key before a batch routes it:
        "demote" (pinned, and the batch's rows for it cannot all ride it),
        "pin" (not pinned, its rows all qualify with one config, and the
        admission could place it), or None."""
        if mge.is_pinned(kh):
            return None if cfg is not None and mge.pinned_cfg.get(kh) == cfg \
                else "demote"
        if cfg is not None and (mge.has_room(kh)
                                or self._mesh_overflow_victim(kh) is not None):
            return "pin"
        return None

    def _mesh_apply(self, mge: MeshGlobalEngine, keys: dict,
                    now: int) -> None:
        """Make the changes ``_mesh_change`` names; the caller holds the
        gate exclusive.  A key demoted here is not pinned again in the
        same batch: its rows take the table, which applies a new config
        or a flag in order."""
        if not self._mesh_routable():
            return
        for kh, (cfg, req) in keys.items():
            change = self._mesh_change(mge, kh, cfg)
            if change == "demote":
                self._mesh_demote(kh)
            elif change == "pin":
                self._mesh_admit(req, kh, now)

    @staticmethod
    def _mesh_plan(mge: MeshGlobalEngine, keys: dict) -> Optional[set]:
        """The keys the tier serves in this batch: those pinned with the
        batch's config; None when a pinned key needs demoting first."""
        served = set()
        for kh, (cfg, _) in keys.items():
            if mge.is_pinned(kh):
                if cfg is None or mge.pinned_cfg.get(kh) != cfg:
                    return None
                served.add(kh)
        return served

    @contextmanager
    def _mesh_routing(self, reqs, now: int):
        """Hold the tier's gate for one object-lane batch and yield the
        request indices the tier serves, mapped to their key hashes.  The
        pins and demotions the batch needs are made first, with the gate
        exclusive; the batch then routes and steps with it shared.
        Should another batch change a key between the two, both are made
        again with the gate exclusive, held through the steps."""
        rows, keys = self._mesh_batch_keys(reqs)
        if not keys:
            yield {}
            return
        mge = self._ensure_meshglobal()
        if self._mesh_routable() and any(
                self._mesh_change(mge, kh, cfg) for kh, (cfg, _) in
                keys.items()):
            with self._mesh_gate.exclusive():
                self._mesh_apply(mge, keys, now)
        with self._mesh_gate.shared():
            served = (self._mesh_plan(mge, keys) if self._mesh_routable()
                      else set())
            if served is not None:
                yield {i: kh for i, kh in rows if kh in served}
                return
        with self._mesh_gate.exclusive():
            self._mesh_apply(mge, keys, now)
            served = (self._mesh_plan(mge, keys) if self._mesh_routable()
                      else set())
            yield {i: kh for i, kh in rows if kh in (served or ())}

    def _mesh_admit(self, req: RateLimitRequest, kh: int, now: int) -> bool:
        """Pin ``kh`` under the overflow admission policy: when its probe
        window is full, the coldest pinned occupant (by sketch rank) is
        demoted, exactly, and the pin retried, provided the newcomer
        ranks strictly hotter."""
        mge = self._ensure_meshglobal()
        if mge.pin(req, kh, now, seed=self._seed_row(kh)):
            self._seed_commit(kh)
            return True
        victim = self._mesh_overflow_victim(kh)
        if victim is None:
            return False
        self._mesh_demote(victim)
        self.recorder.record("mesh_overflow_demote", khash=victim,
                             admitted=kh)
        if not mge.pin(req, kh, now, seed=self._seed_row(kh)):
            return False  # the window changed meanwhile: sharded path
        self._seed_commit(kh)
        return True

    def _mesh_overflow_victim(self, kh: int) -> Optional[int]:
        """The coldest pinned occupant of ``kh``'s probe window, or None
        when the newcomer outranks none of them."""
        ana = self.analytics
        mge = self._meshglobal
        if ana is None or mge is None:
            return None
        best, best_rank = None, ana.sketch_count(kh)
        for k in mge.probe_occupants(kh):
            if k == kh:
                continue
            r = ana.sketch_count(k)
            if r < best_rank:
                best, best_rank = k, r
        return best

    def _mesh_demote(self, key_hash: int) -> None:
        """Move one mesh key's HOME replica row back into the table (the
        cold tier when its window is full; exact without a fold), then
        retire its slot.  The caller holds the gate exclusive: no wave
        routed to the tier is still to run."""
        mge = self._meshglobal
        if mge is None:
            return
        row = mge.row_state(key_hash)
        if row is not None:
            cols = {f: np.array([row[f]]) for f in row}
            with self._engine_mu:
                placed = self.engine.upsert_rows(
                    np.array([key_hash], np.uint64), cols)
                if not placed and self._tier is not None:
                    self._tier.put_row(key_hash,
                                       {f: int(row[f]) for f in row})
        mge.unpin(key_hash)

    def _mesh_demote_all(self) -> None:
        """Demote every mesh key in one batched write-back (a peer
        joining, the stand-down, a snapshot): home rows need no fold,
        so this works when the fold is what broke.  The caller holds the
        gate exclusive."""
        mge = self._meshglobal
        if mge is None:
            return
        khs = mge.pinned_keys()
        if not khs:
            return
        rows = [(kh, mge.row_state(kh)) for kh in khs]
        rows = [(kh, r) for kh, r in rows if r is not None]
        if rows:
            karr = np.array([kh for kh, _ in rows], np.uint64)
            cols = {f: np.array([r[f] for _, r in rows])
                    for f in rows[0][1]}
            with self._engine_mu:
                placed = self.engine.upsert_rows(karr, cols)
                if placed < len(rows) and self._tier is not None:
                    found, _ = self.engine.gather_rows(karr)
                    for j, (kh, r) in enumerate(rows):
                        if not found[j]:
                            self._tier.put_row(
                                kh, {f: int(r[f]) for f in r})
        for kh in khs:
            mge.unpin(kh)

    def _mesh_reconcile_tick(self) -> None:
        """The GLOBAL manager's mesh backend, on its hits tick: swap the
        accumulators, queue the fold, account generation and staleness,
        and run the degraded fallback.  Never raises."""
        if not self._mesh_mode():
            return
        mge = self._meshglobal
        if mge is None:
            return
        with self._mesh_tick_mu:
            ok = self._mesh_fold_once(mge)
        if not ok:
            if (self._mesh_fail_streak >= self._mesh_fallback_after()
                    and not self._mesh_degraded):
                self._mesh_stand_down()
            return
        if (self._mesh_degraded
                and time.monotonic() >= self._mesh_down_until):
            # the cooldown is over and a fold succeeded: re-arm the tier
            with self._mesh_gate.exclusive():
                self._mesh_degraded = False
            self.metrics.mesh_global_degraded.set(0)
            self.recorder.record("mesh_recovered",
                                 generation=mge.generation)

    def _mesh_fold_once(self, mge: MeshGlobalEngine) -> bool:
        """One swap and fold with its faultpoints and accounting; False
        when it failed (the unfolded hits keep accumulating).  The
        caller holds ``_mesh_tick_mu``."""
        t0 = time.perf_counter()
        self._mesh_last_try = time.monotonic()
        try:
            self._fault_point("global_accum_swap")
            copy = mge.retire_accum()
            self._fault_point("global_psum")
            mge.fold(copy)
        except Exception as e:  # noqa: BLE001 - incl. FaultInjected
            # nothing to undo: the unfolded hits stay in the accumulators
            self.metrics.mesh_global_fold_errors.inc()
            self._mesh_fail_streak += 1
            log.warning("mesh-GLOBAL fold failed (streak %d): %s",
                        self._mesh_fail_streak, exc_text(e))
            return False
        dt = time.perf_counter() - t0
        self._mesh_fail_streak = 0
        self.metrics.mesh_global_folds.inc()
        self.metrics.mesh_global_staleness.set(mge.last_staleness_s)
        self.metrics.mesh_global_keys.set(len(mge.slots))
        # the coherence epoch on later waves, and the fold's time as
        # its own phase
        self.dispatcher.reconcile_gen = mge.generation
        self.dispatcher._obs_phase("global_fold", dt)
        self._mesh_last_fold_ok = time.monotonic()
        ana = self.analytics
        if ana is not None:
            # one cost-model sample: the replicated columns and the
            # accumulator across mge.n devices
            ana.tap_cost("global_fold", mge.fold_nbytes, mge.n, dt)
        return True

    def _mesh_fold_if_late(self) -> None:
        """Fold from a serving thread, after its batch and outside the
        gate, once the oldest unfolded hit is half a reconcile interval
        old and no fold was tried for half of one.  Under load the
        tick's thread waits for the GIL behind the serving threads (its
        wake-up came up to 268 ms after a 100 ms sleep under 8 callers on
        an H100 host, PERF.md section 6), a caller's batch ends tens of
        ms apart, and
        the staleness bound is twice the interval.  The stand-down and
        the recovery stay with the tick."""
        mge = self._meshglobal
        if mge is None or self._mesh_degraded:
            return
        now = time.monotonic()
        age = mge.unfolded_age_s(now)
        half = self.config.behaviors.global_sync_wait_ms / 2000.0
        if age is None or age < half or now - self._mesh_last_try < half:
            return
        if not self._mesh_tick_mu.acquire(blocking=False):
            return  # the tick, or another caller, is folding
        try:
            self._mesh_fold_once(mge)
        finally:
            self._mesh_tick_mu.release()

    def _mesh_stand_down(self) -> None:
        """Degraded fallback: demote every pinned key to the
        owner-sharded path (exact) and route GLOBAL traffic there until
        a fold succeeds after the cooldown: staleness, never
        unavailability."""
        cooldown = max(
            self.config.behaviors.global_sync_wait_ms, 100) * 10 / 1000.0
        self._mesh_down_until = time.monotonic() + cooldown
        # the flag and the demotion with the gate exclusive: a batch sees
        # the tier up with its keys or down without them
        with self._mesh_gate.exclusive():
            self._mesh_degraded = True
            self.metrics.mesh_global_degraded.set(1)
            self.recorder.record("mesh_degraded",
                                 streak=self._mesh_fail_streak,
                                 cooldown_s=round(cooldown, 3))
            try:
                self._mesh_demote_all()
            except Exception:  # noqa: BLE001 - the demotion is best effort
                log.exception("mesh-GLOBAL stand-down demotion")

    def _wire_mesh_runner(self, parsed: dict, now: int):
        """The columnar mesh-GLOBAL flow (the wire lane's ``_mesh_route``):
        qualifying GLOBAL rows are pinned on first touch, in one batched
        upload, and served by the mesh tier; the rest take the engine's
        step.  On the bucket engine the whole batch is ONE wave whose
        ``mslot`` column carries each mesh row's slot (the fused mesh
        launch); the classic engine serves the mesh rows through the
        tier's own waves.  Returns a zero-argument runner, or None when
        a pinned key's config changed (the protobuf lane demotes it
        with its state)."""
        n = parsed["n"]
        kh = mix64_np(parsed["khash_raw"])
        kh = np.where(kh == 0, np.uint64(1), kh)
        batch, errs = pack_columns(
            kh, parsed["hits"], parsed["limit"], parsed["duration"],
            parsed["algorithm"], parsed["behavior"], parsed["burst"], now,
            created_at=parsed["created_at"])
        beh = np.asarray(batch.behavior)
        glob_mask = (beh & int(Behavior.GLOBAL)) != 0
        excluded = (beh & int(self._HOT_EXCLUDED)) != 0
        mesh_mask = glob_mask & ~excluded & np.asarray(batch.valid)
        mge = self._ensure_meshglobal()
        # the caller holds the gate shared: keys to pin or to demote raise
        # _MeshChanges, and the caller makes the changes with the gate
        # exclusive, then runs the batch again
        flagged = glob_mask & excluded & np.asarray(batch.valid)
        keys = {k: (None, None) for k in np.unique(kh[flagged]).tolist()}
        if mesh_mask.any():
            cfg = np.stack([np.asarray(batch.algorithm, np.int64),
                            batch.limit, batch.duration, batch.burst])
            midx = np.nonzero(mesh_mask)[0]
            uniq, first, inv = np.unique(kh[midx], return_index=True,
                                         return_inverse=True)
            # one config a key a batch: a change within the batch takes
            # the protobuf lane, which serves it per request
            head = cfg[:, midx[first]]
            if (cfg[:, midx] != head[:, inv]).any():
                return None
            for j, k in enumerate(uniq.tolist()):
                if k in keys:
                    continue  # flagged rows too: the tier serves none
                i = int(midx[first[j]])
                proto = RateLimitRequest(
                    name="", unique_key="", hits=int(batch.hits[i]),
                    limit=int(head[1, j]), duration=int(head[2, j]),
                    algorithm=int(head[0, j]), behavior=int(beh[i]),
                    burst=int(head[3, j]))
                keys[k] = (_mesh_cfg_of(proto), proto)
        if any(self._mesh_change(mge, k, cfg) is not None
               for k, (cfg, _) in keys.items()):
            raise _MeshChanges(keys)
        if mesh_mask.any():
            # keys left unpinned (no room, nothing colder, or a flag):
            # the sharded path
            on = np.array([mge.is_pinned(k) and keys[k][0] is not None
                           for k in uniq.tolist()])
            mesh_mask[midx[~on[inv]]] = False
        mslot = None
        if getattr(self.engine, "mesh_bound", False) and mesh_mask.any():
            midx = np.nonzero(mesh_mask)[0]
            uniq, inv = np.unique(kh[midx], return_inverse=True)
            with mge._mu:
                slot = np.array([mge.slots.get(k, -1)
                                 for k in uniq.tolist()], np.int32)
            mslot = np.full(n, -1, np.int32)
            mslot[midx] = slot[inv]
            # a key unpinned meanwhile: the sharded path is correct
            mesh_mask = mslot >= 0
            if not mesh_mask.any():
                mslot = None

        def run_fused() -> bytes:
            cols = self.dispatcher.check_packed(batch, kh, now, mslot=mslot)
            errors = dict(errs) if errs else {}
            for j in np.nonzero(cols[4] & (mslot >= 0))[0].tolist():
                errors.setdefault(j, "mesh-global row lost")
            return self._columns_to_bytes(cols, 0, n, errors)

        if mslot is not None:
            return run_fused

        def run() -> bytes:
            status = np.zeros(n, np.int32)
            lim_o = np.zeros(n, np.int64)
            rem = np.zeros(n, np.int64)
            rst = np.zeros(n, np.int64)
            full = np.zeros(n, bool)
            errors = dict(errs) if errs else {}
            if (~mesh_mask).any():
                idx = np.nonzero(~mesh_mask)[0]
                sub = type(batch)(*[np.asarray(c)[idx] for c in batch])
                s_st, s_lim, s_rem, s_rst, s_full = \
                    self.dispatcher.check_packed(sub, kh[idx], now)
                status[idx] = s_st
                lim_o[idx] = s_lim
                rem[idx] = s_rem
                rst[idx] = s_rst
                full[idx] = s_full
            if mesh_mask.any():
                idx = np.nonzero(mesh_mask)[0]
                sub = type(batch)(*[np.asarray(c)[idx] for c in batch])
                m_st, m_rem, m_rst, m_lim, m_lost = mge.check_columns(
                    sub, kh[idx], now)
                status[idx] = m_st
                rem[idx] = m_rem
                rst[idx] = m_rst
                lim_o[idx] = m_lim
                for j in np.nonzero(m_lost)[0].tolist():
                    errors.setdefault(int(idx[j]), "mesh-global row lost")
            return self._columns_to_bytes(
                (status, lim_o, rem, rst, full), 0, n, errors)

        return run

    def health_check(self) -> HealthCheckResponse:
        """reference: gubernator.go › HealthCheck: healthy and the peer
        count, or unhealthy with the GLOBAL manager's last error (a
        failed hits flush or broadcast, for ERROR_TTL_S), else the
        MULTI_REGION manager's (a failed send or an aborted tick).
        Refreshes the table gauges (live rows, capacity, dropped rows
        and, on the bucket engine, the share of full buckets) from one
        device reduction under the engine lock."""
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
        gm, mr = self.global_manager, self.mr_manager
        err = gm.last_error if gm is not None else ""
        if not err and mr is not None:
            err = mr.last_error
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
        # the ingest step: to the job's hand-off to the dispatcher (or
        # the call's end where none is handed over)
        with step("ingest", self.dispatcher, until_submit=True):
            self._fault_point("wire_ingest")
            self._require_packed()
            data = bytes(data) if not isinstance(data, bytes) else data
            if self.store is not None:
                # every answer passes the Store: the object path
                return self._wire_pb2(data, now_ms)
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
                glob = bool(parsed["behavior_or"] & int(Behavior.GLOBAL))
                # alone, GLOBAL batches take the hot set's routing under the
                # promotion gate (see _get_rate_limits), or the mesh tier's
                # under its gate; a pinned key that needs demoting sends the
                # batch to the protobuf lane, before any state changes
                gated = (picker is None and glob
                         and self.config.hot_set_capacity > 0
                         and self._global_mode != "mesh")
                if glob and self._mesh_mode():
                    out = self._wire_parsed_mesh(parsed, data, now)
                else:
                    with (self._promote_gate.shared() if gated
                          else nullcontext()):
                        out = self._wire_parsed(parsed, data, now,
                                                picker, glob)
                if out is None:
                    return self._wire_pb2(data, now_ms)
                if gated and self._promote_pending:
                    self._drain_promotions(now)
                return out
            return self._wire_pb2(data, now_ms)

    def _wire_parsed_mesh(self, parsed: dict, data: bytes,
                          now: int) -> Optional[bytes]:
        """A parsed GLOBAL batch in mesh mode, under the tier's gate held
        shared, the ring read under it (a peer joining demotes with the
        gate exclusive).  The pins and demotions it needs are made with
        the gate exclusive, and the batch runs again; should it need more
        then, the protobuf lane takes it (None)."""
        for again in (False, True):
            try:
                with self._mesh_gate.shared():
                    out = self._wire_parsed(parsed, data, now,
                                            self._clustered_picker(), True)
                self._mesh_fold_if_late()
                return out
            except _MeshChanges as e:
                if again:
                    return None
                with self._mesh_gate.exclusive():
                    self._mesh_apply(self._ensure_meshglobal(), e.keys, now)
        return None

    def _wire_parsed(self, parsed: dict, data: bytes, now: int, picker,
                     glob: bool) -> Optional[bytes]:
        """A parsed batch through its lane: clustered, the hot set's
        (alone, GLOBAL rows) or local; None when the hot set's routing
        hands it to the protobuf lane.  MULTI_REGION rows (not GLOBAL: it
        takes precedence) queue their replication after the step."""
        n = parsed["n"]
        if picker is not None:
            lane = "wire_clustered"
            run = lambda: self._wire_check_clustered(  # noqa: E731
                parsed, data, now, picker)
        else:
            if glob:
                lane = "wire_hotset"
                inner = self._wire_global_runner(parsed, now)
                if inner is None:
                    return None
            else:
                lane = "wire_local"
                inner = lambda: self._wire_check_columns(  # noqa: E731
                    parsed, now)

            def run():
                out = inner()
                if parsed["behavior_or"] & int(Behavior.MULTI_REGION):
                    beh = parsed["behavior"]
                    mr = (((beh & int(Behavior.MULTI_REGION)) != 0)
                          & ((beh & int(Behavior.GLOBAL)) == 0))
                    if mr.any():
                        self._queue_mr_raw(parsed, data, mr, stamp_ms=now)
                return out
        self.dispatcher.admit(n, tenant_cb=lambda: self._tenant_of_wire(data))
        ana = self.analytics
        if ana is not None:
            # the tenants learn new keys from the bytes, on the worker
            ana.tap_wire_names(data, parsed["khash_raw"], raw=True)

        def run_and_sweep():
            out = run()
            self._maybe_sweep(now)
            return out

        return self._counted("api", n, lane, run_and_sweep)

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
            self.dispatcher.admit(
                pre.n, tenant_cb=lambda: self._tenant_of_wire(data))
        except BaseException:
            pre.lease.release()
            raise
        ana = self.analytics
        if ana is not None:
            ana.tap_wire_names(data, pre.khash)

        def run():
            out = self._run_fused(pre, now, True)  # flag_errors
            self._maybe_sweep(now)
            return out

        return self._counted("api", pre.n, "wire_local", run)

    def _run_fused(self, pre, now: int, flag_errors: bool = False) -> bytes:
        """Run a prepacked wave and serialize its responses.  Idle: one
        inline wave in this thread.  Busy: the rows are copied out of the
        lease (the queued job outlives it) and coalesce with the other
        callers' waves.  ``flag_errors`` (the client lane) counts each
        table-full row as its tenant's error, as JAX's fused lane does."""
        disp, n = self.dispatcher, pre.n
        # the tap's hits live in the lease, which the wave releases: an
        # engine tapped on the host needs them copied first
        hits_tap = (np.array(pre.lease.a64[1][:n])
                    if disp.analytics is not None and not disp._fused_tap
                    else None)
        out = disp.run_inline_wave(
            lambda: self.engine.check_prepacked(pre, now), nreq=n)
        if out is not disp._BUSY:
            if flag_errors:
                self._flag_full_rows(out[4][:n], pre.khash)
            resp = self._columns_to_bytes(out, 0, n)
            if hits_tap is not None:
                disp._tap_packed(pre.khash[:n], hits_tap, out[0])
            return resp
        try:
            # an index array copies: the rows outlive the lease
            batch = lease_batch(pre.lease, np.arange(n))
        finally:
            pre.lease.release()
        view = disp.check_packed_view(batch, pre.khash, now)
        if flag_errors:
            self._flag_full_rows(view.cols[4][view.lo:view.hi], pre.khash)
        return self._columns_to_bytes(view.cols, view.lo, view.hi)

    def _flag_full_rows(self, full, khash) -> None:
        """Each table-full row, one ``errors`` flag of its key's tenant."""
        ana = self.analytics
        if ana is None or not full.any():
            return
        for i in np.nonzero(full)[0].tolist():
            ana.tap_flag("errors", 1, khash=int(khash[i]))

    def _columns_to_bytes(self, cols, lo: int, hi: int, errs=None) -> bytes:
        """Rows [lo, hi) of result columns → response bytes (their
        OVER_LIMIT rows counted); ``errs`` maps a row (relative to lo) to
        its error, and table-full rows without one answer ``rate limit
        table full``: the ``build`` step."""
        with step("build", self.dispatcher):
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

    def _wire_global_runner(self, parsed: dict, now: int):
        """The columnar GLOBAL flow of a daemon alone (the wire lane's
        ``_hot_route``): pinned keys take the hot set's step, the rest
        the engine's, with promotion counted per unique key.  Returns a
        zero-argument runner, or None when a pinned key needs demoting
        (a flagged request or a new config: the protobuf lane does it).
        Nothing changes state before the runner runs.  In mesh mode the
        mesh tier's runner takes the batch instead (the owner-sharded
        lane while the tier stands down)."""
        if self._global_mode == "mesh":
            if self._mesh_routable():
                return self._wire_mesh_runner(parsed, now)
            return lambda: self._wire_check_columns(parsed, now)
        if self.config.hot_set_capacity <= 0:
            return lambda: self._wire_check_columns(parsed, now)
        n = parsed["n"]
        kh = mix64_np(parsed["khash_raw"])
        kh = np.where(kh == 0, np.uint64(1), kh)
        batch, errs = pack_columns(
            kh, parsed["hits"], parsed["limit"], parsed["duration"],
            parsed["algorithm"], parsed["behavior"], parsed["burst"], now,
            created_at=parsed["created_at"])
        beh = np.asarray(batch.behavior)
        glob_mask = (beh & int(Behavior.GLOBAL)) != 0
        excluded = (beh & int(self._HOT_EXCLUDED)) != 0
        hs = self._hotset
        hot_mask = np.zeros(n, bool)
        if hs is not None and hs.slots:
            with hs._mu:
                pinned_keys = np.fromiter(hs.slots.keys(), np.uint64,
                                          len(hs.slots))
            pinned_mask = glob_mask & np.isin(kh, pinned_keys)
            if pinned_mask.any():
                if (pinned_mask & excluded).any():
                    return None  # a flagged request on a pinned key
                # the config, compared over the few unique hot keys
                # (duration unfloored, as clamp_config stores it)
                alg, lim = batch.algorithm, batch.limit
                dur, bur = batch.duration, batch.burst
                for k in np.unique(kh[pinned_mask]):
                    cfg = hs.pinned_cfg.get(int(k))
                    m = pinned_mask & (kh == k)
                    if cfg is None or not (
                            (alg[m] == cfg[0]).all()
                            and (lim[m] == cfg[1]).all()
                            and (dur[m] == cfg[2]).all()
                            and (bur[m] == cfg[3]).all()):
                        return None  # a new config: demote first
                hot_mask = pinned_mask
        promo_mask = glob_mask & ~hot_mask & ~excluded & batch.valid

        def run() -> bytes:
            status = np.zeros(n, np.int32)
            lim_o = np.zeros(n, np.int64)
            rem = np.zeros(n, np.int64)
            rst = np.zeros(n, np.int64)
            full = np.zeros(n, bool)
            errors = dict(errs) if errs else {}
            if promo_mask.any():
                pidx = np.nonzero(promo_mask)[0]
                w = np.maximum(batch.hits[pidx], 1)
                uniq, first, inv = np.unique(
                    kh[pidx], return_index=True, return_inverse=True)
                weights = np.bincount(inv, weights=w).astype(np.int64)
                for k, f, wt in zip(uniq, first, weights):
                    i = int(pidx[f])  # the key's first row in the batch
                    self._count_toward_promotion(
                        int(k), int(wt), RateLimitRequest(
                            name="", unique_key="",
                            hits=int(batch.hits[i]),
                            limit=int(batch.limit[i]),
                            duration=int(batch.duration[i]),
                            algorithm=int(batch.algorithm[i]),
                            behavior=int(beh[i]),
                            burst=int(batch.burst[i])))
            if (~hot_mask).any():
                idx = np.nonzero(~hot_mask)[0]
                sub = type(batch)(*[np.asarray(c)[idx] for c in batch])
                s_st, s_lim, s_rem, s_rst, s_full = \
                    self.dispatcher.check_packed(sub, kh[idx], now)
                status[idx] = s_st
                lim_o[idx] = s_lim
                rem[idx] = s_rem
                rst[idx] = s_rst
                full[idx] = s_full
            if hot_mask.any():
                idx = np.nonzero(hot_mask)[0]
                sub = type(batch)(*[np.asarray(c)[idx] for c in batch])
                h_st, h_rem, h_rst, h_lim, h_lost = hs.check_columns(
                    sub, kh[idx], now)
                status[idx] = h_st
                rem[idx] = h_rem
                rst[idx] = h_rst
                lim_o[idx] = h_lim
                for j in np.nonzero(h_lost)[0].tolist():
                    errors.setdefault(int(idx[j]), "hot-set row lost")
            return self._columns_to_bytes(
                (status, lim_o, rem, rst, full), 0, n, errors)

        return run

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
                              membership) -> bytes:
        """C++ parse → batch hash → split by owner on the routing ring →
        each remote owner's rows forwarded as verbatim request TLV slices
        (stamped with this daemon's clock) → the device step for owned
        rows, overlapped with the RPCs → response TLVs spliced back in
        request order.  GLOBAL rows are answered from the local replica
        and never forwarded; their reconcile is queued per unique key as
        raw TLV prototypes, after the step.  Rows rehomed here by the
        health gate, and the eligible rows of a failed forward, serve
        degraded; the other rows of a failed forward answer error
        rows."""
        n = parsed["n"]
        raw = mix64_np(parsed["khash_raw"])
        picker = self._routing_picker()
        peer_list = picker.owner_peers()
        # before the zero remap, as picker.get(key) hashes
        owners = picker.owner_indices(raw)
        kh = np.where(raw == 0, np.uint64(1), raw)
        toff, tlen = parsed["tlv_off"], parsed["tlv_len"]
        created = parsed["created_at"]
        self_pi = [pi for pi, p in enumerate(peer_list) if self.is_self(p)]
        local_mask = np.isin(owners, self_pi)
        # rows rehomed here by an ejection serve DEGRADED: answered
        # locally, flagged, their hits queued to the membership owner
        deg_mask = rehomed = _NO_ROWS
        m_owners = m_peers = None
        if picker is not membership:
            m_peers = membership.owner_peers()
            m_owners = membership.owner_indices(raw)
            # a forwarded row whose routing owner is not its membership
            # owner was rehomed by this daemon's gate: its owner is told
            r_at = {p.info.grpc_address: pi
                    for pi, p in enumerate(peer_list)}
            m_to_r = np.array([r_at.get(p.info.grpc_address, -1)
                               for p in m_peers], np.int64)
            rehomed = m_to_r[m_owners] != owners
            if self.config.behaviors.peer_degraded_fallback:
                m_self = [pi for pi, p in enumerate(m_peers)
                          if self.is_self(p)]
                deg_mask = (local_mask & ~np.isin(m_owners, m_self)
                            & ((parsed["behavior"]
                                & int(self._DEGRADED_EXCLUDED)) == 0))
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
            if deg_mask.size:
                # GLOBAL rows have their own reconcile queue: degrading
                # them too would queue their hits twice
                deg_mask = deg_mask & ~glob_mask
        item_tlvs: List[Optional[bytes]] = [None] * n
        groups = []
        fwd_groups = []
        for pi in np.unique(owners[~local_mask]):
            sel = (owners == pi) & ~local_mask
            if rehomed.size:
                fwd_groups.append((pi, sel & ~rehomed, False))
                fwd_groups.append((pi, sel & rehomed, True))
            else:
                fwd_groups.append((pi, sel, False))
        for pi, sel, marked in fwd_groups:
            idxs = np.nonzero(sel)[0]
            if not idxs.size:
                continue
            if created_at_fwd_enabled():
                sub = wire_native.stamp_req_tlvs(
                    data, toff[idxs], tlen[idxs], created[idxs], now)
            else:
                sub = b"".join(data[int(toff[i]):int(toff[i] + tlen[i])]
                               for i in idxs)
            peer = peer_list[int(pi)]
            fut = send_err = None
            try:
                fut = peer.forward_raw(sub, int(idxs.size), rehomed=marked)
            except Exception as e:  # noqa: BLE001 - circuit open, closing
                send_err = e
            groups.append((idxs, fut, send_err, peer.info.grpc_address))
        if deg_mask.size and deg_mask.any():
            for pi in np.unique(m_owners[deg_mask]):
                didx = np.nonzero(deg_mask & (m_owners == pi))[0]
                addr = m_peers[int(pi)].info.grpc_address
                try:
                    tlvs = self._serve_degraded_wire(parsed, data, didx, kh,
                                                     now, addr)
                    for j, i in enumerate(didx):
                        item_tlvs[int(i)] = tlvs[j]
                except Exception as e:  # noqa: BLE001 - belt rows below
                    log.warning("degraded serve for %d rehomed rows "
                                "(owner %s) failed: %s", didx.size, addr,
                                exc_text(e))
            local_mask = local_mask & ~deg_mask
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
        if parsed["behavior_or"] & int(Behavior.MULTI_REGION):
            # rows this daemon owns replicate to the other regions (a
            # forwarded row is queued by its owner; GLOBAL rows never)
            mr = (np.isin(owners, self_pi)
                  & ((parsed["behavior"] & int(Behavior.MULTI_REGION)) != 0)
                  & ((parsed["behavior"] & int(Behavior.GLOBAL)) == 0))
            if mr.any():
                self._queue_mr_raw(parsed, data, mr, stamp_ms=now)
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
                except Exception as e:  # noqa: BLE001 - degraded or errors
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
            served = self._degrade_failed_forward(parsed, data, idxs, kh,
                                                  now, addr, item_tlvs)
            rest = idxs[~served]
            if rest.size:
                self._error_rows(
                    item_tlvs, rest,
                    f"while fetching rate limit from peer {addr}: "
                    f"{exc_text(err)}")
        if groups:
            self._count_forward(forwarded, failed)
        miss = [i for i, t in enumerate(item_tlvs) if t is None]
        if miss:
            # belt: a failed degraded serve still answers its rows
            self._error_rows(item_tlvs, miss, "degraded-mode serve failed")
        return b"".join(item_tlvs)  # type: ignore[arg-type]

    def _error_rows(self, item_tlvs: list, idxs, msg: str) -> None:
        """Answer rows ``idxs`` with zeroed error rows carrying ``msg``."""
        m = len(idxs)
        zeros = np.zeros(m, np.int64)
        ebytes = wire_native.build_responses_from_columns(
            (np.zeros(m, np.int32), zeros, zeros, zeros), 0, m, [msg] * m)
        self._splice(item_tlvs, idxs, ebytes)

    # ---- degraded serves ------------------------------------------------

    #: behaviors never served from a row that is not the owner's: RESET
    #: and DRAIN change state the reconcile queue cannot carry, and
    #: MULTI_REGION replication must start at the region's owner
    _DEGRADED_EXCLUDED = (Behavior.RESET_REMAINING
                          | Behavior.DRAIN_OVER_LIMIT
                          | Behavior.MULTI_REGION)

    def _serve_degraded_wire(self, parsed: dict, data: bytes,
                             idxs: np.ndarray, kh: np.ndarray, now: int,
                             peer_addr: str) -> List[bytes]:
        """Answer rows ``idxs`` from the local shard in degraded mode: one
        step over the sub-batch (``check_packed_view``), responses
        flagged ``degraded`` / ``degraded_peer`` (built with protobuf:
        the C++ response build has no metadata lane, and this runs only on the
        failure path), and the hits queued per unique key for reconcile
        to the owner.  One response TLV per row of ``idxs``."""
        from .proto import gubernator_pb2 as pb
        from .wire import _varint

        batch, errs = pack_columns(
            kh[idxs], parsed["hits"][idxs], parsed["limit"][idxs],
            parsed["duration"][idxs], parsed["algorithm"][idxs],
            parsed["behavior"][idxs], parsed["burst"][idxs], now,
            created_at=parsed["created_at"][idxs])
        view = self.dispatcher.check_packed_view(batch, kh[idxs], now)
        st, lim, rem, rst, full = view.sliced()
        self.metrics.over_limit_counter.inc(
            int((st == Status.OVER_LIMIT).sum()))
        out: List[bytes] = []
        flagged = 0
        for j in range(int(idxs.size)):
            msg = pb.RateLimitResp(
                status=int(st[j]), limit=int(lim[j]),
                remaining=int(rem[j]), reset_time=int(rst[j]))
            if errs and j in errs:
                msg.error = errs[j]
            elif bool(full[j]):
                msg.error = wire_native.TABLE_FULL
            else:
                msg.metadata["degraded"] = "true"
                msg.metadata["degraded_peer"] = peer_addr
                flagged += 1
            payload = msg.SerializeToString()
            out.append(b"\x0a" + _varint(len(payload)) + payload)
        # reconcile on recovery: the sub-batch's hits per unique key on
        # the raw hit queue (a failed flush requeues them)
        mask = np.zeros(parsed["n"], bool)
        mask[idxs] = True
        gm = self._ensure_global_manager()
        for k, tlv, a, _i in self._raw_queue_groups(parsed, data, mask,
                                                    stamp_ms=now):
            gm.queue_hits_raw(k, tlv, a, degraded=True)
        self.metrics.degraded_served.labels(peer_addr=peer_addr).inc(flagged)
        self._note_degraded(peer_addr, flagged,
                            khash=int(kh[idxs][0]) if idxs.size else None,
                            rows=int(idxs.size))
        return out

    def _degrade_failed_forward(self, parsed: dict, data: bytes,
                                idxs: np.ndarray, kh: np.ndarray, now: int,
                                addr: str, item_tlvs: list) -> np.ndarray:
        """A failed forward's eligible rows served degraded (written into
        ``item_tlvs``); returns the mask, aligned with ``idxs``, of the
        rows served.  Excluded behaviors, or every row when the fallback
        is off, are left for the caller's error rows."""
        served = np.zeros(int(idxs.size), bool)
        if not self.config.behaviors.peer_degraded_fallback:
            return served
        elig = (parsed["behavior"][idxs]
                & int(self._DEGRADED_EXCLUDED)) == 0
        if not elig.any():
            return served
        sub = idxs[elig]
        try:
            tlvs = self._serve_degraded_wire(parsed, data, sub, kh, now,
                                             addr)
        except Exception as e:  # noqa: BLE001 - error rows instead
            log.warning("degraded serve for %d rows (owner %s) failed: %s",
                        sub.size, addr, exc_text(e))
            return served
        for j, i in enumerate(sub):
            item_tlvs[int(i)] = tlvs[j]
        served[elig] = True
        return served

    def _peer_degraded_rewrite(self, parsed: dict, data: bytes, out: bytes,
                               stamp_ms: Optional[int] = None,
                               rehomed: bool = False) -> bytes:
        """The owner side of a rehome: a forwarded row whose MEMBERSHIP
        owner this daemon's gate has ejected, or any row of another
        daemon's in a batch the sender marked ``rehomed``, was routed
        here by the sender's gated ring.  Its local apply (done by the
        caller) is a degraded serve: its response is flagged and its
        hits queued to the true owner, or they would be absorbed into
        this shard.  Runs only while the gate has ejected peers or on a
        marked batch."""
        from .proto import gubernator_pb2 as pb

        bad = self._gate_bad  # lock-free: one frozenset read
        with self._peer_mu:
            mpick = self._picker
        if (not bad and not rehomed) or not mpick.peers() or \
                not self._uses_default_hash(mpick):
            return out
        peers_l = mpick.owner_peers()
        bad_pi = [pi for pi, p in enumerate(peers_l)
                  if not self.is_self(p)
                  and (rehomed or p.info.grpc_address in bad)]
        if not bad_pi:
            return out
        owners = mpick.owner_indices(mix64_np(parsed["khash_raw"]))
        # GLOBAL rows are excluded too: as acting owner this daemon
        # queues their broadcasts already
        mask = (np.isin(owners, bad_pi)
                & ((parsed["behavior"]
                    & int(self._DEGRADED_EXCLUDED | Behavior.GLOBAL)) == 0))
        if not mask.any():
            return out
        gm = self._ensure_global_manager()
        for k, tlv, a, _i in self._raw_queue_groups(parsed, data, mask,
                                                    stamp_ms=stamp_ms):
            gm.queue_hits_raw(k, tlv, a, degraded=True)
        ro, rl, _ = wire_native.split_resp_items(out)
        items: List[bytes] = []
        by_addr: dict = {}
        for j in range(parsed["n"]):
            tlv = out[int(ro[j]):int(ro[j] + rl[j])]
            if mask[j]:
                m = pb.GetRateLimitsResp.FromString(tlv)
                r = m.responses[0]
                if not r.error:
                    addr = peers_l[int(owners[j])].info.grpc_address
                    r.metadata["degraded"] = "true"
                    r.metadata["degraded_peer"] = addr
                    by_addr[addr] = by_addr.get(addr, 0) + 1
                    tlv = m.SerializeToString()
            items.append(tlv)
        for addr, cnt in by_addr.items():
            self.metrics.degraded_served.labels(peer_addr=addr).inc(cnt)
        if by_addr:
            kh0 = mix64_np(parsed["khash_raw"][mask][:1])[0]
            self._note_degraded(min(by_addr), sum(by_addr.values()),
                                khash=int(kh0) or 1, rehomed=True)
        return b"".join(items)

    def _peer_degraded_objects(self, reqs, resps, now: int,
                               rehomed: bool = False) -> None:
        """``_peer_degraded_rewrite`` for a forwarded batch of request
        objects (the protobuf lane)."""
        bad = self._gate_bad  # lock-free: one frozenset read
        with self._peer_mu:
            mpick = self._picker
        if (not bad and not rehomed) or not mpick.peers():
            return
        excl = int(self._DEGRADED_EXCLUDED | Behavior.GLOBAL)
        for req, resp in zip(reqs, resps):
            if resp.error or int(req.behavior) & excl:
                continue
            owner = mpick.get(req.key)
            addr = owner.info.grpc_address
            if self.is_self(owner) or (not rehomed and addr not in bad):
                continue
            self._flag_degraded(resp, addr)
            self._ensure_global_manager().queue_hits(
                _req_stamped(req, now), degraded=True)
            self.metrics.degraded_served.labels(peer_addr=addr).inc()
            self._note_degraded(addr, 1, name=req.name, log=False)

    @staticmethod
    def _splice(item_tlvs: list, idxs, rbytes: bytes, sp=None) -> None:
        """Put the response TLVs of ``rbytes`` at rows ``idxs``."""
        off, ln, _ = sp if sp is not None else \
            wire_native.split_resp_items(rbytes)
        for j, i in enumerate(idxs):
            item_tlvs[int(i)] = rbytes[int(off[j]):int(off[j] + ln[j])]

    def _queue_mr_raw(self, parsed: dict, data: bytes, mask: np.ndarray,
                      stamp_ms: Optional[int] = None) -> None:
        """Queue the masked rows' hits for the other regions, per unique
        key with its last TLV (the wire lanes' ``queue_hits``)."""
        mr = self._ensure_mr_manager()
        for k, tlv, a, _i in self._raw_queue_groups(parsed, data, mask,
                                                    stamp_ms=stamp_ms):
            mr.queue_hits_raw(k, tlv, a)

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
                             now_ms: Optional[int] = None,
                             rehomed: bool = False
                             ) -> List[RateLimitResponse]:
        """Apply a forwarded batch locally (gubernator.go ›
        GetPeerRateLimits); GLOBAL keys are marked for the next
        broadcast, and MULTI_REGION hits queue for the other regions.
        ``rehomed``: the sender's gate rehomed these rows here."""
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
        self._read_through(reqs)
        resps = self.dispatcher.check_batch(reqs, now)
        for req in reqs:
            if int(req.behavior) & int(Behavior.GLOBAL):
                self._ensure_global_manager().queue_update(req)
            if int(req.behavior) & int(Behavior.MULTI_REGION):
                # this daemon is the region's owner of the forwarded key
                self._ensure_mr_manager().queue_hits(_req_stamped(req, now))
        # rows whose membership owner this daemon's gate has ejected, or
        # that the sender's gate rehomed, were rehomed here: flagged,
        # their hits reconciled
        if (self._gate_bad or rehomed) and \
                self.config.behaviors.peer_degraded_fallback:
            self._peer_degraded_objects(reqs, resps, now, rehomed)
        self._after_local(reqs, resps)
        return resps

    def get_peer_rate_limits_wire(self, data: bytes,
                                  now_ms: Optional[int] = None,
                                  rehomed: bool = False) -> bytes:
        """GetPeerRateLimits wire bytes in and out: the owner side of the
        forward hop (its items are field 1, as in GetRateLimitsReq, so
        the C++ lanes apply as they are).  Forwarded rows always apply
        locally; GLOBAL rows mark their keys for the next broadcast and
        MULTI_REGION rows queue their hits for the other regions, after
        the step.  While the health gate has ejected peers, rows whose
        membership owner is ejected were rehomed here, and so were the
        rows of a batch the sender marked ``rehomed`` (its gate ejected
        their owner): they serve degraded (the parse lane; the fused
        lane is skipped then)."""
        with step("ingest", self.dispatcher, until_submit=True):
            self._fault_point("wire_ingest")
            self._require_packed()
            data = bytes(data) if not isinstance(data, bytes) else data
            if self.store is not None:
                return self._wire_peer_pb2(data, now_ms, rehomed)
            # one attribute read in the steady state
            gate_rehome = ((rehomed or bool(self._gate_bad))
                           and self.config.behaviors.peer_degraded_fallback)
            if not gate_rehome:
                out = self._wire_peer_fused(data, now_ms)
                if out is not None:
                    return out
            parsed = wire_native.parse_get_rate_limits(data)
            if parsed is None:
                return self._wire_peer_pb2(data, now_ms, rehomed)
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
            if parsed["behavior_or"] & int(Behavior.MULTI_REGION):
                # no GLOBAL precedence here: the object lane's owner side
                # queues both for a GLOBAL | MULTI_REGION row
                mr = (parsed["behavior"] & int(Behavior.MULTI_REGION)) != 0
                self._queue_mr_raw(parsed, data, mr, stamp_ms=now)
            if gate_rehome:
                out = self._peer_degraded_rewrite(parsed, data, out,
                                                  stamp_ms=now,
                                                  rehomed=rehomed)
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

    def _wire_peer_pb2(self, data: bytes, now_ms: Optional[int],
                       rehomed: bool = False) -> bytes:
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
            [req_from_pb(m) for m in msg.requests], now_ms=now_ms,
            rehomed=rehomed)
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

    # ---- the memory ledger's probes ------------------------------------
    #
    # Each probe re-reads the live attributes when a snapshot runs (the
    # engines rebind their tensors on grow and restore); none waits on
    # the serving stream or holds a lock across a device read.

    def _enroll_memledger(self) -> None:
        led = self.memledger
        if led is None:
            return
        # an injected engine enrols what it holds (JAX's guards)
        if hasattr(self.engine, "table_tensors"):
            led.enroll("hot_table", self._probe_hot_table, advisable=True)
        if hasattr(self.engine, "wave_pool"):
            led.enroll("wave_pool", self._probe_wave_pool, host=True)
        if self._analytics is not None:
            led.enroll("sketch", self._probe_sketch, host=True)
        if self._tier is not None:
            led.enroll("cold_store", self._probe_cold_store, host=True)

    def _probe_hot_table(self) -> dict:
        eng = self.engine
        nbytes = sum(int(t.nbytes) for t in eng.table_tensors())
        live = int(getattr(eng, "live_rows", -1))
        if live < 0:
            # a tick-cadence sampler must not wait on the waves: the
            # last sample stands until a fresh count has landed
            fresh = eng.occupancy_nowait(lock=self._engine_mu)
            if fresh is None:
                live = self._memledger_live
            else:
                live = self._memledger_live = int(fresh)
        demand: dict = {}
        ana = self.analytics
        if ana is not None:
            demand["ranks"] = ana.rank_distribution()
        tier = self._tier
        if tier is not None:
            st = tier.stats()
            demand["promote_rate"] = st.get("promotions", 0)
            demand["demote_rate"] = st.get("demotions", 0)
            demand["overflow"] = st.get("cold_served", 0)
        return {"bytes": nbytes, "capacity_rows": int(eng.cap_local),
                "occupied_rows": max(live, 0), "demand": demand}

    def _probe_wave_pool(self) -> dict:
        st = self.engine.wave_pool.mem_stats()
        return {"bytes": st["pooled_bytes"], "capacity_rows": 0,
                "occupied_rows": st["pooled"],
                "demand": {"rate": st["hits"]}}

    def _probe_sketch(self) -> dict:
        ana = self._analytics
        st = ana.mem_stats()
        return {"bytes": st["bytes"], "capacity_rows": st["width"],
                "occupied_rows": st["used"],
                "demand": {"rate": st["total_weight"]}}

    def _probe_cold_store(self) -> dict:
        tier = self._tier
        st = tier.stats()
        return {"bytes": tier.mem_bytes(), "capacity_rows": 0,
                "occupied_rows": st["cold_keys"],
                "demand": {"promote_rate": st["promotions"],
                           "demote_rate": st["demotions"],
                           "rate": st["cold_served"]}}

    def _probe_meshglobal(self) -> dict:
        mge = self._meshglobal
        if mge is None:
            return {"bytes": 0}
        # the replicas and both accumulator buffers; never mge.stats():
        # it drains the folds, and a probe stays read-only
        with mge._state_mu:
            nbytes = sum(int(t.nbytes) for t in mge.table_tensors())
            folded = float(mge.folded_hits + mge.injected_hits)
        with mge._mu:
            occ = len(mge._occupied)
        return {"bytes": nbytes, "capacity_rows": int(mge.capacity),
                "occupied_rows": occ, "demand": {"fold_rate": folded}}

    def _probe_hotset(self) -> dict:
        hs = self._hotset
        if hs is None:
            return {"bytes": 0}
        nbytes = sum(int(t.nbytes) for t in hs.table_tensors())
        with hs._mu:
            occ = len(hs.slots)
        with self._hot_mu:
            rate = float(sum(self._hot_counts.values()))
        return {"bytes": nbytes, "capacity_rows": int(hs.capacity),
                "occupied_rows": occ, "demand": {"hit_rate": rate}}

    # ---- the SLO engine and the audit ------------------------------------

    def _build_slo(self) -> None:
        """Register the SLOs the JAX instance registers against this
        instance's signals and start the tick loop.  Sources read state
        the other planes keep: the serving path does no extra work."""
        from .config import parse_duration_ms
        from .slo import (DEFAULT_BURN_THRESHOLD, DEFAULT_FAST_S,
                          DEFAULT_SLOW_S, SLO, SLO_CATALOG, SLOEngine)

        def dur_s(v: str, default_s: float) -> float:
            if not v:
                return default_s
            try:
                return parse_duration_ms(v) / 1000.0
            except (ValueError, TypeError):
                return default_s

        def flt(v: str, default: float) -> float:
            try:
                return float(v or default)
            except ValueError:
                return default

        env = os.environ.get
        fast = dur_s(env("GUBER_SLO_FAST", ""), DEFAULT_FAST_S)
        slow = dur_s(env("GUBER_SLO_SLOW", ""), DEFAULT_SLOW_S)
        tick_s = dur_s(env("GUBER_SLO_TICK", ""), 1.0)
        burn = flt(env("GUBER_SLO_BURN", ""), DEFAULT_BURN_THRESHOLD)
        p99_s = flt(env("GUBER_SLO_P99_MS", ""), 250.0) / 1000.0

        def breach_exemplar():
            ex = self.span_recorder.exemplar()
            return ex["trace_id"] if ex else None

        eng = SLOEngine(metrics=self.metrics, recorder=self.recorder,
                        fast_s=fast, slow_s=slow, burn_threshold=burn,
                        exemplar=breach_exemplar)
        stale_target = 2.0 * max(
            self.config.behaviors.global_sync_wait_ms, 100) / 1000.0

        def decision_p99():
            ana = self.analytics
            p = ana.phases.recent_p99("device") if ana is not None else None
            return (p or 0.0, p99_s)

        def global_staleness():
            mge = self._meshglobal
            if mge is None:
                return (0.0, stale_target)
            v = float(mge.last_staleness_s)
            ok = self._mesh_last_fold_ok
            if ok is not None:
                # a failing fold stops updating last_staleness_s: age
                # against the last fold that succeeded
                v = max(v, time.monotonic() - ok)
            return (v, stale_target)

        def error_ratio():
            ana = self.analytics
            t = ana.tenant_totals() if ana is not None else {}
            return (t.get("errors", 0) + t.get("degraded", 0),
                    t.get("requests", 0))

        def shed_ratio():
            ana = self.analytics
            t = ana.tenant_totals() if ana is not None else {}
            return (t.get("shed", 0),
                    t.get("requests", 0) + t.get("shed", 0))

        eng.register(SLO("decision_p99", "threshold", 0.95, decision_p99,
                         SLO_CATALOG["decision_p99"]))
        eng.register(SLO("global_staleness", "threshold", 0.95,
                         global_staleness, SLO_CATALOG["global_staleness"]))
        eng.register(SLO("error_ratio", "ratio", 0.999, error_ratio,
                         SLO_CATALOG["error_ratio"]))
        eng.register(SLO("shed_ratio", "ratio", 0.999, shed_ratio,
                         SLO_CATALOG["shed_ratio"]))
        led = self.memledger
        if led is not None:
            # the pressure sample is the (value, target) pair, and it
            # edge-triggers the memory_pressure event on the same tick
            eng.register(SLO("hbm_pressure", "threshold", 0.95,
                             led.pressure_sample,
                             SLO_CATALOG["hbm_pressure"]))
        if self._analytics is not None:
            eng.register_group(
                "tenant_error_ratio", 0.999,
                lambda: (self.analytics.tenant_red("errors")
                         if self.analytics is not None else {}),
                SLO_CATALOG["tenant_error_ratio"])
            eng.register_group(
                "tenant_shed_ratio", 0.999,
                lambda: (self.analytics.tenant_red("shed")
                         if self.analytics is not None else {}),
                SLO_CATALOG["tenant_shed_ratio"])
        if self.auditor.enabled:
            # seconds the audit drift has been nonzero against the one
            # flush window bound
            eng.register(SLO("fleet_conservation", "threshold", 0.95,
                             self.auditor.slo_sample,
                             SLO_CATALOG["fleet_conservation"]))
        self.slo = eng
        self._slo_loop = IntervalLoop(max(int(tick_s * 1000), 10),
                                      eng.tick, name="slo-engine")

    def audit_doc(self) -> dict:
        """The conservation audit served at GET /debug/audit
        (fleet.py › ConservationAuditor.doc)."""
        return self.auditor.doc()

    def _write_debug_dump(self) -> None:
        """With GUBER_DEBUG_DUMP_DIR set, the event ring with the final
        SLO verdicts, and the sampled spans, as JSONL files there.
        Best-effort: a closing process never wedges on its dump."""
        dirpath = os.environ.get("GUBER_DEBUG_DUMP_DIR", "")
        if not dirpath:
            return
        try:
            from .telemetry import write_debug_dump, write_trace_dump

            verdicts = self.slo.verdicts() if self.slo is not None else None
            iid = (os.environ.get("GUBER_INSTANCE_ID", "")
                   or self.config.advertise_address or "instance")
            path = write_debug_dump(dirpath, iid, self.recorder.events(),
                                    slo_verdicts=verdicts)
            self.recorder.record("debug_dump_written", path=path,
                                 events=len(self.recorder))
            spans = self.span_recorder.spans()
            if spans:
                write_trace_dump(dirpath, iid, spans)
        except Exception as e:  # noqa: BLE001 - the dump is best-effort
            log.warning("debug dump failed: %s", exc_text(e))

    def close(self) -> None:
        """Stop the health prober, flush the GLOBAL and MULTI_REGION
        managers, drain the peer clients, stop the dispatcher (the engine's one user), then
        the analytics, then save the snapshot (the JAX order: the
        dispatcher, the analytics, the snapshot)."""
        if self._closed:
            return
        with self._gm_mu:
            self._closed = True
            probe = self._probe_loop
        if self._slo_loop is not None:
            # first: its close runs one final tick, so the verdicts the
            # dump takes below are the end-of-life state
            self._slo_loop.close()
        if probe is not None:
            probe.close()
        if self.global_manager is not None:
            self.global_manager.close()
        if self.mr_manager is not None:
            self.mr_manager.close()
        if self._hot_sync_loop is not None:
            self._hot_sync_loop.close()
        for p in self.peers():
            p.shutdown()
        self.dispatcher.close()
        if self.dispatcher.analytics is not None:
            self.dispatcher.analytics.close()
        self._write_debug_dump()
        self._save_to_loader()
        if self.memledger is not None:
            # every consumer released: the ledger stands down empty
            for consumer in self.memledger.consumers():
                self.memledger.release(consumer)
