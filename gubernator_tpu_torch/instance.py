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
(``xla``).  Building or launching a kernel raises, and so does building
an engine: there is no fallback engine.

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
``wire_hotset``).  Tenant analytics and tracing wait for their slices.
"""
from __future__ import annotations

import logging
import os
import threading
import time
from concurrent.futures import Future
from contextlib import contextmanager, nullcontext
from dataclasses import replace
from typing import List, Optional, Sequence

import numpy as np

from .config import Config
from .core.batch import lease_batch, pack_columns
from .dispatcher import Dispatcher
from .engine import BucketEngine
from .faults import FaultSet
from .global_manager import GlobalManager
from .hotset import HotSetEngine
from .gregorian import gregorian_rate_duration_ms
from .hashing import (hash_key, hash_keys, hash_request_keys, mix64_np,
                      mixed_fnv1a64)
from .interval import IntervalLoop
from .metrics import Metrics
from .multiregion import MultiRegionManager
from .ops import native as wire_native
from .peer_client import ErrCircuitOpen, ErrClosing, PeerClient
from .peers import RegionPeerPicker, ReplicatedConsistentHash
from .sharded import ShardedEngine, autogrow_limit_per_shard
from .store import CacheItem, arrays_from_items, items_from_arrays
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

    def __init__(self, config: Config, peer_tls_creds=None):
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
        # at least 1024 rows, a power of two (the JAX instance's
        # per-shard floor at one shard)
        cap = 1 << (max(config.cache_size, 1024) - 1).bit_length()
        self.engine = self._build_engine(
            resolve_engine_kind(config.engine), cap, config)
        self.engine.wave_pool.metrics = self.metrics
        self._engine_mu = threading.Lock()
        # key analytics: the heavy-hitter sketch and the phase ledger,
        # fed off the serving path (GUBER_ANALYTICS=0 turns it off)
        self._analytics = None
        if os.environ.get("GUBER_ANALYTICS", "1") != "0":
            from .analytics import KeyAnalytics

            self._analytics = KeyAnalytics(metrics=self.metrics)
        self.dispatcher = self._make_dispatcher()
        analytics = self._analytics
        if self.engine.fused_tap and analytics is not None:
            # the bucket engine taps in its step: its device tap goes
            # straight to the analytics, set once before serving
            self.engine.tap_sink = analytics.tap_device
        # the cold tier: engine.tier, ranked by the sketch; the victim
        # filter is the JAX hook for replica-pinned keys
        self._tier = None
        tier_cold = os.environ.get("GUBER_TIER_COLD")
        if (tier_cold == "1" if tier_cold is not None
                else config.tier_cold):
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
                     if self.engine.fused_tap and analytics is not None
                     else None),
                rank_batch=(analytics.sketch_counts
                            if analytics is not None else None))
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
        # the replicated hot set: built at the first promotion
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

    def _make_dispatcher(self) -> Dispatcher:
        """A dispatcher over this instance's engine, lock, registry,
        recorder and faultpoints; the GUBER_* dispatcher knobs are read
        now."""
        return Dispatcher(self.engine,
                          max_wave=self.engine.wave_buckets[-1],
                          lock=self._engine_mu, metrics=self.metrics,
                          recorder=self.recorder, faults=self.faults,
                          analytics=self._analytics)

    @property
    def analytics(self):
        """The KeyAnalytics (None when off); it lives on the dispatcher,
        so detaching that one reference darkens every host tap."""
        return self.dispatcher.analytics

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
        # hot rows live outside the table: fold them back in first
        self._demote_all()
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
        with self._engine_mu:
            n = self.engine.remove_rows(np.array([kh], np.uint64))
            if self._tier is not None \
                    and self._tier.pop_row(kh) is not None:
                n += 1  # the row lived in the cold tier
        if self.store is not None:
            self.store.remove(f"{name}_{unique_key}")
        return n > 0

    def _tier_victim_pinned(self, kh: int) -> bool:
        """The tier's eviction filter: a hot-set pinned key's table row is
        the home of its state, which moving it cold while the pin serves
        would fork."""
        hs = self._hotset
        return hs is not None and hs.is_pinned(kh)

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
        left; the health gate starts afresh.  Keys re-home and moved
        keys start afresh (the reference's behavior), unless
        ``handover_on_reshard`` hands their rows to the new owners."""
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
                                      tls_creds=self._peer_tls))
            self._picker = picker
            # a membership change invalidates the gated view: the next
            # routing lookup derives it again from live health
            self._gate_bad = frozenset()
            self._gate_picker = None
            self._ring_gen += 1
            gen = self._ring_gen
        self.metrics.ring_generation.set(gen)
        self.metrics.ring_ejected_peers.set(0)
        for departed in old.values():
            threading.Thread(target=departed.shutdown, daemon=True,
                             name="peer-shutdown").start()
        have_others = any(info.grpc_address != self._self_addr
                          for info in infos)
        if have_others:
            # the hot set serves a daemon alone: its keys go back to the
            # table with their consumption
            self._demote_all()
        if self.config.handover_on_reshard and have_others:
            self._start_handover(old_picker, "handover")

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
        hot: List[tuple] = []  # (request index, key hash): the hot set
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
        # alone, GLOBAL keys may ride the hot set
        hot_on = membership is None and self.config.hot_set_capacity > 0
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
                    if not self.is_self(owner):
                        fwd.append((i, owner, req))
                        continue
                    local_idx.append(i)
                    if gate_active and not int(req.behavior) & EXCL:
                        mowner = membership.get(req.key)
                        if not self.is_self(mowner):
                            deg_local.append(
                                (i, mowner.info.grpc_address))
                    # the local region's owner replicates to the others
                    if int(req.behavior) & MULTI_REGION:
                        self._ensure_mr_manager().queue_hits(
                            _req_stamped(req, now))
            # forwards first, so their RPCs overlap the device step
            futures = [(i, self._forward_one(peer, req, now),
                        peer.info.grpc_address, req) for i, peer, req in fwd]
            over = 0
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
        over = 0
        for (i, req, addr), resp in zip(deg_failed, dresps):
            if not resp.error:
                self._flag_degraded(resp, addr)
                gm.queue_hits(_req_stamped(req, now), degraded=True)
                self.metrics.degraded_served.labels(peer_addr=addr).inc()
                over += resp.status == Status.OVER_LIMIT
            responses[i] = resp
        self.recorder.record("degraded", peer=deg_failed[0][2],
                             rows=len(deg_failed))
        return over

    @staticmethod
    def _flag_degraded(resp: RateLimitResponse, addr: str) -> None:
        resp.metadata["degraded"] = "true"
        resp.metadata["degraded_peer"] = addr

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
        """The hot set on the engine's device, one replica (the engine's
        device count), and its sync loop, built at the first promotion."""
        with self._gm_mu:
            if self._hotset is None:
                cap = 1 << (self.config.hot_set_capacity - 1).bit_length()
                self._hotset = HotSetEngine(1, capacity=cap,
                                            device=self.engine.device)
                self._hot_sync_loop = IntervalLoop(
                    self.config.behaviors.global_sync_wait_ms,
                    self._hotset.sync, name="hotset-sync")
            return self._hotset

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
        self._fault_point("wire_ingest")
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
            # promotion gate (see _get_rate_limits); a pinned key that
            # needs demoting sends the batch to the protobuf lane, before
            # any state changes
            gated = (picker is None and glob
                     and self.config.hot_set_capacity > 0)
            with (self._promote_gate.shared() if gated else nullcontext()):
                out = self._wire_parsed(parsed, data, now, picker, glob)
            if out is None:
                return self._wire_pb2(data, now_ms)
            if gated and self._promote_pending:
                self._drain_promotions(now)
            return out
        return self._wire_pb2(data, now_ms)

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
        self.dispatcher.admit(n)

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
        # the tap's hits live in the lease, which the wave releases: an
        # engine tapped on the host needs them copied first
        hits_tap = (np.array(pre.lease.a64[1][:n])
                    if disp.analytics is not None and not disp._fused_tap
                    else None)
        out = disp.run_inline_wave(
            lambda: self.engine.check_prepacked(pre, now), nreq=n)
        if out is not disp._BUSY:
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

    def _wire_global_runner(self, parsed: dict, now: int):
        """The columnar GLOBAL flow of a daemon alone (the wire lane's
        ``_hot_route``): pinned keys take the hot set's step, the rest
        the engine's, with promotion counted per unique key.  Returns a
        zero-argument runner, or None when a pinned key needs demoting
        (a flagged request or a new config: the protobuf lane does it).
        Nothing changes state before the runner runs."""
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
        deg_mask = _NO_ROWS
        m_owners = m_peers = None
        if picker is not membership and \
                self.config.behaviors.peer_degraded_fallback:
            m_peers = membership.owner_peers()
            m_owners = membership.owner_indices(raw)
            m_self = [pi for pi, p in enumerate(m_peers) if self.is_self(p)]
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
        self.recorder.record("degraded", peer=peer_addr, rows=int(idxs.size))
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
                               stamp_ms: Optional[int] = None) -> bytes:
        """The owner side of a rehome: a forwarded row whose MEMBERSHIP
        owner this daemon's gate has ejected was routed here by another
        daemon's gated ring.  Its local apply (done by the caller) is a
        degraded serve: its response is flagged and its hits queued to
        the true owner, or they would be absorbed into this shard.  Runs
        only while the gate has ejected peers."""
        from .proto import gubernator_pb2 as pb

        bad = self._gate_bad  # lock-free: one frozenset read
        with self._peer_mu:
            mpick = self._picker
        if not bad or not mpick.peers() or not self._uses_default_hash(
                mpick):
            return out
        peers_l = mpick.owner_peers()
        bad_pi = [pi for pi, p in enumerate(peers_l)
                  if p.info.grpc_address in bad]
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
            self.recorder.record("degraded", peer=min(by_addr),
                                 rows=sum(by_addr.values()), rehomed=True)
        return b"".join(items)

    def _peer_degraded_objects(self, reqs, resps, now: int) -> None:
        """``_peer_degraded_rewrite`` for a forwarded batch of request
        objects (the protobuf lane)."""
        bad = self._gate_bad  # lock-free: one frozenset read
        with self._peer_mu:
            mpick = self._picker
        if not bad or not mpick.peers():
            return
        excl = int(self._DEGRADED_EXCLUDED | Behavior.GLOBAL)
        for req, resp in zip(reqs, resps):
            if resp.error or int(req.behavior) & excl:
                continue
            owner = mpick.get(req.key)
            addr = owner.info.grpc_address
            if addr not in bad or self.is_self(owner):
                continue
            self._flag_degraded(resp, addr)
            self._ensure_global_manager().queue_hits(
                _req_stamped(req, now), degraded=True)
            self.metrics.degraded_served.labels(peer_addr=addr).inc()

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
                             now_ms: Optional[int] = None
                             ) -> List[RateLimitResponse]:
        """Apply a forwarded batch locally (gubernator.go ›
        GetPeerRateLimits); GLOBAL keys are marked for the next
        broadcast, and MULTI_REGION hits queue for the other regions."""
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
        # rows whose membership owner this daemon's gate has ejected
        # were rehomed here: flagged, their hits reconciled
        if self._gate_bad and self.config.behaviors.peer_degraded_fallback:
            self._peer_degraded_objects(reqs, resps, now)
        self._after_local(reqs, resps)
        return resps

    def get_peer_rate_limits_wire(self, data: bytes,
                                  now_ms: Optional[int] = None) -> bytes:
        """GetPeerRateLimits wire bytes in and out: the owner side of the
        forward hop (its items are field 1, as in GetRateLimitsReq, so
        the C++ lanes apply as they are).  Forwarded rows always apply
        locally; GLOBAL rows mark their keys for the next broadcast and
        MULTI_REGION rows queue their hits for the other regions, after
        the step.  While the health gate has ejected peers, rows
        whose membership owner is ejected were rehomed here and serve
        degraded (the parse lane; the fused lane is skipped then)."""
        self._fault_point("wire_ingest")
        data = bytes(data) if not isinstance(data, bytes) else data
        if self.store is not None:
            return self._wire_peer_pb2(data, now_ms)
        # one attribute read in the steady state
        gate_rehome = (bool(self._gate_bad)
                       and self.config.behaviors.peer_degraded_fallback)
        if not gate_rehome:
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
        if parsed["behavior_or"] & int(Behavior.MULTI_REGION):
            # no GLOBAL precedence here: the object lane's owner side
            # queues both for a GLOBAL | MULTI_REGION row
            mr = (parsed["behavior"] & int(Behavior.MULTI_REGION)) != 0
            self._queue_mr_raw(parsed, data, mr, stamp_ms=now)
        if gate_rehome:
            out = self._peer_degraded_rewrite(parsed, data, out,
                                              stamp_ms=now)
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
        """Stop the health prober, flush the GLOBAL and MULTI_REGION
        managers, drain the peer clients, stop the dispatcher (the engine's one user), then
        the analytics, then save the snapshot (the JAX order: the
        dispatcher, the analytics, the snapshot)."""
        if self._closed:
            return
        with self._gm_mu:
            self._closed = True
            probe = self._probe_loop
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
        self._save_to_loader()
