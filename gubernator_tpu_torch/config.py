"""Configuration: the subset of gubernator_tpu/config.py that the port
reads (one daemon, its peers and where they come from, TLS, their
batching / GLOBAL / MULTI_REGION timing and failure handling, its
region, its shared client port, its persistence hooks, cold tier and hot
set), plus the ``device`` it serves on.  The analytics knobs
(GUBER_ANALYTICS, GUBER_TOPK, GUBER_SKETCH_WIDTH) and GUBER_TIER_NATIVE
are read from the environment where the JAX package reads them
(instance.py, analytics.py, tiering.py), not here.

Layering is the JAX package's: defaults < ``KEY=value`` config file <
environment (``GUBER_*``).  A GUBER_TLS_* key set while TLS is off
(none of GUBER_TLS_AUTO, GUBER_TLS_CERT, GUBER_TLS_CA) raises, and so
does a TLS setting the port cannot honor when the daemon starts
(tlsutil.py); an unknown discovery type raises there too.  Keys of
subsystems the port does not have yet are ignored, so the repository's
example.conf loads as is.  ``HELP`` holds the operator description of
the discovery, TLS and observability keys (JAX's ENV_REGISTRY entries);
the observability keys (GUBER_TRACE_*, GUBER_TENANT_*, GUBER_SLO*,
GUBER_MEM_*, GUBER_FLEET_*, GUBER_PROFILE_DIR, GUBER_DEBUG_DUMP_DIR,
GUBER_INSTANCE_ID) are read from the environment where the JAX package
reads them, with its defaults.
"""
from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .types import PeerInfo

#: the operator description of the discovery, TLS and observability keys
#: (the JAX package's ENV_REGISTRY entries, word for word)
HELP: Dict[str, str] = {
    "GUBER_DNS_FQDN": "DNS discovery: FQDN to resolve for peers",
    "GUBER_DNS_RESOLVE_INTERVAL": "DNS discovery: re-resolve interval (duration)",
    "GUBER_ETCD_ENDPOINTS": "etcd discovery: comma-separated endpoints",
    "GUBER_ETCD_PREFIX": "etcd discovery: key prefix for peer registration",
    "GUBER_K8S_INSECURE": "k8s discovery: skip API-server cert verification",
    "GUBER_K8S_NAMESPACE": "k8s discovery: namespace to watch",
    "GUBER_K8S_POD_SELECTOR": "k8s discovery: pod label selector",
    "GUBER_K8S_SERVICE": "k8s discovery: service name whose endpoints are peers",
    "GUBER_MEMBERLIST_KNOWN_HOSTS": "memberlist discovery: seed hosts",
    "GUBER_PEERS": "static peer list (host:port,... ) for static discovery",
    "GUBER_PEERS_FILE": "file-based discovery: path to the peer list",
    "GUBER_PEER_DISCOVERY_TYPE": "peer discovery backend (static/file/dns/etcd/k8s/memberlist)",
    "GUBER_TLS_AUTO": "generate a self-signed TLS setup at startup",
    "GUBER_TLS_CA": "TLS CA bundle path",
    "GUBER_TLS_CERT": "TLS server certificate path",
    "GUBER_TLS_CLIENT_AUTH": "TLS client-auth mode",
    "GUBER_TLS_CLIENT_AUTH_CA_CERT": "TLS client-auth CA path",
    "GUBER_TLS_INSECURE_SKIP_VERIFY": "peer clients skip TLS verification",
    "GUBER_TLS_KEY": "TLS server key path",
    # the observability planes, read from the environment where the JAX
    # package reads them (instance.py, analytics.py, slo.py,
    # memledger.py, fleet.py, daemon.py)
    "GUBER_DEBUG_DUMP_DIR": "crash forensics: close() dumps the event ring + final SLO verdicts here as JSONL",
    "GUBER_FLEET_AUDIT": "conservation auditor on the GLOBAL lanes: 0 disables the audit taps + /debug/audit drift (default on)",
    "GUBER_FLEET_DRIFT_BOUND": "conservation drift staleness bound (duration) before the fleet_conservation SLO burns; default 2x GUBER_GLOBAL_SYNC_WAIT",
    "GUBER_INSTANCE_ID": "stable instance id (defaults to advertise address)",
    "GUBER_MEM_ADVISE_FLOOR": "memory ledger: per-consumer minimum rows in the advised split (default 64)",
    "GUBER_MEM_LEDGER": "0 disables the device-memory ledger plane (default 1)",
    "GUBER_MEM_PRESSURE": "hbm_pressure SLO target: byte-weighted occupancy fraction (default 0.85)",
    "GUBER_PROFILE_DIR": "on-demand device-profiler capture directory",
    "GUBER_SLO": "0 disables the in-process SLO burn-rate engine",
    "GUBER_SLO_BURN": "burn-rate breach threshold (multiple of the error-budget spend rate, default 2.0)",
    "GUBER_SLO_FAST": "SLO fast burn window (duration, default 1m)",
    "GUBER_SLO_P99_MS": "decision_p99 SLO target: device-phase p99 ms (default 250)",
    "GUBER_SLO_SLOW": "SLO slow burn window (duration, default 5m)",
    "GUBER_SLO_TICK": "SLO engine evaluation interval (duration, default 1s)",
    "GUBER_TENANT_DELIM": "tenant id = key-name prefix up to this delimiter (default /)",
    "GUBER_TENANT_MAX": "max distinct tenant buckets; overflow folds into __other__ (default 64)",
    "GUBER_TRACE_SAMPLE": "head-sampling rate for the trace plane (0 disables)",
    "GUBER_TRACE_SPANS": "span-recorder ring capacity (completed spans kept)",
}

_DUR_RE = re.compile(r"(\d+(?:\.\d+)?)(ns|us|µs|ms|s|m|h)")
_DUR_UNIT_MS = {"ns": 1e-6, "us": 1e-3, "µs": 1e-3, "ms": 1.0,
                "s": 1000.0, "m": 60_000.0, "h": 3_600_000.0}


def parse_duration_ms(s: str | int | float) -> int:
    """Go-style duration string ("1m30s", "250ms") or bare number (ms)
    → integer milliseconds."""
    if isinstance(s, (int, float)):
        return int(s)
    s = s.strip()
    if not s:
        return 0
    if re.fullmatch(r"-?\d+", s):
        return int(s)
    total, pos = 0.0, 0
    neg = s.startswith("-")
    if neg:
        pos = 1
    for m in _DUR_RE.finditer(s, pos):
        if m.start() != pos:
            raise ValueError(f"invalid duration: {s!r}")
        total += float(m.group(1)) * _DUR_UNIT_MS[m.group(2)]
        pos = m.end()
    if pos != len(s):
        raise ValueError(f"invalid duration: {s!r}")
    return int(-total if neg else total)


@dataclass
class BehaviorConfig:
    """Peer batching and GLOBAL timing (config.go › BehaviorConfig; ms
    integers, the JAX package's defaults)."""

    #: deadline slack of a forwarded batch (the forward RPC's deadline is
    #: this plus 60 s) and of a caller waiting for its forward
    batch_timeout_ms: int = 500
    batch_wait_ms: int = 500
    #: most requests in one forwarded peer batch
    batch_limit: int = 1000
    #: how long GLOBAL hits accumulate before they flush to their owner
    global_sync_wait_ms: int = 100
    #: deadline of a GLOBAL hits flush or broadcast RPC
    global_timeout_ms: int = 500
    #: most GLOBAL items in one flush or broadcast RPC
    global_batch_limit: int = 1000
    #: interval between the owner's broadcasts of changed GLOBAL rows
    global_broadcast_interval_ms: int = 100
    #: in-flight RPCs per peer per method (the send lanes' pipeline depth)
    peer_inflight: int = 4
    #: how long a flush waits for stragglers after draining its backlog
    peer_coalesce_us: int = 200
    #: re-sends of a failed flush, with linear backoff
    peer_retry_limit: int = 2
    peer_retry_backoff_ms: int = 25
    #: consecutive failed flushes that open a peer's circuit (sends then
    #: fail fast until the cooldown ends and one flush half-opens it)
    peer_circuit_threshold: int = 3
    peer_circuit_cooldown_ms: int = 2000
    #: a failed forward's eligible rows (no RESET_REMAINING,
    #: DRAIN_OVER_LIMIT or MULTI_REGION) are answered from the local
    #: shard, flagged ``metadata.degraded``, and their hits reconcile to
    #: the owner through the GLOBAL hit queues; False answers error rows
    peer_degraded_fallback: bool = True
    #: the health-gated routing ring: a peer whose circuit has stayed
    #: open for peer_eject_after_ms leaves the ring requests route by
    #: (its keys rehome and serve degraded), and returns after staying
    #: recovered for peer_readmit_after_ms
    peer_health_gate: bool = True
    peer_eject_after_ms: int = 3000
    peer_readmit_after_ms: int = 3000
    #: MULTI_REGION: how long a region owner's hits accumulate before
    #: they are sent to the key's owner in every other region, that
    #: send's RPC deadline, and the most requests in one send
    multi_region_sync_wait_ms: int = 300
    multi_region_timeout_ms: int = 900
    multi_region_batch_limit: int = 1000


@dataclass
class Config:
    """Core-instance configuration."""

    #: Rows in the device counter table (rounded up to a power of two;
    #: the instance serves at least 1024).
    cache_size: int = 1 << 16
    #: Rows of the small wave bucket (the big one is 8×).
    batch_rows: int = 1024
    #: Upper bound (rows) for the classic engine's on-device auto-grow
    #: when the table fills with live keys (0 disables); rounded down to
    #: a power of two.  The bucket engine has no grow.
    cache_autogrow_max: int = 0
    #: Serving engine (GUBER_ENGINE): "" / "auto" / "pallas" = the bucket
    #: engine (K1; counters < 2^30), "xla" / "sharded" = the classic SoA
    #: engine (the full value domain, auto-grow).  Anything else raises.
    engine: str = ""
    #: Milliseconds between expired-row sweeps (0 disables).
    sweep_interval_ms: int = 30_000
    #: Device the engine serves on: "cuda" (default; raises without a
    #: GPU) or "cpu" (the plain PyTorch step).
    device: str = "cuda"
    behaviors: BehaviorConfig = field(default_factory=BehaviorConfig)
    #: this daemon's own peer address (host:port of its gRPC listener):
    #: the ring entry that is "self"
    advertise_address: str = ""
    #: on a membership change or a flip of the health gate, rows whose
    #: routing owner moved are handed to the new owner over the peer
    #: wire instead of starting afresh there (the reference's behavior,
    #: and this default, is to reset them)
    handover_on_reshard: bool = False
    #: persistence hooks (store.py): a Loader restores the table when the
    #: instance starts and saves it when it closes; a Store is called
    #: around every local decision (read-through, write-through)
    loader: Optional[object] = None
    store: Optional[object] = None
    #: the host cold tier behind the device table (tiering.py): a key
    #: the table cannot hold is served exactly from host memory, not
    #: answered table_full, and moves to the device once its sketch rank
    #: reaches tier_promote_threshold.  GUBER_TIER_COLD overrides.
    tier_cold: bool = False
    #: sketch-rank admission threshold of a cold row (GUBER_TIER_PROMOTE)
    tier_promote_threshold: int = 8
    #: this daemon's region (datacenter): with one set, peers are picked
    #: per region (peers.py › RegionPeerPicker) and MULTI_REGION hits
    #: replicate to the other regions (multiregion.py)
    data_center: str = ""
    #: the replicated hot set (hotset.py): a daemon alone pins up to this
    #: many GLOBAL keys (rounded up to a power of two) once each has
    #: taken hot_promote_threshold hits (or its sketch count says so);
    #: 0 turns it off
    hot_set_capacity: int = 1024
    hot_promote_threshold: int = 64

    def set_defaults(self) -> "Config":
        """Normalize invalid values (config.go › SetDefaults)."""
        if self.cache_size <= 0:
            self.cache_size = 1 << 16
        self.cache_size = 1 << (self.cache_size - 1).bit_length()
        if self.batch_rows <= 0:
            self.batch_rows = 1024
        return self


@dataclass
class TLSSettings:
    """reference: tls.go › TLSConfig (its declarative part)."""

    ca_file: str = ""
    cert_file: str = ""
    key_file: str = ""
    #: generate a self-signed CA and server certificate in memory
    auto_tls: bool = False
    #: "none" | "require-any" | "verify" (client certificates); "request"
    #: cannot be honored on gRPC and raises at startup
    client_auth: str = "none"
    client_auth_ca_file: str = ""
    #: cannot be honored (raises at startup when true)
    insecure_skip_verify: bool = False


@dataclass
class DaemonConfig:
    """Everything needed to spawn a daemon."""

    http_listen_address: str = "localhost:1050"
    #: gRPC front door (V1 GetRateLimits / HealthCheck and
    #: grpc.health.v1); "" serves none.  Needs grpcio: with an address
    #: set and no grpcio the daemon raises.
    grpc_listen_address: str = "localhost:1051"
    #: a SHARED client-facing gRPC address (GUBER_CLIENT_ADDRESS), bound
    #: with SO_REUSEPORT: several daemon processes on one host bind it and
    #: the kernel spreads client connections over them, while each keeps
    #: its own grpc_listen_address for peer traffic (cluster.py ›
    #: start_subprocess_group); "" binds none
    client_listen_address: str = ""
    cache_size: int = 1 << 16
    batch_rows: int = 1024
    cache_autogrow_max: int = 0
    engine: str = ""
    sweep_interval_ms: int = 30_000
    device: str = "cuda"
    log_level: str = "info"
    #: the address peers reach this daemon at; "" = the gRPC listener's
    #: host and bound port
    advertise_address: str = ""
    behaviors: BehaviorConfig = field(default_factory=BehaviorConfig)
    #: "none" | "static" | "file" | "dns" | "etcd" | "k8s" |
    #: "member-list" (also "memberlist", "gossip"); anything else raises
    peer_discovery_type: str = "none"
    #: static discovery: "host:grpc_port[;host:http_port][@dc]" entries
    static_peers: List[str] = field(default_factory=list)
    #: file discovery: a JSON or lines peers file, re-read on change
    peers_file: str = ""
    #: dns discovery: the name to resolve, and how often
    dns_fqdn: str = ""
    dns_resolve_interval_ms: int = 30_000
    #: etcd discovery (its v3 JSON gateway)
    etcd_endpoints: List[str] = field(default_factory=list)
    etcd_prefix: str = "/gubernator/peers/"
    #: k8s discovery: pods by label selector, or a service's endpoints
    k8s_namespace: str = ""
    k8s_pod_selector: str = ""
    k8s_service: str = ""
    #: explicit opt-out of the API server's certificate check
    k8s_insecure_skip_verify: bool = False
    #: member-list (gossip) discovery: seed gossip addresses
    memberlist_known_hosts: List[str] = field(default_factory=list)
    #: TLS for the gRPC listeners, the peer clients and HTTP; None = off
    tls: Optional[TLSSettings] = None
    #: graceful-shutdown drain window (ms, GUBER_DRAIN_GRACE): close()
    #: answers /healthz with 503 "draining" for this long, still serving,
    #: before it sheds new requests and stops the listeners; 0 skips the
    #: wait (the drain events still fire)
    drain_grace_ms: int = 0
    #: Config.handover_on_reshard (GUBER_HANDOVER_ON_RESHARD)
    handover_on_reshard: bool = False
    #: the Loader snapshot file (GUBER_SNAPSHOT_PATH): restored at start,
    #: saved at close (store.py › FileLoader); "" keeps no snapshot
    snapshot_path: str = ""
    #: this daemon's region (GUBER_DATA_CENTER; Config.data_center)
    data_center: str = ""
    #: a name for logs (GUBER_INSTANCE_ID)
    instance_id: str = ""

    def instance_config(self) -> Config:
        return Config(cache_size=self.cache_size,
                      batch_rows=self.batch_rows,
                      cache_autogrow_max=self.cache_autogrow_max,
                      engine=self.engine,
                      sweep_interval_ms=self.sweep_interval_ms,
                      device=self.device, behaviors=self.behaviors,
                      advertise_address=self.advertise_address,
                      handover_on_reshard=self.handover_on_reshard,
                      data_center=self.data_center).set_defaults()


def load_conf_file(path: str) -> Dict[str, str]:
    """Parse a ``KEY=value`` config file: blank lines and #-comments
    ignored."""
    out: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if "=" not in line:
                raise ValueError(
                    f"invalid config line (want KEY=value): {line!r}")
            k, _, v = line.partition("=")
            out[k.strip()] = v.strip()
    return out


def setup_daemon_config(conf_file: str = "",
                        env: Optional[Dict[str, str]] = None
                        ) -> DaemonConfig:
    """DaemonConfig from defaults < config file < environment.  ``env``
    replaces os.environ (hermetic tests)."""
    conf = load_conf_file(conf_file) if conf_file else {}
    conf.update(os.environ if env is None else env)
    d = DaemonConfig()
    d.http_listen_address = conf.get("GUBER_HTTP_ADDRESS",
                                     d.http_listen_address)
    d.grpc_listen_address = conf.get("GUBER_GRPC_ADDRESS",
                                     d.grpc_listen_address)
    d.client_listen_address = conf.get("GUBER_CLIENT_ADDRESS",
                                       d.client_listen_address)
    d.cache_size = int(conf.get("GUBER_CACHE_SIZE", d.cache_size))
    d.batch_rows = int(conf.get("GUBER_BATCH_ROWS", d.batch_rows))
    d.cache_autogrow_max = int(conf.get("GUBER_CACHE_AUTOGROW_MAX",
                                        d.cache_autogrow_max))
    d.engine = conf.get("GUBER_ENGINE", d.engine)
    d.device = conf.get("GUBER_DEVICE", d.device)
    d.log_level = conf.get("GUBER_LOG_LEVEL", d.log_level)
    d.advertise_address = conf.get("GUBER_ADVERTISE_ADDRESS",
                                   d.advertise_address)
    d.data_center = conf.get("GUBER_DATA_CENTER", d.data_center)
    d.instance_id = conf.get("GUBER_INSTANCE_ID", d.instance_id)

    def get(name, default, cast):
        return cast(conf[name]) if name in conf else default

    def flag(v: str) -> bool:
        return str(v).strip().lower() in ("1", "true", "yes", "on")

    b = d.behaviors
    b.batch_timeout_ms = get("GUBER_BATCH_TIMEOUT", b.batch_timeout_ms,
                             parse_duration_ms)
    b.batch_wait_ms = get("GUBER_BATCH_WAIT", b.batch_wait_ms,
                          parse_duration_ms)
    b.batch_limit = get("GUBER_BATCH_LIMIT", b.batch_limit, int)
    b.global_sync_wait_ms = get("GUBER_GLOBAL_SYNC_WAIT",
                                b.global_sync_wait_ms, parse_duration_ms)
    b.global_timeout_ms = get("GUBER_GLOBAL_TIMEOUT", b.global_timeout_ms,
                              parse_duration_ms)
    b.global_batch_limit = get("GUBER_GLOBAL_BATCH_LIMIT",
                               b.global_batch_limit, int)
    b.global_broadcast_interval_ms = get(
        "GUBER_GLOBAL_BROADCAST_INTERVAL", b.global_broadcast_interval_ms,
        parse_duration_ms)
    b.multi_region_sync_wait_ms = get(
        "GUBER_MULTI_REGION_SYNC_WAIT", b.multi_region_sync_wait_ms,
        parse_duration_ms)
    b.multi_region_timeout_ms = get(
        "GUBER_MULTI_REGION_TIMEOUT", b.multi_region_timeout_ms,
        parse_duration_ms)
    b.multi_region_batch_limit = get(
        "GUBER_MULTI_REGION_BATCH_LIMIT", b.multi_region_batch_limit, int)
    b.peer_degraded_fallback = get("GUBER_PEER_DEGRADED_FALLBACK",
                                   b.peer_degraded_fallback, flag)
    b.peer_health_gate = get("GUBER_PEER_HEALTH_GATE", b.peer_health_gate,
                             flag)
    b.peer_eject_after_ms = get("GUBER_PEER_EJECT_AFTER",
                                b.peer_eject_after_ms, parse_duration_ms)
    b.peer_readmit_after_ms = get("GUBER_PEER_READMIT_AFTER",
                                  b.peer_readmit_after_ms, parse_duration_ms)
    d.handover_on_reshard = get("GUBER_HANDOVER_ON_RESHARD",
                                d.handover_on_reshard, flag)
    d.drain_grace_ms = get("GUBER_DRAIN_GRACE", d.drain_grace_ms,
                           parse_duration_ms)
    d.snapshot_path = conf.get("GUBER_SNAPSHOT_PATH", d.snapshot_path)
    d.peer_discovery_type = conf.get("GUBER_PEER_DISCOVERY_TYPE",
                                     d.peer_discovery_type)
    peers = conf.get("GUBER_PEERS", "")
    if peers:
        d.static_peers = [p.strip() for p in peers.split(",") if p.strip()]
        if d.peer_discovery_type == "none":
            d.peer_discovery_type = "static"

    def listed(name):
        return [p.strip() for p in conf.get(name, "").split(",")
                if p.strip()]

    d.peers_file = conf.get("GUBER_PEERS_FILE", d.peers_file)
    d.dns_fqdn = conf.get("GUBER_DNS_FQDN", d.dns_fqdn)
    d.dns_resolve_interval_ms = get("GUBER_DNS_RESOLVE_INTERVAL",
                                    d.dns_resolve_interval_ms,
                                    parse_duration_ms)
    d.etcd_endpoints = listed("GUBER_ETCD_ENDPOINTS") or d.etcd_endpoints
    d.etcd_prefix = conf.get("GUBER_ETCD_PREFIX", d.etcd_prefix)
    d.k8s_namespace = conf.get("GUBER_K8S_NAMESPACE", d.k8s_namespace)
    d.k8s_pod_selector = conf.get("GUBER_K8S_POD_SELECTOR",
                                  d.k8s_pod_selector)
    d.k8s_service = conf.get("GUBER_K8S_SERVICE", d.k8s_service)
    d.k8s_insecure_skip_verify = get("GUBER_K8S_INSECURE",
                                     d.k8s_insecure_skip_verify, flag)
    d.memberlist_known_hosts = (listed("GUBER_MEMBERLIST_KNOWN_HOSTS")
                                or d.memberlist_known_hosts)
    # TLS is asked for by any non-empty GUBER_TLS_* key but a false AUTO
    tls_keys = sorted(k for k, v in conf.items()
                      if k.startswith("GUBER_TLS_") and str(v).strip()
                      and k != "GUBER_TLS_AUTO")
    if (get("GUBER_TLS_AUTO", False, flag) or conf.get("GUBER_TLS_CERT")
            or conf.get("GUBER_TLS_CA")):
        d.tls = TLSSettings(
            ca_file=conf.get("GUBER_TLS_CA", ""),
            cert_file=conf.get("GUBER_TLS_CERT", ""),
            key_file=conf.get("GUBER_TLS_KEY", ""),
            auto_tls=get("GUBER_TLS_AUTO", False, flag),
            client_auth=conf.get("GUBER_TLS_CLIENT_AUTH", "none"),
            client_auth_ca_file=conf.get("GUBER_TLS_CLIENT_AUTH_CA_CERT",
                                         ""),
            insecure_skip_verify=get("GUBER_TLS_INSECURE_SKIP_VERIFY",
                                     False, flag))
    elif tls_keys:
        # JAX drops these silently, serving in plaintext
        raise ValueError(
            f"{', '.join(tls_keys)} set while TLS is off: set "
            "GUBER_TLS_CERT and GUBER_TLS_KEY, or GUBER_TLS_AUTO=true")
    return d


def parse_peer_list(specs: List[str], default_dc: str = "") -> List[PeerInfo]:
    """"host:grpc_port[;host:http_port][@dc]" strings → PeerInfo list."""
    out = []
    for s in specs:
        dc = default_dc
        if "@" in s:
            s, _, dc = s.partition("@")
        grpc_addr, _, http_addr = s.partition(";")
        out.append(PeerInfo(grpc_address=grpc_addr.strip(),
                            http_address=http_addr.strip(),
                            datacenter=dc.strip()))
    return out
