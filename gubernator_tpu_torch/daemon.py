"""Daemon: the gRPC and HTTP front doors around one V1Instance (the port
of gubernator_tpu/daemon.py):

- gRPC on ``grpc_listen_address`` (grpc_api.py): V1 GetRateLimits as raw
  wire bytes into ``V1Instance.get_rate_limits_wire`` (a ValueError
  becomes INVALID_ARGUMENT), V1 HealthCheck, grpc.health.v1, and the
  peer service PeersV1 (GetPeerRateLimits as raw bytes into
  ``get_peer_rate_limits_wire``, UpdatePeerGlobals).  A shed batch
  (``ResourceExhausted``) aborts with RESOURCE_EXHAUSTED; the call's
  remaining deadline scopes admission (``request_deadline``).  grpcio is
  imported only when an address is set; set and missing, the daemon
  raises.  The listener binds first, so a ``:0`` address advertises its
  bound port;
- with ``client_listen_address`` (GUBER_CLIENT_ADDRESS) set, a second
  gRPC server on that address bound with SO_REUSEPORT, serving V1 and
  grpc.health.v1 only: sibling daemon processes on the host bind the
  same address and the kernel spreads client connections over them
  (cluster.py › start_subprocess_group), while peer traffic stays on
  each daemon's own ``grpc_listen_address``.  It starts before the peer
  listener, so SERVING on the peer port means the shared port accepts;
- peers from ``peer_discovery_type`` (discovery.py: static, file, dns,
  member-list, etcd or k8s) into ``V1Instance.set_peers``;
- with ``tls`` set (GUBER_TLS_*, tlsutil.py), TLS on both gRPC
  listeners, on the peer clients' channels and on the HTTP listener; a
  setting the port cannot honor raises here;
- an HTTP/JSON gateway on ``http_listen_address``: POST
  /v1/GetRateLimits (numeric enums in and out, snake_case and camelCase
  field names) through the object lane (a shed batch answers 429), GET
  /healthz (also /v1/HealthCheck; ``?deep=1`` adds the dispatcher's and
  the peer lanes' state), GET /metrics (the instance's Prometheus
  registry) and GET /debug/events (its flight recorder, filtered by
  ``limit``, ``kind``, ``since_seq``, ``tenant`` and ``trace``), GET
  /debug/faults (the armed faultpoints, their counters, the catalog)
  and POST /debug/faults (``{"spec": "peer_send@host:port:error",
  "seed": 7}`` arms, ``{"clear": true}`` disarms; a malformed spec
  answers 400 and changes nothing), GET /debug/topkeys (the
  heavy-hitter sketch's top keys, ``?limit=``, each with its ring owner),
  GET /debug/phases (the per-phase latency ledger and the waves'
  percentiles), GET /debug/tenants (the tenant ledger) and GET
  /debug/costmodel (the fitted cost model); these answer 404 with
  GUBER_ANALYTICS=0; GET /debug/kernels (this process's CUDA kernel
  launches); GET /debug/traces (the span ring, ``?trace_id=`` and
  ``?limit=``), GET /debug/audit (the conservation audit, always
  served), GET /debug/slo (404 with GUBER_SLO=0), GET /debug/memory
  (``?advise=1`` adds the advisor's split; 404 with GUBER_MEM_LEDGER=0)
  and GET /debug/profile (``?seconds=N`` starts one ``torch.profiler``
  capture into a fresh temporary directory: 400 for a bad N, 409 while
  any capture runs; without ``seconds`` its status).  ``?deep=1`` on
  /healthz adds the SLO engine's ``slo`` block and the memory ledger's
  ``memory`` totals;
- every gRPC handler and the HTTP GetRateLimits run in a request context
  (tracing.py): the inbound ``traceparent`` is adopted (or a trace
  started), a span records the handler, and the trace commits at its
  end; GUBER_PROFILE_DIR starts a capture at start-up, stopped at close;
- ``snapshot_path`` (GUBER_SNAPSHOT_PATH): a FileLoader, so the table
  (both tiers) is restored at start and saved at close.

``close()`` drains first: /healthz answers 503 "draining" while requests
still serve for ``drain_grace_ms``, then new requests shed and the
listeners stop.
"""
from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional
from urllib.parse import parse_qs, urlsplit

from .config import DaemonConfig
from .discovery import make_discovery
from .dispatcher import ResourceExhausted, request_deadline
from .instance import V1Instance
from .netutil import resolve_host_ip, split_host_port
from .peer_client import is_rehomed
from .store import FileLoader
from .telemetry import exc_text
from .tlsutil import setup_tls
from .tracing import grpc_request_context, request_context, span
from .types import Behavior, PeerInfo, RateLimitRequest

log = logging.getLogger("gubernator_tpu_torch.daemon")


def _json_to_req(o: dict) -> RateLimitRequest:
    """Accept both snake_case and grpc-gateway camelCase field names."""

    def g(*names, default=None):
        for n in names:
            if n in o:
                return o[n]
        return default

    return RateLimitRequest(
        name=g("name", default=""),
        unique_key=g("unique_key", "uniqueKey", default=""),
        hits=int(g("hits", default=1)),
        limit=int(g("limit", default=0)),
        duration=int(g("duration", default=0)),
        algorithm=int(g("algorithm", default=0)),
        behavior=Behavior(int(g("behavior", default=0))),
        burst=int(g("burst", default=0)),
        metadata=g("metadata", default={}) or {},
    )


def _resp_to_json(r) -> dict:
    return {"status": int(r.status), "limit": r.limit,
            "remaining": r.remaining,
            "reset_time": r.reset_time, "resetTime": r.reset_time,
            "error": r.error, "metadata": r.metadata}


def _split_host_port(addr: str) -> tuple[str, int]:
    host, port = split_host_port(addr)
    return host.strip("[]") or "0.0.0.0", port


class _V1Servicer:
    """V1 over the instance: GetRateLimits as raw wire bytes."""

    def __init__(self, instance: V1Instance):
        self.instance = instance

    def GetRateLimitsWire(self, request: bytes, context):
        import grpc

        inst = self.instance
        with grpc_request_context(context, recorder=inst.span_recorder), \
                span("grpc.GetRateLimits", metrics=inst.metrics), \
                request_deadline(context.time_remaining()):
            try:
                return inst.get_rate_limits_wire(request)
            except ValueError as e:
                context.abort(grpc.StatusCode.INVALID_ARGUMENT, exc_text(e))
            except ResourceExhausted as e:
                context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED,
                              exc_text(e))

    def HealthCheck(self, request, context):
        from .wire import health_to_pb

        return health_to_pb(self.instance.health_check())


class _PeersServicer:
    """PeersV1 over the instance: the owner side of the forward hop and
    the replicas' side of GLOBAL broadcasts."""

    def __init__(self, instance: V1Instance):
        self.instance = instance

    def GetPeerRateLimitsWire(self, request: bytes, context):
        import grpc

        inst = self.instance
        with grpc_request_context(context, recorder=inst.span_recorder), \
                span("grpc.GetPeerRateLimits", metrics=inst.metrics), \
                request_deadline(context.time_remaining()):
            try:
                return inst.get_peer_rate_limits_wire(
                    request, rehomed=is_rehomed(context))
            except ValueError as e:
                context.abort(grpc.StatusCode.INVALID_ARGUMENT, exc_text(e))
            except ResourceExhausted as e:
                context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED,
                              exc_text(e))

    def UpdatePeerGlobals(self, request, context):
        from .proto import peers_pb2 as peers_pb

        inst = self.instance
        with grpc_request_context(context, recorder=inst.span_recorder), \
                span("grpc.UpdatePeerGlobals", metrics=inst.metrics):
            inst.update_peer_globals(list(request.globals))
            return peers_pb.UpdatePeerGlobalsResp()


class Daemon:
    """Use spawn_daemon() to construct."""

    def __init__(self, cfg: DaemonConfig, mesh=None, engine=None):
        self.cfg = cfg
        #: the instance's mesh (mesh.py) as given; None: its default
        self.mesh = mesh
        self._closed = False
        #: True from the moment close() starts: /healthz answers 503
        #: "draining" through the grace window
        self._draining = False
        self.http_server: Optional[ThreadingHTTPServer] = None
        self._http_thread: Optional[threading.Thread] = None
        self.grpc_server = None
        self.grpc_port = 0
        #: the shared SO_REUSEPORT front door (client_listen_address)
        self.client_server = None
        self.client_port = 0
        self.instance: Optional[V1Instance] = None
        self.discovery = None
        self.advertise_address = cfg.advertise_address
        #: the TLS context (tlsutil.py), None in plaintext
        self.tls = None
        #: the GUBER_PROFILE_DIR capture, and one /debug/profile capture
        #: at a time (the profiler is process-wide)
        self.profiler = None
        self._prof_mu = threading.Lock()
        self._runtime_prof: Optional[dict] = None  # guarded-by: self._prof_mu
        try:
            self.tls = setup_tls(cfg.tls)
            if cfg.grpc_listen_address:
                self._bind_grpc(cfg.grpc_listen_address)
            elif cfg.peer_discovery_type not in ("", "none"):
                raise ValueError("peer discovery needs a gRPC listener: "
                                 "set grpc_listen_address")
            icfg = cfg.instance_config()
            icfg.advertise_address = self.advertise_address
            if cfg.snapshot_path:
                icfg.loader = FileLoader(cfg.snapshot_path)
            self.instance = V1Instance(
                icfg, peer_tls_creds=(self.tls.grpc_client_credentials()
                                      if self.tls is not None else None),
                mesh=mesh, engine=engine)
            # warm-up: build the kernel and run one wave before serving
            self.instance.get_rate_limits(
                [RateLimitRequest(name="_warmup", unique_key="w", hits=0,
                                  limit=1, duration=1000)])
            warmup = getattr(self.instance.engine, "warmup", None)
            if warmup is not None:
                warmup()
            if cfg.client_listen_address:
                self._serve_client(cfg.client_listen_address)
            if self.grpc_server is not None:
                self._serve_grpc()
            self._start_http(cfg.http_listen_address)
            self.discovery = make_discovery(cfg, self.peer_info(),
                                            self.instance.set_peers)
            from .tracing import DeviceProfiler

            self.profiler = DeviceProfiler.from_env(cuda=self._on_cuda())
        except BaseException:
            # a half-built daemon leaks no listener or thread
            self._closed = True
            self._teardown()
            raise

    def _bind_grpc(self, addr: str) -> None:
        """Bind the gRPC listener (not serving yet), so the advertise
        address can name its real port; raises when grpcio is missing
        or the address cannot be bound."""
        try:
            import grpc
        except ImportError as e:
            raise RuntimeError(
                f"grpc_listen_address={addr!r} needs grpcio, which is not "
                "installed; set GUBER_GRPC_ADDRESS= (empty) to serve HTTP "
                "only") from e
        from concurrent.futures import ThreadPoolExecutor

        server = grpc.server(ThreadPoolExecutor(max_workers=32),
                             options=[("grpc.so_reuseport", 0)])
        port = self._add_port(server, addr)
        if port == 0:
            raise OSError(f"failed to bind {addr}")
        self.grpc_server, self.grpc_port = server, port
        host, _ = split_host_port(addr)
        adv = self.cfg.advertise_address or f"{host}:{port}"
        adv_host, adv_port = split_host_port(adv)
        if adv_port == 0:
            adv = f"{adv_host}:{port}"
        self.advertise_address = resolve_host_ip(adv)

    def _serve_grpc(self) -> None:
        """V1 (raw wire bytes), PeersV1 and grpc.health.v1."""
        from .grpc_api import (add_health_servicer, add_peers_servicer_raw,
                               add_v1_servicer_raw)

        add_v1_servicer_raw(self.grpc_server, _V1Servicer(self.instance))
        add_peers_servicer_raw(self.grpc_server,
                               _PeersServicer(self.instance))
        add_health_servicer(self.grpc_server, self.instance)
        self.grpc_server.start()

    def _serve_client(self, addr: str) -> None:
        """V1 and grpc.health.v1 on the shared client address, bound
        with SO_REUSEPORT (the peer service stays on the daemon's own
        port: the ring needs one identity a process)."""
        import grpc
        from concurrent.futures import ThreadPoolExecutor

        from .grpc_api import add_health_servicer, add_v1_servicer_raw

        server = grpc.server(ThreadPoolExecutor(max_workers=32),
                             options=[("grpc.so_reuseport", 1)])
        add_v1_servicer_raw(server, _V1Servicer(self.instance))
        add_health_servicer(server, self.instance)
        port = self._add_port(server, addr)
        if port == 0:
            raise OSError(f"failed to bind client address {addr} "
                          "(SO_REUSEPORT)")
        self.client_server, self.client_port = server, port
        server.start()

    def _add_port(self, server, addr: str) -> int:
        """Bind ``addr`` on a gRPC server, over TLS when it is on."""
        if self.tls is not None:
            return server.add_secure_port(
                addr, self.tls.grpc_server_credentials())
        return server.add_insecure_port(addr)

    def set_peers(self, infos: List[PeerInfo]) -> None:
        self.instance.set_peers(infos)

    def peer_info(self) -> PeerInfo:
        return PeerInfo(grpc_address=self.advertise_address,
                        http_address=self.cfg.http_listen_address,
                        datacenter=self.cfg.data_center)

    def _start_http(self, addr: str) -> None:
        host, port = _split_host_port(addr)
        daemon = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet
                log.debug("http: " + fmt, *args)

            def _send(self, code: int, body: bytes,
                      ctype: str = "application/json"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                parts = urlsplit(self.path)
                path, q = parts.path, parse_qs(parts.query)
                if path == "/metrics":
                    ana = daemon.instance.analytics
                    if ana is not None:
                        ana.republish()  # the top-K gauge, at scrape time
                    led = daemon.instance.memledger
                    if led is not None:
                        # the ledger's gauges too: its probes run on the
                        # scraper's time
                        led.republish(daemon.instance.metrics)
                    self._send(200, daemon.instance.metrics.render(),
                               "text/plain; version=0.0.4")
                elif path in ("/healthz", "/v1/HealthCheck"):
                    code, body = daemon.health(
                        q.get("deep", ["0"])[-1] not in ("", "0", "false"))
                    self._send(code, json.dumps(body).encode())
                elif path == "/debug/events":
                    self._send(200, json.dumps(
                        {"events": daemon.instance.recorder.events(
                            limit=_int_arg(q, "limit"),
                            kind=q.get("kind", [""])[-1] or None,
                            since_seq=_int_arg(q, "since_seq"),
                            tenant=q.get("tenant", [""])[-1] or None,
                            trace=q.get("trace", [""])[-1] or None)}
                    ).encode())
                elif path == "/debug/faults":
                    self._send(200, json.dumps(
                        daemon.instance.faults.describe()).encode())
                elif path in ("/debug/topkeys", "/debug/phases",
                              "/debug/tenants", "/debug/costmodel"):
                    self._send(*daemon.analytics_doc(path, q))
                elif path == "/debug/kernels":
                    self._send(200, json.dumps(kernel_launches()).encode())
                elif path in ("/debug/traces", "/debug/audit", "/debug/slo",
                              "/debug/memory", "/debug/profile"):
                    code, body = daemon.debug_doc(path, q)
                    self._send(code, json.dumps(body).encode())
                else:
                    self._send(404, b'{"error":"not found"}')

            def _post_faults(self):
                """Arm or clear this daemon's faultpoints at run time."""
                faults = daemon.instance.faults
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(length) or b"{}")
                    if payload.get("clear"):
                        out = faults.clear()
                    else:
                        out = faults.arm(payload.get("spec", ""),
                                         seed=payload.get("seed"))
                except (ValueError, TypeError) as e:
                    self._send(400, json.dumps(
                        {"error": exc_text(e)}).encode())
                    return
                self._send(200, json.dumps(out).encode())

            def do_POST(self):
                if self.path == "/debug/faults":
                    self._post_faults()
                    return
                if self.path not in ("/v1/GetRateLimits",
                                     "/v1/V1/GetRateLimits"):
                    self._send(404, b'{"error":"not found"}')
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(length) or b"{}")
                    reqs = [_json_to_req(o)
                            for o in payload.get("requests", [])]
                    inst = daemon.instance
                    with request_context(self.headers.get("traceparent"),
                                         recorder=inst.span_recorder), \
                            span("http.GetRateLimits", metrics=inst.metrics):
                        resps = inst.get_rate_limits(reqs)
                except ValueError as e:
                    self._send(400, json.dumps(
                        {"error": exc_text(e)}).encode())
                    return
                except ResourceExhausted as e:
                    # admission shed or drain: the HTTP analog of gRPC
                    # RESOURCE_EXHAUSTED
                    self._send(429, json.dumps(
                        {"error": exc_text(e)}).encode())
                    return
                self._send(200, json.dumps({
                    "responses": [_resp_to_json(r) for r in resps]}).encode())

        self.http_server = ThreadingHTTPServer((host, port), Handler)
        if self.tls is not None:
            self.http_server.socket = self.tls.http_ssl_context().wrap_socket(
                self.http_server.socket, server_side=True)
        self.http_port = self.http_server.server_address[1]
        self._http_thread = threading.Thread(
            target=self.http_server.serve_forever, daemon=True,
            name=f"http-{addr}")
        self._http_thread.start()

    def health(self, deep: bool) -> tuple:
        """(HTTP code, body) of /healthz: 503 "draining" once close()
        began; else the instance's health check, and with ``deep`` the
        dispatcher's ``debug_stats()``, each peer's ``lane_stats()``, the
        SLO engine's ``health()`` (``slo``: breached and burning SLOs, the
        ``--fail-on-burn`` feed) and the memory ledger's totals
        (``memory``)."""
        inst = self.instance
        if self._draining:
            return 503, {"status": "draining",
                         "message": "daemon is shutting down",
                         "peer_count": len(inst.peers())}
        h = inst.health_check()
        body = {"status": h.status, "message": h.message,
                "peer_count": h.peer_count}
        if deep:
            body["dispatcher"] = inst.dispatcher.debug_stats()
            body["peers"] = {p.info.grpc_address: p.lane_stats()
                             for p in inst.peers()}
            if inst.slo is not None:
                body["slo"] = inst.slo.health()
            if inst.memledger is not None:
                snap = inst.memledger.snapshot()
                body["memory"] = {k: snap[k] for k in (
                    "device_bytes", "host_bytes", "pressure",
                    "pressure_target")}
        return (200 if h.status == "healthy" else 503), body

    def analytics_doc(self, path: str, q: dict) -> tuple:
        """(HTTP code, JSON body) of /debug/topkeys, /debug/phases,
        /debug/tenants or /debug/costmodel."""
        inst = self.instance
        ana = inst.analytics
        if ana is None:
            return 404, json.dumps({"error": "analytics disabled "
                                             "(GUBER_ANALYTICS=0)"}).encode()
        if path == "/debug/topkeys":
            ana.flush(timeout=2.0)  # fold the queued taps first
            snap = ana.topkeys_snapshot(_int_arg(q, "limit"))
            for e in snap["keys"]:
                e["owner"] = inst.owner_addr_by_khash(int(e["khash"], 16))
            return 200, json.dumps(snap).encode()
        if path == "/debug/tenants":
            ana.flush(timeout=2.0)  # fold the queued taps first
            return 200, json.dumps(ana.tenants_snapshot()).encode()
        if path == "/debug/costmodel":
            return 200, json.dumps(ana.costmodel_snapshot()).encode()
        body = ana.phases_snapshot()
        tel = inst.dispatcher.telemetry_snapshot()
        body["waves"] = {k: tel.get(k) for k in (
            "waves", "wave_duration_p50_ms", "wave_duration_p99_ms",
            "queue_wait_p50_ms", "queue_wait_p99_ms")}
        return 200, json.dumps(body).encode()

    def debug_doc(self, path: str, q: dict) -> tuple:
        """(HTTP code, JSON-able body) of /debug/traces, /debug/audit,
        /debug/slo, /debug/memory or /debug/profile."""
        inst = self.instance
        if path == "/debug/traces":
            rec = inst.span_recorder
            st = rec.stats()
            return 200, {"sample": st["sample"], "capacity": st["capacity"],
                         "dropped": st["dropped"],
                         "spans": rec.spans(
                             trace_id=q.get("trace_id", [""])[-1] or None,
                             limit=_int_arg(q, "limit"))}
        if path == "/debug/audit":
            return 200, inst.audit_doc()
        if path == "/debug/slo":
            if inst.slo is None:
                return 404, {"error": "slo engine disabled (GUBER_SLO=0)"}
            return 200, inst.slo.snapshot()
        if path == "/debug/memory":
            led = inst.memledger
            if led is None:
                return 404, {"error": "memory ledger disabled "
                                      "(GUBER_MEM_LEDGER=0)"}
            body = led.snapshot()
            if q.get("advise", ["0"])[-1] not in ("", "0", "false"):
                body["advise"] = led.advise()
            return 200, body
        return self._handle_profile(q)

    #: the longest runtime capture: a capture taxes the serving loop and
    #: its trace grows with time
    PROFILE_MAX_SECONDS = 300.0

    def _on_cuda(self) -> bool:
        dev = getattr(self.instance.engine, "device", None)
        return getattr(dev, "type", "") == "cuda"

    def _handle_profile(self, q: dict) -> tuple:
        """``?seconds=N`` starts a DeviceProfiler capture for N seconds
        into a fresh directory (GUBER_PROFILE_DIR's parent is not used:
        each capture its own); 400 for a bad N, 409 while any capture
        (runtime or GUBER_PROFILE_DIR's) runs.  Without ``seconds``: the
        capture's status, its trace file once written."""
        from .tracing import DeviceProfiler, ProfilerBusy

        raw = q.get("seconds", [""])[-1]
        with self._prof_mu:
            rp = self._runtime_prof
            active = rp is not None and not rp["done"].is_set()
            if not raw:
                body = {"active": active}
                if rp is not None:
                    body.update({"dir": rp["dir"], "seconds": rp["seconds"]})
                    if rp["done"].is_set():
                        body["trace"] = rp["profiler"].path
                elif self.profiler is not None:
                    body.update({"active": True,
                                 "dir": self.profiler.log_dir,
                                 "startup_env": True})
                return 200, body
            try:
                seconds = float(raw)
            except ValueError:
                return 400, {"error": f"invalid seconds={raw!r}"}
            if not 0 < seconds <= self.PROFILE_MAX_SECONDS:
                return 400, {"error": f"seconds must be in (0, "
                                      f"{self.PROFILE_MAX_SECONDS:.0f}]"}
            if active or self.profiler is not None:
                return 409, {"error": "a profile capture is already active"}
            import tempfile

            log_dir = tempfile.mkdtemp(prefix="guber_profile_")
            try:
                prof = DeviceProfiler(log_dir, cuda=self._on_cuda())
            except ProfilerBusy as e:  # another daemon of the process
                return 409, {"error": exc_text(e)}
            except Exception as e:  # noqa: BLE001 - the caller's answer
                return 500, {"error": f"profiler start failed: "
                                      f"{exc_text(e)}"}
            done = threading.Event()
            stop = threading.Event()
            state = {"profiler": prof, "dir": log_dir, "seconds": seconds,
                     "done": done, "stop": stop}
            self._runtime_prof = state
        inst = self.instance
        inst.recorder.record("profile_start", dir=log_dir, seconds=seconds)

        def stop_later():
            stop.wait(seconds)  # close() cuts a capture short
            try:
                prof.stop()
            finally:
                done.set()
                inst.recorder.record("profile_stop", dir=log_dir)

        t = threading.Thread(target=stop_later, daemon=True,
                             name="debug-profile-stop")
        state["thread"] = t
        t.start()
        return 200, {"profiling": True, "dir": log_dir, "seconds": seconds}

    def close(self) -> None:
        """Graceful shutdown: drain first.  /healthz answers 503
        "draining" and requests still serve for ``drain_grace_ms`` (load
        balancers stop routing before connections die); then the
        dispatcher sheds new ingress, discovery and the listeners stop,
        and the instance flushes its GLOBAL manager, drains its peer
        clients and saves its snapshot."""
        if self._closed:
            return
        self._closed = True
        self._draining = True
        inst = self.instance
        if inst is not None:
            inst.recorder.record("drain_started",
                                 grace_ms=self.cfg.drain_grace_ms)
            inst.metrics.draining.set(1)
            if self.cfg.drain_grace_ms > 0:
                time.sleep(self.cfg.drain_grace_ms / 1000.0)
            inst.dispatcher.drain()
        self._teardown()
        if inst is not None:
            inst.recorder.record("drain_completed")

    def _teardown(self) -> None:
        if self.profiler is not None:
            self.profiler.stop()
        with self._prof_mu:
            rp = self._runtime_prof
        if rp is not None:
            rp["stop"].set()
            rp["thread"].join(timeout=30)
        if self.discovery is not None:
            self.discovery.close()
        if self.client_server is not None:
            self.client_server.stop(grace=None).wait()
        if self.grpc_server is not None:
            self.grpc_server.stop(grace=None).wait()
        if self.http_server is not None:
            self.http_server.shutdown()
            self.http_server.server_close()
        if self.instance is not None:
            self.instance.close()


def kernel_launches() -> dict:
    """This process's CUDA kernel launches since it started, each the
    wrapper's own count (K1 ``decide_cuda``, K2 ``sweep_cuda``, K3
    ``probe_add_cuda``): GET /debug/kernels, how a caller outside the
    process (a subprocess group's parent) reads them.  The JAX daemon
    has no counterpart: its kernels are XLA's."""
    from .ops.decide import decide_cuda
    from .ops.probe import probe_add_cuda
    from .ops.sweep import sweep_cuda

    return {"decide": decide_cuda.launches, "sweep": sweep_cuda.launches,
            "probe_add": probe_add_cuda.launches}


def _int_arg(q: dict, name: str) -> Optional[int]:
    """A query argument as a positive int, None when absent, 0 or
    malformed."""
    try:
        return int(q.get(name, ["0"])[-1]) or None
    except ValueError:
        return None


def spawn_daemon(cfg: DaemonConfig, mesh=None, engine=None) -> Daemon:
    """reference: daemon.go › SpawnDaemon.  ``mesh`` (mesh.py) is the
    instance's: by default every visible GPU on ``cuda``.  ``engine``
    injects the instance's engine (e.g. oracle.OracleEngine), which
    then serves on its own terms: ``cfg.device`` and ``mesh`` build
    nothing."""
    d = Daemon(cfg, mesh=mesh, engine=engine)
    log.info("gubernator-tpu-torch daemon up: grpc=%s http=%s "
             "advertise=%s device=%s engine=%s",
             cfg.grpc_listen_address or "off", cfg.http_listen_address,
             d.advertise_address or "-", cfg.device,
             type(d.instance.engine).__name__)
    return d
