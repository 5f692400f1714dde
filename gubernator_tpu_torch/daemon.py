"""Daemon: the gRPC and HTTP front doors around one V1Instance.

The solo daemon of gubernator_tpu/daemon.py:

- gRPC on ``grpc_listen_address`` (grpc_api.py): V1 GetRateLimits as raw
  wire bytes into ``V1Instance.get_rate_limits_wire`` (a ValueError
  becomes INVALID_ARGUMENT), V1 HealthCheck, and grpc.health.v1.  grpcio
  is imported only when an address is set; set and missing, the daemon
  raises;
- an HTTP/JSON gateway on ``http_listen_address``: POST
  /v1/GetRateLimits (numeric enums in and out, snake_case and camelCase
  field names) through the object lane, and GET /healthz (also
  /v1/HealthCheck).
"""
from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .config import DaemonConfig
from .instance import V1Instance
from .types import Behavior, RateLimitRequest

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
    host, _, port = addr.rpartition(":")
    return host.strip("[]") or "0.0.0.0", int(port)


class _V1Servicer:
    """V1 over the instance: GetRateLimits as raw wire bytes."""

    def __init__(self, instance: V1Instance):
        self.instance = instance

    def GetRateLimitsWire(self, request: bytes, context):
        import grpc

        try:
            return self.instance.get_rate_limits_wire(request)
        except ValueError as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))

    def HealthCheck(self, request, context):
        from .wire import health_to_pb

        return health_to_pb(self.instance.health_check())


class Daemon:
    """Use spawn_daemon() to construct."""

    def __init__(self, cfg: DaemonConfig):
        self.cfg = cfg
        self._closed = False
        self.http_server: Optional[ThreadingHTTPServer] = None
        self._http_thread: Optional[threading.Thread] = None
        self.grpc_server = None
        self.grpc_port = 0
        self.instance = V1Instance(cfg.instance_config())
        try:
            # warm-up: build the kernel and run one wave before serving
            self.instance.get_rate_limits(
                [RateLimitRequest(name="_warmup", unique_key="w", hits=0,
                                  limit=1, duration=1000)])
            self.instance.engine.warmup()
            if cfg.grpc_listen_address:
                self._start_grpc(cfg.grpc_listen_address)
            self._start_http(cfg.http_listen_address)
        except BaseException:
            self.close()
            raise

    def _start_grpc(self, addr: str) -> None:
        """V1 (raw wire bytes) and grpc.health.v1 on ``addr``; raises
        when grpcio is missing or the address cannot be bound."""
        try:
            import grpc
        except ImportError as e:
            raise RuntimeError(
                f"grpc_listen_address={addr!r} needs grpcio, which is not "
                "installed; set GUBER_GRPC_ADDRESS= (empty) to serve HTTP "
                "only") from e
        from concurrent.futures import ThreadPoolExecutor

        from .grpc_api import add_health_servicer, add_v1_servicer_raw

        server = grpc.server(ThreadPoolExecutor(max_workers=32),
                             options=[("grpc.so_reuseport", 0)])
        add_v1_servicer_raw(server, _V1Servicer(self.instance))
        add_health_servicer(server, self.instance)
        port = server.add_insecure_port(addr)
        if port == 0:
            raise OSError(f"failed to bind {addr}")
        server.start()
        self.grpc_server, self.grpc_port = server, port

    def _start_http(self, addr: str) -> None:
        host, port = _split_host_port(addr)
        daemon = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet
                log.debug("http: " + fmt, *args)

            def _send(self, code: int, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path.split("?")[0] not in ("/healthz",
                                                   "/v1/HealthCheck"):
                    self._send(404, b'{"error":"not found"}')
                    return
                h = daemon.instance.health_check()
                self._send(200 if h.status == "healthy" else 503,
                           json.dumps({"status": h.status,
                                       "message": h.message,
                                       "peer_count": h.peer_count}).encode())

            def do_POST(self):
                if self.path not in ("/v1/GetRateLimits",
                                     "/v1/V1/GetRateLimits"):
                    self._send(404, b'{"error":"not found"}')
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(length) or b"{}")
                    reqs = [_json_to_req(o)
                            for o in payload.get("requests", [])]
                    resps = daemon.instance.get_rate_limits(reqs)
                except ValueError as e:
                    self._send(400, json.dumps({"error": str(e)}).encode())
                    return
                self._send(200, json.dumps({
                    "responses": [_resp_to_json(r) for r in resps]}).encode())

        self.http_server = ThreadingHTTPServer((host, port), Handler)
        self.http_port = self.http_server.server_address[1]
        self._http_thread = threading.Thread(
            target=self.http_server.serve_forever, daemon=True,
            name=f"http-{addr}")
        self._http_thread.start()

    def close(self) -> None:
        """Stop the listener first, so no request lands after the
        instance closed."""
        if self._closed:
            return
        self._closed = True
        if self.grpc_server is not None:
            self.grpc_server.stop(grace=None).wait()
        if self.http_server is not None:
            self.http_server.shutdown()
            self.http_server.server_close()
        self.instance.close()


def spawn_daemon(cfg: DaemonConfig) -> Daemon:
    """reference: daemon.go › SpawnDaemon."""
    d = Daemon(cfg)
    log.info("gubernator-tpu-torch daemon up: grpc=%s http=%s device=%s "
             "engine=%s", cfg.grpc_listen_address or "off",
             cfg.http_listen_address, cfg.device,
             type(d.instance.engine).__name__)
    return d
