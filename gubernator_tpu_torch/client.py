"""Client library for a port daemon: the port's copy of
gubernator_tpu/client.py.

The analog of the reference's Go client helpers: a thin wrapper over
the gRPC V1 service (grpc_api.V1Stub, with optional TLS credentials and
the caller's W3C trace context), plus a JSON client for the HTTP
gateway.  Imports grpcio only when a gRPC ``Client`` is built.
"""
from __future__ import annotations

import json
import urllib.request
from typing import List, Optional, Sequence

from .types import HealthCheckResponse, RateLimitRequest, RateLimitResponse


class Client:
    """gRPC client for V1.GetRateLimits / V1.HealthCheck."""

    def __init__(self, address: str, tls_creds=None,
                 timeout_s: float = 30.0):
        import grpc

        from .grpc_api import V1Stub

        self.address = address
        self.timeout_s = timeout_s
        if tls_creds is not None:
            self._channel = grpc.secure_channel(address, tls_creds)
        else:
            self._channel = grpc.insecure_channel(address)
        self._stub = V1Stub(self._channel)

    def get_rate_limits(self, reqs: Sequence[RateLimitRequest]
                        ) -> List[RateLimitResponse]:
        from .proto import gubernator_pb2 as pb
        from .tracing import outbound_metadata
        from .wire import req_to_pb, resp_from_pb

        msg = pb.GetRateLimitsReq()
        msg.requests.extend(req_to_pb(r) for r in reqs)
        # the caller's W3C trace context, when one is active (a service
        # calling the rate limiter inside its own request)
        resp = self._stub.GetRateLimits(msg, timeout=self.timeout_s,
                                        metadata=outbound_metadata())
        return [resp_from_pb(m) for m in resp.responses]

    def check(self, req: RateLimitRequest) -> RateLimitResponse:
        return self.get_rate_limits([req])[0]

    def health_check(self) -> HealthCheckResponse:
        from .proto import gubernator_pb2 as pb

        h = self._stub.HealthCheck(pb.HealthCheckReq(),
                                   timeout=self.timeout_s)
        return HealthCheckResponse(status=h.status, message=h.message,
                                   peer_count=h.peer_count)

    def close(self) -> None:
        self._channel.close()

    def __enter__(self) -> "Client":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class HttpClient:
    """JSON client for the HTTP gateway (grpc-gateway's mirror)."""

    def __init__(self, base_url: str, timeout_s: float = 30.0):
        self.base_url = base_url.rstrip("/")
        self.timeout_s = timeout_s

    def get_rate_limits(self, reqs: Sequence[RateLimitRequest]
                        ) -> List[RateLimitResponse]:
        payload = {"requests": [{
            "name": r.name, "unique_key": r.unique_key, "hits": int(r.hits),
            "limit": int(r.limit), "duration": int(r.duration),
            "algorithm": int(r.algorithm), "behavior": int(r.behavior),
            "burst": int(r.burst), "metadata": r.metadata} for r in reqs]}
        req = urllib.request.Request(
            self.base_url + "/v1/GetRateLimits",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=self.timeout_s) as f:
            body = json.loads(f.read())
        return [RateLimitResponse(
            status=o.get("status", 0), limit=o.get("limit", 0),
            remaining=o.get("remaining", 0),
            reset_time=o.get("reset_time", 0), error=o.get("error", ""),
            metadata=o.get("metadata", {})) for o in body["responses"]]

    def check(self, req: RateLimitRequest) -> RateLimitResponse:
        return self.get_rate_limits([req])[0]

    def health_check(self) -> HealthCheckResponse:
        with urllib.request.urlopen(self.base_url + "/v1/HealthCheck",
                                    timeout=self.timeout_s) as f:
            o = json.loads(f.read())
        return HealthCheckResponse(status=o["status"],
                                   message=o.get("message", ""),
                                   peer_count=o.get("peer_count", 0))
