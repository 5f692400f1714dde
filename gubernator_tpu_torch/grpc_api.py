"""gRPC service registration and client stubs: the port's copy of
gubernator_tpu/grpc_api.py.

Written by hand on grpc's generic-handler API (no generated
``*_pb2_grpc``); method paths and wire format are those of generated
code: /pb.gubernator.V1/GetRateLimits and /pb.gubernator.V1/HealthCheck,
/pb.gubernator.PeersV1/GetPeerRateLimits and UpdatePeerGlobals, plus
the standard /grpc.health.v1.Health/Check and Watch.  Imports grpcio, so
only a daemon that serves gRPC imports this module.
"""
from __future__ import annotations

import threading
import time

import grpc

from .proto import gubernator_pb2 as pb
from .proto import peers_pb2 as peers_pb

V1_SERVICE = "pb.gubernator.V1"
PEERS_SERVICE = "pb.gubernator.PeersV1"
HEALTH_SERVICE = "grpc.health.v1.Health"


def add_v1_servicer_raw(server: grpc.Server, servicer) -> None:
    """V1 with GetRateLimits as raw bytes in and out
    (``servicer.GetRateLimitsWire(data, ctx) -> bytes``), so the
    instance's C++ wire lane runs without protobuf; HealthCheck keeps
    the generated classes.  Clients cannot tell the difference."""
    handlers = {
        "GetRateLimits": grpc.unary_unary_rpc_method_handler(
            servicer.GetRateLimitsWire,
            request_deserializer=None, response_serializer=None),
        "HealthCheck": grpc.unary_unary_rpc_method_handler(
            servicer.HealthCheck,
            request_deserializer=pb.HealthCheckReq.FromString,
            response_serializer=pb.HealthCheckResp.SerializeToString),
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(V1_SERVICE, handlers),))


def add_peers_servicer_raw(server: grpc.Server, servicer) -> None:
    """PeersV1 with GetPeerRateLimits as raw bytes in and out
    (``servicer.GetPeerRateLimitsWire(data, ctx) -> bytes``, the C++
    lane on the owner); UpdatePeerGlobals keeps the generated classes
    (a cold path)."""
    handlers = {
        "GetPeerRateLimits": grpc.unary_unary_rpc_method_handler(
            servicer.GetPeerRateLimitsWire,
            request_deserializer=None, response_serializer=None),
        "UpdatePeerGlobals": grpc.unary_unary_rpc_method_handler(
            servicer.UpdatePeerGlobals,
            request_deserializer=peers_pb.UpdatePeerGlobalsReq.FromString,
            response_serializer=(
                peers_pb.UpdatePeerGlobalsResp.SerializeToString)),
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(PEERS_SERVICE, handlers),))


#: grpc.health.v1.HealthCheckResponse: field 1, ServingStatus
SERVING = bytes([0x08, 0x01])
NOT_SERVING = bytes([0x08, 0x02])
#: open Watch streams at most (each parks a server thread), and how
#: often a stream reads the status
MAX_WATCHERS = 4
WATCH_POLL_S = 1.0


def add_health_servicer(server: grpc.Server, instance) -> None:
    """The standard ``grpc.health.v1.Health`` that Kubernetes gRPC probes
    speak, on hand-written wire bytes: any service name is answered with
    the instance's health (SERVING or NOT_SERVING).  ``Watch`` sends the
    status at once, then again on every change (polled every
    WATCH_POLL_S), until the client leaves; a sync server parks one
    worker thread per open stream, so at most MAX_WATCHERS streams are
    open and a further one is refused RESOURCE_EXHAUSTED (probes should
    poll Check)."""
    mu = threading.Lock()
    watchers = [0]

    def status() -> bytes:
        try:
            ok = instance.health_check().status == "healthy"
        except Exception:  # noqa: BLE001 - a failing source is unhealthy
            return NOT_SERVING
        return SERVING if ok else NOT_SERVING

    def check(request: bytes, context) -> bytes:
        return status()

    def watch(request: bytes, context):
        with mu:
            if watchers[0] >= MAX_WATCHERS:
                context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED,
                              "too many health watchers; poll Check")
            watchers[0] += 1
        try:
            last = None
            while context.is_active():
                cur = status()
                if cur != last:
                    last = cur
                    yield cur
                time.sleep(WATCH_POLL_S)
        finally:
            with mu:
                watchers[0] -= 1

    handlers = {
        "Check": grpc.unary_unary_rpc_method_handler(
            check, request_deserializer=None, response_serializer=None),
        "Watch": grpc.unary_stream_rpc_method_handler(
            watch, request_deserializer=None, response_serializer=None),
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(HEALTH_SERVICE, handlers),))


class V1Stub:
    """Client stub for the V1 service (the generated code's twin)."""

    def __init__(self, channel: grpc.Channel):
        self.GetRateLimits = channel.unary_unary(
            f"/{V1_SERVICE}/GetRateLimits",
            request_serializer=pb.GetRateLimitsReq.SerializeToString,
            response_deserializer=pb.GetRateLimitsResp.FromString)
        self.HealthCheck = channel.unary_unary(
            f"/{V1_SERVICE}/HealthCheck",
            request_serializer=pb.HealthCheckReq.SerializeToString,
            response_deserializer=pb.HealthCheckResp.FromString)


class PeersV1Stub:
    """Client stub for the PeersV1 service."""

    def __init__(self, channel: grpc.Channel):
        self.GetPeerRateLimits = channel.unary_unary(
            f"/{PEERS_SERVICE}/GetPeerRateLimits",
            request_serializer=(
                peers_pb.GetPeerRateLimitsReq.SerializeToString),
            response_deserializer=peers_pb.GetPeerRateLimitsResp.FromString)
        self.UpdatePeerGlobals = channel.unary_unary(
            f"/{PEERS_SERVICE}/UpdatePeerGlobals",
            request_serializer=(
                peers_pb.UpdatePeerGlobalsReq.SerializeToString),
            response_deserializer=peers_pb.UpdatePeerGlobalsResp.FromString)


def raw_unary(channel: grpc.Channel, method: str,
              service: str = V1_SERVICE):
    """Bytes-in / bytes-out unary call handle (identity serializers) on
    ``service``; wire format is that of the typed stubs.  The peer send
    lanes (peer_client.py) ship joined TLV slices through these on
    PEERS_SERVICE."""
    return channel.unary_unary(f"/{service}/{method}")


def dial_peer(address: str, tls_creds=None) -> grpc.Channel:
    """A channel to a peer (peer_client.go › dialPeer): over TLS with
    ``tls_creds`` (tlsutil.py › TLSContext.grpc_client_credentials),
    else in plaintext."""
    opts = [("grpc.enable_retries", 1)]
    if tls_creds is not None:
        return grpc.secure_channel(address, tls_creds, options=opts)
    return grpc.insecure_channel(address, options=opts)
