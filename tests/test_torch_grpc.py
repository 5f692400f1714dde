"""The port's gRPC front door on the CPU: the verify flow over
/pb.gubernator.V1/GetRateLimits (raw wire bytes and the typed stub), a
HealthCheck equal to the JAX instance's, INVALID_ARGUMENT on bytes that
are no GetRateLimitsReq, and the grpc.health.v1 probe.  Every server
binds port 0."""
import sys

import grpc
import pytest

from gubernator_tpu_torch.config import DaemonConfig, setup_daemon_config
from gubernator_tpu_torch.daemon import spawn_daemon
from gubernator_tpu_torch.grpc_api import (HEALTH_SERVICE, SERVING,
                                           V1Stub, raw_unary)
from gubernator_tpu_torch.proto import gubernator_pb2 as pb
from gubernator_tpu_torch.types import RateLimitRequest
from gubernator_tpu_torch.wire import encode_get_rate_limits

CAP = 1 << 12


@pytest.fixture(params=["", "xla"], ids=["bucket", "classic"])
def daemon(request):
    d = spawn_daemon(DaemonConfig(grpc_listen_address="127.0.0.1:0",
                                  http_listen_address="127.0.0.1:0",
                                  cache_size=CAP, device="cpu",
                                  engine=request.param))
    try:
        yield d
    finally:
        d.close()


@pytest.fixture
def channel(daemon):
    ch = grpc.insecure_channel(f"127.0.0.1:{daemon.grpc_port}")
    try:
        yield ch
    finally:
        ch.close()


def test_verify_flow_over_raw_wire_bytes(channel):
    call = raw_unary(channel, "GetRateLimits")
    data = encode_get_rate_limits([RateLimitRequest(
        name="api", unique_key="u1", hits=1, limit=3, duration=5000)])
    got = [pb.GetRateLimitsResp.FromString(call(data, timeout=30))
           .responses[0] for _ in range(5)]
    assert [r.status for r in got] == [0, 0, 0, 1, 1]
    assert [r.remaining for r in got] == [2, 1, 0, 0, 0]
    assert got[0].reset_time > 0 and not got[0].error


def test_verify_flow_over_the_typed_stub(channel):
    stub = V1Stub(channel)
    req = pb.GetRateLimitsReq()
    req.requests.add(name="api", unique_key="u2", hits=1, limit=3,
                     duration=5000)
    req.requests.add(name="api", unique_key="")
    got = [stub.GetRateLimits(req, timeout=30).responses for _ in range(5)]
    assert [r[0].status for r in got] == [0, 0, 0, 1, 1]
    assert [r[0].remaining for r in got] == [2, 1, 0, 0, 0]
    assert got[0][1].error == "field 'unique_key' cannot be empty"


def test_health_check_equals_the_jax_instance(monkeypatch, channel):
    from gubernator_tpu.config import Config as JaxConfig
    from gubernator_tpu.instance import V1Instance as JaxInstance
    from gubernator_tpu.wire import health_to_pb

    for var in ("GUBER_ANALYTICS", "GUBER_SLO", "GUBER_MEM_LEDGER"):
        monkeypatch.setenv(var, "0")
    got = V1Stub(channel).HealthCheck(pb.HealthCheckReq(), timeout=30)
    jax_inst = JaxInstance(JaxConfig(cache_size=CAP, sweep_interval_ms=0,
                                     hot_set_capacity=0))
    try:
        want = health_to_pb(jax_inst.health_check())
    finally:
        jax_inst.close()
    assert got.SerializeToString() == want.SerializeToString()
    assert (got.status, got.message) == ("healthy", "")


def test_garbage_bytes_are_invalid_argument(channel):
    call = raw_unary(channel, "GetRateLimits")
    with pytest.raises(grpc.RpcError) as e:
        call(b"\xff\xff\xff", timeout=30)
    assert e.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    big = encode_get_rate_limits([RateLimitRequest(
        name="n", unique_key=f"k{i}", limit=1) for i in range(1001)])
    with pytest.raises(grpc.RpcError) as e:
        call(big, timeout=30)
    assert e.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    assert "list too large" in e.value.details()


def test_grpc_health_v1_probe(channel):
    check = raw_unary(channel, "Check", service=HEALTH_SERVICE)
    assert check(b"", timeout=30) == SERVING
    watch = channel.unary_stream(f"/{HEALTH_SERVICE}/Watch")
    stream = watch(b"", timeout=30)
    try:
        assert next(stream) == SERVING
    finally:
        stream.cancel()


def test_grpc_address_is_read_and_defaults_as_in_jax():
    from gubernator_tpu.config import DaemonConfig as JaxDaemonConfig

    assert DaemonConfig().grpc_listen_address == \
        JaxDaemonConfig().grpc_listen_address == "localhost:1051"
    cfg = setup_daemon_config(env={"GUBER_GRPC_ADDRESS": "127.0.0.1:7"})
    assert cfg.grpc_listen_address == "127.0.0.1:7"


def test_no_grpcio_with_an_address_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "grpc", None)
    with pytest.raises(RuntimeError, match="needs grpcio"):
        spawn_daemon(DaemonConfig(grpc_listen_address="127.0.0.1:0",
                                  http_listen_address="127.0.0.1:0",
                                  cache_size=CAP, device="cpu"))


def test_no_grpc_address_serves_http_only():
    d = spawn_daemon(DaemonConfig(grpc_listen_address="",
                                  http_listen_address="127.0.0.1:0",
                                  cache_size=CAP, device="cpu"))
    try:
        assert d.grpc_server is None and d.grpc_port == 0
        assert d.http_port > 0
    finally:
        d.close()
