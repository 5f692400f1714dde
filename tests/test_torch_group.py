"""The port's SO_REUSEPORT subprocess group (cluster.py ›
start_subprocess_group): N daemon processes behind one client port,
ring-split over the peer wire.  Mirrors tests/test_reuseport_group.py
with 2 CPU workers, and adds a worker killed for real (its peer ejects
it and serves its keys degraded) and a cuda group on a host without a
GPU, which must fail to start.  Every count is exact."""
from __future__ import annotations

import json
import socket
import sys
import time
import urllib.request

import grpc
import pytest

from gubernator_tpu_torch.cluster import start_subprocess_group
from gubernator_tpu_torch.proto import gubernator_pb2 as pb
from gubernator_tpu_torch.types import RateLimitRequest
from gubernator_tpu_torch.wire import encode_get_rate_limits

pytestmark = pytest.mark.skipif(
    not hasattr(socket, "SO_REUSEPORT")
    or not sys.platform.startswith("linux"),
    reason="the SO_REUSEPORT group is a Linux deployment shape")


def _raw_channel(addr: str) -> grpc.Channel:
    # a local subchannel pool gives each channel its own TCP connection,
    # which SO_REUSEPORT may hand to either process
    return grpc.insecure_channel(
        addr, options=[("grpc.use_local_subchannel_pool", 1)])


def _batch(key: str, hits: int, limit: int = 1_000_000) -> bytes:
    return encode_get_rate_limits([RateLimitRequest(
        name="group", unique_key=key, hits=hits, limit=limit,
        duration=60_000)])


def _call(ch, data: bytes):
    out = ch.unary_unary("/pb.gubernator.V1/GetRateLimits")(data, timeout=30)
    return pb.GetRateLimitsResp.FromString(out).responses


def _metrics(http_addr: str) -> str:
    with urllib.request.urlopen(f"http://{http_addr}/metrics",
                                timeout=10) as f:
        return f.read().decode()


@pytest.fixture(scope="module")
def group():
    g = start_subprocess_group(2, device="cpu", cache_size=1 << 12,
                               batch_rows=256)
    yield g
    g.stop()


def test_group_conserves_hits_across_connections(group):
    """One key hit over 12 connections, whichever process each lands on,
    drains exactly once per hit (exact)."""
    chans = [_raw_channel(group.client_address) for _ in range(12)]
    try:
        total = 0
        for ch in chans:
            [r] = _call(ch, _batch("shared-key", hits=3))
            total += 3
            assert (r.error, r.status) == ("", 0)
            assert r.remaining == 1_000_000 - total
        [r] = _call(chans[0], _batch("shared-key", hits=0))
        assert r.remaining == 1_000_000 - total
    finally:
        for ch in chans:
            ch.close()


def test_group_spreads_connections(group):
    """12 connections over 2 processes: both serve client requests
    (P[all on one] = 2^-11), read from each process's /metrics."""
    chans = [_raw_channel(group.client_address) for _ in range(12)]
    try:
        for i, ch in enumerate(chans):
            _call(ch, _batch(f"spread-{i}", hits=1))
    finally:
        for ch in chans:
            ch.close()
    seen = 0
    for addr in group.http_addresses:
        text = _metrics(addr)
        seen += any(
            line.split()[-1] not in ("0", "0.0")
            for line in text.splitlines()
            if line.startswith("gubernator_wire_lane_requests_total")
            and ('lane="wire_clustered"' in line
                 or 'lane="wire_local"' in line))
    assert seen == 2, "the kernel did not spread the connections"


def test_group_health_on_shared_port(group):
    ch = _raw_channel(group.client_address)
    try:
        check = ch.unary_unary("/grpc.health.v1.Health/Check")
        assert check(b"", timeout=10) == bytes([0x08, 0x01])
    finally:
        ch.close()


def test_killed_worker_is_ejected_and_its_keys_serve_degraded():
    """SIGKILL one of two workers: the survivor's forwards to it fail
    and serve degraded (flagged, never an error row), its health gate
    ejects the dead peer, and the survivor's own keys stay exact."""
    g = start_subprocess_group(
        2, device="cpu", cache_size=1 << 12, batch_rows=256,
        env_extra={"GUBER_PEER_EJECT_AFTER": "300ms",
                   "GUBER_PEER_READMIT_AFTER": "300ms",
                   "GUBER_BATCH_TIMEOUT": "200ms"})
    try:
        from gubernator_tpu_torch.peers import ReplicatedConsistentHash

        class Peer:
            def __init__(self, addr):
                self.info = type("I", (), {"grpc_address": addr})()

        ring = ReplicatedConsistentHash()
        for a in g.grpc_addresses:
            ring.add(Peer(a))
        keys = [f"kk{i}" for i in range(200)]
        dead_keys = [k for k in keys if ring.get(f"group_{k}").info
                     .grpc_address == g.grpc_addresses[1]]
        own_keys = [k for k in keys if k not in dead_keys]
        assert dead_keys and own_keys
        data = encode_get_rate_limits([RateLimitRequest(
            name="group", unique_key=k, hits=1, limit=1000,
            duration=60_000) for k in keys])
        g.kill(1)
        t_kill = time.time()
        ejected = []
        sent = 0
        deadline = time.monotonic() + 60
        while not ejected and time.monotonic() < deadline:
            ch = _raw_channel(g.client_address)  # lands on the survivor
            try:
                resps = _call(ch, data)
            finally:
                ch.close()
            sent += 1
            for k, r in zip(keys, resps):
                assert r.error == "", r.error
                if k in dead_keys:
                    assert r.metadata["degraded"] == "true"
                    assert r.metadata["degraded_peer"] == \
                        g.grpc_addresses[1]
                else:
                    assert "degraded" not in r.metadata
                    assert r.remaining == 1000 - sent  # exact
            with urllib.request.urlopen(
                    f"http://{g.http_addresses[0]}/debug/events"
                    "?kind=ring_ejected", timeout=10) as f:
                ejected = json.loads(f.read())["events"]
        assert ejected and ejected[0]["peer"] == g.grpc_addresses[1]
        assert ejected[0]["t_ms"] >= t_kill * 1000 - 1000
        text = _metrics(g.http_addresses[0])
        flagged = sum(float(line.split()[-1]) for line in text.splitlines()
                      if line.startswith("gubernator_degraded_served"))
        assert flagged >= len(dead_keys) * sent
    finally:
        g.stop()


@pytest.mark.parametrize("prebuild", [True, False])
def test_cuda_group_on_a_host_without_a_gpu_fails_to_start(
        prebuild, tmp_path, monkeypatch):
    """No fallback to the CPU: building the kernels in the parent fails
    without the CUDA toolkit, and (with that build skipped) a cuda
    worker that finds no GPU exits non-zero, so the start raises with
    its log tail."""
    import torch

    from gubernator_tpu_torch import cluster

    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    if not prebuild:
        monkeypatch.setattr(cluster, "_prebuild", lambda device: None)
    with pytest.raises(RuntimeError) as e:
        start_subprocess_group(2, device="cuda", cache_size=1 << 12,
                               batch_rows=256, log_dir=str(tmp_path),
                               ready_timeout=60)
    msg = str(e.value)
    if prebuild:
        assert "nvcc" in msg
    else:
        assert "exited rc=" in msg and "CUDA" in msg
