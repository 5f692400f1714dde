"""The port's client library (gubernator_tpu_torch/client.py) held to the
JAX package's: the port's ``Client`` (gRPC) and ``HttpClient`` (JSON)
against a port daemon on the CPU give the responses the JAX clients give
against the same daemon, on the same seeded stream.  Each batch goes out
through the port's client on its keys, then at once through JAX's on a
twin set of keys, so the two see the same state; the daemon stamps its
own clock, so the reset times may differ by the time between the two
calls of a batch and no more.  Also: the health check, ``check``, the
caller's trace context riding the gRPC call, and TLS credentials."""
import time

import numpy as np
import pytest

from gubernator_tpu.client import Client as JaxClient
from gubernator_tpu.client import HttpClient as JaxHttpClient
from gubernator_tpu.types import RateLimitRequest as JaxReq
from gubernator_tpu_torch.client import Client, HttpClient
from gubernator_tpu_torch.config import DaemonConfig, TLSSettings
from gubernator_tpu_torch.daemon import spawn_daemon
from gubernator_tpu_torch.types import RateLimitRequest


@pytest.fixture(scope="module")
def daemon():
    d = spawn_daemon(DaemonConfig(device="cpu", cache_size=1 << 12,
                                  batch_rows=64,
                                  grpc_listen_address="127.0.0.1:0",
                                  http_listen_address="127.0.0.1:0"))
    yield d
    d.close()


def stream(seed: int):
    """Batches of (unique key, hits, limit, duration, algorithm,
    behavior) over a few keys: token and leaky, RESET and DRAIN rows,
    queries, an empty unique key now and then."""
    rng = np.random.default_rng(seed)
    cfg = {k: (int(rng.integers(2, 9)), 60_000 * int(rng.integers(1, 4)),
               int(rng.integers(0, 2))) for k in range(10)}
    out = []
    for b in range(8):
        rows = []
        for i in range(int(rng.integers(1, 30))):
            k = int(rng.integers(0, 10))
            u = rng.random()
            beh = 8 if u < 0.06 else 32 if u < 0.12 else 0
            lim, dur, algo = cfg[k]
            rows.append(("" if (b, i) == (3, 0) else f"k{k}",
                         int(rng.integers(0, 4)), lim, dur, algo, beh))
        out.append(rows)
    return out


def reqs_of(rows, name, cls):
    return [cls(name=name, unique_key=u, hits=h, limit=lim, duration=dur,
                algorithm=algo, behavior=beh)
            for u, h, lim, dur, algo, beh in rows]


def answers(resps):
    return [(int(r.status), r.limit, r.remaining, r.error, dict(r.metadata))
            for r in resps]


@pytest.mark.parametrize("transport", ["grpc", "http"])
def test_clients_answer_as_jax_clients(daemon, transport):
    if transport == "grpc":
        addr = f"127.0.0.1:{daemon.grpc_port}"
        port_c, jax_c = Client(addr), JaxClient(addr)
    else:
        base = f"http://127.0.0.1:{daemon.http_port}"
        port_c, jax_c = HttpClient(base), JaxHttpClient(base)
    name = f"cl_{transport}"
    over = 0
    lag = 0.0  # the longest gap between a batch's two calls so far
    for rows in stream(1 if transport == "grpc" else 2):
        t0 = time.time() * 1000
        a = port_c.get_rate_limits(reqs_of(rows, name + "_p",
                                           RateLimitRequest))
        b = jax_c.get_rate_limits(reqs_of(rows, name + "_j", JaxReq))
        lag = max(lag, time.time() * 1000 - t0)
        assert answers(a) == answers(b)
        for x, y in zip(a, b):
            if not x.error:
                # a token key's reset was stamped at its first batch
                assert 0 <= y.reset_time - x.reset_time <= lag + 1
        over += sum(int(x.status) == 1 for x in a)
    assert over > 0
    h, j = port_c.health_check(), jax_c.health_check()
    assert (h.status, h.message, h.peer_count) == \
        (j.status, j.message, j.peer_count)
    r = port_c.check(RateLimitRequest(name=name, unique_key="one",
                                      limit=2, duration=60_000))
    assert (int(r.status), r.remaining) == (0, 1)
    if transport == "grpc":
        port_c.close()
        jax_c.close()


def test_client_is_a_context_manager(daemon):
    with Client(f"127.0.0.1:{daemon.grpc_port}", timeout_s=10) as c:
        assert c.health_check().status == "healthy"
    with pytest.raises(Exception):
        c.health_check()


def test_grpc_client_carries_the_callers_trace(daemon):
    from gubernator_tpu_torch.tracing import request_context

    inst = daemon.instance
    sample = inst.span_recorder.sample
    inst.span_recorder.sample = 1.0
    tid = "4bf92f3577b34da6a3ce929d0e0e4736"
    try:
        with Client(f"127.0.0.1:{daemon.grpc_port}") as c, \
                request_context(f"00-{tid}-00f067aa0ba902b7-01"):
            c.check(RateLimitRequest(name="tr", unique_key="k", limit=5,
                                     duration=60_000))
        assert inst.span_recorder.spans(trace_id=tid)
    finally:
        inst.span_recorder.sample = sample


def test_grpc_client_dials_tls():
    d = spawn_daemon(DaemonConfig(device="cpu", cache_size=1 << 12,
                                  batch_rows=64,
                                  grpc_listen_address="127.0.0.1:0",
                                  http_listen_address="127.0.0.1:0",
                                  tls=TLSSettings(auto_tls=True)))
    try:
        with Client(f"localhost:{d.grpc_port}",
                    tls_creds=d.tls.grpc_client_credentials()) as c:
            out = c.get_rate_limits([RateLimitRequest(
                name="tls", unique_key="k", limit=3, duration=60_000)] * 4)
        assert [r.remaining for r in out] == [2, 1, 0, 0]
        assert [int(r.status) for r in out] == [0, 0, 0, 1]
    finally:
        d.close()
