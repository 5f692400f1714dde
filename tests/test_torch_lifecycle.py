"""One port daemon's serving lifecycle on the CPU:

- GET /metrics serves the instance's registry as Prometheus text;
- GET /healthz?deep=1 has the top-level keys, dispatcher keys and
  admission keys of a JAX daemon's (whose SLO and memory blocks are off,
  as those subsystems are not ported);
- GET /debug/events serves the flight recorder with its filters;
- a shed batch answers HTTP 429 and gRPC RESOURCE_EXHAUSTED;
- close() drains: /healthz answers 503 "draining" while a request still
  serves, then requests shed with "draining", and the recorder holds
  drain_started and drain_completed;
- the port's ``cmd.healthcheck`` exits as the JAX CLI does against the
  same daemon states (healthy, a stalled wave, draining).
"""
import json
import threading
import time
import urllib.error
import urllib.request

import grpc
import pytest
from prometheus_client.parser import text_string_to_metric_families

from gubernator_tpu.cmd import healthcheck as jax_healthcheck
from gubernator_tpu_torch.cmd import healthcheck
from gubernator_tpu_torch.config import DaemonConfig, setup_daemon_config
from gubernator_tpu_torch.daemon import spawn_daemon
from gubernator_tpu_torch.dispatcher import ResourceExhausted
from gubernator_tpu_torch.types import RateLimitRequest
from gubernator_tpu_torch.wire import encode_get_rate_limits

CAP = 1 << 12
QUIET = ("GUBER_ANALYTICS", "GUBER_SLO", "GUBER_MEM_LEDGER")


def daemon_cfg(**kw):
    return DaemonConfig(grpc_listen_address="127.0.0.1:0",
                        http_listen_address="127.0.0.1:0", cache_size=CAP,
                        device="cpu", **kw)


@pytest.fixture()
def daemon():
    d = spawn_daemon(daemon_cfg())
    try:
        yield d
    finally:
        d.close()


def get(port: int, path: str):
    """(status, headers, body bytes) of a GET, error statuses included."""
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def post(port: int, reqs: list):
    body = json.dumps({"requests": reqs}).encode()
    r = urllib.request.Request(f"http://127.0.0.1:{port}/v1/GetRateLimits",
                               body, {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(r, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


REQ = {"name": "life", "uniqueKey": "u1", "hits": 1, "limit": 3,
       "duration": 60_000}


def test_metrics_are_prometheus_text(daemon):
    for _ in range(4):
        assert post(daemon.http_port, [REQ])[0] == 200
    code, headers, body = get(daemon.http_port, "/metrics")
    assert code == 200
    assert headers["Content-Type"] == "text/plain; version=0.0.4"
    fams = {f.name: f for f in text_string_to_metric_families(body.decode())}
    val = {(s.name, tuple(sorted(s.labels.items()))): s.value
           for f in fams.values() for s in f.samples}
    # the daemon's warm-up request and the 4 posted
    assert val[("gubernator_getratelimit_total", (("calltype", "api"),))] \
        == 5
    assert val[("gubernator_over_limit_total", ())] == 1
    assert val[("gubernator_dispatcher_wave_duration_count", ())] == \
        daemon.instance.dispatcher.debug_stats()["waves"] == 5
    assert fams["gubernator_dispatcher_wave_duration"].type == "histogram"
    assert fams["gubernator_admission_shed"].type == "counter"
    assert val[("gubernator_concurrent_checks_counter", ())] == 0


@pytest.fixture()
def jax_daemon(monkeypatch):
    from gubernator_tpu.config import DaemonConfig as JaxDaemonConfig
    from gubernator_tpu.daemon import spawn_daemon as jax_spawn
    from gubernator_tpu.parallel import make_mesh

    for var in QUIET:
        monkeypatch.setenv(var, "0")
    d = jax_spawn(JaxDaemonConfig(grpc_listen_address="127.0.0.1:0",
                                  http_listen_address="127.0.0.1:0",
                                  cache_size=CAP), mesh=make_mesh(n=1))
    try:
        yield d
    finally:
        d.close()


def test_deep_healthz_has_the_jax_keys(daemon, jax_daemon):
    bodies = []
    for d in (daemon, jax_daemon):
        code, _, body = get(d.http_port, "/healthz?deep=1")
        assert code == 200
        bodies.append(json.loads(body))
    got, want = bodies
    assert got.keys() == want.keys() == {"status", "message", "peer_count",
                                         "dispatcher", "peers"}
    assert got["dispatcher"].keys() == want["dispatcher"].keys()
    assert got["dispatcher"]["admission"].keys() == \
        want["dispatcher"]["admission"].keys()
    assert got["dispatcher"]["buffer_pool"].keys() == \
        want["dispatcher"]["buffer_pool"].keys()
    assert (got["status"], got["message"], got["peer_count"],
            got["peers"]) == ("healthy", "", 0, {})
    code, _, body = get(daemon.http_port, "/healthz")
    assert code == 200 and "dispatcher" not in json.loads(body)


def test_debug_events_filters(daemon):
    for i in range(3):
        post(daemon.http_port, [dict(REQ, uniqueKey=f"e{i}")])
    rec = daemon.instance.recorder
    rec.record("note", tenant="acme", trace="t9", n=1)
    rec.record("note", tenant="other", n=2)
    cases = {"": {}, "?limit=2": {"limit": 2},
             "?kind=wave_completed": {"kind": "wave_completed"},
             "?since_seq=4": {"since_seq": 4},
             "?tenant=acme": {"tenant": "acme"}, "?trace=t9": {"trace": "t9"},
             "?kind=note&limit=1": {"kind": "note", "limit": 1},
             "?limit=bad&since_seq=x": {}}
    for q, kw in cases.items():
        code, _, body = get(daemon.http_port, "/debug/events" + q)
        assert code == 200
        assert json.loads(body)["events"] == rec.events(**kw), q
    events = json.loads(get(daemon.http_port, "/debug/events?kind=note")[2])
    assert [e["n"] for e in events["events"]] == [1, 2]
    assert get(daemon.http_port, "/nope")[0] == 404


def test_a_shed_batch_answers_429_and_resource_exhausted(daemon):
    inst = daemon.instance
    inst.dispatcher.admission_limit = 1
    code, body = post(daemon.http_port, [REQ, dict(REQ, uniqueKey="u2")])
    assert code == 429 and "(queue_full:" in body["error"]
    inst.dispatcher.admission_limit = 0  # no bound
    assert post(daemon.http_port, [REQ, dict(REQ, uniqueKey="u2")])[0] == 200
    inst.dispatcher.drain()
    code, body = post(daemon.http_port, [REQ])
    assert code == 429 and "(draining:" in body["error"]
    data = encode_get_rate_limits([RateLimitRequest(
        name="life", unique_key="g1", hits=1, limit=3, duration=60_000)])
    ch = grpc.insecure_channel(f"127.0.0.1:{daemon.grpc_port}")
    try:
        call = ch.unary_unary("/pb.gubernator.V1/GetRateLimits")
        with pytest.raises(grpc.RpcError) as e:
            call(data, timeout=30)
    finally:
        ch.close()
    assert e.value.code() == grpc.StatusCode.RESOURCE_EXHAUSTED
    assert "(draining:" in e.value.details()
    g = inst.metrics.registry.get_sample_value
    assert g("gubernator_admission_shed_total", {"reason": "queue_full"}) == 2
    assert g("gubernator_admission_shed_total", {"reason": "draining"}) == 2


def cli_exits(port: int, argv: list) -> list:
    """(port CLI exit code, JAX CLI exit code) against one daemon."""
    url = f"http://127.0.0.1:{port}/healthz"
    return [mod.main(["--url", url, "--timeout", "10"] + argv)
            for mod in (healthcheck, jax_healthcheck)]


ARGVS = ([], ["--deep"], ["--deep", "--fail-on-stall"], ["--fail-on-stall"])


def test_healthcheck_cli_exits_as_jax(daemon, capsys):
    port = daemon.http_port
    assert [cli_exits(port, a) for a in ARGVS] == [[0, 0]] * 4
    assert "dispatcher:" in capsys.readouterr().out
    # a wave in flight past the stall threshold, flagged by the watchdog
    disp = daemon.instance.dispatcher
    wid = disp._wave_begin("packed", nreq=1)
    real = disp._clock
    disp._clock = lambda: real() + 3600.0
    try:
        assert disp._watchdog_poll()
        exits = [cli_exits(port, a) for a in ARGVS]
    finally:
        disp._clock = real
        disp._wave_end(wid)
    assert exits == [[0, 0], [0, 0], [1, 1], [0, 0]]
    assert "stalled wave" in capsys.readouterr().err
    assert cli_exits(port, ["--deep", "--fail-on-stall"]) == [0, 0]
    assert cli_exits(1, []) == [1, 1]  # nothing listens on port 1


def test_close_drains_first(monkeypatch, capsys):
    d = spawn_daemon(daemon_cfg(drain_grace_ms=1500))
    inst, port = d.instance, d.http_port
    closer = threading.Thread(target=d.close)
    t0 = time.monotonic()
    closer.start()
    try:
        for _ in range(500):
            code, _, body = get(port, "/healthz")
            if code == 503:
                break
            time.sleep(0.005)
        assert code == 503 and json.loads(body) == {
            "status": "draining", "message": "daemon is shutting down",
            "peer_count": 0}
        assert get(port, "/v1/HealthCheck?deep=1")[0] == 503
        assert cli_exits(port, ["--deep"]) == [1, 1]
        code, body = post(port, [REQ])
        assert code == 200 and body["responses"][0]["remaining"] == 2
        assert time.monotonic() - t0 < 1.5
        assert inst.metrics.registry.get_sample_value(
            "gubernator_draining") == 1
    finally:
        closer.join(timeout=60)
    assert not closer.is_alive() and time.monotonic() - t0 >= 1.5
    with pytest.raises(ResourceExhausted, match=r"\(draining:"):
        inst.get_rate_limits([RateLimitRequest(name="life", unique_key="x",
                                               limit=3)])
    kinds = [e["kind"] for e in inst.recorder.events()]
    assert kinds.index("drain_started") < kinds.index("drain_completed")
    assert inst.recorder.events(kind="drain_started")[0]["grace_ms"] == 1500
    assert not inst.dispatcher._thread.is_alive()


def test_drain_grace_config_parses_as_jax():
    from gubernator_tpu.config import setup_daemon_config as jax_setup

    for v in ("", "250ms", "2s", "1m", "750"):
        env = {"GUBER_DRAIN_GRACE": v} if v else {}
        want = jax_setup(env=env).drain_grace_ms
        assert setup_daemon_config(env=env).drain_grace_ms == want
    assert DaemonConfig().drain_grace_ms == 0
