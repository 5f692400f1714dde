"""The port's SLO engine (slo.py) against the JAX package's on the CPU,
under the same injected clock and sources: the breach / recover
lifecycle, tenant groups, threshold SLOs, the published burn gauges, the
snapshot and health documents, the breach event's exemplar; the
instance's registered SLOs (every one JAX registers); ``/debug/slo``,
the deep-health block, ``cmd/healthcheck.py --fail-on-burn`` exiting 0
and 1 (and 1 on a real breach driven by degraded serves), and the debug
dump on close (none by default).  Burns and verdicts compare exactly."""
import json
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, HTTPServer

import pytest

from gubernator_tpu import slo as js
from gubernator_tpu.telemetry import FlightRecorder as JaxRecorder
from gubernator_tpu_torch import slo as ps
from gubernator_tpu_torch.config import Config, DaemonConfig
from gubernator_tpu_torch.daemon import spawn_daemon
from gubernator_tpu_torch.instance import V1Instance
from gubernator_tpu_torch.metrics import Metrics
from gubernator_tpu_torch.telemetry import FlightRecorder
from gubernator_tpu_torch.types import RateLimitRequest

NOW = 1_791_000_000_000


def events(rec):
    return [{k: v for k, v in e.items() if k not in ("t_ms", "seq")}
            for e in rec.events() if e["kind"].startswith("slo_")]


def run_both(build, drive):
    """``build(mod, recorder)`` registers SLOs on an engine of each
    package; ``drive(engine, tick)`` ticks them under the same clock.
    Returns (port rows, port events) after asserting JAX's are equal."""
    out = []
    for mod, rec in ((ps, FlightRecorder()), (js, JaxRecorder())):
        eng = build(mod, rec)
        rows = []
        drive(eng, lambda now: rows.append(eng.tick(now=now)))
        out.append((rows, events(rec), eng.verdicts()))
    assert out[0] == out[1]
    return out[0]


@pytest.mark.parametrize("bad_share", [0, 5, 50])
def test_breach_recover_lifecycle_equals_jax(bad_share):
    state = {"bad": 0.0, "total": 0.0}

    def build(mod, rec):
        eng = mod.SLOEngine(recorder=rec, fast_s=10.0, slow_s=30.0,
                            burn_threshold=2.0)
        eng.register(mod.SLO("err", "ratio", 0.99,
                             lambda: (state["bad"], state["total"])))
        return eng

    def drive(eng, tick):
        state.update(bad=0.0, total=0.0)
        t = 1000.0
        for phase in (0, bad_share, 0):
            for _ in range(35):
                state["total"] += 100
                state["bad"] += phase
                tick(t)
                t += 1.0

    rows, evs, verdicts = run_both(build, drive)
    kinds = [e["kind"] for e in evs]
    if bad_share == 50:
        assert kinds == ["slo_breach", "slo_recovered"]
        assert evs[0]["fast_burn"] > 2.0
    elif bad_share == 0:
        assert kinds == []
    assert verdicts == [{"slo": "err", "breached": False,
                         **({"since_mono_s": verdicts[0]["since_mono_s"]}
                            if kinds else {})}]


def test_tenant_group_breach_is_attributed_as_jax():
    state = {"t-bad": (0.0, 0.0)}

    def build(mod, rec):
        eng = mod.SLOEngine(recorder=rec, fast_s=10.0, slow_s=20.0,
                            burn_threshold=2.0)
        eng.register_group("tenant_err", 0.99,
                           lambda: {"t-bad": state["t-bad"],
                                    "t-good": (0.0, state["t-bad"][1]),
                                    "t-idle": (0.0, 0.0)})
        return eng

    def drive(eng, tick):
        for i in range(40):
            state["t-bad"] = (i * 60.0, i * 100.0)
            tick(float(i))

    rows, evs, _ = run_both(build, drive)
    assert evs and evs[0]["slo"] == "tenant_err"
    assert {e.get("tenant") for e in evs} == {"t-bad"}


@pytest.mark.parametrize("value", [0.5, 5.0])
def test_threshold_ticks_equal_jax(value):
    val = {"v": 0.0}

    def build(mod, rec):
        eng = mod.SLOEngine(recorder=rec, fast_s=10.0, slow_s=20.0,
                            burn_threshold=2.0)
        eng.register(mod.SLO("stale", "threshold", 0.95,
                             lambda: (val["v"], 1.0)))
        return eng

    def drive(eng, tick):
        val["v"] = 0.0
        for t in range(30):
            tick(float(t))
        val["v"] = value
        for t in range(30, 45):
            tick(float(t))

    rows, evs, _ = run_both(build, drive)
    last = rows[-1][0]
    assert last["breached"] == (value > 1.0)
    assert (last["value"], last["target"]) == (value, 1.0)


def test_snapshot_health_gauges_and_exemplar_equal_jax():
    state = {"n": 0}

    def src():
        state["n"] += 10
        return (state["n"], state["n"])  # all bad

    docs = []
    for mod, rec, metrics in ((ps, FlightRecorder(), Metrics()),
                              (js, JaxRecorder(), None)):
        clock = iter(range(100)).__next__
        eng = mod.SLOEngine(metrics=metrics, recorder=rec, fast_s=5.0,
                            slow_s=10.0, clock=lambda: float(clock()),
                            exemplar=lambda: "ab" * 16)
        eng.register(mod.SLO("error_ratio", "ratio", 0.99, src,
                             "desc"))
        eng.register_group("tenant_shed_ratio", 0.999,
                           lambda: {"acme": (state["n"] // 10, state["n"]),
                                    "idle": (0, 0)})
        state["n"] = 0
        for _ in range(6):
            eng.tick()
        docs.append((eng.snapshot(), eng.health(), eng.names(),
                     events(rec)))
        if metrics is not None:
            assert metrics.registry.get_sample_value(
                "gubernator_slo_burn",
                {"slo": "error_ratio", "tenant": ""}) > 2.0
            assert metrics.registry.get_sample_value(
                "gubernator_slo_burn",
                {"slo": "tenant_shed_ratio", "tenant": "acme"}) > 0
    assert docs[0] == docs[1]
    snap, health, _, evs = docs[0]
    assert health["breached"] == ["error_ratio", "tenant_shed_ratio"]
    assert evs[0]["exemplar_trace"] == "ab" * 16
    assert snap["ticks"] == 8 - 1  # six ticks, the snapshot's; health's after
    assert ps.SLO_CATALOG == js.SLO_CATALOG


def test_a_failing_source_never_kills_the_tick():
    eng = ps.SLOEngine(exemplar=lambda: 1 / 0)
    eng.register(ps.SLO("boom", "ratio", 0.9, lambda: 1 / 0))
    eng.register_group("g", 0.9, lambda: 1 / 0)
    assert eng.tick(now=0.0) == []
    with pytest.raises(ValueError):
        ps.SLO("x", "median", 0.9, lambda: (0, 0))


def req(name, key, hits=1):
    return RateLimitRequest(name=name, unique_key=key, hits=hits,
                            limit=100, duration=60_000)


def test_instance_registers_every_jax_slo(monkeypatch):
    monkeypatch.setenv("GUBER_SLO_TICK", "10s")
    inst = V1Instance(Config(cache_size=1 << 10, device="cpu",
                             batch_rows=64))
    try:
        assert inst.slo.names() == [
            "decision_p99", "global_staleness", "error_ratio", "shed_ratio",
            "hbm_pressure", "fleet_conservation", "tenant_error_ratio",
            "tenant_shed_ratio"]
        inst.get_rate_limits([req("sloco/api", "k")])
        assert inst.analytics.flush()
        rows = {(r["slo"], r.get("tenant")): r
                for r in inst.slo.snapshot()["slos"]}
        assert rows[("global_staleness", None)]["value"] == 0.0
        assert rows[("global_staleness", None)]["target"] == 0.2
        assert rows[("decision_p99", None)]["target"] == 0.25
        assert ("tenant_error_ratio", "sloco") in rows
        assert not any(r["breached"] for r in rows.values())
    finally:
        inst.close()


def test_slo_env_knobs_and_off(monkeypatch):
    monkeypatch.setenv("GUBER_SLO_FAST", "2s")
    monkeypatch.setenv("GUBER_SLO_SLOW", "1m")
    monkeypatch.setenv("GUBER_SLO_BURN", "3.5")
    monkeypatch.setenv("GUBER_SLO_P99_MS", "40")
    inst = V1Instance(Config(cache_size=1 << 10, device="cpu"))
    try:
        snap = inst.slo.snapshot()
        assert (snap["fast_window_s"], snap["slow_window_s"],
                snap["burn_threshold"]) == (2.0, 60.0, 3.5)
        row = [r for r in snap["slos"] if r["slo"] == "decision_p99"][0]
        assert row["target"] == 0.04
    finally:
        inst.close()
    monkeypatch.setenv("GUBER_SLO", "0")
    inst = V1Instance(Config(cache_size=1 << 10, device="cpu"))
    try:
        assert inst.slo is None and inst._slo_loop is None
    finally:
        inst.close()


def test_debug_dump_on_close(tmp_path, monkeypatch):
    monkeypatch.setenv("GUBER_DEBUG_DUMP_DIR", str(tmp_path))
    monkeypatch.setenv("GUBER_INSTANCE_ID", "dump-test")
    inst = V1Instance(Config(cache_size=1 << 10, device="cpu"))
    inst.get_rate_limits([req("dumpco/api", "k")])
    inst.close()
    files = sorted(tmp_path.glob("guber_dump_dump-test_*.jsonl"))
    assert len(files) == 1
    lines = files[0].read_text().splitlines()
    header = json.loads(lines[0])
    assert header["kind"] == "dump_header"
    assert header["instance"] == "dump-test"
    assert {v["slo"] for v in header["slo_verdicts"]} >= \
        {"decision_p99", "error_ratio", "shed_ratio", "hbm_pressure"}
    evs = [json.loads(ln) for ln in lines[1:]]
    assert len(evs) == header["events"] >= 1
    assert any(e["kind"] == "wave_completed" for e in evs)
    assert inst.recorder.events(kind="debug_dump_written")
    # sample 0 and no forced outcome: no span survived, no span file
    assert not list(tmp_path.glob("guber_traces_*.jsonl"))


def test_no_debug_dump_by_default(tmp_path, monkeypatch):
    monkeypatch.delenv("GUBER_DEBUG_DUMP_DIR", raising=False)
    inst = V1Instance(Config(cache_size=1 << 10, device="cpu"))
    inst.get_rate_limits([req("a/b", "k")])
    inst.close()
    assert not inst.recorder.events(kind="debug_dump_written")


@pytest.fixture(scope="module")
def sdaemon():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GUBER_SLO_P99_MS", "60000")
        mp.setenv("GUBER_SLO_TICK", "100ms")
        d = spawn_daemon(DaemonConfig(device="cpu", cache_size=4096,
                                      http_listen_address="127.0.0.1:0",
                                      grpc_listen_address="127.0.0.1:0"))
    yield d
    d.close()


def _get(d, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{d.http_port}{path}",
                                timeout=30) as f:
        return json.loads(f.read())


def test_debug_slo_and_the_deep_health_block(sdaemon):
    sdaemon.instance.get_rate_limits([req("endpoint/api", "k")])
    body = _get(sdaemon, "/debug/slo")
    assert body["fast_window_s"] == 60.0 and body["slow_window_s"] == 300.0
    assert body["burn_threshold"] == 2.0 and body["ticks"] >= 1
    assert {r["slo"] for r in body["slos"]} >= set(ps.SLO_CATALOG) - {
        "tenant_error_ratio", "tenant_shed_ratio"}
    for r in body["slos"]:
        assert {"slo", "kind", "objective", "fast_burn", "slow_burn",
                "breached", "description"} <= r.keys()
    deep = _get(sdaemon, "/healthz?deep=1")
    assert deep["slo"] == {"breached": [], "burning": [],
                           "max_fast_burn": 0.0, "burn_threshold": 2.0}


def test_fail_on_burn_exits_0_when_healthy(sdaemon, capsys):
    from gubernator_tpu_torch.cmd.healthcheck import main

    url = f"http://127.0.0.1:{sdaemon.http_port}/healthz"
    assert main(["--url", url, "--fail-on-burn"]) == 0
    assert "slo:" in capsys.readouterr().out


@pytest.mark.parametrize("breached", [True, False])
def test_fail_on_burn_against_a_canned_body(breached, capsys):
    """The flag's rule on a canned /healthz, as JAX's CLI reads it: a
    breached SLO exits 1 with the flag, 0 without."""
    from gubernator_tpu.cmd.healthcheck import main as jax_main
    from gubernator_tpu_torch.cmd.healthcheck import main

    body = json.dumps({
        "status": "healthy", "message": "", "peer_count": 0,
        "slo": {"breached": ["error_ratio"] if breached else [],
                "burning": ["error_ratio"], "max_fast_burn": 9.5,
                "burn_threshold": 2.0}}).encode()

    class H(BaseHTTPRequestHandler):
        def do_GET(self):
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = HTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}/healthz"
        want = 1 if breached else 0
        assert main(["--url", url, "--fail-on-burn"]) == want == \
            jax_main(["--url", url, "--fail-on-burn"])
        if breached:
            assert "SLO breached: error_ratio" in capsys.readouterr().err
        assert main(["--url", url]) == 0
    finally:
        srv.shutdown()
        srv.server_close()


def test_error_ratio_breaches_on_degraded_serves(monkeypatch):
    """A live breach: a daemon whose sends to its peer fail serves the
    peer's keys degraded; with short windows error_ratio breaches (both
    burns above the threshold), the event carries the forced degraded
    trace as its exemplar, and --fail-on-burn exits 1 once breached."""
    from gubernator_tpu_torch import cluster
    from gubernator_tpu_torch.cmd.healthcheck import main

    monkeypatch.setenv("GUBER_SLO_FAST", "2s")
    monkeypatch.setenv("GUBER_SLO_SLOW", "4s")
    monkeypatch.setenv("GUBER_SLO_TICK", "10s")  # ticked by hand below
    c = cluster.start_with([DaemonConfig(
        grpc_listen_address="127.0.0.1:0",
        http_listen_address="127.0.0.1:0", cache_size=4096, batch_rows=64,
        device="cpu") for _ in range(2)])
    try:
        inst = c.instance_at(0)
        url = f"http://127.0.0.1:{c.daemon_at(0).http_port}/healthz"
        inst.slo.tick(now=0.0)
        assert main(["--url", url, "--fail-on-burn"]) == 0
        other = c.daemon_at(1).advertise_address
        inst.faults.arm(f"peer_send@{other}:error")
        keys = [f"s{i}" for i in range(80)
                if c.owner_daemon_of(f"burnco/api_s{i}") is c.daemon_at(1)]
        from gubernator_tpu_torch.tracing import current_trace_id, \
            request_context

        with request_context(None, recorder=inst.span_recorder):
            tid = current_trace_id()
            inst.get_rate_limits([req("burnco/api", k) for k in keys[:20]])
        assert inst.analytics.flush()
        rows = {r["slo"]: r for r in inst.slo.tick(now=1.0)
                if r["tenant"] is None}
        er = rows["error_ratio"]
        assert er["breached"] and er["fast_burn"] > 2 and er["slow_burn"] > 2
        ev = inst.recorder.events(kind="slo_breach")
        assert [e for e in ev if e["slo"] == "error_ratio"]
        # the degraded serve forced its trace's sample at sample 0: the
        # breach links to it
        assert ev[0]["exemplar_trace"] == tid
        assert inst.span_recorder.spans(tid)
        assert inst.slo.health()["breached"]
        # the daemon also reports unhealthy while its hits flush fails:
        # either way the probe fails
        assert main(["--url", url, "--fail-on-burn"]) == 1
    finally:
        c.stop()
