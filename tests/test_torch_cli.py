"""The port's load-test and debug CLI (gubernator_tpu_torch/cmd/cli.py)
held to the JAX package's (gubernator_tpu/cmd/cli.py):

- the load tester runs as a process of its own against a port daemon
  process on the CPU (``cmd.daemon --device cpu``), over gRPC and over
  HTTP: exit 0, no error, JAX's one-line JSON keys, and its decisions
  and OVER_LIMIT answers equal to the daemon's own /metrics deltas;
- its key stream is JAX's: ``rng.zipf(a) % rate_limits`` from
  ``default_rng(worker)`` (uniform keys for a <= 1), batch for batch;
- every ``debug`` and ``fleet`` subcommand prints, with ``--json`` and
  without, what the JAX CLI prints against the same port daemons.
"""
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest

from gubernator_tpu.cmd import cli as jax_cli
from gubernator_tpu_torch import cluster
from gubernator_tpu_torch.cmd import cli
from gubernator_tpu_torch.types import RateLimitRequest, RateLimitResponse

ROOT = Path(__file__).resolve().parents[1]


def fetch(url: str):
    with urllib.request.urlopen(url, timeout=30) as f:
        return f.read()


def metric(base: str, name: str, labels: str = "") -> float:
    for line in fetch(base + "/metrics").decode().splitlines():
        if line.startswith(name + labels + " "):
            return float(line.split()[-1])
    return 0.0


@pytest.fixture(scope="module")
def daemon_proc():
    """``python -m gubernator_tpu_torch.cmd.daemon --device cpu`` on free
    ports; (gRPC address, HTTP base URL)."""
    g, h = cluster.free_port(), cluster.free_port()
    env = dict(os.environ, GUBER_GRPC_ADDRESS=f"127.0.0.1:{g}",
               GUBER_HTTP_ADDRESS=f"127.0.0.1:{h}",
               GUBER_CACHE_SIZE="8192", GUBER_BATCH_ROWS="256")
    p = subprocess.Popen([sys.executable, "-m",
                          "gubernator_tpu_torch.cmd.daemon", "--device",
                          "cpu"], cwd=ROOT, env=env,
                         stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    base = f"http://127.0.0.1:{h}"
    try:
        deadline = time.monotonic() + 120
        while True:
            assert p.poll() is None, p.stderr.read().decode()[-3000:]
            try:
                fetch(base + "/healthz")
                break
            except OSError:
                assert time.monotonic() < deadline
                time.sleep(0.2)
        yield f"127.0.0.1:{g}", base
    finally:
        p.terminate()
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


@pytest.mark.parametrize("transport", ["grpc", "http"])
def test_load_tester_process_against_a_daemon_process(daemon_proc,
                                                      transport):
    addr, base = daemon_proc
    if transport == "http":
        addr = base[len("http://"):]
    api0 = metric(base, "gubernator_getratelimit_total",
                  '{calltype="api"}')
    over0 = metric(base, "gubernator_over_limit_total")
    argv = [sys.executable, "-m", "gubernator_tpu_torch.cmd.cli",
            "--address", addr, "--rate-limits", "500", "--concurrency",
            "2", "--batch", "50", "--zipf", "1.1", "--duration", "1.5",
            "--limit", "20", "--json"]
    if transport == "http":
        argv.append("--http")
    r = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert set(out) == {"decisions", "decisions_per_s", "over_limit",
                        "p50_ms", "p99_ms", "batch", "concurrency",
                        "errors"}
    assert out["errors"] == [] and out["decisions"] > 0
    assert (out["batch"], out["concurrency"]) == (50, 2)
    assert out["over_limit"] > 0
    assert out["decisions"] == metric(
        base, "gubernator_getratelimit_total", '{calltype="api"}') - api0
    assert out["over_limit"] == metric(
        base, "gubernator_over_limit_total") - over0


class StopAfter(Exception):
    pass


def key_stream(module, client_mod, monkeypatch, zipf: str) -> list:
    """The keys one worker's first three batches ask for, through
    ``module.main`` with its client replaced by a recorder."""
    seen = []

    class Recorder:
        def __init__(self, *a, **k):
            pass

        def get_rate_limits(self, reqs):
            if len(seen) == 3:
                raise StopAfter("enough")
            seen.append([(r.name, r.unique_key, r.hits, r.limit,
                          r.duration) for r in reqs])
            return [RateLimitResponse() for _ in reqs]

    monkeypatch.setattr(client_mod, "Client", Recorder)
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = module.main(["--rate-limits", "1000", "--concurrency", "1",
                          "--batch", "64", "--zipf", zipf, "--duration",
                          "30", "--limit", "7", "--window", "1234",
                          "--json"])
    assert rc == 1  # the recorder's stop is the run's one error
    return seen


@pytest.mark.parametrize("zipf", ["1.1", "0"])
def test_load_tester_key_stream_is_jax(monkeypatch, zipf):
    import gubernator_tpu.client as jax_client_mod
    import gubernator_tpu_torch.client as client_mod

    port = key_stream(cli, client_mod, monkeypatch, zipf)
    ref = key_stream(jax_cli, jax_client_mod, monkeypatch, zipf)
    assert len(port) == 3 and port == ref
    assert all(name == "load" and h == 1 and (lim, dur) == (7, 1234)
               for batch in port for name, _, h, lim, dur in batch)


def run_cli(module, argv) -> tuple:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = module.main(argv)
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def daemons():
    """Two port daemons on the CPU in one cluster, with traffic: a few
    object-lane batches (one GLOBAL key), sampled spans, settled queues.
    The SLO tick is an hour, and once the traffic settled sampling stops
    and the GLOBAL managers close, so nothing lands between the two
    CLIs' reads."""
    old = {k: os.environ.get(k) for k in ("GUBER_SLO_TICK",
                                          "GUBER_TRACE_SAMPLE")}
    os.environ["GUBER_SLO_TICK"] = "3600s"
    os.environ["GUBER_TRACE_SAMPLE"] = "1"
    c = cluster.start(2, device="cpu")
    try:
        for i in range(2):
            inst = c.instance_at(i)
            for b in range(3):
                inst.get_rate_limits([RateLimitRequest(
                    name=f"acme/api{j % 2}", unique_key=f"k{j}", hits=1,
                    limit=5, duration=60_000,
                    behavior=2 if j == 0 else 0) for j in range(12)])
        for i in range(2):
            gm = c.instance_at(i).global_manager
            if gm is not None:
                gm.poke()
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and any(
                c.instance_at(i).audit_doc()["drift"] for i in range(2)):
            time.sleep(0.1)
        for i in range(2):
            inst = c.instance_at(i)
            inst.analytics.flush()
            # the spans and events so far stay; the GLOBAL ticks' own
            # (a slow tick is force-sampled) would land between the two
            # CLIs' reads: the drained managers close
            inst.span_recorder.sample = 0.0
            if inst.global_manager is not None:
                inst.global_manager.close()
                inst.global_manager = None
        yield c
    finally:
        c.stop()
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


DEBUG = [["events"], ["events", "--limit", "5"], ["events", "--kind",
                                                   "wave_launched"],
         ["traces"], ["traces", "--limit", "3"], ["topkeys"],
         ["topkeys", "--limit", "2"], ["tenants"], ["slo"], ["memory"],
         ["memory", "--advise"], ["faults"]]


def untick(out: tuple, fmt: str) -> tuple:
    """An SLO output without its tick count: GET /debug/slo ticks the
    engine once (in both packages), so a second read counts one more
    tick a daemon.  Returns (exit code, output, ticks)."""
    rc, text = out
    if fmt == "json":
        doc = json.loads(text)
        ticks = doc.pop("ticks")
        return rc, json.dumps(doc), ticks
    m = re.search(r"ticks=(\d+)", text) or re.search(r"(\d+) ticks",
                                                     text)
    return rc, text[:m.start(1)] + text[m.end(1):], int(m.group(1))


@pytest.mark.parametrize("args", DEBUG, ids=lambda a: "-".join(a))
@pytest.mark.parametrize("fmt", ["json", "text"])
def test_debug_subcommands_print_what_jax_prints(daemons, args, fmt):
    argv = ["debug", *args, "--url", daemons.http_address(0)]
    if fmt == "json":
        argv.append("--json")
    port = run_cli(cli, argv)
    ref = run_cli(jax_cli, argv)
    if args == ["slo"]:
        (rc, text, ticks), (rc_j, text_j, ticks_j) = \
            untick(port, fmt), untick(ref, fmt)
        assert (rc, text, ticks + 1) == (rc_j, text_j, ticks_j)
    else:
        assert port == ref
    assert port[0] == 0 and port[1]
    if fmt == "json":
        json.loads(port[1])


def test_debug_traces_stitch_several_daemons_as_jax(daemons):
    argv = ["debug", "traces", "--url", daemons.http_address(0),
            "--url", daemons.http_address(1), "--waterfall"]
    port, ref = run_cli(cli, argv), run_cli(jax_cli, argv)
    assert port == ref and port[0] == 0


def test_debug_faults_arm_and_clear_as_jax(daemons):
    url = daemons.http_address(1)
    for module in (cli, jax_cli):
        outs = []
        for argv in (["--set", "device_step:delay:1ms", "--seed", "5"],
                     [], ["--clear"]):
            outs.append(run_cli(module, ["debug", "faults", "--url", url,
                                         "--json", *argv]))
        if module is cli:
            port = outs
        else:
            ref = outs
    assert port == ref
    assert json.loads(port[1][1])["armed"]
    assert not json.loads(port[2][1])["armed"]


FLEET = ["status", "audit", "topkeys", "tenants", "slo", "memory"]


@pytest.mark.parametrize("what", FLEET)
@pytest.mark.parametrize("fmt", ["json", "text"])
def test_fleet_subcommands_fold_as_jax(daemons, what, fmt):
    argv = ["fleet", what, "--url", daemons.http_address(0), "--url",
            daemons.http_address(1)]
    if fmt == "json":
        argv.append("--json")
    port, ref = run_cli(cli, argv), run_cli(jax_cli, argv)
    if what == "slo":
        (rc, text, ticks), (rc_j, text_j, ticks_j) = \
            untick(port, fmt), untick(ref, fmt)
        assert (rc, text, ticks + 2) == (rc_j, text_j, ticks_j)
    else:
        assert port == ref
    assert port[0] == 0, port[1]


def test_debug_and_fleet_exit_1_on_a_dead_url():
    dead = f"http://127.0.0.1:{cluster.free_port()}"
    for argv in (["debug", "events", "--url", dead, "--timeout", "2"],
                 ["fleet", "status", "--url", dead, "--timeout", "2"]):
        assert run_cli(cli, argv)[0] == run_cli(jax_cli, argv)[0] == 1
