"""The port's trace plane (tracing.py) against the JAX package's, on the
CPU: traceparent parsing, seeded head sampling, forced samples, the
span ring's bounds and drop counts, tombstone routing, exemplars, hop
spans, ``assemble`` / ``render_waterfall`` on the same slices, wave
spans whose phase children partition the wave exactly (inline and
queued waves), a shed's forced sample, one tree over the slices of two
port daemons on localhost (one forward) with the structure of the JAX
pair's, ``/debug/traces`` and ``/debug/profile`` (400, 409 and the
status documents; CPU activity), and the span dump on close.  Span
times are wall-clock: they are compared by structure, everything else
exactly."""
import glob
import json
import os
import random
import threading
import time
import urllib.error
import urllib.request

import pytest

from gubernator_tpu import tracing as jt
from gubernator_tpu_torch import tracing as pt
from gubernator_tpu_torch.config import Config, DaemonConfig
from gubernator_tpu_torch.daemon import spawn_daemon
from gubernator_tpu_torch.instance import V1Instance
from gubernator_tpu_torch.types import RateLimitRequest

NOW = 1_791_000_000_000
TID = "ab" * 16
BOTH = pytest.mark.parametrize("mod", [pt, jt], ids=["port", "jax"])


def req(key, name="traceco/api", hits=1):
    return RateLimitRequest(name=name, unique_key=key, hits=hits,
                            limit=100_000, duration=600_000)


def _tids(seed, n):
    rng = random.Random(seed)
    return [f"{rng.getrandbits(128):032x}" for _ in range(n)]


def _span(tid, sid, parent=None, name="s", start=0.0, end=1.0):
    return {"trace_id": tid, "span_id": sid, "parent_id": parent,
            "name": name, "start": start, "end": end, "attrs": {}}


@pytest.mark.parametrize("header", [
    None, "", f"00-{TID}-{'cd' * 8}-01", f"00-{TID.upper()}-{'CD' * 8}-00",
    f"01-{TID}-{'cd' * 8}-01", f"00-{'0' * 32}-{'cd' * 8}-01",
    f"00-{TID}-{'0' * 16}-01", f"00-{TID}-{'cd' * 8}", f"00-{TID[:30]}-"
    f"{'cd' * 8}-01", f"00-{'zz' * 16}-{'cd' * 8}-01",
    f" 00-{TID}-{'cd' * 8}-01 "])
def test_traceparent_parsing_equals_jax(header):
    assert pt.parse_traceparent(header) == jt.parse_traceparent(header)
    assert pt.parent_span_id(header) == jt.parent_span_id(header)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5, 1.0])
def test_head_sampling_equals_jax_on_seeded_ids(seed, rate):
    tids = _tids(seed, 2000) + ["zz", "", "1"]
    p, j = pt.SpanRecorder(sample=rate), jt.SpanRecorder(sample=rate)
    got = [p.head_sampled(t) for t in tids]
    assert got == [j.head_sampled(t) for t in tids]
    if 0 < rate < 1:
        assert 0.5 * rate < sum(got) / len(got) < 1.5 * rate


def _drive(mod, r):
    """The same span traffic into a recorder of ``mod``: forced
    outcomes at sample 0, an error, an unforced trace, ring overflow,
    pending bounds and late adds; returns what the recorder shows."""
    for reason, tid in (("shed", "a" * 32), ("degraded", "d" * 32)):
        with mod.request_context(f"00-{tid}-{'cd' * 8}-01", recorder=r):
            with mod.span(f"forced.{reason}"):
                mod.force_sample(reason)
    with pytest.raises(RuntimeError):
        with mod.request_context(f"00-{'e' * 32}-{'cd' * 8}-01",
                                 recorder=r):
            with mod.span("forced.error"):
                raise RuntimeError("boom")
    with mod.request_context(f"00-{'f' * 32}-{'cd' * 8}-01", recorder=r):
        with mod.span("unforced"):
            pass
    for i in range(3 * mod.SpanRecorder.PENDING_SPANS):
        r.add(_span(TID, f"{i:016x}"))
    for i in range(2 * mod.SpanRecorder.PENDING_TRACES):
        r.add(_span(f"{i:032x}", "aa" * 8))
    r.commit(TID, forced="x")
    r.add(_span(TID, "bb" * 8))  # a late add after the commit
    assert not r.commit("cd" * 16)
    r.add(_span("cd" * 16, "cc" * 8))
    r.discard(f"{5:032x}")
    return ([(s["trace_id"], s["name"], s["parent_id"]) for s in r.spans()],
            r.stats(), r.exemplar(), len(r))


def test_recorder_ring_drops_and_forced_samples_equal_jax():
    p = _drive(pt, pt.SpanRecorder(capacity=40, sample=0.0))
    j = _drive(jt, jt.SpanRecorder(capacity=40, sample=0.0))
    assert p == j
    names = {n for _, n, _ in p[0]}
    assert {"forced.shed", "forced.degraded", "forced.error"} <= names
    assert "unforced" not in names
    assert p[1]["dropped"] > 0 and p[3] == len(p[0]) >= 4


@BOTH
def test_ring_keeps_the_newest(mod):
    r = mod.SpanRecorder(capacity=8, sample=1.0)
    for i in range(20):
        tid = f"{i:032x}"
        r.add(_span(tid, f"{i:016x}"))
        assert r.commit(tid)
    assert [s["trace_id"] for s in r.spans()] == \
        [f"{i:032x}" for i in range(12, 20)]
    assert r.spans(limit=3) == r.spans()[-3:]
    assert r.exemplar() == {"trace_id": f"{19:032x}"}


def test_hop_span_is_the_minted_parent_on_both():
    out = []
    for mod in (pt, jt):
        r = mod.SpanRecorder(sample=1.0)
        with mod.request_context(f"00-{TID}-{'cd' * 8}-01", recorder=r):
            with mod.span("grpc.GetRateLimits"):
                tp = mod.hop_traceparent("peer.forward", attrs={"items": 3})
                md = mod.outbound_metadata([("x", "y")])
        hop = [s for s in r.spans() if s["name"] == "peer.forward"]
        root = [s for s in r.spans() if s["name"] == "grpc.GetRateLimits"]
        assert hop[0]["span_id"] == tp.split("-")[2]
        assert hop[0]["parent_id"] == root[0]["span_id"]
        assert root[0]["parent_id"] == "cd" * 8
        assert md[0] == ("x", "y") and md[1][0] == "traceparent"
        assert md[1][1].split("-")[1] == TID
        out.append((tp.split("-")[1], hop[0]["attrs"]))
    assert out[0] == out[1]
    assert pt.hop_traceparent("peer.forward") is None
    assert pt.outbound_metadata() is None


def test_assemble_and_waterfall_equal_jax():
    spans = [
        _span(TID, "r" * 16, name="root", start=0.0, end=3.0),
        _span(TID, "c" * 16, parent="r" * 16, name="child", start=1.0,
              end=2.0),
        _span(TID, "c" * 16, parent="r" * 16, name="child", start=1.0,
              end=2.0),
        _span(TID, "o" * 16, parent="f" * 16, name="orphan", start=0.5,
              end=0.6),
        _span("99" * 16, "d" * 16, name="other", start=-1.0),
    ]
    for tid in (TID, None):
        got, ref = pt.assemble(spans, tid), jt.assemble(spans, tid)
        assert got == ref
        for t in got:
            assert pt.render_waterfall(t) == jt.render_waterfall(t)
    assert pt.render_waterfall({"trace_id": "x", "roots": []}) == \
        jt.render_waterfall({"trace_id": "x", "roots": []})


#: the port's host steps, which its wave spans carry under their phases
#: (the JAX package has none)
STEPS = {n for n in pt.SPAN_CATALOG if n.startswith("wave.")} - {
    "wave.pack", "wave.device", "wave.resolve"}


def _tree(trace, skip=frozenset()):
    """An assembled trace's structure: names, nested, children sorted;
    spans named in ``skip`` left out with what hangs under them."""
    def node(n):
        return (n["name"], tuple(sorted(node(c) for c in n["children"]
                                        if c["name"] not in skip)))
    return tuple(sorted(node(r) for r in trace["roots"]))


def _exact_partition(wave):
    kids = wave["children"]
    assert [k["name"] for k in kids] == ["wave.pack", "wave.device",
                                         "wave.resolve"]
    assert kids[0]["start"] == wave["start"]
    for a, b in zip(kids, kids[1:]):
        assert b["start"] == a["end"]
    assert kids[-1]["end"] == wave["end"]


def _waves(trace):
    out = []

    def walk(n):
        if n["name"] == "wave":
            out.append(n)
        for c in n["children"]:
            walk(c)

    for r in trace["roots"]:
        walk(r)
    return out


@pytest.mark.parametrize("queued", [False, True])
def test_wave_children_partition_the_wave(queued):
    """An inline wave (the caller's thread) and a queued one (the
    worker's, the job carrying the trace): the wave hangs under the
    request span and its phases tile it exactly; its events carry the
    trace and span id."""
    inst = V1Instance(Config(cache_size=1 << 10, device="cpu",
                             batch_rows=64))
    try:
        inst.span_recorder.sample = 1.0
        with pt.request_context(None, recorder=inst.span_recorder):
            tid = pt.current_trace_id()
            with pt.span("grpc.GetRateLimits"):
                if queued:
                    inst.get_rate_limits([req(f"pk{i}") for i in range(8)],
                                         now_ms=NOW)
                else:
                    from gubernator_tpu_torch.wire import \
                        encode_get_rate_limits

                    inst.get_rate_limits_wire(encode_get_rate_limits(
                        [req(f"wk{i}") for i in range(8)]), NOW)
        traces = pt.assemble(inst.span_recorder.spans(), tid)
        assert len(traces) == 1 and len(traces[0]["roots"]) == 1
        root = traces[0]["roots"][0]
        waves = _waves(traces[0])
        assert root["name"] == "grpc.GetRateLimits" and len(waves) == 1
        assert waves[0]["parent_id"] == root["span_id"]
        _exact_partition(waves[0])
        assert waves[0]["attrs"]["kind"] == ("list" if queued
                                             else "inline_wire")
        evs = [e for e in inst.recorder.events(kind="wave_completed")
               if e["trace"] == tid]
        assert evs and evs[-1]["span_id"] == waves[0]["span_id"]
    finally:
        inst.close()


def test_shed_forces_the_sample_and_names_the_span():
    from gubernator_tpu_torch.dispatcher import ResourceExhausted

    inst = V1Instance(Config(cache_size=1 << 10, device="cpu",
                             batch_rows=64))
    try:
        inst.get_rate_limits([req("warm")], now_ms=NOW)
        inst.dispatcher.drain()
        with pt.request_context(None, recorder=inst.span_recorder):
            tid = pt.current_trace_id()
            with pytest.raises(ResourceExhausted):
                with pt.span("grpc.GetRateLimits"):
                    inst.get_rate_limits([req("shed_k")], now_ms=NOW)
        assert {s["name"] for s in inst.span_recorder.spans(tid)} == \
            {"grpc.GetRateLimits"}
        ev = inst.recorder.events(kind="admission_shed")[-1]
        assert ev["trace"] == tid and ev["span_id"]
        assert ev["tenant"] == "traceco"
    finally:
        inst.close()


def _pair_trees(start, mod, sample_env):
    """Two daemons of a package on localhost, GUBER_TRACE_SAMPLE=1: one
    batch through daemon 0's gRPC front door with a sampled traceparent,
    a key owned there and one owned by daemon 1; the assembled trees of
    the two daemons' slices."""
    import grpc

    from gubernator_tpu_torch.wire import encode_get_rate_limits

    c = start()
    try:
        keys = {}
        for i in range(200):
            k = f"k{i}"
            owner = c.owner_daemon_of(f"acme/x_{k}")
            keys.setdefault(owner is c.daemons[1], k)
            if len(keys) == 2:
                break
        reqs = [RateLimitRequest(name="acme/x", unique_key=keys[b],
                                 hits=1, limit=10, duration=60_000)
                for b in (True, False)]
        ch = grpc.insecure_channel(f"127.0.0.1:{c.daemons[0].grpc_port}")
        call = ch.unary_unary("/pb.gubernator.V1/GetRateLimits")
        try:
            call(encode_get_rate_limits(reqs),
                 metadata=[("traceparent", f"00-{TID}-{'cd' * 8}-01")],
                 timeout=30)
        finally:
            ch.close()
        deadline = time.monotonic() + 10
        while True:
            spans = [s for d in c.daemons
                     for s in d.instance.span_recorder.spans(TID)]
            trees = mod.assemble(spans, TID)
            if len(_waves(trees[0])) == 2 or time.monotonic() > deadline:
                return trees
            time.sleep(0.05)
    finally:
        c.stop()


def test_two_daemons_assemble_one_tree_shaped_as_jax(monkeypatch):
    from gubernator_tpu import cluster as jax_cluster
    from gubernator_tpu.config import DaemonConfig as JaxDaemonConfig
    from gubernator_tpu.parallel import make_mesh
    from gubernator_tpu_torch import cluster

    monkeypatch.setenv("GUBER_TRACE_SAMPLE", "1")
    port = _pair_trees(lambda: cluster.start_with([
        DaemonConfig(grpc_listen_address="127.0.0.1:0",
                     http_listen_address="127.0.0.1:0", cache_size=4096,
                     batch_rows=64, device="cpu") for _ in range(2)]),
        pt, "1")
    for var in ("GUBER_ANALYTICS", "GUBER_SLO", "GUBER_MEM_LEDGER"):
        monkeypatch.setenv(var, "0")
    ref = _pair_trees(lambda: jax_cluster.start_with([
        JaxDaemonConfig(grpc_listen_address="127.0.0.1:0",
                        http_listen_address="127.0.0.1:0", cache_size=4096)
        for _ in range(2)], mesh=make_mesh(n=1)), jt, "1")
    assert len(port) == 1 and len(port[0]["roots"]) == 1
    t = _tree(port[0], skip=STEPS)
    assert t == _tree(ref[0])
    # the port's steps hang under the phases of its waves
    for w in _waves(port[0]):
        kids = [c for k in w["children"] for c in k["children"]]
        assert kids and {c["name"] for c in kids} <= STEPS
    root = port[0]["roots"][0]
    assert root["name"] == "grpc.GetRateLimits"
    hop = [c for c in root["children"] if c["name"] == "peer.forward"]
    assert [c["name"] for c in hop[0]["children"]] == \
        ["grpc.GetPeerRateLimits"]
    for w in _waves(port[0]):
        _exact_partition(w)
    text = pt.render_waterfall(port[0])
    assert "peer.forward" in text and "grpc.GetPeerRateLimits" in text


@pytest.fixture(scope="module")
def tdaemon():
    d = spawn_daemon(DaemonConfig(device="cpu", cache_size=4096,
                                  http_listen_address="127.0.0.1:0",
                                  grpc_listen_address="127.0.0.1:0"))
    d.instance.span_recorder.sample = 1.0
    yield d
    d.close()


def _get(d, path):
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{d.http_port}{path}", timeout=30) as f:
            return f.status, json.loads(f.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post(d, key, tp=f"00-{TID}-{'cd' * 8}-01"):
    body = json.dumps({"requests": [{"name": "traceco/api",
                                     "uniqueKey": key, "hits": 1,
                                     "limit": 10, "duration": 60000}]})
    r = urllib.request.Request(
        f"http://127.0.0.1:{d.http_port}/v1/GetRateLimits",
        data=body.encode(), headers={"traceparent": tp})
    with urllib.request.urlopen(r, timeout=30) as f:
        return json.loads(f.read())


def test_debug_traces_endpoint(tdaemon):
    assert _post(tdaemon, "k_traces")["responses"][0]["error"] == ""
    code, body = _get(tdaemon, f"/debug/traces?trace_id={TID}")
    assert code == 200
    assert {"http.GetRateLimits", "wave", "wave.pack", "wave.device",
            "wave.resolve"} <= {s["name"] for s in body["spans"]}
    assert body["sample"] == 1.0 and body["capacity"] == 2048
    assert "dropped" in body
    assert all(s["trace_id"] == TID for s in body["spans"])
    _, full = _get(tdaemon, "/debug/traces")
    _, lim = _get(tdaemon, "/debug/traces?limit=2")
    assert lim["spans"] == full["spans"][-2:]
    _, evs = _get(tdaemon, f"/debug/events?trace={TID}")
    assert [e for e in evs["events"] if e["kind"] == "wave_completed"
            and e.get("span_id")]


def test_debug_profile_rules_and_status(tdaemon, tmp_path):
    assert _get(tdaemon, "/debug/profile") == (200, {"active": False})
    for bad in ("x", "0", "-1", "301"):
        code, body = _get(tdaemon, f"/debug/profile?seconds={bad}")
        assert code == 400 and "error" in body
    code, body = _get(tdaemon, "/debug/profile?seconds=0.5")
    assert code == 200 and body["profiling"] and body["seconds"] == 0.5
    assert _get(tdaemon, "/debug/profile?seconds=1")[0] == 409
    _post(tdaemon, "k_profile")
    code, st = _get(tdaemon, "/debug/profile")
    assert code == 200 and st["dir"] == body["dir"]
    deadline = time.monotonic() + 20
    while st["active"] and time.monotonic() < deadline:
        time.sleep(0.1)
        _, st = _get(tdaemon, "/debug/profile")
    assert not st["active"] and os.path.exists(st["trace"])
    with open(st["trace"], encoding="utf-8") as f:
        assert "traceEvents" in json.load(f)
    kinds = [e["kind"] for e in tdaemon.instance.recorder.events()]
    assert "profile_start" in kinds and "profile_stop" in kinds
    # a capture ended: the next one may start; a capture by anyone else
    # in the process meanwhile is refused
    code, again = _get(tdaemon, "/debug/profile?seconds=0.2")
    assert code == 200 and again["dir"] != body["dir"]
    with pytest.raises(pt.ProfilerBusy):
        pt.DeviceProfiler(str(tmp_path))
    deadline = time.monotonic() + 20
    while _get(tdaemon, "/debug/profile")[1]["active"]:
        assert time.monotonic() < deadline
        time.sleep(0.05)


def test_device_profiler_and_annotation_on_the_cpu(tmp_path):
    """A capture writes a Chrome trace; one capture a process; an
    annotated region is recorded where the profiler records CPU ops (its
    own thread: CUDA activity is traced process-wide)."""
    import torch

    from gubernator_tpu_torch.tracing import _ProfilerThread

    prof = pt.DeviceProfiler(str(tmp_path))
    with pytest.raises(pt.ProfilerBusy):
        pt.DeviceProfiler(str(tmp_path / "second"))

    def annotated():
        with pt.step_annotation("guber_step"):
            torch.ones(64).sum()

    _ProfilerThread.run(annotated)
    prof.stop()
    prof.stop()  # a second stop does nothing
    with open(prof.path, encoding="utf-8") as f:
        doc = json.load(f)
    assert any(e.get("name") == "guber_step" for e in doc["traceEvents"])
    pt.DeviceProfiler(str(tmp_path / "next")).stop()


def test_profiler_from_env(monkeypatch, tmp_path):
    monkeypatch.delenv("GUBER_PROFILE_DIR", raising=False)
    assert pt.DeviceProfiler.from_env() is None
    monkeypatch.setenv("GUBER_PROFILE_DIR", str(tmp_path / "p"))
    prof = pt.DeviceProfiler.from_env()
    prof.stop()
    assert os.path.exists(prof.path)


def test_span_metric_and_dump_on_close(tmp_path, monkeypatch):
    monkeypatch.setenv("GUBER_DEBUG_DUMP_DIR", str(tmp_path))
    inst = V1Instance(Config(cache_size=1 << 10, device="cpu",
                             batch_rows=64))
    inst.span_recorder.sample = 1.0
    with pt.request_context(None, recorder=inst.span_recorder):
        with pt.span("grpc.GetRateLimits", metrics=inst.metrics):
            inst.get_rate_limits([req("dump_k")], now_ms=NOW)
    assert inst.metrics.registry.get_sample_value(
        "gubernator_func_duration_count",
        {"name": "grpc.GetRateLimits"}) == 1
    inst.close()
    files = glob.glob(str(tmp_path / "guber_traces_*.jsonl"))
    assert len(files) == 1
    with open(files[0], encoding="utf-8") as f:
        lines = [json.loads(ln) for ln in f if ln.strip()]
    assert lines[0]["kind"] == "trace_header"
    assert lines[0]["spans"] == len(lines) - 1 >= 5
    assert {ln["name"] for ln in lines[1:]} >= {"grpc.GetRateLimits", "wave"}


def test_sixteen_threads_never_block_on_the_recorder():
    r = pt.SpanRecorder(capacity=256, sample=0.5)
    errors = []

    def worker(i):
        try:
            for j in range(200):
                with pt.request_context(None, recorder=r):
                    with pt.span("a"):
                        with pt.span("b"):
                            if j % 50 == 0:
                                pt.force_sample("degraded")
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not errors and len(r) == 256
    assert r.stats()["pending"] == 0


# --- host steps (tracing.step) ------------------------------------------

WAVE_STEPS = {"wave.fill", "wave.upload", "wave.plan", "wave.launch",
              "wave.download", "wave.collect"}


def _wire_calls(inst, n, rows=8, prefix="st"):
    from gubernator_tpu_torch.wire import encode_get_rate_limits

    for c in range(n):
        inst.get_rate_limits_wire(encode_get_rate_limits(
            [req(f"{prefix}{c}_{i}") for i in range(rows)]), NOW)


def _timelines(disp):
    """Capture each wave's start, end and step timeline as it ends
    (perf_counter readings)."""
    got = []
    end = disp._wave_end

    def recording(wid, error=None):
        with disp._tel_mu:
            info = disp._inflight.get(wid)
        if info is not None:
            got.append((info["p0"], time.perf_counter(),
                        list(info["steps"])))
        return end(wid, error)

    disp._wave_end = recording
    return got


@pytest.mark.parametrize("pipeline", ["0", "1"])
def test_steps_lie_inside_their_wave(monkeypatch, pipeline):
    """Inline waves (pipeline off) and pipelined ones: each wave's steps
    start and end inside it, none overlaps another step of the wave but
    the one it runs in, their sum stays under the wave's duration, each
    step's CPU time under its wall time, and every step of the engine
    path shows; the phases still partition the wave and its span."""
    monkeypatch.setenv("GUBER_PIPELINE", pipeline)
    inst = V1Instance(Config(cache_size=1 << 10, device="cpu",
                             batch_rows=64))
    try:
        got = _timelines(inst.dispatcher)
        inst.span_recorder.sample = 1.0
        with pt.request_context(None, recorder=inst.span_recorder):
            tid = pt.current_trace_id()
            with pt.span("grpc.GetRateLimits"):
                _wire_calls(inst, 3)
        assert len(got) == 3
        for p0, p1, steps in got:
            assert {s[0] for s in steps} == WAVE_STEPS
            for name, phase, t0, t1, wall, cpu, seq, parent in steps:
                assert p0 <= t0 <= t1 <= p1, name
                assert 0 <= cpu <= wall <= t1 - t0, name
                assert phase == "device" or pipeline == "1"
            assert sum(s[4] for s in steps) <= p1 - p0
            outer = [s for s in steps if s[7] is None]
            outer.sort(key=lambda s: s[2])
            for a, b in zip(outer, outer[1:]):
                assert a[3] <= b[2]
        evs = [e for e in inst.recorder.events(kind="wave_completed")
               if e["trace"] == tid]
        assert len(evs) == 3
        for e in evs:
            assert set(e["steps"]) == WAVE_STEPS
            assert sum(e["steps"].values()) <= \
                e["duration_ms"] + 0.0005 * len(e["steps"])
            assert abs(sum(e["phases"].values()) - e["duration_ms"]) <= \
                0.0005 * (len(e["phases"]) + 1)
        (trace,) = pt.assemble(inst.span_recorder.spans(), tid)
        for w in _waves(trace):
            _exact_partition(w)
            kids = [c for k in w["children"] for c in k["children"]]
            assert {c["name"] for c in kids} <= WAVE_STEPS
            assert all(w["start"] <= c["start"] <= c["end"] <= w["end"]
                       for c in kids)
    finally:
        inst.close()


def test_no_annotation_without_a_profiler(monkeypatch):
    """With no profiler recording, a step never opens a device-trace
    range, and neither does the analytics' tap copy."""
    calls = []

    def spy(name):
        calls.append(name)
        return pt.contextlib.nullcontext()

    monkeypatch.setattr(pt, "step_annotation", spy)
    inst = V1Instance(Config(cache_size=1 << 10, device="cpu",
                             batch_rows=64))
    try:
        _wire_calls(inst, 2)
        inst.get_rate_limits([req("spy_k")], now_ms=NOW)
        assert not pt.profiling() and calls == []
        assert inst.metrics.registry.get_sample_value(
            "gubernator_phase_duration_count", {"phase": "wave.plan"}) == 3
    finally:
        inst.close()


def test_steps_are_ranges_of_a_cpu_profile(monkeypatch):
    """Under torch.profiler (every thread recorded, as the benchmark's
    traced run records): the wave's ranges lie on the dispatcher's
    worker, the caller's ingest and build on the caller's thread."""
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.setenv("GUBER_PIPELINE", "1")
    inst = V1Instance(Config(cache_size=1 << 10, device="cpu",
                             batch_rows=64))
    try:
        _wire_calls(inst, 1, prefix="warm")
        with profile(activities=[ProfilerActivity.CPU],
                     experimental_config=_ExperimentalConfig(
                         profile_all_threads=True)) as prof:
            assert pt.profiling()
            with torch.profiler.record_function("test.caller"):
                _wire_calls(inst, 3)
        assert not pt.profiling()
        evs = [(e.name(), e.start_thread_id())
               for e in prof.profiler.kineto_results.events()]
        names = {n for n, _ in evs}
        assert {"guber." + s for s in WAVE_STEPS} | {
            "guber.ingest", "guber.build"} <= names
        caller = {t for n, t in evs if n == "test.caller"}
        worker = {t for n, t in evs if n.startswith("guber.wave.")}
        assert len(worker) == 1 and worker.isdisjoint(caller)
        assert {t for n, t in evs
                if n in ("guber.ingest", "guber.build")} == caller
        assert not any("decide_kernel" in n or n == "portbench.window"
                       for n in names if n.startswith("guber."))
    finally:
        inst.close()


@pytest.mark.parametrize("pipeline", ["0", "1"])
def test_ingest_and_build_once_per_wire_call(monkeypatch, pipeline):
    """Each wire call observes one ingest and one build, with their CPU
    time, inline (its ingest ends where its wave starts) or queued (at
    its job's hand-off)."""
    monkeypatch.setenv("GUBER_PIPELINE", pipeline)
    inst = V1Instance(Config(cache_size=1 << 10, device="cpu",
                             batch_rows=64))
    g = inst.metrics.registry.get_sample_value
    try:
        _wire_calls(inst, 5)
        for phase in ("ingest", "build"):
            assert g("gubernator_phase_duration_count",
                     {"phase": phase}) == 5
            cpu = g("gubernator_phase_cpu_seconds_total", {"phase": phase})
            assert 0 < cpu <= g("gubernator_phase_duration_sum",
                                {"phase": phase})
    finally:
        inst.close()
