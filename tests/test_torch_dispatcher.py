"""The port's dispatcher lifecycle (gubernator_tpu_torch/dispatcher.py)
held to the JAX package's Dispatcher on the same inputs:

- the GUBER_* dispatcher knobs parse alike (well-formed, malformed,
  zero, negative, NaN and inf), seen through ``debug_stats()``,
  ``max_delay_s`` and ``admission_limit``;
- admission sheds for each of its three reasons with the same message,
  shed rows, counter and event, and its row accounting returns to 0
  after a burst that went through the carry;
- the stall watchdog, driven by a fake clock, flags a stall and clears
  it, and is off for a threshold <= 0;
- a caller that outwaits RESULT_TIMEOUT_S gets a diagnosed TimeoutError;
- ``debug_stats()`` has JAX's keys.
"""
import math
import threading

import numpy as np
import pytest

from gubernator_tpu import dispatcher as jdisp
from gubernator_tpu.metrics import Metrics as JaxMetrics
from gubernator_tpu.telemetry import FlightRecorder as JaxRecorder
from gubernator_tpu.types import RateLimitRequest as JaxReq
from gubernator_tpu.types import RateLimitResponse as JaxResp
from gubernator_tpu_torch import dispatcher as pdisp
from gubernator_tpu_torch.core.batch import WaveBufferPool, pack_columns
from gubernator_tpu_torch.engine import BucketEngine
from gubernator_tpu_torch.metrics import Metrics
from gubernator_tpu_torch.telemetry import FlightRecorder
from gubernator_tpu_torch.types import RateLimitRequest

NOW = 1_765_000_000_000
KNOBS = ("GUBER_COALESCE_US", "GUBER_PIPELINE", "GUBER_PIPELINE_DEPTH",
         "GUBER_ADMISSION_LIMIT", "GUBER_RESULT_TIMEOUT_S",
         "GUBER_STALL_THRESHOLD_S")
VALUES = ("", "3", "1", "2.5", "abc", "0", "-4", "nan", "inf")
SIDES = {"port": (pdisp, Metrics, FlightRecorder),
         "jax": (jdisp, JaxMetrics, JaxRecorder)}


class FakeEngine:
    """What a dispatcher asks of an engine at construction: a pipelining
    capability and a wave pool; ``gate`` holds its engine calls."""

    def __init__(self, gate=None):
        self.wave_pool = WaveBufferPool()
        self.gate = gate

    def launch_packed(self, batch, khash, now_ms):
        return batch, khash

    def check_packed(self, batch, khash, now_ms):
        if self.gate is not None:
            self.gate.wait(30)
        n = len(khash)
        z = np.zeros(n, np.int64)
        return np.zeros(n, np.int32), z, z, z, np.zeros(n, bool)

    def check_batch(self, reqs, now_ms):
        self.check_packed(None, np.zeros(len(reqs)), now_ms)
        return [JaxResp() for _ in reqs]


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def pair(**kw):
    """(port dispatcher, JAX dispatcher) over fake engines."""
    out = []
    for mod, metrics, rec in (SIDES["port"], SIDES["jax"]):
        out.append(mod.Dispatcher(FakeEngine(), metrics=metrics(),
                                  recorder=rec(), **kw))
    return out


def close(*ds):
    for d in ds:
        d.close()


def same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


@pytest.mark.parametrize("value", VALUES, ids=lambda v: v or "unset")
@pytest.mark.parametrize("knob", KNOBS)
def test_env_knobs_parse_as_jax(monkeypatch, knob, value):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    if value:
        monkeypatch.setenv(knob, value)
    port, ref = pair(max_wave=512)
    try:
        got, want = port.debug_stats(), ref.debug_stats()
        assert got.keys() == want.keys()
        for k in got:
            assert same(got[k], want[k]), (k, got[k], want[k])
        assert same(port.max_delay_s, ref.max_delay_s)
        assert port.admission_limit == ref.admission_limit
        assert port.pipeline_depth == ref.pipeline_depth
        assert (port._watchdog is None) == (ref._watchdog is None)
    finally:
        close(port, ref)


def shed(d, mod, reason: str) -> str:
    if reason == "draining":
        d.drain()
        call = lambda: d.admit(7)  # noqa: E731
    elif reason == "queue_full":
        d.admission_limit = 10
        call = lambda: d.admit(11)  # noqa: E731
    else:
        # 100 rows ahead, recent waves of 10 rows taking 1 s each: a
        # projected wait of 1 s against a 0.5 s deadline
        d._queued_rows = 100
        d._recent_sizes.append(10)
        d._recent_durs.append(1.0)
        if reason == "deadline":
            call = lambda: d.admit(5, deadline_s=0.5)  # noqa: E731
        else:
            def call():
                with mod.request_deadline(0.5):
                    d.admit(5)
    with pytest.raises(mod.ResourceExhausted) as e:
        call()
    return str(e.value)


@pytest.mark.parametrize("reason", ["draining", "queue_full", "deadline",
                                    "deadline in context"])
def test_shed_matches_jax(reason):
    port, ref = pair(max_wave=64)
    try:
        msgs = [shed(d, mod, reason) for d, mod in ((port, pdisp),
                                                    (ref, jdisp))]
        assert msgs[0] == msgs[1]
        assert msgs[0].startswith("admission control shed ")
        label = reason.split()[0]
        assert f"({label}:" in msgs[0]
        rows = [d.debug_stats()["admission"]["shed_rows"]
                for d in (port, ref)]
        assert rows[0] == rows[1] > 0
        samples = [d.metrics.registry.get_sample_value(
            "gubernator_admission_shed_total", {"reason": label})
            for d in (port, ref)]
        assert samples[0] == samples[1] == rows[0]
        events = [[{k: v for k, v in e.items() if k not in ("t_ms", "seq")}
                   for e in d.recorder.events(kind="admission_shed")]
                  for d in (port, ref)]
        assert events[0] == events[1] and len(events[0]) == 1
    finally:
        close(port, ref)


def test_no_deadline_shed_without_a_backlog():
    port = pdisp.Dispatcher(FakeEngine())
    try:
        port._recent_durs.append(10.0)
        with pdisp.request_deadline(0.001):
            port.admit(5)  # idle: the wave launches at once
    finally:
        port.close()


def test_admission_rows_return_to_zero_after_a_burst():
    """Concurrent callers whose batches overflow a wave (the carry path)
    leave no queued rows behind: queue_full does not shed forever."""
    eng = BucketEngine(device="cpu", capacity=4096, batch_rows=64)
    disp = pdisp.Dispatcher(eng, max_wave=64, max_delay_ms=5)
    errs = []

    def go(c):
        try:
            for b in range(3):
                reqs = [RateLimitRequest(name=f"b{c}", unique_key=f"k{i}",
                                         hits=1, limit=9, duration=60_000)
                        for i in range(40)]
                disp.check_batch(reqs, NOW + b)
        except Exception as e:  # noqa: BLE001 - asserted below
            errs.append(e)

    threads = [threading.Thread(target=go, args=(c,)) for c in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    try:
        assert not errs and not any(t.is_alive() for t in threads)
        st = disp.debug_stats()
        assert st["admission"]["queued_rows"] == 0 and st["queue_depth"] == 0
        assert st["waves"] == disp.wave_count >= 9
        disp.admission_limit = 40
        disp.admit(40)  # the bound holds a full batch again
    finally:
        disp.close()


def watch(mod, metrics, rec):
    clock = FakeClock()
    d = mod.Dispatcher(FakeEngine(), metrics=metrics(), recorder=rec(),
                       clock=clock)
    # the polls below are the test's; no thread polls meanwhile
    assert d._watchdog is None
    d._stall_threshold_s = 5.0
    wid = d._wave_begin("packed", nreq=3)
    clock.t += 4.9
    seen = [d._watchdog_poll()]
    clock.t += 0.2
    seen += [d._watchdog_poll(), d._watchdog_poll()]
    mid = d.debug_stats()
    gauge = d.metrics.registry.get_sample_value
    mid_gauge = gauge("gubernator_dispatcher_stalled")
    d._wave_end(wid)
    end = d.debug_stats()
    out = (seen, mid, mid_gauge, end,
           gauge("gubernator_dispatcher_stalled"),
           gauge("gubernator_dispatcher_stall_events_total"),
           [e["kind"] for e in d.recorder.events()])
    d.close()
    return out


def test_watchdog_flags_and_clears_a_stall_as_jax(monkeypatch):
    monkeypatch.setenv("GUBER_STALL_THRESHOLD_S", "0")
    port = watch(*SIDES["port"])
    ref = watch(*SIDES["jax"])
    assert port == ref
    seen, mid, mid_gauge, end, end_gauge, events, kinds = port
    assert seen == [False, True, False]
    assert mid["stalled"] and mid["stall_events"] == 1
    assert mid["oldest_wave_age_s"] == 5.1 and mid_gauge == 1
    assert not end["stalled"] and end["in_flight"] == 0 and end_gauge == 0
    assert events == 1
    assert kinds == ["wave_launched", "wave_stalled", "wave_completed",
                     "first_wave"]


@pytest.mark.parametrize("threshold", ["0", "-1", "nan"])
def test_watchdog_is_off_at_a_threshold_at_or_below_zero(monkeypatch,
                                                          threshold):
    monkeypatch.setenv("GUBER_STALL_THRESHOLD_S", threshold)
    d = pdisp.Dispatcher(FakeEngine())
    try:
        assert d._watchdog is None
        assert d.debug_stats()["stall_threshold_s"] <= 0
    finally:
        d.close()


def test_watchdog_thread_runs_and_joins(monkeypatch):
    monkeypatch.setenv("GUBER_STALL_THRESHOLD_S", "0.05")
    gate = threading.Event()
    d = pdisp.Dispatcher(FakeEngine(gate), recorder=FlightRecorder())
    t = threading.Thread(target=d.check_batch,
                         args=([RateLimitRequest(name="a", unique_key="b",
                                                 limit=1)], NOW))
    t.start()
    try:
        for _ in range(500):
            if d.debug_stats()["stalled"]:
                break
            threading.Event().wait(0.01)
        assert d.debug_stats()["stalled"]
    finally:
        gate.set()
        t.join(timeout=10)
        d.close()
    assert not d._watchdog.is_alive() and not d._thread.is_alive()
    assert "wave_stalled" in [e["kind"] for e in d.recorder.events()]


@pytest.mark.parametrize("side", ["port", "jax"])
def test_result_timeout_is_diagnosed(monkeypatch, side):
    mod, metrics, rec = SIDES[side]
    monkeypatch.setenv("GUBER_RESULT_TIMEOUT_S", "0.2")
    gate = threading.Event()
    d = mod.Dispatcher(FakeEngine(gate), metrics=metrics(), recorder=rec())
    req_cls = RateLimitRequest if side == "port" else JaxReq
    # the JAX object lane runs an idle wave inline, in the caller's
    # thread: with the inline path taken the call queues in both
    d._inline_mu.acquire()
    try:
        with pytest.raises(TimeoutError) as e:
            d.check_batch([req_cls(name="a", unique_key="b", limit=1)], NOW)
        msg = str(e.value)
        assert msg.startswith("dispatcher wave result timed out after 0s")
        assert "in_flight=1" in msg and "GUBER_RESULT_TIMEOUT_S" in msg
        st = d.debug_stats()
        assert st["timeouts"] == 1 and st["result_timeout_s"] == 0.2
        assert d.metrics.registry.get_sample_value(
            "gubernator_dispatcher_wave_timeouts_total") == 1
        assert [ev["error"] for ev in d.recorder.events(
            kind="wave_timeout")] == [msg]
    finally:
        gate.set()
        d._inline_mu.release()
        d.close()


def test_debug_stats_keys_match_jax():
    port, ref = pair()
    try:
        got, want = port.debug_stats(), ref.debug_stats()
        assert got.keys() == want.keys()
        assert got["admission"].keys() == want["admission"].keys()
        assert got["buffer_pool"].keys() == want["buffer_pool"].keys()
        assert got["analytics"] is want["analytics"] is None
        snap, ref_snap = port.telemetry_snapshot(), ref.telemetry_snapshot()
        assert snap.keys() == ref_snap.keys()
    finally:
        close(port, ref)


def test_projected_queue_wait_matches_jax():
    port, ref = pair(max_wave=64)
    try:
        for d in (port, ref):
            d._recent_sizes.extend([10, 30, 50])
            d._recent_durs.extend([0.5, 1.0, 1.5])
        for queued in (0, 1, 30, 64, 65, 500):
            for d in (port, ref):
                d._queued_rows = queued
            assert port.projected_queue_wait_s(7) == \
                ref.projected_queue_wait_s(7), queued
    finally:
        close(port, ref)


def test_waves_feed_the_histograms():
    """Every engine call is one wave: inline, coalesced and pipelined
    waves each count once in the wave histograms and the recorder."""
    eng = BucketEngine(device="cpu", capacity=4096, batch_rows=64)
    m, rec = Metrics(), FlightRecorder()
    disp = pdisp.Dispatcher(eng, max_wave=512, metrics=m, recorder=rec)
    kh = np.arange(1, 11, dtype=np.uint64)
    ones = np.ones(10, np.int64)
    batch = pack_columns(kh, ones, 5 * ones, 60_000 * ones,
                         np.zeros(10, np.int32), np.zeros(10, np.int32),
                         np.zeros(10, np.int64), NOW)[0]
    try:
        disp.check_packed(batch, kh, NOW)  # idle: inline
        disp.check_batch([RateLimitRequest(name="a", unique_key="b",
                                           limit=3)], NOW)  # worker
    finally:
        disp.close()
    g = m.registry.get_sample_value
    assert g("gubernator_dispatcher_wave_duration_count") == 2
    assert g("gubernator_dispatcher_wave_size_sum") == 11
    assert g("gubernator_phase_duration_count", {"phase": "device"}) == 2
    assert g("gubernator_dispatcher_waves_in_flight") == 0
    kinds = [(e["kind"], e.get("wave_kind")) for e in rec.events()]
    assert kinds[:2] == [("wave_launched", "inline_packed"),
                         ("wave_completed", "inline_packed")]
    assert ("wave_completed", "list") in kinds
    assert disp.inline_waves == 1 and disp.wave_count == 1
