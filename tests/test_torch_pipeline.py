"""The launch/sync pipeline of the port's dispatcher on the CPU
(``GUBER_PIPELINE=1``; on CUDA it is the default):

- 12 callers on disjoint keys, at pipeline depths 1 and 2, get the wire
  bytes a JAX instance answers when given the same batches one after
  another (ROADMAP section C says why the reference runs sequentially),
  on the bucket and the classic engine, through the fused, parse and
  protobuf lanes;
- the waves really were pipelined: at least 3 ``packed_pipelined``
  waves, and at depth 2 a wave launched behind another (slot 1);
- no wave lease is left outstanding or leaked, and no row stays queued;
- an engine exception in a launch or a sync fails only its own wave.
"""
import threading
import time

import pytest

from gubernator_tpu_torch.dispatcher import Dispatcher

from test_torch_wire import (ENGINES, jax_instance, port_instance,  # noqa: E402
                             quiet_jax, wire_stream)


def pipelined(monkeypatch, depth: int) -> None:
    quiet_jax(monkeypatch)
    monkeypatch.setenv("GUBER_PIPELINE", "1")
    monkeypatch.setenv("GUBER_PIPELINE_DEPTH", str(depth))


def sequential_reference(engine: str, batches):
    """A JAX instance's answers to ``batches``, one after another."""
    ref = jax_instance(ENGINES[engine])
    try:
        return [ref.get_rate_limits_wire(data, now) for data, now in batches]
    finally:
        ref.close()


def run_gated(port, streams):
    """Every caller's stream in its own thread.  Caller 0 starts alone,
    and its first launch waits until another caller's job is queued, so
    a depth-2 pipeline launches that job behind it."""
    entered = threading.Event()
    launch = port.engine.launch_packed

    def gated(*a, **k):
        if not entered.is_set():
            entered.set()
            end = time.monotonic() + 30
            while port.dispatcher._queue.empty() and time.monotonic() < end:
                time.sleep(0.001)
        return launch(*a, **k)

    port.engine.launch_packed = gated
    out, failures = {}, []

    def go(c):
        try:
            out[c] = [port.get_rate_limits_wire(data, now)
                      for data, now in streams[c]]
        except Exception as e:  # noqa: BLE001 - re-raised below
            failures.append(e)

    threads = {c: threading.Thread(target=go, args=(c,)) for c in streams}
    threads[0].start()
    assert entered.wait(30)
    for c, t in threads.items():
        if c:
            t.start()
    for t in threads.values():
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads.values())
    if failures:
        raise failures[0]
    return out


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_pipelined_callers_match_jax(monkeypatch, engine, depth):
    pipelined(monkeypatch, depth)
    streams = {c: wire_stream(c, 11) for c in range(12)}
    port = port_instance(ENGINES[engine])
    try:
        assert port.dispatcher.debug_stats()["pipeline_depth"] == depth
        got = run_gated(port, streams)
        stats = port.dispatcher.debug_stats()
        pool = port.engine.wave_pool.stats()
        events = port.recorder.events(kind="wave_launched")
        inline = port.dispatcher.inline_waves
    finally:
        port.close()
    want = sequential_reference(
        engine, [b for c in sorted(streams) for b in streams[c]])
    flat = [b for c in sorted(streams) for b in got[c]]
    assert flat == want
    slots = [e["slot"] for e in events
             if e["wave_kind"] == "packed_pipelined"]
    assert len(slots) >= 3 and inline == 0
    assert max(slots) == depth - 1
    assert pool["outstanding"] == 0 and pool["leaks"] == 0
    assert stats["admission"]["queued_rows"] == 0
    assert stats["in_flight"] == 0 and stats["timeouts"] == 0


def test_pipeline_is_off_on_the_cpu_by_default(monkeypatch):
    """On the CPU a launch computes the whole step: the default keeps
    the inline path; an engine without launch_packed never pipelines."""
    quiet_jax(monkeypatch)
    monkeypatch.delenv("GUBER_PIPELINE", raising=False)
    port = port_instance("")
    try:
        assert port.dispatcher.debug_stats()["pipeline_depth"] == 0
        assert port.metrics.registry.get_sample_value(
            "gubernator_dispatcher_pipeline_depth") == 0
    finally:
        port.close()

    class NoLaunch:
        device = port.engine.device

    monkeypatch.setenv("GUBER_PIPELINE", "1")
    d = Dispatcher(NoLaunch())
    try:
        assert d.debug_stats()["pipeline_depth"] == 0
    finally:
        d.close()


@pytest.mark.parametrize("where", ["launch_packed", "sync_packed"])
@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_engine_fault_fails_only_its_own_wave(monkeypatch, engine, where):
    """The third launch (or sync) raises: that batch's caller gets the
    error, every other batch answers as the JAX instance does (a failed
    launch changed no state; a failed sync's launch did), and nothing
    leaks or stays queued."""
    pipelined(monkeypatch, 2)
    batches = [b for c in range(3) for b in wire_stream(c, 13)]
    port = port_instance(ENGINES[engine])
    calls = [0]
    real = getattr(port.engine, where)

    def faulty(*a, **k):
        calls[0] += 1
        if calls[0] == 3:
            raise RuntimeError("injected engine fault")
        return real(*a, **k)

    setattr(port.engine, where, faulty)
    got = []
    try:
        for data, now in batches:
            try:
                got.append(port.get_rate_limits_wire(data, now))
            except RuntimeError as e:
                got.append(str(e))
        errors = port.recorder.events(kind="wave_error")
        stats = port.dispatcher.debug_stats()
        pool = port.engine.wave_pool.stats()
    finally:
        port.close()
    failed = [i for i, g in enumerate(got) if isinstance(g, str)]
    assert len(failed) == 1 and got[failed[0]] == "injected engine fault"
    ref_batches = [b for i, b in enumerate(batches)
                   if not (where == "launch_packed" and i == failed[0])]
    want = sequential_reference(engine, ref_batches)
    if where == "launch_packed":
        assert [g for i, g in enumerate(got) if i != failed[0]] == want
    else:
        assert [g for i, g in enumerate(got) if i != failed[0]] == \
            [w for i, w in enumerate(want) if i != failed[0]]
    assert [(e["wave_kind"], e["error"]) for e in errors] == \
        [("packed_pipelined", "injected engine fault")]
    assert stats["in_flight"] == 0 and stats["admission"]["queued_rows"] == 0
    assert pool["outstanding"] == 0 and pool["leaks"] == 0
