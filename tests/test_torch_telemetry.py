"""The port's flight recorder (gubernator_tpu_torch/telemetry.py) held to
the JAX package's: the same seeded sequence of ``record`` calls gives
equal ``events()`` under every filter (all fields but the wall-clock
``t_ms``), and the ring bounds, JSON safety, capacity validation and
``exc_text`` behave alike."""
import json

import numpy as np
import pytest

from gubernator_tpu import telemetry as jax_tel
from gubernator_tpu_torch import telemetry as tel

KINDS = ("wave_launched", "wave_completed", "admission_shed", "broadcast")
TENANTS = (None, "acme", "globex")
TRACES = (None, "t1", "t2")


def record_stream(rec, seed: int, n: int) -> None:
    """``n`` events of mixed kinds, tenants, traces and field types,
    drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    for i in range(n):
        fields = {"wave": i, "size": int(rng.integers(0, 9000)),
                  "duration_ms": float(rng.random()),
                  "ok": bool(rng.random() < 0.5)}
        t = TENANTS[int(rng.integers(0, 3))]
        if t is not None:
            fields["tenant"] = t
        if rng.random() < 0.3:
            fields["phases"] = {"pack": 0.1, "device": 0.2,
                                "obj": object.__name__}
        if rng.random() < 0.2:
            fields["blob"] = (1, 2)  # not JSON: coerced with repr
        rec.record(KINDS[int(rng.integers(0, 4))],
                   trace=TRACES[int(rng.integers(0, 3))], **fields)


def strip(events):
    return [{k: v for k, v in e.items() if k != "t_ms"} for e in events]


def jax_recorder(capacity):
    """The JAX recorder, its trace defaulting to no active trace (the
    port reads none: tracing is not ported)."""
    return jax_tel.FlightRecorder(capacity=capacity)


FILTERS = [dict(), dict(limit=5), dict(limit=0), dict(kind="broadcast"),
           dict(since_seq=40), dict(tenant="acme"), dict(trace="t2"),
           dict(kind="wave_launched", tenant="globex", limit=3),
           dict(trace="t1", since_seq=10, limit=7)]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("flt", FILTERS, ids=lambda f: ",".join(
    f"{k}={v}" for k, v in f.items()) or "all")
def test_events_match_jax_under_every_filter(seed, flt):
    port, ref = tel.FlightRecorder(capacity=64), jax_recorder(64)
    record_stream(port, seed, 100)
    record_stream(ref, seed, 100)
    got, want = port.events(**flt), ref.events(**flt)
    assert strip(got) == strip(want)
    assert all(isinstance(e["t_ms"], int) for e in got)


def test_ring_is_bounded_and_keeps_the_newest():
    port, ref = tel.FlightRecorder(capacity=8), jax_recorder(8)
    for rec in (port, ref):
        for i in range(20):
            rec.record("k", wave=i)
    assert len(port) == len(ref) == 8
    assert [e["seq"] for e in port.events()] == list(range(13, 21))
    assert strip(port.events()) == strip(ref.events())


def test_events_are_json_safe():
    port = tel.FlightRecorder()
    record_stream(port, 3, 50)
    port.record("odd", value=np.int64(3), nested={"a": [1, 2]},
                err=ValueError("x"))
    back = json.loads(json.dumps(port.events()))
    assert back[-1]["nested"] == {"a": "[1, 2]"}
    assert back[-1]["value"] == repr(np.int64(3))


@pytest.mark.parametrize("capacity", [0, -1])
def test_capacity_must_be_positive(capacity):
    for mod in (tel, jax_tel):
        with pytest.raises(ValueError, match="capacity"):
            mod.FlightRecorder(capacity=capacity)


@pytest.mark.parametrize("exc", [TimeoutError(), TimeoutError("late"),
                                 RuntimeError(), KeyError("k")],
                         ids=repr)
def test_exc_text_never_empty_and_matches_jax(exc):
    assert tel.exc_text(exc) == jax_tel.exc_text(exc)
    assert tel.exc_text(exc)
    assert tel.exc_text(TimeoutError()) == "TimeoutError()"


def test_record_error_carries_the_text():
    port, ref = tel.FlightRecorder(), jax_recorder(512)
    for rec in (port, ref):
        rec.record_error("wave_error", TimeoutError(), wave=3)
    assert strip(port.events()) == strip(ref.events())
    assert port.events()[0]["error"] == "TimeoutError()"
