"""Flight recorder: a bounded in-memory ring of structured events (the
port's copy of gubernator_tpu/telemetry.py).

Every layer that can wedge (dispatcher waves, admission sheds, the
drain, GLOBAL broadcasts) records cheap structured events here, and the
daemon serves the ring as JSON at ``GET /debug/events``.  Events are
plain dicts, JSON-safe by construction, ordered by a monotonic ``seq``;
the ring is bounded, so recording on the hot path is O(1).

An event's ``trace`` is what its caller stamps, by default the calling
thread's active trace id (tracing.py).  ``write_debug_dump`` and
``write_trace_dump`` spill the ring, the final SLO verdicts and the
sampled spans as JSONL at close (GUBER_DEBUG_DUMP_DIR).
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import List, Optional

from .tracing import current_trace_id


def exc_text(e: BaseException) -> str:
    """Non-empty error text for any exception: ``str(e)`` is empty for a
    bare ``TimeoutError``, so error rows, logs and events take the
    message when there is one and ``repr`` otherwise."""
    return str(e) or repr(e)


class FlightRecorder:
    """Bounded ring of structured events (thread-safe).

    Each event is ``{"seq": int, "t_ms": wall-clock ms, "kind": str,
    "trace": trace id or None, **fields}``.  Non-primitive field values
    are coerced with ``repr`` (one-level dicts keep their structure), so
    ``events()`` is always JSON-safe."""

    def __init__(self, capacity: int = 512, clock=time.time):
        if capacity < 1:
            raise ValueError("recorder capacity must be >= 1")
        self.capacity = capacity
        self._clock = clock
        self._mu = threading.Lock()
        self._ring: deque = deque(maxlen=capacity)  # guarded-by: self._mu
        self._seq = 0  # guarded-by: self._mu

    def record(self, kind: str, trace: Optional[str] = None,
               **fields) -> dict:
        """Append one event; returns the stored dict.  ``trace`` defaults
        to the calling thread's active trace id."""
        if trace is None:
            trace = current_trace_id()
        ev = {"kind": kind, "t_ms": int(self._clock() * 1000),
              "trace": trace}
        for k, v in fields.items():
            ev[k] = self._coerce(v)
        with self._mu:
            self._seq += 1
            ev["seq"] = self._seq
            self._ring.append(ev)
        return ev

    @classmethod
    def _coerce(cls, v):
        """Primitives pass, one-level dicts keep their structure (a
        wave's ``phases`` block stays queryable), the rest reprs."""
        if v is None or isinstance(v, (str, int, float, bool)):
            return v
        if isinstance(v, dict):
            return {str(k): (vv if vv is None
                             or isinstance(vv, (str, int, float, bool))
                             else repr(vv))
                    for k, vv in v.items()}
        return repr(v)

    def record_error(self, kind: str, e: BaseException, **fields) -> dict:
        """``record`` with the exception's non-empty text in ``error``."""
        return self.record(kind, error=exc_text(e), **fields)

    def events(self, limit: Optional[int] = None,
               kind: Optional[str] = None,
               since_seq: Optional[int] = None,
               tenant: Optional[str] = None,
               trace: Optional[str] = None) -> List[dict]:
        """Chronological snapshot (oldest first).  ``kind``, ``tenant``
        and ``trace`` keep only events with that field value,
        ``since_seq`` only events with ``seq > since_seq``; ``limit``
        then keeps the newest N."""
        with self._mu:
            out = list(self._ring)
        if kind:
            out = [e for e in out if e.get("kind") == kind]
        if tenant:
            out = [e for e in out if e.get("tenant") == tenant]
        if trace:
            out = [e for e in out if e.get("trace") == trace]
        if since_seq is not None:
            out = [e for e in out if e.get("seq", 0) > since_seq]
        if limit is not None and limit >= 0:
            out = out[len(out) - min(limit, len(out)):]
        return out

    def __len__(self) -> int:
        with self._mu:
            return len(self._ring)


def write_debug_dump(dirpath: str, instance_id: str,
                     events: List[dict],
                     slo_verdicts: Optional[List[dict]] = None,
                     clock=time.time) -> str:
    """Crash-forensics dump: one JSONL file per close —
    header line with the final SLO verdicts, then the whole event
    ring — so a killed pod leaves a post-mortem artifact in
    ``GUBER_DEBUG_DUMP_DIR``.  Returns the written path.  Callers
    (instance.close) treat any failure as best-effort: a dying
    process must never wedge on its own black box."""

    os.makedirs(dirpath, exist_ok=True)
    t_ms = int(clock() * 1000)
    safe = "".join(c if c.isalnum() or c in "-._" else "_"
                   for c in str(instance_id)) or "instance"
    path = os.path.join(dirpath, f"guber_dump_{safe}_{t_ms}.jsonl")
    header = {"kind": "dump_header", "t_ms": t_ms,
              "instance": str(instance_id), "events": len(events)}
    if slo_verdicts is not None:
        header["slo_verdicts"] = slo_verdicts
    with open(path, "w", encoding="utf-8") as f:
        f.write(json.dumps(header) + "\n")
        for ev in events:
            f.write(json.dumps(ev) + "\n")
    return path


def write_trace_dump(dirpath: str, instance_id: str,
                     spans: List[dict], clock=time.time) -> str:
    """The span ring beside ``write_debug_dump``: a header line, then
    one completed span per line, so sampled traces survive the
    process.  Same best-effort contract as the event dump."""

    os.makedirs(dirpath, exist_ok=True)
    t_ms = int(clock() * 1000)
    safe = "".join(c if c.isalnum() or c in "-._" else "_"
                   for c in str(instance_id)) or "instance"
    path = os.path.join(dirpath, f"guber_traces_{safe}_{t_ms}.jsonl")
    header = {"kind": "trace_header", "t_ms": t_ms,
              "instance": str(instance_id), "spans": len(spans)}
    with open(path, "w", encoding="utf-8") as f:
        f.write(json.dumps(header) + "\n")
        for s in spans:
            f.write(json.dumps(s) + "\n")
    return path
