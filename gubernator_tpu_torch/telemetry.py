"""Flight recorder: a bounded in-memory ring of structured events (the
port's copy of gubernator_tpu/telemetry.py).

Every layer that can wedge (dispatcher waves, admission sheds, the
drain, GLOBAL broadcasts) records cheap structured events here, and the
daemon serves the ring as JSON at ``GET /debug/events``.  Events are
plain dicts, JSON-safe by construction, ordered by a monotonic ``seq``;
the ring is bounded, so recording on the hot path is O(1).

The tracing slice is not ported: an event's ``trace`` is what its caller
stamps (None by default), where the JAX recorder reads the calling
thread's trace id.  The crash dumps (``write_debug_dump`` /
``write_trace_dump``) wait for that slice too.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import List, Optional


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
        """Append one event; returns the stored dict."""
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
