"""Tracing and profiling (the port of gubernator_tpu/tracing.py).

- ``span(name)`` wraps host-side sections and feeds the
  ``gubernator_func_duration`` histogram.
- ``SpanRecorder`` keeps the structure: when a request context is armed
  with a recorder, every ``span()`` and the dispatcher's wave spans land
  in a bounded per-daemon ring, head-sampled at ``GUBER_TRACE_SAMPLE``
  (a pure function of the trace id, so every daemon keeps the same
  traces), with forced samples on error, degraded and shed outcomes.
  ``GET /debug/traces`` serves the ring; ``assemble()`` and
  ``render_waterfall()`` stitch per-daemon slices into one tree.
- ``DeviceProfiler`` captures a ``torch.profiler`` trace (CPU activity,
  and CUDA activity on a CUDA daemon: the kernels, K1's among them) into
  a directory as a Chrome trace (``trace.json``); ``step_annotation``
  names a region in it (``_RecordFunctionFast``, which keeps the GIL,
  else ``record_function``).  One capture a process:
  the profiler is process-wide.
- ``step(name)`` times one host step of a wave (or of a caller's call)
  with its wall and thread CPU time; the dispatcher arms a wave's
  timeline on its thread (``armed``) and folds the steps into
  ``gubernator_phase_duration`` / ``gubernator_phase_cpu_seconds``, its
  wave span and its ``wave_completed`` event.  While a torch profiler
  records, each step is also a ``guber.<name>`` range in the trace, on
  the kernels' clock (``device_range``).
"""
from __future__ import annotations

import contextlib
import logging
import os
import secrets
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, Iterator, List, Optional

log = logging.getLogger("gubernator_tpu_torch.tracing")


# --- W3C trace-context propagation (traceparent in/out) ---------------
#
# The header format is the W3C spec ("00-<32hex trace-id>-<16hex
# parent-span-id>-<2hex flags>"): parsed and generated here, the active
# trace carried in a thread-local.  Servicers adopt the inbound header,
# and every peer call re-emits it with a fresh span id.

_tls = threading.local()

#: test hook: called with the raw inbound traceparent header (or None)
#: each time a request context is adopted
inbound_hook = None


def parse_traceparent(header: Optional[str]):
    """(trace_id_hex32, flags_hex2) or None for absent/malformed input
    (malformed → start a new trace, per the W3C spec's restart rule)."""
    if not header:
        return None
    parts = header.strip().split("-")
    if len(parts) != 4 or parts[0] != "00":
        return None
    tid, sid, flags = parts[1].lower(), parts[2].lower(), parts[3]
    if len(tid) != 32 or len(sid) != 16 or len(flags) != 2 \
            or tid == "0" * 32 or sid == "0" * 16:
        return None
    try:
        int(tid, 16), int(sid, 16), int(flags, 16)
    except ValueError:
        return None
    return tid, flags


def parent_span_id(header: Optional[str]) -> Optional[str]:
    """The 16-hex parent-span-id of a valid traceparent, or None.
    ``parse_traceparent`` deliberately discards it (the trace context
    is (trace_id, flags)); the span plane needs it back so an inbound
    request's first span parents under the caller's hop span."""
    if parse_traceparent(header) is None:
        return None
    return header.strip().split("-")[2].lower()


def current_trace_id() -> Optional[str]:
    """The active request's 32-hex trace id, or None outside any
    request context.  Cheap enough for hot-path capture (the flight
    recorder and dispatcher jobs stamp it at submit time — worker
    threads have no request context of their own)."""
    tp = getattr(_tls, "trace", None)
    return tp[0] if tp is not None else None


def current_traceparent() -> Optional[str]:
    """Outbound header for the active request's trace (fresh span id
    per hop), or None outside any request context."""
    tp = getattr(_tls, "trace", None)
    if tp is None:
        return None
    tid, flags = tp
    return f"00-{tid}-{secrets.token_hex(8)}-{flags}"


# --- the span plane --------------------------------------------------
#
# The SpanRecorder keeps the structure of the spans: completed spans
# (trace_id/span_id/parent_id, name, start/end, attrs) buffer per-trace
# while the request runs, then commit as a unit — head-sampled by a
# DETERMINISTIC function of the trace id so every daemon in a cluster
# keeps (or drops) the same traces and cross-daemon assembly always
# sees whole traces, with forced sampling on error/degraded/shed
# outcomes so the interesting requests survive even at sample=0.

#: the span names, as in the JAX package
SPAN_CATALOG: Dict[str, str] = {
    "grpc.GetRateLimits": "public V1 handler (pb2 and raw-wire twins)",
    "grpc.GetPeerRateLimits": "owner-side peer handler (pb2 and wire)",
    "grpc.UpdatePeerGlobals": "owner→replica GLOBAL broadcast handler",
    "http.GetRateLimits": "HTTP/JSON gateway handler",
    "peer.forward": "caller-side hop: batched forward lane send",
    "global.hits_flush": "async GLOBAL hit-flush tick (owner-bound)",
    "global.broadcast": "async GLOBAL broadcast tick (replica-bound)",
    "wave": "one dispatcher wave (fan-in over the batched jobs)",
    "wave.pack": "host pack phase (absent when the engine fuses it)",
    "wave.device": "device step phase",
    "wave.resolve": "host resolve/demux phase",
    "wave.fill": "host step: a launch but its nested steps (concat, "
                 "arrival order, routing, packed fill, engine lock)",
    "wave.upload": "host step: the packed pair's copies to the device",
    "wave.plan": "host step: K1's plan (bucket sort, its two syncs)",
    "wave.launch": "host step: K1's launch, outputs, tap, result vector",
    "wave.download": "host step: the result vector's copy to the host",
    "wave.collect": "host step: a sync but its download (results into "
                    "columns, counter folds, re-runs)",
}


class SpanRecorder:
    """Bounded, lock-aware ring of completed spans.

    Spans ``add()``ed while a request runs buffer per-trace; the
    request context's exit ``commit()``s the whole trace — into the
    ring when head-sampled or forced, dropped otherwise.  A bounded
    tombstone map remembers recent commit decisions so late adds from
    pipelined wave workers (future resolved before ``_wave_end`` ran)
    still route correctly.  All state is O(bounded); the lock is a
    leaf (never held while calling out)."""

    PENDING_TRACES = 128   # distinct in-flight traces buffered
    PENDING_SPANS = 64     # spans buffered per trace
    TOMBSTONES = 256       # remembered commit decisions

    def __init__(self, capacity: int = 2048, sample: float = 0.0):
        if capacity < 1:
            raise ValueError("span recorder capacity must be >= 1")
        self.capacity = capacity
        #: head-sampling rate in [0,1]; plain attr, racy reads are fine
        self.sample = float(sample)
        self._mu = threading.Lock()
        self._ring: deque = deque(maxlen=capacity)  # guarded-by: self._mu
        self._pending: OrderedDict = OrderedDict()  # guarded-by: self._mu
        self._done: OrderedDict = OrderedDict()  # guarded-by: self._mu
        self._last_sampled: Optional[str] = None  # guarded-by: self._mu
        self._dropped = 0  # guarded-by: self._mu

    def head_sampled(self, trace_id: str) -> bool:
        """Deterministic head-sampling decision: a pure function of the
        trace id, so every daemon in the cluster keeps the same traces
        (cluster-wide assembly never sees half a trace)."""
        rate = self.sample
        if rate <= 0.0:
            return False
        if rate >= 1.0:
            return True
        try:
            return int(trace_id[:8], 16) / 4294967296.0 < rate
        except (ValueError, TypeError):
            return False

    def add(self, span_dict: dict) -> None:
        """Buffer one completed span under its trace (bounded).  After
        the trace committed, route by the remembered decision."""
        tid = span_dict.get("trace_id")
        if not tid:
            return
        with self._mu:
            if tid in self._done:
                if self._done[tid]:
                    self._ring.append(span_dict)
                else:
                    self._dropped += 1
                return
            buf = self._pending.get(tid)
            if buf is None:
                while len(self._pending) >= self.PENDING_TRACES:
                    self._pending.popitem(last=False)
                    self._dropped += 1
                buf = self._pending[tid] = []
            if len(buf) < self.PENDING_SPANS:
                buf.append(span_dict)
            else:
                self._dropped += 1

    def commit(self, trace_id: str, forced=None) -> bool:
        """Resolve a trace's buffered spans: keep when forced or
        head-sampled, drop otherwise.  Returns the decision."""
        sampled = bool(forced) or self.head_sampled(trace_id)
        with self._mu:
            buf = self._pending.pop(trace_id, None)
            self._done[trace_id] = sampled
            while len(self._done) > self.TOMBSTONES:
                self._done.popitem(last=False)
            if sampled:
                if buf:
                    self._ring.extend(buf)
                self._last_sampled = trace_id
            elif buf:
                self._dropped += len(buf)
        return sampled

    def discard(self, trace_id: str) -> None:
        """Drop a trace's buffered spans without a tombstone."""
        with self._mu:
            self._pending.pop(trace_id, None)

    def exemplar(self) -> Optional[dict]:
        """The most recently committed SAMPLED trace, as a prometheus
        exemplar label dict — the histogram/SLO link from a burning
        signal to one concrete trace."""
        with self._mu:
            tid = self._last_sampled
        return {"trace_id": tid} if tid else None

    def spans(self, trace_id: Optional[str] = None,
              limit: Optional[int] = None) -> List[dict]:
        """Chronological snapshot of committed spans (oldest first);
        ``trace_id`` filters server-side, ``limit`` keeps the newest N."""
        with self._mu:
            out = list(self._ring)
        if trace_id:
            out = [s for s in out if s.get("trace_id") == trace_id]
        if limit is not None and limit >= 0:
            out = out[len(out) - min(limit, len(out)):]
        return out

    def stats(self) -> dict:
        with self._mu:
            return {"spans": len(self._ring), "capacity": self.capacity,
                    "sample": self.sample, "pending": len(self._pending),
                    "dropped": self._dropped}

    def __len__(self) -> int:
        with self._mu:
            return len(self._ring)


class _SpanState:
    """Per-request span bookkeeping (thread-local): the recorder, the
    open-span stack, the inbound parent id, and the forced-sample
    verdict."""

    __slots__ = ("recorder", "trace_id", "parent", "stack", "forced")

    def __init__(self, recorder, trace_id, parent):
        self.recorder = recorder
        self.trace_id = trace_id
        self.parent = parent
        self.stack: List[str] = []
        self.forced: Optional[str] = None


def new_span_id() -> str:
    return secrets.token_hex(8)


def current_span_id() -> Optional[str]:
    """The innermost open recorded span's id (the wave's parent when
    launched from a request thread), or None when the span plane is
    not armed here."""
    st = getattr(_tls, "span", None)
    if st is None:
        return None
    return st.stack[-1] if st.stack else st.parent


def force_sample(reason: str) -> None:
    """Flag the active trace for forced sampling (error / degraded /
    shed outcomes must survive even at sample=0).  First reason wins."""
    st = getattr(_tls, "span", None)
    if st is not None and st.forced is None:
        st.forced = reason


def hop_traceparent(name: str, attrs: Optional[dict] = None
                    ) -> Optional[str]:
    """Mint an outbound traceparent AND record the caller-side hop as
    an instant span whose span id IS the minted parent id — the
    receiving daemon's request span then parents under it, stitching
    owner-side work back to this request."""
    tp = getattr(_tls, "trace", None)
    if tp is None:
        return None
    tid, flags = tp
    sid = secrets.token_hex(8)
    st = getattr(_tls, "span", None)
    if st is not None and st.trace_id == tid:
        now = time.time()  # clock-ok: telemetry wall clock (span timestamps)
        st.recorder.add({
            "trace_id": tid, "span_id": sid,
            "parent_id": st.stack[-1] if st.stack else st.parent,
            "name": name, "start": now, "end": now,
            "attrs": dict(attrs) if attrs else {}})
    return f"00-{tid}-{sid}-{flags}"


@contextlib.contextmanager
def request_context(traceparent: Optional[str],
                    recorder: Optional[SpanRecorder] = None
                    ) -> Iterator[None]:
    """Adopt an inbound traceparent — or start a new trace — for the
    handler's duration; peer calls made inside propagate the same
    trace id (otelgrpc server-interceptor parity).  With ``recorder``
    the span plane arms: ``span()`` records, and exit commits the
    trace (head-sampled / forced)."""
    if inbound_hook is not None:
        inbound_hook(traceparent)
    parsed = parse_traceparent(traceparent)
    prev = getattr(_tls, "trace", None)
    _tls.trace = parsed or (secrets.token_hex(16), "01")
    st = prev_st = None
    if recorder is not None:
        prev_st = getattr(_tls, "span", None)
        st = _SpanState(recorder, _tls.trace[0],
                        parent_span_id(traceparent))
        _tls.span = st
    try:
        yield
    finally:
        _tls.trace = prev
        if st is not None:
            _tls.span = prev_st
            st.recorder.commit(st.trace_id, forced=st.forced)


def grpc_request_context(context, recorder: Optional[SpanRecorder] = None):
    """request_context from a grpc servicer context's metadata."""
    header = None
    try:
        for k, v in context.invocation_metadata():
            if k.lower() == "traceparent":
                header = v
                break
    except Exception:  # noqa: BLE001 - metadata is best-effort
        pass
    return request_context(header, recorder=recorder)


def outbound_metadata(extra=()):
    """grpc call metadata carrying the active trace (otelgrpc
    client-interceptor parity); None when there is neither a trace nor
    extra metadata."""
    tp = current_traceparent()
    md = list(extra)
    if tp is not None:
        md.append(("traceparent", tp))
    return md or None


@contextlib.contextmanager
def span(name: str, metrics=None, attrs: Optional[dict] = None
         ) -> Iterator[None]:
    """Host-side span: always a duration metric, on the error path too.  When the request
    context armed a SpanRecorder, the span is RECORDED: fresh span id,
    parented under the innermost open span (or the inbound hop), and
    an exception in the body force-samples the whole trace."""
    t0 = time.perf_counter()
    st = getattr(_tls, "span", None)
    sid = parent = None
    wall0 = 0.0
    if st is not None:
        sid = secrets.token_hex(8)
        parent = st.stack[-1] if st.stack else st.parent
        wall0 = time.time()  # clock-ok: telemetry wall clock (span start)
        st.stack.append(sid)
    try:
        yield
    except BaseException:
        if st is not None and st.forced is None:
            st.forced = "error"
        raise
    finally:
        dt = time.perf_counter() - t0
        if st is not None:
            if st.stack and st.stack[-1] == sid:
                st.stack.pop()
            st.recorder.add({
                "trace_id": st.trace_id, "span_id": sid,
                "parent_id": parent, "name": name,
                "start": wall0, "end": wall0 + dt,
                "attrs": dict(attrs) if attrs else {}})
        if metrics is not None:
            metrics.func_duration.labels(name=name).observe(dt)


# --- cross-daemon assembly --------------------------------------------


def assemble(spans: List[dict], trace_id: Optional[str] = None
             ) -> List[dict]:
    """Stitch span slices (possibly from N daemons' /debug/traces)
    into per-trace trees.  Returns one dict per trace — ``trace_id``,
    ``spans`` (count), ``roots`` (nested via ``children``) — ordered
    by earliest span start.  Duplicate span ids (the same daemon's
    slice fetched twice) dedup; orphans (parent not in the slice
    set) surface as extra roots rather than vanishing."""
    by_trace: Dict[str, dict] = {}
    for s in spans:
        tid = s.get("trace_id")
        if not tid or (trace_id and tid != trace_id):
            continue
        by_trace.setdefault(tid, {}).setdefault(s.get("span_id"), s)
    out = []
    for tid, seen in by_trace.items():
        nodes = {sid: dict(s, children=[]) for sid, s in seen.items()}
        roots = []
        for n in nodes.values():
            p = n.get("parent_id")
            if p and p in nodes and p != n.get("span_id"):
                nodes[p]["children"].append(n)
            else:
                roots.append(n)
        for n in nodes.values():
            n["children"].sort(key=lambda c: c.get("start") or 0.0)
        roots.sort(key=lambda c: c.get("start") or 0.0)
        out.append({"trace_id": tid, "spans": len(nodes),
                    "roots": roots})
    out.sort(key=lambda t: min((r.get("start") or 0.0
                                for r in t["roots"]), default=0.0))
    return out


def render_waterfall(trace: dict, width: int = 40) -> str:
    """Text waterfall for one assembled trace (a dict from
    ``assemble()``): indent = depth, one bar per span scaled to the
    trace's [min start, max end] window."""
    flat: List[tuple] = []

    def _walk(n, depth):
        flat.append((depth, n))
        for c in n.get("children", ()):
            _walk(c, depth + 1)

    for r in trace.get("roots", ()):
        _walk(r, 0)
    if not flat:
        return f"trace {trace.get('trace_id')}: no spans"
    t0 = min(n.get("start") or 0.0 for _, n in flat)
    t1 = max(n.get("end") or 0.0 for _, n in flat)
    window = max(t1 - t0, 1e-9)
    lines = [f"trace {trace.get('trace_id')}  "
             f"({trace.get('spans')} spans, {window * 1e3:.2f}ms)"]
    for depth, n in flat:
        s = (n.get("start") or 0.0) - t0
        e = (n.get("end") or 0.0) - t0
        lo = int(s / window * width)
        hi = max(int(e / window * width), lo + 1)
        bar = " " * lo + "#" * (hi - lo) + " " * (width - hi)
        dur_ms = max(e - s, 0.0) * 1e3
        lines.append(f"  [{bar}] {'  ' * depth}{n.get('name')} "
                     f"+{s * 1e3:.2f}ms {dur_ms:.2f}ms")
    return "\n".join(lines)


class ProfilerBusy(RuntimeError):
    """A capture was asked for while another runs in the process."""


class _ProfilerThread:
    """The one thread of the process that starts and stops every
    ``torch.profiler`` capture: the profiler's back end must be driven
    from the thread that first initialized it, so each capture's start
    and stop run here, in order."""

    _mu = threading.Lock()
    _jobs = None  # guarded-by: _mu

    @classmethod
    def run(cls, fn):
        """``fn()`` on the profiler thread; returns its result or raises
        its error."""
        import queue
        from concurrent.futures import Future

        with cls._mu:
            if cls._jobs is None:
                cls._jobs = queue.Queue()
                threading.Thread(target=cls._loop, args=(cls._jobs,),
                                 daemon=True, name="device-profiler").start()
            jobs = cls._jobs
        fut: Future = Future()
        jobs.put((fn, fut))
        return fut.result()

    @staticmethod
    def _loop(jobs) -> None:
        while True:
            fn, fut = jobs.get()
            try:
                fut.set_result(fn())
            except BaseException as e:  # noqa: BLE001 - the caller's
                fut.set_exception(e)


class DeviceProfiler:
    """A ``torch.profiler`` capture around the serving loop, written to
    ``log_dir/trace.json`` (Chrome trace format) on ``stop()``.  CUDA
    activity (CUPTI: every kernel of the process, K1's among them) is
    traced with ``cuda=True`` (a daemon on ``cuda``).  Start and stop run
    on the process's one profiler thread; the constructor returns once
    the capture runs, or raises its error."""

    TRACE_FILE = "trace.json"

    #: the capture running in this process, if any: one at a time (the
    #: profiler is process-wide); a second raises ProfilerBusy
    _active_mu = threading.Lock()
    _active: Optional["DeviceProfiler"] = None  # guarded-by: _active_mu

    def __init__(self, log_dir: str, cuda: bool = False):
        self.log_dir = log_dir
        self.cuda = cuda
        self._mu = threading.Lock()
        with DeviceProfiler._active_mu:
            if DeviceProfiler._active is not None:
                raise ProfilerBusy("a profile capture is already active")
            DeviceProfiler._active = self
        try:
            os.makedirs(log_dir, exist_ok=True)
            self._prof = _ProfilerThread.run(self._start)  # guarded-by: self._mu
        except BaseException:
            self._release()
            raise
        log.info("device profiling → %s", log_dir)

    def _release(self) -> None:
        with DeviceProfiler._active_mu:
            if DeviceProfiler._active is self:
                DeviceProfiler._active = None

    def _start(self):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        return prof

    @classmethod
    def from_env(cls, cuda: bool = False) -> Optional["DeviceProfiler"]:
        d = os.environ.get("GUBER_PROFILE_DIR", "")
        return cls(d, cuda=cuda) if d else None

    @property
    def path(self) -> str:
        return os.path.join(self.log_dir, self.TRACE_FILE)

    def stop(self) -> None:
        """Stop the capture and write its trace (returns once written;
        a second call does nothing)."""
        with self._mu:
            prof, self._prof = self._prof, None
        if prof is None:
            return

        def finish():
            prof.stop()
            prof.export_chrome_trace(self.path)

        try:
            _ProfilerThread.run(finish)
        finally:
            self._release()


@contextlib.contextmanager
def step_annotation(name: str) -> Iterator[None]:
    """A named region in the profiler's trace.  ``_RecordFunctionFast``
    where torch has it: ``record_function`` enters and exits through
    operator calls that release the GIL, so under the serving threads'
    contention each of its ranges waits to win the GIL back twice."""
    import torch

    fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
    with (fast(name) if fast is not None
          else torch.profiler.record_function(name)):
        yield


# --- host steps, on the wave's timeline and the device trace's clock --
#
# A step is one piece of host work inside a wave (fill, upload, plan,
# launch, download, collect) or of a caller's call (ingest, build).  It
# takes its wall time (perf_counter) and its thread's CPU time
# (thread_time), exclusive of the steps nested in it, so the steps of
# one thread never overlap.  The dispatcher arms a wave's timeline on
# its thread around the engine calls (``armed``); a step without a sink
# lands there, and with nothing armed does nothing.  A step with a sink
# (``observe_step(name, wall_s, cpu_s)``) reports to it when it ends.

class _StepLocal(threading.local):
    """This thread's step state: the armed timeline and its phase, the
    open steps (innermost last) and the last step's number."""

    timeline = None
    phase = None
    seq = 0

    def __init__(self):
        self.stack = []


_steps = _StepLocal()
_prof_mod = None


def profiling() -> bool:
    """True while a torch profiler records (not in its warm-up): one
    module-attribute read, seen from every thread."""
    return (_prof_mod or _load_prof())._is_profiler_enabled


def _load_prof():
    global _prof_mod
    import torch.autograd.profiler as prof

    _prof_mod = prof
    return prof


def device_range(name: str):
    """``step_annotation(name)`` while a torch profiler records, else a
    context that does nothing."""
    if profiling():
        return step_annotation(name)
    return contextlib.nullcontext()


@contextlib.contextmanager
def armed(timeline: list, phase: str) -> Iterator[None]:
    """Arm ``timeline`` on this thread for the body: each step that ends
    in it appends (name, phase, start, end, wall_s, cpu_s, seq, parent
    seq) to it; start and end are perf_counter readings, the times
    exclusive of nested steps."""
    st = _steps
    prev = st.timeline, st.phase
    st.timeline, st.phase = timeline, phase
    try:
        yield
    finally:
        st.timeline, st.phase = prev


class step:
    """Time one host step: ``with step("wave.plan"): ...``.  Ends at the
    block's exit or at ``end()``, whichever comes first; a step made
    with ``until_submit`` also ends at ``submitted()`` on its thread
    (the caller's ingest ends where its job is handed to the
    dispatcher).  Each stretch of a step reads the thread's CPU clock
    inside the wall-clock readings that bound it, so its CPU time
    cannot pass its wall time; where that clock ticks coarsely (whole
    scheduler ticks), a step's CPU time is a count of the ticks that
    fell in it, and only its sum over many steps is to be read."""

    __slots__ = ("name", "sink", "until_submit", "_tl", "_ann", "_t0",
                 "_rw", "_rc", "_w", "_c", "_seq", "_parent", "_live")

    def __init__(self, name: str, sink=None, until_submit: bool = False):
        self.name = name
        self.sink = sink
        self.until_submit = until_submit
        self._live = False

    def __enter__(self) -> "step":
        st = _steps
        tl = None
        if self.sink is None:
            tl = st.timeline
            if tl is None:
                return self
        self._tl = tl
        stack = st.stack
        parent = stack[-1] if stack else None
        if parent is not None:  # paused while this one runs
            parent._c += time.thread_time() - parent._rc
            w = time.perf_counter()
            parent._w += w - parent._rw
            self._parent = parent._seq
        else:
            w = time.perf_counter()
            self._parent = None
        self._seq = st.seq = st.seq + 1
        stack.append(self)
        self._t0 = self._rw = w
        self._w = self._c = 0.0
        self._ann = None
        if (_prof_mod or _load_prof())._is_profiler_enabled:
            self._ann = step_annotation("guber." + self.name)
            self._ann.__enter__()
        self._live = True
        self._rc = time.thread_time()
        return self

    def __exit__(self, *exc) -> bool:
        self.end()
        return False

    def end(self) -> None:
        if not self._live:
            return
        self._live = False
        c = time.thread_time()
        w = time.perf_counter()
        if self._ann is not None:
            self._ann.__exit__(None, None, None)
        wall, cpu = self._w, self._c
        st = _steps
        stack = st.stack
        if stack[-1] is self:
            wall += w - self._rw
            cpu += c - self._rc
            stack.pop()
            if stack:  # the step this one paused runs on
                parent = stack[-1]
                parent._rw = w
                parent._rc = time.thread_time()
        else:  # ended while paused under a nested step, which runs on
            stack.remove(self)
        if self._tl is not None:
            self._tl.append((self.name, st.phase, self._t0, w, wall, cpu,
                             self._seq, self._parent))
        else:
            self.sink.observe_step(self.name, wall, cpu)


def submitted() -> None:
    """The caller's job was handed to the dispatcher: end this thread's
    open ``until_submit`` steps."""
    stack = _steps.stack
    if stack:
        for s in [s for s in stack if s.until_submit]:
            s.end()
