"""Dispatcher: cross-request coalescing into device waves, with admission
control, wave telemetry, a stall watchdog and the launch/sync pipeline
(the port of gubernator_tpu/dispatcher.py).

Concurrent callers submit jobs to a queue; one worker thread drains it
into a wave of at most ``max_wave`` rows (waiting up to the coalescing
window for stragglers once the backlog is taken), merges the jobs'
columns into ONE engine call, and hands each caller its part: an
object-lane caller its response objects, a columnar caller a
``ResultView`` (row bounds into the wave's shared result columns), so
slicing and wire serialization run in the caller's thread.  Every job is
packed at its own ``now`` (per-request arrival times ride the ``now``
column), so jobs from different instants share a launch.  Engine calls
are serialized by one lock, which the instance's row-level operations
(sweep, row ops) share.

- **Inline.** An idle dispatcher lets a columnar caller run its wave in
  its own thread (``check_packed_view``, ``run_inline_wave``).
- **Pipeline.** Where the engine serves on CUDA (``GUBER_PIPELINE=1/0``
  overrides; an engine without ``launch_packed`` never pipelines), pure
  columnar waves are launched (``engine.launch_packed``) into a FIFO
  ring of up to ``pipeline_depth`` unsynced waves (GUBER_PIPELINE_DEPTH)
  and resolved oldest first (``engine.sync_packed``), so the worker
  packs the next wave while earlier ones run.  Any other wave flushes
  the ring first, and the inline path is off.
- **Admission.** ``admit`` sheds a batch with ``ResourceExhausted`` when
  the rows queued would pass ``admission_limit`` (GUBER_ADMISSION_LIMIT),
  when the projected queue wait passes the caller's deadline
  (``request_deadline``), or after ``drain()``.
- **Telemetry.** Every engine call is one wave: it feeds the wave
  histograms of ``metrics`` and the ``wave_launched`` / ``wave_completed``
  / ``wave_error`` events of ``recorder`` (both optional), and sits in
  the in-flight map the stall watchdog scans (GUBER_STALL_THRESHOLD_S).
  A caller that waits past RESULT_TIMEOUT_S (GUBER_RESULT_TIMEOUT_S)
  gets a TimeoutError that says what the waves were doing.

- **Faults.** With a ``FaultSet`` (faults.py) the dispatcher runs the
  ``dispatch_*`` and ``device_step`` faultpoints at the JAX package's
  sites; each costs one attribute read while disarmed.
- **Analytics.** With a ``KeyAnalytics`` (analytics.py) every resolved
  wave is tapped after its callers' results are set: an object-lane
  wave with its columns and its callers' request lists (``_tap_named``:
  the sketch learns the names of new keys; the engine's device tap is
  muted for it), any other wave with its columns (``_tap_packed``),
  which an engine that taps in its step (``fused_tap``) skips.  Phase samples feed the analytics'
  PhaseLedger beside the histogram.

Not ported: wave spans wait for the tracing slice.
"""
from __future__ import annotations

import logging
import math
import os
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FuturesTimeout
from contextlib import contextmanager
from contextvars import ContextVar
from typing import List, Optional, Sequence

import numpy as np

from .core.batch import RequestBatch, pack_requests, responses_from_columns
from .hashing import hash_request_keys
from .telemetry import exc_text
from .types import RateLimitRequest, RateLimitResponse

log = logging.getLogger("gubernator_tpu_torch.dispatcher")


class ResourceExhausted(RuntimeError):
    """Raised at ingress when admission control sheds a batch (queue
    full, projected queue wait past the caller's deadline, or drain
    mode).  The daemon answers it with gRPC RESOURCE_EXHAUSTED / HTTP
    429: a shed is cheap and explicit, never a timeout."""


#: the caller's remaining deadline (seconds), set by the front door
#: (gRPC ``context.time_remaining()``) and read by ``Dispatcher.admit``
#: in the same thread
_REQUEST_DEADLINE: "ContextVar[Optional[float]]" = ContextVar(
    "guber_torch_request_deadline", default=None)


@contextmanager
def request_deadline(seconds: Optional[float]):
    """Scope the caller's remaining deadline (seconds) for admission
    control; None means no deadline (only queue-full and drain shed)."""
    tok = _REQUEST_DEADLINE.set(seconds)
    try:
        yield
    finally:
        _REQUEST_DEADLINE.reset(tok)


class ResultView:
    """Rows [lo, hi) of a wave's shared downloaded result columns
    (status i32, limit i64, remaining i64, reset i64, table_full bool).
    The worker resolves a columnar job with one of these instead of
    slicing, so slicing and byte serialization run in the caller's
    thread."""

    __slots__ = ("cols", "lo", "hi")

    def __init__(self, cols, lo: int, hi: int):
        self.cols = cols
        self.lo = lo
        self.hi = hi

    def sliced(self) -> tuple:
        lo, hi = self.lo, self.hi
        return tuple(c[lo:hi] for c in self.cols)


class _Job:
    """One caller's submission: request objects (``reqs``) or packed
    columns (``batch`` + ``khash``); ``t_enq`` is stamped at submit."""

    __slots__ = ("reqs", "batch", "khash", "now_ms", "future", "t_enq")

    def __init__(self, now_ms: int, reqs=None, batch=None, khash=None):
        self.reqs = reqs
        self.batch = batch
        self.khash = khash
        self.now_ms = now_ms
        self.future: Future = Future()
        self.t_enq: Optional[float] = None

    def __len__(self) -> int:
        return len(self.reqs) if self.reqs is not None else len(self.khash)


def _concat(parts) -> tuple:
    """[(RequestBatch, khash), ...] → one (batch, khash)."""
    if len(parts) == 1:
        return parts[0]
    batch = RequestBatch(*[
        np.concatenate([np.asarray(b[f]) for b, _ in parts])
        for f in range(len(RequestBatch._fields))])
    return batch, np.concatenate([kh for _, kh in parts])


def _fail(jobs, e: BaseException) -> None:
    for j in jobs:
        if not j.future.done():
            j.future.set_exception(e)


class Dispatcher:
    """Serializes engine access by merging, not locking."""

    #: cap on how long a caller waits for its wave (GUBER_RESULT_TIMEOUT_S:
    #: finite and > 0, else this default)
    RESULT_TIMEOUT_S = 120.0
    #: a wave in flight this long is flagged by the watchdog, well before
    #: callers give up (GUBER_STALL_THRESHOLD_S; <= 0 disables)
    STALL_THRESHOLD_S = 30.0
    #: launched waves in flight at once under the pipeline
    #: (GUBER_PIPELINE_DEPTH, at least 1: depth 1 is launch-then-sync)
    PIPELINE_DEPTH = 2
    #: rows queued before ingress sheds, in waves of max_wave rows
    #: (GUBER_ADMISSION_LIMIT in rows; 0 disables the bound)
    ADMISSION_LIMIT_WAVES = 8

    def __init__(self, engine, max_wave: int = 8192,
                 max_delay_ms: float = 0.2,
                 lock: Optional[threading.Lock] = None,
                 metrics=None, recorder=None, clock=time.monotonic,
                 faults=None, analytics=None):
        self.engine = engine
        #: the owning instance's KeyAnalytics (optional)
        self.analytics = analytics
        self._fused_tap = getattr(engine, "fused_tap", False)
        #: the owning instance's FaultSet (optional)
        self._faults = faults
        self.max_wave = max_wave
        # the coalescing window: GUBER_COALESCE_US overrides the
        # constructor default; malformed values keep it, negative ones
        # close the window
        coalesce_env = os.environ.get("GUBER_COALESCE_US", "")
        if coalesce_env:
            try:
                max_delay_ms = max(float(coalesce_env), 0.0) / 1000.0
            except ValueError:
                pass
        self.max_delay_s = max_delay_ms / 1000.0
        depth_env = os.environ.get("GUBER_PIPELINE_DEPTH", "")
        try:
            depth = int(depth_env) if depth_env else self.PIPELINE_DEPTH
        except ValueError:
            depth = self.PIPELINE_DEPTH
        self.pipeline_depth = max(depth, 1)
        #: per-instance Metrics registry and FlightRecorder, both optional
        self.metrics = metrics
        self.recorder = recorder
        self._clock = clock
        #: waves the worker ran / waves callers ran inline
        self.wave_count = 0
        self.inline_waves = 0
        self._phase_hist: dict = {}  # phase → histogram child (benign race)
        # ---- wave telemetry (under _tel_mu) ----
        self._tel_mu = threading.Lock()
        #: wave id → {t0, kind, size, stalled, slot, marks}
        self._inflight: dict = {}  # guarded-by: self._tel_mu
        self._wave_seq = 0  # guarded-by: self._tel_mu
        self._wave_count = 0  # guarded-by: self._tel_mu
        self._stall_count = 0  # guarded-by: self._tel_mu
        self._timeout_count = 0  # guarded-by: self._tel_mu
        self._first_wave_s: Optional[float] = None  # guarded-by: self._tel_mu
        self._last_wave_end: Optional[float] = None  # guarded-by: self._tel_mu
        #: recent waves, for the percentiles of telemetry_snapshot and
        #: the admission projection
        self._recent_sizes: deque = deque(maxlen=4096)  # guarded-by: self._tel_mu
        self._recent_durs: deque = deque(maxlen=4096)  # guarded-by: self._tel_mu
        self._recent_waits: deque = deque(maxlen=4096)  # guarded-by: self._tel_mu
        self._engine_lock = lock if lock is not None else threading.Lock()
        self._queue: "queue.Queue[_Job]" = queue.Queue()
        #: the job that would have pushed a wave past max_wave leads the
        #: next one (worker thread only)
        self._carry: Optional[_Job] = None
        self._closing = threading.Event()
        self._submit_mu = threading.Lock()  # serializes submit vs close
        # ---- admission ----
        adm_env = os.environ.get("GUBER_ADMISSION_LIMIT", "")
        try:
            self.admission_limit = (int(adm_env) if adm_env
                                    else self.ADMISSION_LIMIT_WAVES
                                    * self.max_wave)
        except ValueError:
            self.admission_limit = self.ADMISSION_LIMIT_WAVES * self.max_wave
        #: rows submitted and not yet taken into a wave or the carry
        self._queued_rows = 0  # guarded-by: self._submit_mu
        #: drain flag: one racy bool write in drain(), lock-free reads
        self._draining = False
        self._shed_rows = 0  # guarded-by: self._submit_mu
        #: one admission_shed event a second at most
        self._last_shed_event = 0.0  # guarded-by: self._submit_mu
        #: held by the one caller running a wave inline
        self._inline_mu = threading.Lock()
        #: the policy and the engine's capability, folded once so the
        #: inline gate and the worker's mode agree
        self._pipelined = (self._want_pipeline(engine)
                           and hasattr(engine, "launch_packed"))
        if self.metrics is not None:
            self.metrics.pipeline_depth.set(
                self.pipeline_depth if self._pipelined else 0)
        env_timeout = os.environ.get("GUBER_RESULT_TIMEOUT_S", "")
        if env_timeout:
            try:
                parsed = float(env_timeout)
            except ValueError:
                parsed = 0.0
            # 0, negative and NaN would fail every queued wave at once;
            # inf would park a caller of a wedged wave forever
            if math.isfinite(parsed) and parsed > 0:
                self.RESULT_TIMEOUT_S = parsed
        # the stall threshold defaults below the result timeout and
        # scales down with it ("stall first, timeout later"); an explicit
        # value is honored verbatim, <= 0 (or NaN) disables the watchdog
        default_stall = min(self.STALL_THRESHOLD_S,
                            self.RESULT_TIMEOUT_S / 4.0)
        stall_env = os.environ.get("GUBER_STALL_THRESHOLD_S", "")
        try:
            self._stall_threshold_s = (float(stall_env) if stall_env
                                       else default_stall)
        except ValueError:
            self._stall_threshold_s = default_stall
        if self._stall_threshold_s != self._stall_threshold_s:  # NaN
            self._stall_threshold_s = 0.0
        self._watchdog: Optional[threading.Thread] = None
        if self._stall_threshold_s > 0:
            #: polled well inside the threshold
            self._watch_interval_s = max(
                min(self._stall_threshold_s / 4.0, 1.0), 0.02)
            self._watchdog = threading.Thread(
                target=self._watchdog_run, daemon=True,
                name="dispatcher-watchdog")
            self._watchdog.start()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="device-dispatcher")
        self._thread.start()

    @staticmethod
    def _want_pipeline(engine) -> bool:
        """Launch/sync pipelining is on by default where the engine
        serves on CUDA: there a launch returns before the device is done.
        On the CPU a launch computes the whole step, so splitting it from
        its sync only adds a hand-off.  GUBER_PIPELINE=1/0 overrides."""
        pipe_env = os.environ.get("GUBER_PIPELINE", "")
        if pipe_env:
            return pipe_env == "1"
        dev = getattr(engine, "device", None)
        return getattr(dev, "type", None) == "cuda"

    # ---- caller entries ------------------------------------------------

    def check_batch(self, reqs: Sequence[RateLimitRequest], now_ms: int
                    ) -> List[RateLimitResponse]:
        """Submit request objects and wait; concurrent callers share
        device waves."""
        return self._wait(self._submit(_Job(now_ms, reqs=list(reqs))))

    def check_packed(self, batch: RequestBatch, khash: np.ndarray,
                     now_ms: int) -> tuple:
        """Columnar submit (engine.check_packed's contract): returns the
        caller's (status, limit, remaining, reset, table_full) slice."""
        return self.check_packed_view(batch, khash, now_ms).sliced()

    def check_packed_view(self, batch: RequestBatch, khash: np.ndarray,
                          now_ms: int) -> ResultView:
        """``check_packed`` returning the ResultView: row bounds into the
        wave's shared result columns.  Idle (and not pipelined): the wave
        runs inline, in this thread (a lone packed job's wave is exactly
        engine.check_packed); else it coalesces with the queued jobs."""
        out = self.run_inline_wave(
            lambda: self.engine.check_packed(batch, khash, now_ms),
            kind="inline_packed", nreq=len(khash))
        if out is not self._BUSY:
            self._tap_packed(khash, batch.hits, out[0])
            return ResultView(out, 0, len(khash))
        return self._wait(self._submit(_Job(now_ms, batch=batch,
                                            khash=khash)))

    def _fault(self, point: str) -> None:
        f = self._faults
        if f is not None and f.armed:
            f.fire(point)

    def _wait(self, job: _Job):
        try:
            return job.future.result(timeout=self.RESULT_TIMEOUT_S)
        except FuturesTimeout as e:
            raise self._result_timeout(e) from e

    # ---- the idle inline path ------------------------------------------

    #: run_inline_wave's "dispatcher busy" answer (None is a valid
    #: engine result, so the miss has its own identity)
    _BUSY = object()

    def _try_inline(self) -> bool:
        """True when the pipeline is off, nothing is queued and no other
        caller is inline: the calling thread may then run the engine
        itself, skipping two thread hand-offs and the coalescing window.
        The caller must release ``_inline_mu`` when this returns True."""
        if self._pipelined or not self._queue.empty() \
                or self._closing.is_set():
            return False
        if not self._inline_mu.acquire(blocking=False):
            return False
        # re-checked under _inline_mu: close() waits for inline callers
        # by taking this mutex after setting _closing, so a caller that
        # passed the first check and took the mutex late must not start
        # an engine call after close() returned
        if self._closing.is_set() or not self._queue.empty():
            self._inline_mu.release()
            return False
        return True

    def run_inline_wave(self, fn, kind: str = "inline_wire",
                        nreq: int = 0):
        """Run ``fn()`` (an engine call the caller composed, e.g. the
        fused wire lane's ``check_prepacked``) as one inline wave of
        ``nreq`` rows in this thread, under the engine lock.  Returns its
        result, or ``_BUSY`` when the inline path is not free (pipelined,
        jobs queued, another caller inline, closing): the caller then
        takes the queued path."""
        if not self._try_inline():
            return self._BUSY
        try:
            wid = self._wave_begin(kind, nreq=nreq)
            try:
                self._wave_mark(wid, "pack")
                with self._engine_lock:
                    self._fault("device_step")
                    out = fn()
                self._wave_mark(wid, "device")
            except Exception as e:  # noqa: BLE001 - recorded, re-raised
                self._wave_end(wid, error=e)
                raise
            self._wave_end(wid)
            self.inline_waves += 1
            return out
        finally:
            self._inline_mu.release()

    # ---- admission -----------------------------------------------------

    def _shed(self, reason: str, nrows: int) -> None:
        if self.metrics is not None:
            self.metrics.admission_shed.labels(reason=reason).inc(nrows)
        with self._submit_mu:
            self._shed_rows += nrows
            now = self._clock()
            throttled = now - self._last_shed_event < 1.0
            if not throttled:
                self._last_shed_event = now
        if self.recorder is not None and not throttled:
            # under sustained overload one event a second, not one a call
            self.recorder.record(
                "admission_shed", reason=reason, rows=nrows,
                queued_rows=self._queued_rows)  # lock-free: diagnostic snapshot
        raise ResourceExhausted(
            f"admission control shed {nrows} requests ({reason}: "
            f"queued_rows={self._queued_rows}, "  # lock-free: diagnostic snapshot
            f"limit={self.admission_limit})")

    def projected_queue_wait_s(self, extra_rows: int = 0) -> float:
        """How long the rows already queued (+ ``extra_rows``) take to
        drain, from the recent waves' sizes and durations; an empty queue
        projects 0 (the wave launches at once)."""
        with self._tel_mu:
            # lock-free: projection input; a racy read costs one wave of error
            queued = self._queued_rows + extra_rows
            sizes = list(self._recent_sizes)
            durs = list(self._recent_durs)
        if queued <= 0 or not durs:
            return 0.0
        wave_s = sum(durs) / len(durs)
        # queued rows coalesce into waves of up to max_wave rows, never
        # better than the sizes observed
        avg_rows = max(sum(sizes) / max(len(sizes), 1), 1.0)
        rows_per_wave = min(max(avg_rows, queued), self.max_wave)
        return math.ceil(queued / rows_per_wave) * wave_s

    def admit(self, nrows: int, deadline_s: Optional[float] = None) -> None:
        """The ingress gate: raise ResourceExhausted instead of queueing
        work that cannot finish (no device work, no allocation).  The
        deadline sheds only behind a backlog: an idle dispatcher serves
        any deadline."""
        if self._draining:
            self._shed("draining", nrows)
        lim = self.admission_limit
        if lim and self._queued_rows + nrows > lim:  # lock-free: GIL-atomic int read; admission is approximate
            self._shed("queue_full", nrows)
        dl = deadline_s if deadline_s is not None \
            else _REQUEST_DEADLINE.get()
        if dl is not None and dl > 0 and self._queued_rows > 0:  # lock-free: GIL-atomic int read
            # the wait is what is AHEAD of this batch
            if self.projected_queue_wait_s(0) > dl:
                self._shed("deadline", nrows)

    def drain(self) -> None:
        """Drain mode: queued and in-flight waves complete, new ingress
        sheds with ResourceExhausted("draining")."""
        self._draining = True

    def _submit(self, job: _Job) -> _Job:
        self._fault("dispatch_enqueue")
        n = len(job)
        self.admit(n)
        job.t_enq = self._clock()
        with self._submit_mu:
            # under the lock close() takes: no job slips in after the
            # final drain
            if self._closing.is_set():
                raise RuntimeError("dispatcher is closed")
            self._queue.put(job)
            self._queued_rows += n
        return job

    def _dequeued(self, job: _Job) -> None:
        """The job left the ingress queue for a wave or the carry: its
        rows no longer count against the admission bound."""
        with self._submit_mu:
            self._queued_rows = max(self._queued_rows - len(job), 0)

    # ---- wave telemetry ------------------------------------------------
    #
    # Every engine call (inline, coalesced, pipelined launch to sync) is
    # ONE wave: _wave_begin observes its size and its jobs' queue waits
    # and puts it in _inflight (the watchdog's scan set); a mark stamps
    # the end of a phase (pack, device; the tail is resolve); _wave_end
    # observes the duration and resolves stall state.  Observations are
    # per wave, never per request.

    def _wave_begin(self, kind: str, jobs=None, nreq: int = 0,
                    slot: Optional[int] = None) -> int:
        t0 = self._clock()
        waits = []
        if jobs:
            nreq = sum(len(j) for j in jobs)
            waits = [max(t0 - j.t_enq, 0.0) for j in jobs
                     if j.t_enq is not None]
        with self._tel_mu:
            self._wave_seq += 1
            wid = self._wave_seq
            self._inflight[wid] = {"t0": t0, "kind": kind, "size": nreq,
                                   "stalled": False, "slot": slot,
                                   "marks": []}
            self._recent_sizes.append(nreq)
            self._recent_waits.extend(waits)
        m = self.metrics
        if m is not None:
            m.wave_size.observe(nreq)
            for w in waits:
                m.wave_queue_wait.observe(w)
            m.waves_in_flight.inc()
        for w in waits:
            self._obs_phase("queue_wait", w)
        if self.recorder is not None:
            ev = {"wave": wid, "wave_kind": kind, "size": nreq,
                  "jobs": len(jobs) if jobs else 1}
            if slot is not None:
                # position in the in-flight ring at launch (0 = oldest)
                ev["slot"] = slot
            self.recorder.record("wave_launched", **ev)
        return wid

    def _wave_mark(self, wid: int, name: str) -> None:
        t = self._clock()
        with self._tel_mu:
            info = self._inflight.get(wid)
            if info is not None:
                info["marks"].append((name, t))

    def _obs_phase(self, phase: str, seconds: float) -> None:
        """One phase sample → the analytics' ledger and the histogram
        (KeyAnalytics.observe_phase feeds both), or the histogram alone
        without analytics."""
        ana = self.analytics
        if ana is not None:
            ana.observe_phase(phase, seconds)
        elif self.metrics is not None:
            child = self._phase_hist.get(phase)
            if child is None:  # benign race: labels() is idempotent
                child = self._phase_hist[phase] = \
                    self.metrics.phase_duration.labels(phase=phase)
            child.observe(max(seconds, 0.0))

    def _tap_packed(self, khash, hits, status) -> None:
        """A resolved wave's columns to the analytics (never raises into
        the serving path).  An engine that taps in its step already
        delivered them: skipped."""
        ana = self.analytics
        if ana is not None and not self._fused_tap:
            try:
                ana.tap_packed(khash, hits, status)
            except Exception:  # pragma: no cover - analytics only
                log.exception("analytics tap")

    def _tap_named(self, khash, batch, cols, req_lists) -> None:
        """An object-lane wave to the analytics: references only (the
        worker reads the columns)."""
        ana = self.analytics
        if ana is not None:
            try:
                ana.tap_named(khash, batch, cols, req_lists)
            except Exception:  # pragma: no cover - analytics only
                log.exception("analytics tap")

    def _wave_end(self, wid: int, error: Optional[BaseException] = None
                  ) -> None:
        t1 = self._clock()
        with self._tel_mu:
            info = self._inflight.pop(wid, None)
            if info is None:
                return
            dur = max(t1 - info["t0"], 0.0)
            self._wave_count += 1
            first = self._wave_count == 1
            if first:
                self._first_wave_s = dur
            self._recent_durs.append(dur)
            self._last_wave_end = t1
            was_stalled = info["stalled"]
            any_stalled = any(i["stalled"] for i in self._inflight.values())
        phases = None
        if info["marks"]:
            phases = {}
            prev = info["t0"]
            for name, tm in info["marks"]:
                phases[name] = max(tm - prev, 0.0)
                prev = tm
            phases["resolve"] = max(t1 - prev, 0.0)
        for name, secs in (phases or {}).items():
            self._obs_phase(name, secs)
        m = self.metrics
        if m is not None:
            m.wave_duration.observe(dur)
            m.waves_in_flight.dec()
            if first:
                m.first_wave_duration.set(dur)
            if was_stalled and not any_stalled:
                m.dispatcher_stalled.set(0)
        if was_stalled:
            log.warning("dispatcher stall resolved: wave %d (%s, %d reqs) "
                        "completed after %.1fs%s", wid, info["kind"],
                        info["size"], dur,
                        " with error" if error is not None else "")
        if self.recorder is not None:
            ev = {"wave": wid, "wave_kind": info["kind"],
                  "size": info["size"], "duration_ms": round(dur * 1000, 3)}
            if info["slot"] is not None:
                ev["slot"] = info["slot"]
            if phases is not None:
                # per-phase breakdown in ms; sums to duration_ms
                ev["phases"] = {k: round(v * 1000, 3)
                                for k, v in phases.items()}
            if error is not None:
                self.recorder.record("wave_error", error=exc_text(error),
                                     **ev)
            else:
                self.recorder.record("wave_completed", **ev)
            if first:
                # the first wave pays what the warm-up did not cover
                self.recorder.record("first_wave",
                                     duration_ms=round(dur * 1000, 3))

    # ---- the stall watchdog --------------------------------------------

    def _watchdog_run(self) -> None:
        while not self._closing.wait(self._watch_interval_s):
            try:
                self._watchdog_poll()
            except Exception:  # pragma: no cover - must never die
                log.exception("dispatcher watchdog poll")

    def _watchdog_poll(self) -> bool:
        """One scan: flag waves in flight past the threshold.  Apart from
        the thread loop so tests drive it with a fake clock.  Returns
        True when a new stall was flagged."""
        now = self._clock()
        newly = []
        with self._tel_mu:
            for wid, info in self._inflight.items():
                if (not info["stalled"]
                        and now - info["t0"] >= self._stall_threshold_s):
                    info["stalled"] = True
                    newly.append((wid, dict(info)))
            self._stall_count += len(newly)
            any_stalled = any(i["stalled"] for i in self._inflight.values())
        if self.metrics is not None:
            self.metrics.dispatcher_stalled.set(1 if any_stalled else 0)
        for wid, info in newly:
            age = now - info["t0"]
            msg = (f"wave {wid} ({info['kind']}, {info['size']} reqs) in "
                   f"flight {age:.1f}s > stall threshold "
                   f"{self._stall_threshold_s:.1f}s — a first-use kernel "
                   f"build or a wedged device; callers time out at "
                   f"{self.RESULT_TIMEOUT_S:.0f}s (GUBER_RESULT_TIMEOUT_S)")
            log.warning("dispatcher stall: %s", msg)
            if self.metrics is not None:
                self.metrics.stall_event_counter.inc()
            if self.recorder is not None:
                self.recorder.record("wave_stalled", error=msg, wave=wid,
                                     wave_kind=info["kind"],
                                     size=info["size"], age_s=round(age, 3))
        return bool(newly)

    def _result_timeout(self, e: BaseException) -> BaseException:
        """The caller-facing timeout, its message a diagnosis of the
        waves (``str()`` of a bare TimeoutError is empty).  Same
        exception type, so handlers keep matching."""
        stats = self.debug_stats()
        msg = (f"dispatcher wave result timed out after "
               f"{self.RESULT_TIMEOUT_S:.0f}s (queue_depth="
               f"{stats['queue_depth']}, in_flight={stats['in_flight']}, "
               f"oldest_wave_age_s={stats['oldest_wave_age_s']}, "
               f"stalled={stats['stalled']}; a first-use kernel build runs "
               f"inside a wave — raise GUBER_RESULT_TIMEOUT_S when callers "
               f"can arrive before the warm-up)")
        with self._tel_mu:
            self._timeout_count += 1
        if self.metrics is not None:
            self.metrics.wave_timeout_counter.inc()
        if self.recorder is not None:
            self.recorder.record("wave_timeout", error=msg)
        return type(e)(msg)

    def debug_stats(self) -> dict:
        """Cheap dispatcher state for /healthz?deep=1 and timeout
        diagnoses: no device work."""
        now = self._clock()
        with self._tel_mu:
            inflight = [dict(i) for i in self._inflight.values()]
            last_end = self._last_wave_end
            waves, stalls = self._wave_count, self._stall_count
            timeouts, first = self._timeout_count, self._first_wave_s
        oldest = max((now - i["t0"] for i in inflight), default=None)
        return {
            "queue_depth": self._queue.qsize(),
            "in_flight": len(inflight),
            "oldest_wave_age_s": (round(oldest, 3)
                                  if oldest is not None else None),
            "last_wave_age_s": (round(now - last_end, 3)
                                if last_end is not None else None),
            "stalled": any(i["stalled"] for i in inflight),
            "waves": waves,
            "stall_events": stalls,
            "timeouts": timeouts,
            "first_wave_s": round(first, 3) if first is not None else None,
            "stall_threshold_s": self._stall_threshold_s,
            "result_timeout_s": self.RESULT_TIMEOUT_S,
            "pipeline_depth": (self.pipeline_depth if self._pipelined
                               else 0),
            "admission": {"limit_rows": self.admission_limit,
                          # lock-free: healthz snapshot, staleness ok
                          "queued_rows": self._queued_rows,
                          "shed_rows": self._shed_rows,
                          "draining": self._draining,
                          "projected_wait_s": round(
                              self.projected_queue_wait_s(), 4)},
            "buffer_pool": (self.engine.wave_pool.stats()
                            if hasattr(self.engine, "wave_pool") else None),
            "analytics": (self.analytics.stats()
                          if self.analytics is not None else None),
        }

    def telemetry_snapshot(self) -> dict:
        """debug_stats + recent-wave percentiles."""
        with self._tel_mu:
            sizes = list(self._recent_sizes)
            durs = list(self._recent_durs)
            waits = list(self._recent_waits)

        def pct(xs, p, scale=1.0):
            if not xs:
                return None
            return round(float(np.percentile(xs, p)) * scale, 3)

        snap = self.debug_stats()
        snap.update({
            "wave_size_p50": pct(sizes, 50),
            "wave_size_p99": pct(sizes, 99),
            "wave_duration_p50_ms": pct(durs, 50, 1e3),
            "wave_duration_p99_ms": pct(durs, 99, 1e3),
            "queue_wait_p50_ms": pct(waits, 50, 1e3),
            "queue_wait_p99_ms": pct(waits, 99, 1e3),
        })
        return snap

    # ---- the merge loop ------------------------------------------------

    def _drain_wave(self, block_s: float = 0.1) -> List[_Job]:
        """Block for one job (up to ``block_s``; 0 polls), take what is
        already queued, then wait up to the coalescing window for more,
        never past ``max_wave`` rows."""
        if self._carry is not None:
            first, self._carry = self._carry, None
        else:
            try:
                first = (self._queue.get(timeout=block_s) if block_s > 0
                         else self._queue.get_nowait())
            except queue.Empty:
                return []
            self._dequeued(first)
        wave = [first]
        total = len(first)
        deadline = None  # armed once the backlog is drained
        while total < self.max_wave:
            try:
                job = self._queue.get_nowait()
            except queue.Empty:
                if self.max_delay_s <= 0:
                    break
                if deadline is None:
                    deadline = time.monotonic() + self.max_delay_s
                remain = deadline - time.monotonic()
                if remain <= 0:
                    break
                try:
                    job = self._queue.get(timeout=remain)
                except queue.Empty:
                    break
            self._dequeued(job)
            if total + len(job) > self.max_wave:
                self._carry = job
                try:
                    # delay parks the carried job across the wave
                    # boundary; error fails it, never launched
                    self._fault("dispatch_carry")
                except Exception as e:  # noqa: BLE001 - injected only
                    self._carry = None
                    _fail([job], e)
                break
            wave.append(job)
            total += len(job)
        try:
            # delay widens the window between collecting this wave and
            # launching it: concurrent callers land in the NEXT wave
            self._fault("dispatch_merge")
        except Exception as e:  # noqa: BLE001 - injected only
            _fail(wave, e)
            return []
        return wave

    def _run(self) -> None:
        # Pure columnar waves go into a FIFO ring of up to
        # pipeline_depth launched, unsynced waves; the worker packs and
        # launches the next wave while earlier ones run, and resolves
        # them oldest first.  Device order is launch order (one stream),
        # so results do not depend on when they are read.  Any other
        # wave flushes the ring first.
        pipelined = self._pipelined
        depth = self.pipeline_depth
        pending: deque = deque()  # (jobs, token, wave id), unsynced

        while not (self._closing.is_set() and self._queue.empty()
                   and self._carry is None):
            wave = self._drain_wave(block_s=0.0 if pending else 0.1)
            if not wave:
                while pending:
                    self._sync_and_resolve(*pending.popleft())
                continue
            if pipelined and all(j.reqs is None for j in wave):
                launched = self._launch_packed_jobs(wave, slot=len(pending))
                if launched is not None:
                    pending.append(launched)
                    while len(pending) >= depth:
                        self._sync_and_resolve(*pending.popleft())
                continue
            while pending:
                self._sync_and_resolve(*pending.popleft())
            self._run_wave(wave)
        while pending:
            self._sync_and_resolve(*pending.popleft())

    def _launch_packed_jobs(self, jobs: List[_Job], slot: int):
        """Concatenate and LAUNCH a pure columnar wave; returns (jobs,
        token, wave id) for the sync, or None when the launch failed (its
        callers already hold the error).  The wave is in flight, visible
        to the watchdog, from launch until its sync resolves."""
        wid = self._wave_begin("packed_pipelined", jobs, slot=slot)
        try:
            self._fault("dispatch_launch")
            batch, khash = _concat([(j.batch, j.khash) for j in jobs])
            now = max(j.now_ms for j in jobs)
            with self._engine_lock:
                self._fault("device_step")
                token = self.engine.launch_packed(batch, khash, now)
            # the launch's host routing and upload are pack work; device
            # time runs from here until sync_packed returns
            self._wave_mark(wid, "pack")
            return jobs, token, wid
        except Exception as e:  # noqa: BLE001 - surfaced to its callers
            self._wave_end(wid, error=e)
            _fail(jobs, e)
            return None

    def _sync_and_resolve(self, jobs: List[_Job], token, wid: int) -> None:
        try:
            self._fault("dispatch_sync")
            cols = self.engine.sync_packed(token,
                                           engine_lock=self._engine_lock)
            self._wave_mark(wid, "device")
            # delay holds the splice while later waves launch
            self._fault("dispatch_splice")
            views, a = [], 0
            for j in jobs:
                b = a + len(j.khash)
                views.append(ResultView(cols, a, b))
                a = b
        except Exception as e:  # noqa: BLE001 - surfaced to its callers
            self._wave_end(wid, error=e)
            _fail(jobs, e)
            return
        self._resolve(wid, jobs, views)
        if self.analytics is not None and not self._fused_tap:
            batch, khash = _concat([(j.batch, j.khash) for j in jobs])
            self._tap_packed(khash, batch.hits, cols[0])

    def _resolve(self, wid: int, jobs: List[_Job], results: list) -> None:
        """End the wave, then hand each caller its result: a caller that
        resumes sees the wave counted."""
        self.wave_count += 1
        self._wave_end(wid)
        for j, r in zip(jobs, results):
            j.future.set_result(r)

    def _run_wave(self, wave: List[_Job]) -> None:
        """Pack every job at its own now, concatenate, ONE engine call,
        then resolve each job with its slice."""
        n_list = sum(j.reqs is not None for j in wave)
        kind = ("packed" if not n_list
                else "list" if n_list == len(wave) else "merged")
        wid = self._wave_begin(kind, wave)
        try:
            self._fault("dispatch_launch")
            parts = []  # (job, batch, khash, errors or None)
            for j in wave:
                if j.reqs is not None:
                    kh = hash_request_keys([r.name for r in j.reqs],
                                           [r.unique_key for r in j.reqs])
                    b, errs = pack_requests(j.reqs, j.now_ms,
                                            size=len(j.reqs), key_hashes=kh)
                    parts.append((j, b, kh, errs))
                else:
                    parts.append((j, j.batch, j.khash, None))
            batch, khash = _concat([(p[1], p[2]) for p in parts])
            # the scalar now only backstops rows without their own
            now = max(j.now_ms for j in wave)
            self._wave_mark(wid, "pack")
            # an object-lane wave is tapped below with its key names:
            # the engine's device tap stays quiet for it
            mute = kind == "list" and self._fused_tap
            with self._engine_lock:
                self._fault("device_step")
                self.engine._tap_mute = mute
                try:
                    cols = self.engine.check_packed(batch, khash, now)
                finally:
                    self.engine._tap_mute = False
            self._wave_mark(wid, "device")
            self._fault("dispatch_splice")
            results, a = [], 0
            for j, _, kh, errs in parts:
                b = a + len(kh)
                results.append(
                    ResultView(cols, a, b) if errs is None
                    else responses_from_columns(
                        tuple(c[a:b] for c in cols), errs))
                a = b
        except Exception as e:  # noqa: BLE001 - surfaced to every caller
            self._wave_end(wid, error=e)
            _fail(wave, e)
            return
        self._resolve(wid, wave, results)
        if kind == "list":
            self._tap_named(khash, batch, cols, [j.reqs for j in wave])
        else:
            self._tap_packed(khash, batch.hits, cols[0])

    def close(self) -> None:
        with self._submit_mu:
            self._closing.set()
        # wait out a caller already inside an inline wave: no engine call
        # the dispatcher let start is in flight once close() returns
        with self._inline_mu:
            pass
        self._thread.join(timeout=10)
        if self._watchdog is not None:
            self._watchdog.join(timeout=5)
        while True:
            try:
                job = self._queue.get_nowait()
            except queue.Empty:
                break
            job.future.set_exception(RuntimeError("dispatcher closed"))
