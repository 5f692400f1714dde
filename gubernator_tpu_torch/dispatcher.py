"""Dispatcher: cross-request coalescing into one device wave.

The coalescing core of gubernator_tpu/dispatcher.py.  Concurrent
callers submit jobs to a queue; one worker thread drains it into a wave
of at most ``max_wave`` rows (waiting up to ``max_delay_ms`` for
stragglers once the backlog is taken), merges the jobs' columns into
ONE ``engine.check_packed`` call, and hands each caller its part: an
object-lane caller its response objects, a columnar caller a
``ResultView`` (row bounds into the wave's shared result columns), so
slicing and wire serialization run in the caller's thread, not the
worker's.  Every job is packed at its own ``now`` (per-request arrival
times ride the ``now`` column), so jobs from different instants share a
launch.  An idle dispatcher lets a columnar caller run its wave inline,
in its own thread (``check_packed_view``, ``run_inline_wave``).  Engine
calls are serialized by one lock, which the instance's row-level
operations (sweep) share.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import List, Optional, Sequence

import numpy as np

from .core.batch import RequestBatch, pack_requests, responses_from_columns
from .hashing import hash_request_keys
from .types import RateLimitRequest, RateLimitResponse


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
    columns (``batch`` + ``khash``)."""

    __slots__ = ("reqs", "batch", "khash", "now_ms", "future")

    def __init__(self, now_ms: int, reqs=None, batch=None, khash=None):
        self.reqs = reqs
        self.batch = batch
        self.khash = khash
        self.now_ms = now_ms
        self.future: Future = Future()

    def __len__(self) -> int:
        return len(self.reqs) if self.reqs is not None else len(self.khash)


class Dispatcher:
    """Serializes engine access by merging, not locking."""

    #: cap on how long a caller waits for its wave
    RESULT_TIMEOUT_S = 120.0

    def __init__(self, engine, max_wave: int = 8192,
                 max_delay_ms: float = 0.2,
                 lock: Optional[threading.Lock] = None):
        self.engine = engine
        self.max_wave = max_wave
        self.max_delay_s = max_delay_ms / 1000.0
        #: waves the worker ran / waves callers ran inline
        self.wave_count = 0
        self.inline_waves = 0
        self._engine_lock = lock if lock is not None else threading.Lock()
        self._queue: "queue.Queue[_Job]" = queue.Queue()
        #: the job that would have pushed a wave past max_wave leads the
        #: next one (worker thread only)
        self._carry: Optional[_Job] = None
        self._closing = threading.Event()
        self._submit_mu = threading.Lock()  # serializes submit vs close
        #: held by the one caller running a wave inline
        self._inline_mu = threading.Lock()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="device-dispatcher")
        self._thread.start()

    def _submit(self, job: _Job):
        with self._submit_mu:
            if self._closing.is_set():
                raise RuntimeError("dispatcher closed")
            self._queue.put(job)
        return job.future.result(timeout=self.RESULT_TIMEOUT_S)

    def check_batch(self, reqs: Sequence[RateLimitRequest], now_ms: int
                    ) -> List[RateLimitResponse]:
        """Submit request objects and wait; concurrent callers share
        device waves."""
        return self._submit(_Job(now_ms, reqs=list(reqs)))

    def check_packed(self, batch: RequestBatch, khash: np.ndarray,
                     now_ms: int) -> tuple:
        """Columnar submit (engine.check_packed's contract): returns the
        caller's (status, limit, remaining, reset, table_full) slice."""
        return self.check_packed_view(batch, khash, now_ms).sliced()

    def check_packed_view(self, batch: RequestBatch, khash: np.ndarray,
                          now_ms: int) -> ResultView:
        """``check_packed`` returning the ResultView: row bounds into the
        wave's shared result columns.  Idle: the wave runs inline, in
        this thread (a lone packed job's wave is exactly
        engine.check_packed); else it coalesces with the queued jobs."""
        out = self.run_inline_wave(
            lambda: self.engine.check_packed(batch, khash, now_ms))
        if out is not self._BUSY:
            return ResultView(out, 0, len(khash))
        return self._submit(_Job(now_ms, batch=batch, khash=khash))

    # ---- the idle inline path ------------------------------------------

    #: run_inline_wave's "dispatcher busy" answer (None is a valid
    #: engine result, so the miss has its own identity)
    _BUSY = object()

    def _try_inline(self) -> bool:
        """True when nothing is queued and no other caller is inline: the
        calling thread may then run the engine itself, skipping two
        thread hand-offs and the coalescing window.  The caller must
        release ``_inline_mu`` when this returns True."""
        if not self._queue.empty() or self._closing.is_set():
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

    def run_inline_wave(self, fn):
        """Run ``fn()`` (an engine call the caller composed, e.g. the
        fused wire lane's ``check_prepacked``) as one inline wave in this
        thread, under the engine lock.  Returns its result, or ``_BUSY``
        when the inline path is not free (jobs queued, another caller
        inline, closing): the caller then takes the queued path."""
        if not self._try_inline():
            return self._BUSY
        try:
            with self._engine_lock:
                out = fn()
            self.inline_waves += 1
            return out
        finally:
            self._inline_mu.release()

    # ---- the merge loop -------------------------------------------------

    def _drain_wave(self, block_s: float = 0.1) -> List[_Job]:
        """Block for one job (up to ``block_s``), take what is already
        queued, then wait up to the coalescing window for more, never
        past ``max_wave`` rows."""
        if self._carry is not None:
            first, self._carry = self._carry, None
        else:
            try:
                first = self._queue.get(timeout=block_s)
            except queue.Empty:
                return []
        wave = [first]
        total = len(first)
        deadline = None  # armed once the backlog is drained
        while total < self.max_wave:
            try:
                job = self._queue.get_nowait()
            except queue.Empty:
                if deadline is None:
                    deadline = time.monotonic() + self.max_delay_s
                remain = deadline - time.monotonic()
                if remain <= 0:
                    break
                try:
                    job = self._queue.get(timeout=remain)
                except queue.Empty:
                    break
            if total + len(job) > self.max_wave:
                self._carry = job
                break
            wave.append(job)
            total += len(job)
        return wave

    def _run(self) -> None:
        while not (self._closing.is_set() and self._queue.empty()
                   and self._carry is None):
            wave = self._drain_wave()
            if wave:
                self._run_wave(wave)

    def _run_wave(self, wave: List[_Job]) -> None:
        """Pack every job at its own now, concatenate, ONE engine call,
        then resolve each job with its slice."""
        try:
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
            batch = RequestBatch(*[
                np.concatenate([np.asarray(p[1][f]) for p in parts])
                for f in range(len(RequestBatch._fields))])
            khash = np.concatenate([p[2] for p in parts])
            # the scalar now only backstops rows without their own
            now = max(j.now_ms for j in wave)
            with self._engine_lock:
                cols = self.engine.check_packed(batch, khash, now)
            self.wave_count += 1
            a = 0
            for j, _, kh, errs in parts:
                b = a + len(kh)
                j.future.set_result(
                    ResultView(cols, a, b) if errs is None
                    else responses_from_columns(
                        tuple(c[a:b] for c in cols), errs))
                a = b
        except Exception as e:  # noqa: BLE001 - surfaced to every caller
            for j in wave:
                if not j.future.done():
                    j.future.set_exception(e)

    def close(self) -> None:
        with self._submit_mu:
            self._closing.set()
        # wait out a caller already inside an inline wave: no engine call
        # the dispatcher let start is in flight once close() returns
        with self._inline_mu:
            pass
        self._thread.join(timeout=10)
        while True:
            try:
                job = self._queue.get_nowait()
            except queue.Empty:
                break
            job.future.set_exception(RuntimeError("dispatcher closed"))
