"""Deterministic fault injection: named faultpoints, armed on demand (the
port's copy of gubernator_tpu/faults.py).

A chaos run that fails a peer's sends, delays the device step or drops
a broadcast must be repeatable.  Each instrumented site costs one
attribute read (``fs.armed``) while disarmed.  Points are armed from the
``GUBER_FAULT`` environment variable when an instance is built, or at
run time through the daemon's ``POST /debug/faults``.

Spec grammar (comma-separated)::

    point[@tag]:mode[:arg[:prob]]

    peer_send:error:0.3           30% of peer flush RPCs fail
    device_step:delay:50ms        every device step sleeps 50ms
    peer_send@10.0.0.2:5001:error flushes to that peer always fail

Modes: ``error`` raises :class:`FaultInjected` at the point (``arg`` is
the probability, default 1.0); ``delay`` sleeps (``arg`` is a Go-style
duration, an optional 4th field the probability).  ``tag`` scopes a
point to one call site (peer points pass the peer's gRPC address); a
point without a tag matches every site.

Every point draws from its own ``random.Random`` seeded from ``(seed,
point, tag, mode)`` (``GUBER_FAULT_SEED``, default 0), so a seeded run
replays draw for draw, as the JAX package's does.  A ``FaultSet`` is per
instance: arming one daemon of an in-process cluster leaves its
siblings alone.

:data:`FAULT_POINTS` is the JAX package's catalog, each point fired
where JAX fires it (``global_accum_swap`` and ``global_psum`` in the
mesh-GLOBAL reconcile tick).  Arming a point outside the catalog raises:
a chaos run must never test nothing without saying so.
"""
from __future__ import annotations

import logging
import os
import random
import threading
import time
from typing import Dict, List, Optional

from .config import parse_duration_ms

log = logging.getLogger("gubernator_tpu_torch.faults")


class FaultInjected(Exception):
    """Raised by an armed ``error``-mode faultpoint."""


#: faultpoint catalog: name → where the check lives
FAULT_POINTS = {
    "peer_send": "peer_client._SendLane._launch — before the flush RPC "
                 "leaves (tag: peer address)",
    "peer_recv": "peer_client._SendLane._rpc_done — after a flush RPC "
                 "succeeded, before entries resolve (tag: peer address)",
    "peer_circuit": "PeerClient._circuit_blocked — forces the peer's "
                    "circuit to read as OPEN (tag: peer address)",
    "dispatch_enqueue": "Dispatcher._submit — job admission into the "
                        "wave queue",
    "dispatch_launch": "Dispatcher wave launch — before the engine call "
                       "of a queued wave",
    "dispatch_sync": "Dispatcher._sync_and_resolve — before a pipelined "
                     "wave's sync",
    "dispatch_merge": "Dispatcher._drain_wave — after a wave's jobs are "
                      "collected, before the merge and launch (delay "
                      "widens the window for callers to land in the "
                      "NEXT wave)",
    "dispatch_carry": "Dispatcher._drain_wave — when an overflow job is "
                      "held as the next wave's carry (delay parks it "
                      "across the wave boundary; error fails it)",
    "dispatch_splice": "Dispatcher result splicing — after the engine "
                       "call, before the jobs' futures resolve from the "
                       "shared result columns",
    "device_step": "the engine call itself (inline and queued waves)",
    "wire_ingest": "instance wire entry — before the C++ parse",
    "global_broadcast": "GlobalManager._broadcast_tick — before the "
                        "owner broadcast tick",
    "global_hits": "GlobalManager._hits_tick — before the hit flush "
                   "tick (an aborted tick pops nothing)",
    "global_accum_swap": "V1Instance._mesh_reconcile_tick — before the "
                         "mesh-GLOBAL accumulator double-buffer swap "
                         "(error aborts the tick; buffers untouched)",
    "global_psum": "V1Instance._mesh_reconcile_tick — before the "
                   "mesh-GLOBAL reconcile collective launches (error "
                   "swaps the retired buffer back; no hit stranded)",
    "mr_sync": "MultiRegionManager._run_async_reqs — before the "
               "cross-region flush tick (queues not yet popped, so an "
               "aborted tick loses nothing)",
    "snapshot": "instance._save_to_loader — before the Loader snapshot",
    "restore": "instance._load_from_loader — before the Loader restore",
    "tier_promote": "TierController.promote — after the admissibility "
                    "gate, before the cold row is written to the "
                    "device table (error aborts the migration: the row "
                    "stays cold, tier_migrations_aborted increments)",
    "tier_demote": "TierController.demote — before the victim row is "
                   "gathered off the device (error aborts the "
                   "eviction: the row stays hot and the triggering "
                   "promotion is abandoned)",
}


class _Point:
    __slots__ = ("name", "tag", "mode", "prob", "delay_s", "rng",
                 "checked", "fired")

    def __init__(self, name: str, tag: Optional[str], mode: str,
                 prob: float, delay_s: float, seed: int):
        self.name = name
        self.tag = tag
        self.mode = mode
        self.prob = prob
        self.delay_s = delay_s
        # one stream per point: a replay does not depend on how other
        # points interleave their draws
        self.rng = random.Random(f"{seed}|{name}|{tag}|{mode}")
        self.checked = 0
        self.fired = 0

    def describe(self) -> dict:
        return {"point": self.name, "tag": self.tag, "mode": self.mode,
                "prob": self.prob,
                "delay_ms": round(self.delay_s * 1000, 3),
                "checked": self.checked, "fired": self.fired}


def _parse_spec(spec: str, seed: int) -> List[_Point]:
    points: List[_Point] = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        head = parts[0]
        tag: Optional[str] = None
        if "@" in head:
            head, _, tag = head.partition("@")
            # a peer tag is host:port, which the ":" split cut in two; a
            # purely numeric next field can only be that port (modes are
            # words, probabilities carry a dot)
            if len(parts) > 1 and parts[1].isdigit():
                tag = f"{tag}:{parts[1]}"
                parts.pop(1)
        name = head.strip()
        if name not in FAULT_POINTS:
            raise ValueError(
                f"unknown faultpoint {name!r} (catalog: "
                f"{', '.join(sorted(FAULT_POINTS))})")
        mode = parts[1].strip() if len(parts) > 1 else "error"
        prob, delay_s = 1.0, 0.0
        if mode == "error":
            if len(parts) > 2 and parts[2].strip():
                prob = float(parts[2])
        elif mode == "delay":
            if len(parts) < 3 or not parts[2].strip():
                raise ValueError(
                    f"faultpoint {name!r}: delay mode needs a duration "
                    f"(e.g. {name}:delay:50ms)")
            delay_s = parse_duration_ms(parts[2].strip()) / 1000.0
            if len(parts) > 3 and parts[3].strip():
                prob = float(parts[3])
        else:
            raise ValueError(
                f"faultpoint {name!r}: unknown mode {mode!r} "
                "(want 'error' or 'delay')")
        if not (0.0 <= prob <= 1.0):
            raise ValueError(
                f"faultpoint {name!r}: probability {prob} outside [0,1]")
        points.append(_Point(name, tag or None, mode, prob, delay_s, seed))
    return points


class FaultSet:
    """One instance's armed faultpoints.  ``armed`` is the hot-path gate
    every site reads first; ``metrics`` (gubernator_fault_injected) and
    ``recorder`` (fault_armed / fault_cleared events) are wired by the
    owning instance."""

    def __init__(self, seed: int = 0):
        self.armed = False
        self.seed = seed
        self._mu = threading.Lock()
        self._points: Dict[str, List[_Point]] = {}  # guarded-by: self._mu
        self._spec = ""  # guarded-by: self._mu
        self.metrics = None
        self.recorder = None

    @classmethod
    def from_env(cls, env=None) -> "FaultSet":
        """GUBER_FAULT_SEED (a malformed seed is ignored) and GUBER_FAULT
        (armed at once; a malformed spec raises)."""
        env = os.environ if env is None else env
        seed = 0
        raw_seed = env.get("GUBER_FAULT_SEED", "")
        if raw_seed:
            try:
                seed = int(raw_seed)
            except ValueError:
                log.warning("malformed GUBER_FAULT_SEED=%r ignored",
                            raw_seed)
        fs = cls(seed=seed)
        spec = env.get("GUBER_FAULT", "")
        if spec:
            fs.arm(spec)
        return fs

    # ---- arming ---------------------------------------------------------

    def arm(self, spec: str, seed: Optional[int] = None) -> dict:
        """Replace the armed set with ``spec`` (an empty spec disarms).
        A malformed spec raises ValueError and changes nothing."""
        if seed is not None:
            self.seed = int(seed)
        points = _parse_spec(spec, self.seed)
        by_name: Dict[str, List[_Point]] = {}
        for p in points:
            by_name.setdefault(p.name, []).append(p)
        with self._mu:
            self._points = by_name
            self._spec = spec if points else ""
            self.armed = bool(points)
        if points:
            log.warning("faults ARMED (seed=%d): %s", self.seed, spec)
        if self.recorder is not None:
            if points:
                self.recorder.record("fault_armed", spec=spec,
                                     seed=self.seed)
            else:
                self.recorder.record("fault_cleared")
        return self.describe()

    def clear(self) -> dict:
        return self.arm("")

    def describe(self) -> dict:
        with self._mu:
            pts = [p.describe() for ps in self._points.values()
                   for p in ps]
            spec = self._spec
        return {"armed": self.armed, "seed": self.seed, "spec": spec,
                "points": pts, "catalog": sorted(FAULT_POINTS)}

    # ---- the hot-path checks -------------------------------------------

    def fire(self, name: str, tag: Optional[str] = None) -> None:
        """Run the faultpoint: sleep for matched ``delay`` points, raise
        FaultInjected for a matched ``error`` point.  Callers read
        ``armed`` first; this re-checks, so racing a disarm is
        harmless."""
        if not self.armed:
            return
        boom = False
        delay = 0.0
        fired = 0
        with self._mu:
            for p in self._points.get(name, ()):
                if p.tag is not None and p.tag != tag:
                    continue
                p.checked += 1
                if p.prob < 1.0 and p.rng.random() >= p.prob:
                    continue
                p.fired += 1
                fired += 1
                if p.mode == "delay":
                    delay += p.delay_s
                else:
                    boom = True
        if fired and self.metrics is not None:
            self.metrics.fault_injected.labels(point=name).inc(fired)
        if delay > 0:
            time.sleep(delay)
        if boom:
            raise FaultInjected(
                f"fault injected: {name}" + (f"@{tag}" if tag else ""))

    def should(self, name: str, tag: Optional[str] = None) -> bool:
        """Boolean twin of ``fire`` for a point that gates a condition
        (``peer_circuit`` forces the circuit open)."""
        if not self.armed:
            return False
        try:
            self.fire(name, tag)
        except FaultInjected:
            return True
        return False
