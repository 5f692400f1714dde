"""SLO plane: declarative objectives evaluated in-process with
multi-window burn rates (the port of gubernator_tpu/slo.py).

A registry of SLOs, each a cheap source callable over a signal another
plane keeps (the phase ledger's p99, the tenant ledger's totals, the
memory ledger's pressure, the conservation audit's drift), evaluated on
a fixed tick with the multi-window burn-rate discipline of the SRE
workbook:

- an SLO's **error budget** is ``1 - objective`` (objective 0.999 →
  budget 0.1%);
- the **burn rate** over a window is the bad-event fraction in that
  window divided by the budget (burn 1.0 = spending exactly the
  budget; burn 10 = ten times too fast);
- a **breach** fires only when BOTH the fast and the slow window burn
  past the threshold (the fast window gives reaction speed, the slow
  window rides out blips), and **recovery** fires when the fast
  window's burn drops back under it.

Two source shapes:

- ``ratio`` sources return cumulative ``(bad, total)`` counters (e.g.
  shed rows vs admitted rows): the window burn is the delta-ratio
  over the window.
- ``threshold`` sources return an instantaneous ``(value, target)``
  pair (e.g. staleness seconds vs the reconcile interval): each tick
  contributes one bad event when ``value > target``, so the burn is
  the fraction of recent ticks spent out of bounds over the budget.

Per-tenant SLOs register as a **group**: one source returning
``{tenant: (bad, total)}`` snapshots (bounded cardinality — the
tenant ledger folds overflow into ``__other__``), evaluated per
tenant with the same windows.

Verdicts surface as ``gubernator_slo_burn{slo,tenant}`` gauges,
``slo_breach``/``slo_recovered`` flight-recorder events,
``GET /debug/slo``, the ``?deep=1`` healthz block, and the
``healthcheck --fail-on-burn`` readiness hook.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

#: the SLOs an instance registers (instance.py › _build_slo), as in the
#: JAX package
SLO_CATALOG: Dict[str, str] = {
    "decision_p99": "device-phase p99 latency vs GUBER_SLO_P99_MS "
                    "(the decision kernel's tail)",
    "global_staleness": "mesh-GLOBAL coherence staleness vs 2× the "
                        "reconcile interval (grpc mode reports 0)",
    "error_ratio": "error + degraded rows / total attributed rows",
    "shed_ratio": "admission-shed rows / (attributed + shed) rows",
    "tenant_error_ratio": "per-tenant error + degraded rows / that "
                          "tenant's rows",
    "tenant_shed_ratio": "per-tenant shed rows / that tenant's "
                         "(attributed + shed) rows",
    "hbm_pressure": "byte-weighted device occupancy fraction vs "
                    "GUBER_MEM_PRESSURE (fires before table-full / "
                    "cap-overflow starts demoting)",
    "fleet_conservation": "seconds the GLOBAL audit drift (injected "
                          "minus applied, both backends) has been "
                          "nonzero vs the one-flush-window bound "
                          "(2x GUBER_GLOBAL_SYNC_WAIT or "
                          "GUBER_FLEET_DRIFT_BOUND)",
}

DEFAULT_FAST_S = 60.0
DEFAULT_SLOW_S = 300.0
DEFAULT_BURN_THRESHOLD = 2.0


class SLO:
    """One declarative objective.  ``source`` is a cheap callable:
    ratio kind → cumulative ``(bad, total)``; threshold kind →
    instantaneous ``(value, target)``."""

    __slots__ = ("name", "kind", "objective", "source", "description",
                 "budget")

    def __init__(self, name: str, kind: str, objective: float,
                 source: Callable[[], Tuple[float, float]],
                 description: str = ""):
        if kind not in ("ratio", "threshold"):
            raise ValueError(f"unknown SLO kind {kind!r}")
        self.name = name
        self.kind = kind
        self.objective = float(objective)
        self.source = source
        self.description = description
        #: error budget: the tolerated bad fraction
        self.budget = max(1.0 - self.objective, 1e-9)


class _Track:
    """Window state for one (slo, tenant) series: a deque of
    ``(t, bad_cum, total_cum)`` samples plus the breach latch."""

    __slots__ = ("samples", "breached", "since", "last_value",
                 "last_target")

    def __init__(self):
        self.samples: deque = deque()
        self.breached = False
        self.since: Optional[float] = None
        self.last_value: Optional[float] = None
        self.last_target: Optional[float] = None

    def append(self, t: float, bad: float, total: float,
               keep_s: float) -> None:
        self.samples.append((t, float(bad), float(total)))
        cutoff = t - keep_s
        s = self.samples
        # keep one sample OLDER than the slow window so the window
        # delta has a baseline even exactly at the horizon
        while len(s) > 2 and s[1][0] <= cutoff:
            s.popleft()

    def burn(self, now: float, window_s: float, budget: float) -> float:
        """Bad-fraction over the trailing window / budget.  The
        baseline is the newest sample at or older than the window
        start (falling back to the oldest sample while uptime is
        shorter than the window — standard early-life behavior)."""
        s = self.samples
        if len(s) < 2:
            return 0.0
        cut = now - window_s
        base = s[0]
        for smp in s:
            if smp[0] <= cut:
                base = smp
            else:
                break
        t1, b1, n1 = s[-1]
        _, b0, n0 = base
        dn = n1 - n0
        if dn <= 0:
            return 0.0
        frac = max(b1 - b0, 0.0) / dn
        return frac / budget


class SLOEngine:
    """The in-process evaluator: ``tick()`` samples every registered
    source, updates burn gauges, and latches breach/recovery events
    into the flight recorder.  Thread-safe: tick runs on its
    IntervalLoop; ``snapshot``/``health`` serve HTTP threads."""

    def __init__(self, metrics=None, recorder=None,
                 fast_s: float = DEFAULT_FAST_S,
                 slow_s: float = DEFAULT_SLOW_S,
                 burn_threshold: float = DEFAULT_BURN_THRESHOLD,
                 clock=time.monotonic, exemplar=None):
        self.metrics = metrics
        self.recorder = recorder
        #: optional zero-arg callable → recent sampled trace id: breach
        #: events carry it as ``exemplar_trace``, so a burning SLO links
        #: to one concrete trace
        self.exemplar = exemplar
        self.fast_s = max(float(fast_s), 1e-3)
        self.slow_s = max(float(slow_s), self.fast_s)
        self.burn_threshold = float(burn_threshold)
        self._clock = clock
        self._mu = threading.Lock()
        self._slos: List[SLO] = []  # guarded-by: self._mu
        #: per-tenant groups: name → (objective, kind, source, desc)
        self._groups: Dict[str, tuple] = {}  # guarded-by: self._mu
        #: (slo_name, tenant-or-None) → _Track
        self._tracks: Dict[tuple, _Track] = {}  # guarded-by: self._mu
        self._ticks = 0  # guarded-by: self._mu
        #: (slo, tenant) label pairs currently exported (bounded-label
        #: gauge discipline: departed series are removed first)
        self._published: set = set()  # guarded-by: self._mu

    # ---- registration ---------------------------------------------------

    def register(self, slo: SLO) -> None:
        with self._mu:
            self._slos.append(slo)

    def register_group(self, name: str, objective: float,
                       source: Callable[[], Dict[str, tuple]],
                       description: str = "") -> None:
        """Per-tenant family: ``source`` returns ``{tenant: (bad,
        total)}`` cumulative snapshots (bounded cardinality — the
        caller's ledger caps the tenant set)."""
        with self._mu:
            self._groups[name] = (float(objective), source, description)

    def names(self) -> List[str]:
        with self._mu:
            return ([s.name for s in self._slos]
                    + list(self._groups))

    # ---- evaluation -----------------------------------------------------

    def _eval_one(self, name: str, kind: str, budget: float,
                  tenant: Optional[str], bad: float, total: float,
                  now: float, events: list, value=None, target=None
                  ) -> dict:
        tr = self._tracks.get((name, tenant))  # lock-free: caller holds self._mu (tick)
        if tr is None:
            tr = self._tracks[(name, tenant)] = _Track()  # lock-free: caller holds self._mu (tick)
        if kind == "threshold":
            # synthesize cumulative counters: one event per tick,
            # bad when out of bounds
            prev = tr.samples[-1] if tr.samples else (now, 0.0, 0.0)
            tr.last_value, tr.last_target = value, target
            bad = prev[1] + (1.0 if bad else 0.0)
            total = prev[2] + 1.0
        tr.append(now, bad, total, self.slow_s * 1.5)
        fast = tr.burn(now, self.fast_s, budget)
        slow = tr.burn(now, self.slow_s, budget)
        thr = self.burn_threshold
        if not tr.breached and fast > thr and slow > thr:
            tr.breached = True
            tr.since = now
            events.append(("slo_breach", name, tenant, fast, slow))
        elif tr.breached and fast < thr:
            tr.breached = False
            tr.since = now
            events.append(("slo_recovered", name, tenant, fast, slow))
        return {"slo": name, "tenant": tenant, "fast_burn": fast,
                "slow_burn": slow, "breached": tr.breached,
                "value": tr.last_value, "target": tr.last_target}

    def tick(self, now: Optional[float] = None) -> List[dict]:
        """One evaluation pass; returns the per-series verdicts (the
        snapshot cache) — IntervalLoop-driven in the daemon, called
        directly by tests with a fake clock."""
        now = self._clock() if now is None else now
        events: list = []
        rows: List[dict] = []
        with self._mu:
            self._ticks += 1
            for slo in self._slos:
                try:
                    a, b = slo.source()
                except Exception:  # pragma: no cover - source must
                    continue  # never kill the tick
                if slo.kind == "threshold":
                    rows.append(self._eval_one(
                        slo.name, "threshold", slo.budget, None,
                        float(a) > float(b), 0.0, now, events,
                        value=float(a), target=float(b)))
                else:
                    rows.append(self._eval_one(
                        slo.name, "ratio", slo.budget, None,
                        float(a), float(b), now, events))
            for name, (objective, source, _d) in self._groups.items():
                budget = max(1.0 - objective, 1e-9)
                try:
                    per_tenant = source()
                except Exception:  # pragma: no cover
                    continue
                for tenant, (a, b) in per_tenant.items():
                    rows.append(self._eval_one(
                        name, "ratio", budget, tenant,
                        float(a), float(b), now, events))
            self._publish_locked(rows)
        rec = self.recorder
        if rec is not None:
            for kind, name, tenant, fast, slow in events:
                ev = {"slo": name, "fast_burn": round(fast, 3),
                      "slow_burn": round(slow, 3),
                      "threshold": self.burn_threshold}
                if tenant is not None:
                    ev["tenant"] = tenant
                if kind == "slo_breach":
                    if self.exemplar is not None:
                        try:
                            tid = self.exemplar()
                        except Exception:  # pragma: no cover - link only
                            tid = None
                        if tid:
                            # the breach → trace link
                            ev["exemplar_trace"] = tid
                    rec.record("slo_breach", **ev)
                else:
                    rec.record("slo_recovered", **ev)
        return rows

    def _publish_locked(self, rows: List[dict]) -> None:
        """gubernator_slo_burn{slo,tenant} refresh under _mu: departed
        series (a tenant that left the bounded ledger) are removed
        before the current set is written, so cardinality stays
        bounded by #SLOs + #SLO-groups × (GUBER_TENANT_MAX + 1)."""
        m = self.metrics
        if m is None:
            return
        fresh = {(r["slo"], r["tenant"] or ""): r["fast_burn"]
                 for r in rows}
        for pair in self._published - set(fresh):  # lock-free: caller holds self._mu (tick)
            try:
                m.slo_burn.remove(*pair)
            except KeyError:  # pragma: no cover - already gone
                pass
        for (slo, tenant), val in fresh.items():
            m.slo_burn.labels(slo=slo, tenant=tenant).set(val)
        self._published = set(fresh)  # lock-free: caller holds self._mu (tick)

    # ---- reporting ------------------------------------------------------

    def snapshot(self) -> dict:
        """The ``GET /debug/slo`` document: windows + every series'
        current burn/breach state (re-evaluated fresh so a probe
        between ticks still sees live numbers)."""
        rows = self.tick()
        with self._mu:
            descs = {s.name: (s.kind, s.objective, s.description)
                     for s in self._slos}
            for name, (objective, _s, desc) in self._groups.items():
                descs[name] = ("ratio", objective, desc)
            ticks = self._ticks
        out_rows = []
        for r in rows:
            kind, objective, desc = descs.get(
                r["slo"], ("ratio", 0.0, ""))
            row = {"slo": r["slo"], "kind": kind,
                   "objective": objective,
                   "fast_burn": round(r["fast_burn"], 4),
                   "slow_burn": round(r["slow_burn"], 4),
                   "breached": r["breached"],
                   "description": desc}
            if r["tenant"] is not None:
                row["tenant"] = r["tenant"]
            if r["value"] is not None:
                row["value"] = round(r["value"], 6)
                row["target"] = round(r["target"], 6)
            out_rows.append(row)
        return {"fast_window_s": self.fast_s,
                "slow_window_s": self.slow_s,
                "burn_threshold": self.burn_threshold,
                "ticks": ticks, "slos": out_rows}

    def health(self) -> dict:
        """The healthz ``?deep=1`` block + the ``--fail-on-burn``
        readiness feed: which SLOs are breached, which fast windows
        are burning past the threshold right now."""
        rows = self.tick()
        breached = sorted({r["slo"] for r in rows if r["breached"]})
        burning = sorted({r["slo"] for r in rows
                          if r["fast_burn"] > self.burn_threshold})
        max_burn = max((r["fast_burn"] for r in rows), default=0.0)
        return {"breached": breached, "burning": burning,
                "max_fast_burn": round(max_burn, 4),
                "burn_threshold": self.burn_threshold}

    def verdicts(self) -> List[dict]:
        """Final per-series verdicts for the crash-forensics dump
        (telemetry.write_debug_dump): no re-evaluation, just the
        latched state, so a dying process can't wedge on a source."""
        with self._mu:
            out = []
            for (name, tenant), tr in self._tracks.items():
                v = {"slo": name, "breached": tr.breached}
                if tenant is not None:
                    v["tenant"] = tenant
                if tr.since is not None:
                    v["since_mono_s"] = round(tr.since, 3)
                out.append(v)
            return out
