"""Fleet audit (the port of gubernator_tpu/fleet.py): a conservation
auditor on the GLOBAL lanes and the folds of the fleet's debug
documents.

- **AuditTap**: the double-entry ledger each ``GlobalManager`` keeps:
  ``injected`` counts hit weight at queue entry, ``applied`` at the
  owner's acknowledgement (or absorbed, where this daemon is the
  owner), ``lost`` weight dropped without a send.  Sender-side and
  self-contained, so per-daemon backlogs sum exactly across a fleet.
- **ConservationAuditor**: one per instance, on by default
  (``GUBER_FLEET_AUDIT=0`` turns the taps off): folds the tap with the
  live queues into the ``GET /debug/audit`` document, drives
  ``gubernator_fleet_conservation_drift`` and feeds the
  ``fleet_conservation`` SLO (seconds since the backlog last drained,
  against the drift bound).  The port has no mesh-GLOBAL tier: the
  document's lanes hold ``global`` alone.
- **fold_audits / ring_verdict / RingWatch / merge_***: pure folds over
  the daemons' documents (audits, top keys, tenants, SLOs, memory,
  health).

The identity, per daemon and fleet-wide::

    injected == applied + queued + in_flight + lost
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Tuple

#: per-tenant RED ledger columns (analytics.TenantLedger.FIELDS) —
#: duplicated literally so the merge plane works on plain JSON docs
#: without importing the analytics worker machinery
TENANT_FIELDS = ("requests", "hits", "over_limit", "errors",
                 "degraded", "shed")


def audit_enabled() -> bool:
    """GUBER_FLEET_AUDIT=0 disables the conservation audit taps (the
    /debug/audit document still serves, reporting zeros)."""
    return os.environ.get("GUBER_FLEET_AUDIT", "1") != "0"


def drift_bound_s(behaviors) -> float:
    """The fleet_conservation SLO target: how long the audit backlog
    may stay nonzero before the objective counts the tick bad.
    Default 2× the GLOBAL flush window (one window to flush + one to
    ack); GUBER_FLEET_DRIFT_BOUND overrides (duration string)."""
    v = os.environ.get("GUBER_FLEET_DRIFT_BOUND", "")
    if v:
        from .config import parse_duration_ms

        try:
            return max(parse_duration_ms(v) / 1000.0, 1e-3)
        except (ValueError, TypeError):
            pass
    wait_ms = int(getattr(behaviors, "global_sync_wait_ms", 1000))
    return 2.0 * max(wait_ms, 100) / 1000.0


class AuditTap:
    """Sender-side double-entry hit ledger for one GlobalManager.

    Monotonic counters only (the live queue depth is read from the
    queues themselves), own leaf lock, touched OUTSIDE the manager's
    ``_mu`` — the tap adds no edge to the lock order.  ``degraded``
    shares ride as parallel counters so the audit vector can report
    how much of the backlog is degraded-mode reconcile debt."""

    __slots__ = ("_mu", "injected", "applied", "deg_injected",
                 "deg_applied", "absorbed", "lost")

    def __init__(self):
        self._mu = threading.Lock()
        self.injected = 0  # guarded-by: self._mu
        self.applied = 0  # guarded-by: self._mu
        self.deg_injected = 0  # guarded-by: self._mu
        self.deg_applied = 0  # guarded-by: self._mu
        #: subset of ``applied`` that never crossed the wire (this
        #: daemon was the owner; the serve already applied the hits)
        self.absorbed = 0  # guarded-by: self._mu
        #: weight dropped on the unparseable-TLV path: injected,
        #: never applied — permanent drift, the loss detector
        self.lost = 0  # guarded-by: self._mu

    def inject(self, n: int, degraded: bool = False) -> None:
        if n <= 0:
            return
        with self._mu:
            self.injected += n
            if degraded:
                self.deg_injected += n

    def apply(self, n: int, deg: int = 0,
              absorbed: bool = False) -> None:
        if n <= 0:
            return
        with self._mu:
            self.applied += n
            self.deg_applied += min(deg, n)
            if absorbed:
                self.absorbed += n

    def lose(self, n: int, deg: int = 0) -> None:
        if n <= 0:
            return
        with self._mu:
            self.lost += n
            # a dropped entry's degraded share is settled too (it will
            # never flush); keeps deg_pending == pending degraded debt
            self.deg_applied += min(deg, n)

    def snapshot(self) -> Dict[str, int]:
        with self._mu:
            return {"injected": self.injected, "applied": self.applied,
                    "deg_injected": self.deg_injected,
                    "deg_applied": self.deg_applied,
                    "absorbed": self.absorbed, "lost": self.lost}


class ConservationAuditor:
    """One instance's always-on conservation audit vector.

    Reads only already-maintained state (the tap's counters, the
    queues' accumulators) — no new threads; the
    SLO engine's tick doubles as the sample cadence, and the
    ``GET /debug/audit`` handler computes the document on demand."""

    def __init__(self, instance):
        self.instance = instance
        self.enabled = audit_enabled()
        self.bound_s = drift_bound_s(instance.config.behaviors)
        self._mu = threading.Lock()
        #: monotonic stamp of the last drift == 0 observation; the SLO
        #: value is the age of this stamp (0 while conserved)
        self._last_zero = time.monotonic()  # guarded-by: self._mu

    # ---- the audit vector ----------------------------------------------

    def _lanes(self) -> Tuple[dict, Optional[dict]]:
        inst = self.instance
        g = {"injected": 0, "applied": 0, "deg_injected": 0,
             "deg_applied": 0, "absorbed": 0, "lost": 0,
             "queued": 0, "deg_queued": 0}
        gm = inst.global_manager
        if gm is not None:
            tap = gm.audit
            if tap is not None:
                g.update(tap.snapshot())
            q, dq = gm.queued_hits()
            g["queued"], g["deg_queued"] = q, dq
        g["backlog"] = g["injected"] - g["applied"]
        g["in_flight"] = g["backlog"] - g["queued"] - g["lost"]
        g["deg_pending"] = g["deg_injected"] - g["deg_applied"]
        m = None
        return g, m

    def _drift_of(self, g: dict, m: Optional[dict]) -> int:
        return int(g["backlog"]) + (int(m["backlog"]) if m else 0)

    def _age(self, drift: int, now: float) -> float:
        with self._mu:
            if drift == 0:
                self._last_zero = now
            return max(now - self._last_zero, 0.0)

    def slo_sample(self) -> Tuple[float, float]:
        """fleet_conservation source (threshold kind): (seconds the
        audit backlog has been nonzero, the drift bound).  Also drives
        the drift gauge — the sample rides the SLO tick, no loop of
        its own."""
        g, m = self._lanes()
        drift = self._drift_of(g, m)
        age = self._age(drift, time.monotonic())
        self.instance.metrics.fleet_conservation_drift.set(float(drift))
        return (age, self.bound_s)

    def _ring(self) -> dict:
        inst = self.instance
        membership = sorted(p.info.grpc_address for p in inst.peers())
        with inst._peer_mu:
            bad, gen = inst._gate_bad, inst._ring_gen
        ejected = sorted(set(bad) & set(membership))
        routing = [a for a in membership if a not in set(ejected)]
        return {"generation": int(gen),
                "self": inst._self_addr,
                "membership": membership, "routing": routing,
                "ejected": ejected}

    def doc(self) -> dict:
        """The ``GET /debug/audit`` document, also what the fleet fold
        reads."""
        g, m = self._lanes()
        drift = self._drift_of(g, m)
        age = self._age(drift, time.monotonic())
        self.instance.metrics.fleet_conservation_drift.set(float(drift))
        lanes = {"global": g}
        if m is not None:
            lanes["mesh"] = m
        behaviors = self.instance.config.behaviors
        return {"instance": self.instance._self_addr,
                "enabled": self.enabled,
                "drift": drift, "conserved": drift == 0,
                "lost": g["lost"],
                "drain_age_s": round(age, 6),
                "bound_s": round(self.bound_s, 6),
                "flush_window_ms":
                    int(behaviors.global_sync_wait_ms),
                "lanes": lanes, "ring": self._ring()}


# ---- fleet folds (pure functions over /debug documents) ----------------


def fold_audits(docs: List[dict]) -> dict:
    """Fold per-daemon audit vectors into the fleet conservation
    verdict.  The ledgers are sender-side and self-contained, so the
    fold is a plain sum: Σ backlog == fleet drift, exactly."""
    tot = {"injected": 0, "applied": 0, "queued": 0, "in_flight": 0,
           "absorbed": 0, "lost": 0, "deg_pending": 0,
           "mesh_injected": 0, "mesh_folded": 0}
    per: List[dict] = []
    drift = 0
    max_age = 0.0
    bound = 0.0
    stale_ms = 0
    for d in docs:
        g = d.get("lanes", {}).get("global", {})
        m = d.get("lanes", {}).get("mesh")
        for f in ("injected", "applied", "queued", "in_flight",
                  "absorbed", "lost", "deg_pending"):
            tot[f] += int(g.get(f, 0))
        if m:
            tot["mesh_injected"] += int(m.get("injected", 0))
            tot["mesh_folded"] += int(m.get("folded", 0))
        drift += int(d.get("drift", 0))
        max_age = max(max_age, float(d.get("drain_age_s", 0.0)))
        bound = max(bound, float(d.get("bound_s", 0.0)))
        stale_ms = max(stale_ms, int(d.get("flush_window_ms", 0)))
        per.append({"instance": d.get("instance"),
                    "drift": int(d.get("drift", 0)),
                    "drain_age_s": d.get("drain_age_s", 0.0),
                    "backlog": int(g.get("backlog", 0)),
                    "queued": int(g.get("queued", 0)),
                    "in_flight": int(g.get("in_flight", 0)),
                    "lost": int(g.get("lost", 0)),
                    "deg_pending": int(g.get("deg_pending", 0))})
    return {"daemons": len(docs), "drift": drift,
            "conserved": drift == 0, "totals": tot,
            "per_daemon": per,
            "max_drain_age_s": round(max_age, 6),
            "bound_s": round(bound, 6),
            #: audit vectors lag true state by at most one flush
            #: window (RESILIENCE.md › Staleness bound)
            "staleness_bound_s": round(stale_ms / 1000.0, 6)}


def ring_verdict(docs: List[dict]) -> dict:
    """Stateless ring/membership consistency check over audit docs:
    every daemon must agree on the peer set, and no daemon may be
    routing around an ejected member (routing == membership
    everywhere).  Ring generations are per-daemon local counters —
    reported for diagnosis, never compared across daemons."""
    reasons = []
    memberships = {tuple(d.get("ring", {}).get("membership", []))
                   for d in docs}
    routings = {tuple(d.get("ring", {}).get("routing", []))
                for d in docs}
    if len(memberships) > 1:
        reasons.append("membership_mismatch")
    if len(routings) > 1:
        reasons.append("routing_mismatch")
    ejected = sorted({a for d in docs
                      for a in d.get("ring", {}).get("ejected", [])})
    if ejected:
        reasons.append("peers_ejected")
    return {"consistent": not reasons, "reasons": reasons,
            "daemons": len(docs), "ejected": ejected,
            "generations": {d.get("instance"):
                            d.get("ring", {}).get("generation")
                            for d in docs}}


class RingWatch:
    """Edge-triggered wrapper around :func:`ring_verdict`: the first
    inconsistent check records ``fleet_ring_divergence`` into the
    given flight recorder; the first consistent check after that
    records ``fleet_ring_converged``.  One watch per observer (the
    fleet tick, a test) — the latch is the observer's."""

    def __init__(self):
        self._diverged = False

    def check(self, docs: List[dict], recorder=None) -> dict:
        v = ring_verdict(docs)
        if recorder is not None:
            if not v["consistent"] and not self._diverged:
                recorder.record("fleet_ring_divergence",
                                daemons=v["daemons"],
                                reasons=",".join(v["reasons"]),
                                ejected=",".join(v["ejected"]))
            elif v["consistent"] and self._diverged:
                recorder.record("fleet_ring_converged",
                                daemons=v["daemons"])
        self._diverged = not v["consistent"]
        return v


def _kh_int(v) -> int:
    return int(v, 16) if isinstance(v, str) else int(v)


def merge_topkeys(docs: List[dict], k: Optional[int] = None) -> dict:
    """Cluster top-K: fold every daemon's /debug/topkeys document
    through the sketch's exact Space-Saving merge
    (analytics.HeavyHitterSketch.merge_entries).  With key-partitioned
    traffic and enough width the merged sketch is EXACT — byte-equal
    to a single sketch fed the union stream (tests/test_fleet.py)."""
    from .analytics import HeavyHitterSketch

    kk = k or max([int(d.get("k") or 0) for d in docs] + [256])
    width = max([int(d.get("width") or 0) for d in docs] + [4 * kk])
    sk = HeavyHitterSketch(k=kk, width=width)
    owners: Dict[int, str] = {}
    for d in docs:
        entries = d.get("keys", [])
        sk.merge_entries(entries,
                         total_weight=d.get("total_hits_observed"))
        for e in entries:
            if e.get("owner"):
                owners[_kh_int(e["khash"])] = e["owner"]
    rows = sk.topk(kk)
    for e in rows:
        # ring-owner attribution survives the merge: all daemons agree
        # on owners while the ring is consistent (ring_verdict guards)
        e["owner"] = owners.get(e["khash"])
        e["khash"] = f"0x{e['khash']:016x}"
    return {"daemons": len(docs), "k": kk, "width": width,
            "total_hits_observed": int(sk.total_weight),
            "admission_error_bound": sk.error_bound(),
            "keys": rows}


def merge_tenants(docs: List[dict]) -> dict:
    """Fleet tenant RED rollup: field-wise sums per tenant across
    daemons, with the conservation assertion — every daemon's
    per-tenant counts must sum to its own totals row, and the fleet
    totals must equal the per-tenant fleet sums (both exact; a
    mismatch flags the source daemon by index)."""
    tenants: Dict[str, Dict[str, int]] = {}
    totals = {f: 0 for f in TENANT_FIELDS}
    mismatches: List[int] = []
    enabled = 0
    for i, d in enumerate(docs):
        if not d.get("enabled", True):
            continue
        enabled += 1
        own = {f: 0 for f in TENANT_FIELDS}
        for name, c in d.get("tenants", {}).items():
            row = tenants.setdefault(name,
                                     {f: 0 for f in TENANT_FIELDS})
            for f in TENANT_FIELDS:
                v = int(c.get(f, 0))
                row[f] += v
                own[f] += v
        dt = d.get("totals", {})
        if own != {f: int(dt.get(f, 0)) for f in TENANT_FIELDS}:
            mismatches.append(i)
        for f in TENANT_FIELDS:
            totals[f] += int(dt.get(f, 0))
    fleet_sum = {f: sum(t[f] for t in tenants.values())
                 for f in TENANT_FIELDS}
    conserved = not mismatches and fleet_sum == totals
    return {"daemons": len(docs), "enabled_daemons": enabled,
            "tenant_count": len(tenants), "tenants": tenants,
            "totals": totals, "conserved": conserved,
            "mismatched_daemons": mismatches,
            "overflowed": any(d.get("overflowed") for d in docs)}


def merge_slo(docs: List[dict]) -> dict:
    """Fleet SLO rollup: worst-of latch (breached anywhere == breached
    fleet-wide) plus summed burn across daemons — budget spend is
    additive when the objective is fleet-shared, while the max shows
    the worst single daemon."""
    rows: Dict[tuple, dict] = {}
    for d in docs:
        for r in d.get("slos", []):
            key = (r.get("slo"), r.get("tenant") or "")
            cur = rows.get(key)
            if cur is None:
                cur = rows[key] = {
                    "slo": r.get("slo"), "kind": r.get("kind"),
                    "objective": r.get("objective"),
                    "breached": False, "daemons": 0,
                    "fast_burn_max": 0.0, "slow_burn_max": 0.0,
                    "fast_burn_sum": 0.0, "slow_burn_sum": 0.0}
                if r.get("tenant"):
                    cur["tenant"] = r["tenant"]
            cur["daemons"] += 1
            cur["breached"] = cur["breached"] or bool(r.get("breached"))
            fb = float(r.get("fast_burn") or 0.0)
            sb = float(r.get("slow_burn") or 0.0)
            cur["fast_burn_max"] = max(cur["fast_burn_max"], fb)
            cur["slow_burn_max"] = max(cur["slow_burn_max"], sb)
            cur["fast_burn_sum"] = round(cur["fast_burn_sum"] + fb, 6)
            cur["slow_burn_sum"] = round(cur["slow_burn_sum"] + sb, 6)
            if r.get("value") is not None:
                cur["value_max"] = max(float(r["value"]),
                                       cur.get("value_max", 0.0))
                cur["target"] = r.get("target")
    out = sorted(rows.values(),
                 key=lambda r: (r["slo"], r.get("tenant", "")))
    return {"daemons": len(docs),
            "ticks": sum(int(d.get("ticks", 0)) for d in docs),
            "breached": sorted({r["slo"] for r in out
                                if r["breached"]}),
            "slos": out}


def merge_memory(docs: List[dict]) -> dict:
    """Fleet memory-ledger pressure: summed bytes, per-daemon pressure
    rows, and consumer byte totals folded by name."""
    consumers: Dict[str, int] = {}
    per: List[dict] = []
    dev = host = 0
    worst = 0.0
    for d in docs:
        dev += int(d.get("device_bytes", 0))
        host += int(d.get("host_bytes", 0))
        p = float(d.get("pressure", 0.0))
        worst = max(worst, p)
        per.append({"device_bytes": int(d.get("device_bytes", 0)),
                    "host_bytes": int(d.get("host_bytes", 0)),
                    "pressure": p,
                    "pressure_target": d.get("pressure_target")})
        for name, rec in d.get("consumers", {}).items():
            if isinstance(rec, dict) and "bytes" in rec:
                consumers[name] = (consumers.get(name, 0)
                                   + int(rec["bytes"]))
    return {"daemons": len(docs), "device_bytes": dev,
            "host_bytes": host, "max_pressure": round(worst, 6),
            "per_daemon": per, "consumer_bytes": consumers}


def merge_status(health_docs: List[dict],
                 audit_docs: Optional[List[dict]] = None) -> dict:
    """Fleet status: healthz rollup + the ring consistency verdict
    (when audit docs ride along)."""
    statuses = [d.get("status", "unreachable") for d in health_docs]
    out = {"daemons": len(health_docs),
           "healthy": sum(1 for s in statuses if s == "healthy"),
           "statuses": statuses,
           "peer_counts": [d.get("peer_count")
                           for d in health_docs]}
    if audit_docs:
        out["ring"] = ring_verdict(audit_docs)
        fold = fold_audits(audit_docs)
        out["conservation"] = {"drift": fold["drift"],
                               "conserved": fold["conserved"]}
    return out
