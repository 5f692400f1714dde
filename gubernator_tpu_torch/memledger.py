"""Device-memory ledger (the port of gubernator_tpu/memledger.py).

Every device-resident allocation enrolls here at creation with a probe
closure; the ledger itself stores no tensor references.  Engines rebind
their tensors (grow, restore), so a probe re-reads the live attributes
at snapshot time and returns the current byte count (a tensor's
``nbytes``): accounted bytes equal the live tensors' at any instant, not
at enrollment time.

Probe contract — a zero-arg callable returning a dict::

    {"bytes": int,            # live bytes, summed over the consumer
     "capacity_rows": int,    # 0 when the consumer has no row notion
     "occupied_rows": int,    # live occupancy counter the tier keeps
     "demand": {...}}         # optional per-consumer rate counters

Probes run OUTSIDE the ledger lock (they take engine/state locks of
their own; ``self._mu`` is leaf-ranked in the lock hierarchy), so a
probe must never call back into the ledger.

The advisor (``advise``) is the headline deliverable: a "One Pool, Two
Caches"-style water-filling over the measured demand vector.  It is a
recommendation only — nothing repartitions live.  Each advisable
consumer contributes a marginal-hit-density curve (the hot table's from
the Space-Saving rank distribution analytics exports, everything else
flat from its occupancy + rate counters) and granules of the shared row
budget go to whoever's next granule buys the most hits.
"""
from __future__ import annotations

import os
import threading
from typing import Callable, Dict, List, Optional


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


def _env_int(name: str, default: int, lo: int = 1) -> int:
    raw = os.environ.get(name)
    if not raw:
        return default
    try:
        return max(int(raw), lo)
    except ValueError:
        return default


def _pow2_ceil(n: int) -> int:
    return 1 << max(int(n - 1).bit_length(), 0) if n > 1 else 1


class MemoryLedger:
    """Per-instance registry of device (and host) memory consumers."""

    def __init__(self, recorder=None):
        self._mu = threading.Lock()
        self._probes: Dict[str, tuple] = {}  # guarded-by: self._mu
        self._enabled = True  # guarded-by: self._mu
        self._pressure_hi = False  # guarded-by: self._mu
        self._published: set = set()  # guarded-by: self._mu
        self._recorder = recorder
        self.pressure_target = _env_float("GUBER_MEM_PRESSURE", 0.85)
        self.advise_floor = _env_int("GUBER_MEM_ADVISE_FLOOR", 64)

    # ------------------------------------------------------------------
    # enrollment
    def enroll(self, consumer: str,
               probe: Callable[[], dict],
               host: bool = False,
               advisable: bool = False) -> None:
        """Register (or re-register) a consumer.  ``host=True`` keeps it
        out of the device ledger (cold store, numpy pools, sketch);
        ``advisable=True`` marks its row capacity as a knob the advisor
        may move."""
        with self._mu:
            self._probes[consumer] = (probe, bool(host), bool(advisable))

    def release(self, consumer: str) -> bool:
        """Drop a consumer at stand-down; True if it was enrolled."""
        with self._mu:
            return self._probes.pop(consumer, None) is not None

    def consumers(self) -> List[str]:
        with self._mu:
            return sorted(self._probes)

    # ------------------------------------------------------------------
    # bench A/B toggle: a suspended ledger answers snapshots with an
    # empty plane but keeps its enrollment table, so resume is exact.
    def suspend(self) -> None:
        with self._mu:
            self._enabled = False

    def resume(self) -> None:
        with self._mu:
            self._enabled = True

    @property
    def enabled(self) -> bool:
        # lock-free: GIL-atomic single read of a bool
        return self._enabled

    # ------------------------------------------------------------------
    # snapshot
    def snapshot(self) -> dict:
        """Bytes, rows, occupancy and the demand vector, per consumer.

        The enrollment table is copied under the leaf lock, then probes
        run unlocked — they acquire engine/state locks themselves."""
        with self._mu:
            enabled = self._enabled
            probes = dict(self._probes)
        out: Dict[str, dict] = {}
        dev_bytes = host_bytes = 0
        w_occ = w_cap = 0.0
        if enabled:
            for name in sorted(probes):
                probe, host, advisable = probes[name]
                try:
                    rec = dict(probe())
                except Exception as e:  # pragma: no cover - defensive
                    out[name] = {"error": f"{type(e).__name__}: {e}",
                                 "host": host}
                    continue
                rec.setdefault("bytes", 0)
                rec.setdefault("capacity_rows", 0)
                rec.setdefault("occupied_rows", 0)
                rec["host"] = host
                rec["advisable"] = advisable
                out[name] = rec
                if host:
                    host_bytes += int(rec["bytes"])
                else:
                    dev_bytes += int(rec["bytes"])
                    if rec["capacity_rows"] > 0:
                        w_cap += float(rec["bytes"])
                        frac = (min(rec["occupied_rows"],
                                    rec["capacity_rows"])
                                / rec["capacity_rows"])
                        w_occ += float(rec["bytes"]) * frac
        pressure = (w_occ / w_cap) if w_cap > 0 else 0.0
        return {"enabled": enabled,
                "consumers": out,
                "device_bytes": dev_bytes,
                "host_bytes": host_bytes,
                "pressure": pressure,
                "pressure_target": self.pressure_target}

    # ------------------------------------------------------------------
    # pressure plane
    def pressure_sample(self) -> tuple:
        """``(pressure, target)`` for the threshold-kind ``hbm_pressure``
        SLO.  Edge-triggers one ``memory_pressure`` flight-recorder
        event per excursion above target — before table-full or
        cap-overflow starts demoting."""
        snap = self.snapshot()
        p = snap["pressure"]
        hot = p > self.pressure_target
        with self._mu:
            was = self._pressure_hi
            self._pressure_hi = hot
        if hot and not was and self._recorder is not None:
            top = {name: round(
                       rec.get("occupied_rows", 0)
                       / max(rec.get("capacity_rows", 1), 1), 4)
                   for name, rec in snap["consumers"].items()
                   if not rec.get("host") and "error" not in rec
                   and rec.get("capacity_rows", 0) > 0}
            self._recorder.record("memory_pressure",
                                  pressure=round(p, 4),
                                  target=self.pressure_target,
                                  device_bytes=snap["device_bytes"],
                                  occupancy=top)
        return p, self.pressure_target

    # ------------------------------------------------------------------
    # gauges
    def republish(self, metrics) -> None:
        """Refresh the two ledger gauge families; departed consumers'
        label sets are removed so a released tier doesn't linger at its
        last value."""
        if metrics is None:
            return
        snap = self.snapshot()
        seen = set()
        for name, rec in snap["consumers"].items():
            if "error" in rec:
                continue
            metrics.memledger_bytes.labels(consumer=name).set(
                rec["bytes"])
            metrics.memledger_rows.labels(
                consumer=name, state="capacity").set(rec["capacity_rows"])
            metrics.memledger_rows.labels(
                consumer=name, state="occupied").set(rec["occupied_rows"])
            seen.add(name)
        with self._mu:
            gone = self._published - seen
            self._published = seen
        for name in gone:
            try:
                metrics.memledger_bytes.remove(name)
                metrics.memledger_rows.remove(name, "capacity")
                metrics.memledger_rows.remove(name, "occupied")
            except KeyError:
                pass

    # ------------------------------------------------------------------
    # the advisor
    def advise(self, total_rows: Optional[int] = None,
               granule: Optional[int] = None) -> dict:
        """Water-fill the shared row budget over the demand vector.

        ``total_rows`` defaults to the sum of the advisable consumers'
        current capacities (the budget a repartition could move around);
        the dryrun passes the combined configured budget explicitly.
        Returns the current split, the advised split (raw and pow2-
        rounded), and the demand evidence — a recommendation, never a
        live repartition."""
        snap = self.snapshot()
        cands: Dict[str, dict] = {
            name: rec for name, rec in snap["consumers"].items()
            if rec.get("advisable") and "error" not in rec}
        current = {n: int(r["capacity_rows"]) for n, r in cands.items()}
        if total_rows is None:
            total_rows = sum(current.values())
        floor = max(1, self.advise_floor)
        gran = max(1, granule if granule is not None else floor)
        advised = {n: min(floor, total_rows) for n in cands}
        budget = total_rows - sum(advised.values())
        densities = {n: self._density_fn(n, r) for n, r in cands.items()}
        while budget >= gran and densities:
            best, best_d = None, -1.0
            for n, fn in densities.items():
                d = fn(advised[n])
                if d > best_d:
                    best, best_d = n, d
            if best is None or best_d <= 0.0:
                break
            advised[best] += gran
            budget -= gran
        if budget > 0 and advised:
            # leftover rows go to the steepest remaining curve
            best = max(advised,
                       key=lambda n: densities[n](advised[n]))
            advised[best] += budget
        return {"total_rows": int(total_rows),
                "floor_rows": floor,
                "granule_rows": gran,
                "current": current,
                "advised": advised,
                "advised_pow2": {n: _pow2_ceil(v)
                                 for n, v in advised.items()},
                "demand": {n: r.get("demand", {})
                           for n, r in cands.items()},
                "pressure": snap["pressure"]}

    @staticmethod
    def _density_fn(name: str, rec: dict) -> Callable[[int], float]:
        """Marginal hit density at row index r for one consumer.

        A ``demand.ranks`` vector (the Space-Saving rank distribution,
        descending counts) gives a real curve with a harmonic tail
        extrapolation past the sketch's horizon; otherwise the demand
        rate spreads flat over the occupied rows and falls to zero past
        a 2x headroom band — rows beyond twice the live working set buy
        nothing."""
        demand = rec.get("demand", {}) or {}
        ranks = demand.get("ranks")
        if ranks:
            ranks = [max(float(v), 0.0) for v in ranks]
            n = len(ranks)
            tail = ranks[-1] if ranks[-1] > 0 else 0.0

            def density(r: int, _ranks=ranks, _n=n, _tail=tail) -> float:
                if r < _n:
                    return _ranks[r]
                return _tail * _n / (r + 1)

            return density
        rate = 0.0
        for k in ("hit_rate", "rate", "promote_rate", "fold_rate"):
            if demand.get(k):
                rate = float(demand[k])
                break
        occ = max(int(rec.get("occupied_rows", 0)), 0)
        if rate <= 0.0 or occ == 0:
            return lambda r: 0.0
        flat = rate / occ

        def density(r: int, _flat=flat, _occ=occ) -> float:
            return _flat if r < 2 * _occ else 0.0

        return density
