"""The scenario lab: the port's copy of gubernator_tpu/scenarios.py, a
seeded, replayable workload DSL with exact oracles.

- :class:`ScenarioSpec` — a pure-data description (sources, faults,
  clients, clock skew, oracles) that round-trips losslessly through
  JSON and compiles to a byte-deterministic schedule under its seed.
- source primitives — ``zipf_drift`` (skew exponent drifts a0→a1 over
  the run), ``diurnal`` (sinusoidal volume), ``flash_crowd`` (a single
  celebrity key erupts for a tick window), ``tenant_mix`` (weighted
  tenant populations, e.g. 90/10 abuse), ``uniform``, and ``replay``
  (a recorded trace-plane JSONL capture re-emitted as traffic).
- :class:`ScenarioRunner` — drives the compiled schedule against a real
  port stack (``object``, ``wire``, ``clustered``, ``mesh``,
  ``tiered``) on ``device`` (``cuda`` by default) on a **virtual
  clock** (NOW0 + tick·tick_ms, plus per-client skew), arms faults from
  the ``faults.py`` catalog on cue, then judges with exact oracles:
  decision-stream parity against the pure-Python ``Oracle`` on a host
  reference lane (oracle.OracleEngine), exact hit conservation after
  reconcile, Jain's fairness index + tenant-ledger conservation,
  SLO-verdict snapshots, the fleet audit's folded drift, and end-to-end
  trace assembly.  The mesh stack runs two shards: two cards where two
  are visible, else ``[device] * 2`` on one (its row says which).

Determinism contract: the issue loop is single-threaded and
synchronous, all randomness flows from ``np.random.default_rng(seed)``
consumed in (tick, source) order, and the clock is virtual — the same
spec + seed replays a byte-identical decision stream (the sha256 over
``status|remaining|error`` per response, in issue order; ``reset_time``
is a clock artifact and deliberately excluded so clock-skew scenarios
can assert byte-identity against an unskewed twin).  The same spec
compiles to the same schedule as in the JAX package.

The spec library is the repository's ``scenarios/`` directory
(GUBER_SCENARIO_DIR overrides it); ``cmd/scenario_lab.py`` is the CLI.
"""
from __future__ import annotations

import hashlib
import json
import math
import os
import threading
import time
from dataclasses import asdict, dataclass, field, replace
from functools import lru_cache
from typing import Dict, List, Optional

import numpy as np

from .types import MAX_BATCH_SIZE, Algorithm, Behavior, RateLimitRequest

#: schema version stamped into every serialized spec and result row
SCENARIO_SCHEMA = 1

#: virtual-clock epoch, pinned far from the wall clock so any lane
#: substituting its own clock for the caller's time base breaks the
#: parity / conservation oracles visibly (JAX's value)
NOW0 = 1_790_000_000_000

#: stacks a scenario can target (ScenarioRunner._build dispatches)
STACKS = ("object", "wire", "clustered", "mesh", "tiered")

#: source primitive catalog (kind -> one-line contract); SCENARIOS.md
#: documents the full per-kind parameter grammar
SOURCE_KINDS = {
    "zipf_drift": "Zipf keys, exponent drifts a0->a1 across the run",
    "diurnal": "uniform keys, volume modulated by a sinusoidal wave",
    "flash_crowd": "uniform background + a celebrity key eruption",
    "tenant_mix": "weighted tenant populations (e.g. 90/10 abuse)",
    "uniform": "uniform keys at constant volume",
    "replay": "re-emit a recorded trace-plane JSONL capture",
}

#: oracle catalog (name -> one-line contract)
ORACLE_KINDS = {
    "parity": "decision digest == the same schedule on an "
              "Oracle-backed reference lane",
    "conservation": "sum(admitted hits) == limit - remaining, exactly, "
                    "for every token key after reconcile",
    "fairness": "Jain's index over per-tenant admitted hits + exact "
                "tenant-ledger conservation vs the analytics plane",
    "slo": "SLO burn-engine verdict snapshot (breaches recorded; "
           "expect.slo_clean makes breaches a failure)",
    "trace_assembly": "force-sampled spans assemble into >=1 "
                      "multi-span trace with a wave child",
    "fleet_audit": "the live conservation auditors' folded drift "
                   "(fleet.fold_audits over every daemon's own "
                   "/debug/audit vector) drains to zero post-heal",
}

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def default_scenario_dir() -> str:
    """The spec library directory (GUBER_SCENARIO_DIR overrides)."""
    return os.environ.get("GUBER_SCENARIO_DIR") \
        or os.path.join(_REPO_ROOT, "scenarios")


def env_fast() -> bool:
    """GUBER_SCENARIO_FAST=1 forces fast mode in every lab entry."""
    return os.environ.get("GUBER_SCENARIO_FAST", "0") == "1"


def env_seed() -> Optional[int]:
    """GUBER_SCENARIO_SEED overrides every spec's seed (sweep knob)."""
    v = os.environ.get("GUBER_SCENARIO_SEED", "")
    return int(v) if v else None


# ---------------------------------------------------------------------------
# spec


@dataclass
class ScenarioSpec:
    """A pure-data scenario description.  Everything JSON-native —
    sources/faults stay plain dicts so ``to_dict``/``from_dict`` is a
    lossless round trip by construction."""

    name: str
    description: str = ""
    stack: str = "object"            # one of STACKS
    seed: int = 1
    ticks: int = 12
    tick_ms: int = 500               # virtual ms per tick
    clients: int = 2                 # round-robin request issuers
    daemons: int = 3                 # clustered stack size
    skew_ms: List[int] = field(default_factory=list)  # per-client offset
    sources: List[dict] = field(default_factory=list)
    faults: List[dict] = field(default_factory=list)  # timeline entries
    oracles: List[str] = field(default_factory=list)
    expect: dict = field(default_factory=dict)   # oracle thresholds
    fast: dict = field(default_factory=dict)     # fast-mode overrides

    def to_dict(self) -> dict:
        d = {"schema": SCENARIO_SCHEMA}
        d.update(asdict(self))
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ScenarioSpec":
        d = dict(d)
        schema = d.pop("schema", SCENARIO_SCHEMA)
        if schema != SCENARIO_SCHEMA:
            raise ValueError(f"scenario schema {schema} != "
                             f"{SCENARIO_SCHEMA}")
        known = set(cls.__dataclass_fields__)
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown scenario keys: {sorted(unknown)}")
        spec = cls(**d)
        spec.validate()
        return spec

    def validate(self) -> None:
        if self.stack not in STACKS:
            raise ValueError(f"unknown stack {self.stack!r} "
                             f"(one of {STACKS})")
        for src in self.sources:
            if src.get("kind") not in SOURCE_KINDS:
                raise ValueError(f"unknown source kind "
                                 f"{src.get('kind')!r}")
        for o in self.oracles:
            if o not in ORACLE_KINDS:
                raise ValueError(f"unknown oracle {o!r}")
        if self.skew_ms and len(self.skew_ms) != self.clients:
            raise ValueError("skew_ms must list one offset per client")
        for f in self.faults:
            if "arm" not in f and not f.get("clear"):
                raise ValueError(f"fault entry needs arm or clear: {f}")

    def with_fast(self) -> "ScenarioSpec":
        """Apply the spec's ``fast`` overrides (ticks/clients/daemons
        plus a ``rows_scale`` multiplier on every source's volume) —
        the CI-speed twin of the full scenario, same grammar."""
        if not self.fast:
            return self
        over = {k: v for k, v in self.fast.items()
                if k in ("ticks", "tick_ms", "clients", "daemons")}
        spec = replace(self, **over, fast={})
        scale = float(self.fast.get("rows_scale", 1.0))
        if scale != 1.0:
            srcs = []
            for src in spec.sources:
                s = dict(src)
                for k in ("rows", "crowd_rows"):
                    if k in s:
                        s[k] = max(1, int(round(s[k] * scale)))
                srcs.append(s)
            spec = replace(spec, sources=srcs)
        if spec.skew_ms and len(spec.skew_ms) != spec.clients:
            spec = replace(
                spec, skew_ms=(list(spec.skew_ms)
                               * spec.clients)[:spec.clients])
        return spec


def load_spec(path: str) -> ScenarioSpec:
    with open(path) as f:
        return ScenarioSpec.from_dict(json.load(f))


def save_spec(spec: ScenarioSpec, path: str) -> None:
    with open(path, "w") as f:
        json.dump(spec.to_dict(), f, indent=2, sort_keys=True)
        f.write("\n")


def load_library(directory: Optional[str] = None) -> List[ScenarioSpec]:
    """Every ``*.json`` spec in the library directory, name-sorted."""
    d = directory or default_scenario_dir()
    specs = []
    for fn in sorted(os.listdir(d)):
        if fn.endswith(".json"):
            specs.append(load_spec(os.path.join(d, fn)))
    return specs


# ---------------------------------------------------------------------------
# source primitives -> request rows


def _tenant_delim() -> str:
    return os.environ.get("GUBER_TENANT_DELIM", "/") or "/"


def _src_req(src: dict, unique_key: str, hits: int,
             name: Optional[str] = None) -> RateLimitRequest:
    algo = (Algorithm.LEAKY_BUCKET if src.get("algorithm") == "leaky"
            else Algorithm.TOKEN_BUCKET)
    beh = (Behavior.GLOBAL if src.get("behavior") == "global"
           else Behavior.BATCHING)
    return RateLimitRequest(
        name=name if name is not None else str(src.get("name", "scn")),
        unique_key=unique_key, hits=int(hits),
        limit=int(src.get("limit", 1_000_000)),
        duration=int(src.get("duration", 3_600_000)),
        algorithm=algo, behavior=beh, burst=int(src.get("burst", 0)))


def _rows_uniform(src, rng, tick, spec):
    rows = int(src.get("rows", 32))
    nk = int(src.get("n_keys", 16))
    ks = rng.integers(0, nk, size=rows)
    h = int(src.get("hits", 1))
    return [_src_req(src, f"u{int(k)}", h) for k in ks]


def _rows_zipf_drift(src, rng, tick, spec):
    rows = int(src.get("rows", 32))
    nk = int(src.get("n_keys", 64))
    a0 = float(src.get("a0", 1.3))
    a1 = float(src.get("a1", a0))
    frac = tick / max(spec.ticks - 1, 1)
    a = max(a0 + (a1 - a0) * frac, 1.01)
    ks = (rng.zipf(a, size=rows) - 1) % nk
    h = int(src.get("hits", 1))
    return [_src_req(src, f"z{int(k)}", h) for k in ks]


def _rows_diurnal(src, rng, tick, spec):
    base = int(src.get("rows", 32))
    period = max(int(src.get("period_ticks", max(spec.ticks, 1))), 1)
    amp = float(src.get("amplitude", 0.5))
    rows = max(int(round(
        base * (1.0 + amp * math.sin(2 * math.pi * tick / period)))), 0)
    nk = int(src.get("n_keys", 16))
    ks = rng.integers(0, nk, size=rows)
    h = int(src.get("hits", 1))
    return [_src_req(src, f"d{int(k)}", h) for k in ks]


def _rows_flash_crowd(src, rng, tick, spec):
    out = _rows_uniform(
        {**src, "rows": src.get("rows", 16)}, rng, tick, spec)
    start = int(src.get("start_tick", spec.ticks // 3))
    stop = int(src.get("stop_tick", 2 * spec.ticks // 3))
    if start <= tick < stop:
        celeb = str(src.get("celebrity", "celebrity"))
        crowd = int(src.get("crowd_rows", 64))
        h = int(src.get("hits", 1))
        out.extend(_src_req(src, celeb, h) for _ in range(crowd))
    return out


def _rows_tenant_mix(src, rng, tick, spec):
    rows = int(src.get("rows", 32))
    tenants = src.get("tenants") or []
    if not tenants:
        return []
    w = np.array([float(t.get("weight", 1)) for t in tenants])
    picks = rng.choice(len(tenants), size=rows, p=w / w.sum())
    delim = _tenant_delim()
    suffix = str(src.get("name", "api"))
    out = []
    for p in picks:
        t = tenants[int(p)]
        nk = int(t.get("n_keys", 4))
        k = int(rng.integers(0, nk))
        out.append(_src_req(
            src, f"k{k}", int(t.get("hits", src.get("hits", 1))),
            name=f"{t['tenant']}{delim}{suffix}"))
    return out


@lru_cache(maxsize=8)
def _load_capture(path: str) -> tuple:
    """Wave spans of a trace-plane JSONL capture (telemetry.
    write_trace_dump format): skip the ``trace_header`` line and
    non-span lines, keep ``(start, size, trace_id)`` per wave span,
    normalized so ``start`` spreads over [0, 1)."""
    waves = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                d = json.loads(line)
            except ValueError:
                continue
            if not isinstance(d, dict) or d.get("kind") == "trace_header":
                continue
            if d.get("name") == "wave" and "start" in d:
                attrs = d.get("attrs") or {}
                waves.append((float(d["start"]),
                              int(attrs.get("size", 1)),
                              str(d.get("trace_id", ""))))
    if not waves:
        raise ValueError(f"capture {path} holds no wave spans")
    waves.sort()
    t0 = waves[0][0]
    span = max(waves[-1][0] - t0, 1e-9)
    return tuple((min((s - t0) / span, 1.0 - 1e-9), size, tid)
                 for s, size, tid in waves)


def _rows_replay(src, rng, tick, spec):
    path = str(src["capture"])
    if not os.path.isabs(path):
        path = os.path.join(_REPO_ROOT, path)
    waves = _load_capture(path)
    nk = int(src.get("n_keys", 16))
    cap = int(src.get("rows_cap", 64))
    scale = float(src.get("rows_scale", 1.0))
    out = []
    for frac, size, tid in waves:
        if int(frac * spec.ticks) != tick:
            continue
        rows = max(1, min(int(round(size * scale)), cap))
        base = int(tid[:8] or "0", 16) if tid else 0
        out.extend(_src_req(src, f"r{(base + i) % nk}", 1)
                   for i in range(rows))
    return out


_SOURCE_FNS = {
    "uniform": _rows_uniform,
    "zipf_drift": _rows_zipf_drift,
    "diurnal": _rows_diurnal,
    "flash_crowd": _rows_flash_crowd,
    "tenant_mix": _rows_tenant_mix,
    "replay": _rows_replay,
}


def compile_schedule(spec: ScenarioSpec) -> List[List[List[RateLimitRequest]]]:
    """ticks x clients request batches, byte-deterministic under the
    spec's seed: one rng, consumed in (tick, source) order, rows dealt
    round-robin to clients, each client call clamped to the wire's
    MAX_BATCH_SIZE."""
    rng = np.random.default_rng(int(spec.seed))
    sched = []
    for tick in range(spec.ticks):
        rows: List[RateLimitRequest] = []
        for src in spec.sources:
            rows.extend(_SOURCE_FNS[src["kind"]](src, rng, tick, spec))
        per_client: List[List[RateLimitRequest]] = \
            [[] for _ in range(max(spec.clients, 1))]
        for i, r in enumerate(rows):
            per_client[i % len(per_client)].append(r)
        sched.append([c[:MAX_BATCH_SIZE] for c in per_client])
    return sched


# ---------------------------------------------------------------------------
# judge tap


class DecisionDigest:
    """sha256 over ``status|remaining|error`` per response, in issue
    order — the canonical decision stream.  ``reset_time`` is a clock
    artifact (it moves with the caller's time base) and is excluded,
    which is exactly what lets clock-skew scenarios assert
    byte-identity against an unskewed twin."""

    def __init__(self) -> None:
        self._h = hashlib.sha256()
        self.rows = 0

    def update(self, status: int, remaining: int, error: str) -> None:
        self._h.update(f"{status}|{remaining}|{error}\n".encode())
        self.rows += 1

    def update_lines(self, lines: List[str]) -> None:
        """Batch form: one hash update per call, not per row."""
        self._h.update("".join(lines).encode())
        self.rows += len(lines)

    def hex(self) -> str:
        return self._h.hexdigest()


class JudgeTap:
    """Per-run bookkeeping for every (request, response) pair — the
    exact state the oracles judge from.  The service-path half,
    ``observe()``, only RETAINS the pair (one list append under an
    uncontended lock): all per-row work — digest, per-key ledgers,
    tenant attribution — happens in ``finalize()`` at settle time,
    off the measured path.  Keeping it O(1) per call is what makes
    the lab's measurements trustworthy, the same discipline as the
    analytics tap (taps copy cheap, attribute later)."""

    def __init__(self, delim: Optional[str] = None) -> None:
        self._mu = threading.Lock()
        self._pending: List[tuple] = []  # guarded-by: self._mu
        self.digest = DecisionDigest()  # guarded-by: self._mu
        self.templates: Dict[str, RateLimitRequest] = {}  # guarded-by: self._mu
        self.admitted: Dict[str, int] = {}  # guarded-by: self._mu
        self.attempted: Dict[str, int] = {}  # guarded-by: self._mu
        #: tenant -> [requests, hits, admitted_hits, over_limit]
        self._tenant_rows: Dict[str, list] = {}  # guarded-by: self._mu
        self.errors: List[str] = []  # guarded-by: self._mu
        self.total = 0  # guarded-by: self._mu
        self.over_limit = 0  # guarded-by: self._mu
        self._delim = delim or _tenant_delim()

    def tenant_of(self, name: str) -> str:
        i = name.find(self._delim)
        return name if i < 0 else name[:i]

    @property
    def tenants(self) -> Dict[str, dict]:
        self.finalize()
        with self._mu:
            return {name: {"requests": r[0], "hits": r[1],
                           "admitted_hits": r[2], "over_limit": r[3]}
                    for name, r in self._tenant_rows.items()}

    def observe(self, reqs, resps, now_ms: int) -> None:
        """Service-path tap: retain and return.  O(1) per call."""
        with self._mu:
            self._pending.append((reqs, resps))

    def finalize(self) -> None:
        """Settle-time attribution of every retained pair, in issue
        order.  Idempotent; every oracle accessor calls it first."""
        with self._mu:
            pending, self._pending = self._pending, []
            if not pending:
                return
            lines: List[str] = []
            line = lines.append
            templates = self.templates
            admitted = self.admitted
            attempted = self.attempted
            tenant_rows = self._tenant_rows
            tcache: Dict[str, list] = {}
            for reqs, resps in pending:
                for req, resp in zip(reqs, resps):
                    st = resp.status
                    err = resp.error
                    line(f"{int(st)}|{int(resp.remaining)}|"
                         f"{err or ''}\n")
                    key = req.key
                    h = req.hits
                    if key not in templates:
                        templates[key] = req
                    attempted[key] = attempted.get(key, 0) + h
                    t = tcache.get(req.name)
                    if t is None:
                        t = tenant_rows.setdefault(
                            self.tenant_of(req.name), [0, 0, 0, 0])
                        tcache[req.name] = t
                    t[0] += 1
                    t[1] += h
                    if err:
                        if len(self.errors) < 32:
                            self.errors.append(f"{key}: {err}")
                    elif st == 0:
                        if h:
                            admitted[key] = admitted.get(key, 0) + h
                            t[2] += h
                    else:
                        self.over_limit += 1
                        t[3] += 1
            self.total += len(lines)
            self.digest.update_lines(lines)


def jain_index(xs: List[float]) -> float:
    """Jain's fairness index (sum x)^2 / (n * sum x^2) — 1.0 is
    perfectly fair, 1/n is one tenant taking everything."""
    xs = [float(x) for x in xs if x > 0]
    if not xs:
        return 1.0
    s = sum(xs)
    return (s * s) / (len(xs) * sum(x * x for x in xs))


# ---------------------------------------------------------------------------
# stack handles


class _StackHandle:
    """A built stack: entry points to issue batches against, the
    underlying instances for judge taps, and teardown."""

    def __init__(self, instances, issue, close, cluster=None) -> None:
        self.instances = instances
        self._issue = issue
        self._close = close
        self.cluster = cluster

    def issue(self, client: int, reqs, now_ms: int):
        return self._issue(client, reqs, now_ms)

    def close(self) -> None:
        self._close()


def _wire_codec():
    from .proto import gubernator_pb2 as pb

    def ser(reqs) -> bytes:
        msg = pb.GetRateLimitsReq()
        for r in reqs:
            m = msg.requests.add()
            m.name = r.name
            m.unique_key = r.unique_key
            m.hits = int(r.hits)
            m.limit = int(r.limit)
            m.duration = int(r.duration)
            m.algorithm = int(r.algorithm)
            m.behavior = int(r.behavior)
            m.burst = int(r.burst)
            if r.created_at:
                m.created_at = int(r.created_at)
        return msg.SerializeToString()

    def de(data: bytes):
        return pb.GetRateLimitsResp.FromString(data).responses

    return ser, de


class ScenarioRunner:
    """Compile a spec, build its stack, drive the schedule on the
    virtual clock, then judge.  Single-threaded by design — determinism
    is the contract, concurrency chaos belongs to the soak tests.

    ``device`` is where every stack it builds serves (``cuda`` unless
    the caller asks for ``cpu``); ``engine`` injects the solo stacks'
    engine (the parity oracle's reference lane: an ``OracleEngine``,
    which touches no device)."""

    #: settle budget for reconcile convergence (wall seconds)
    SETTLE_TIMEOUT_S = 30.0

    def __init__(self, spec: ScenarioSpec, fast: bool = False,
                 engine=None, device: str = "cuda") -> None:
        if fast or env_fast():
            spec = spec.with_fast()
        seed = env_seed()
        if seed is not None:
            spec = replace(spec, seed=seed)
        spec.validate()
        self.spec = spec
        self._engine = engine
        self.device = device
        #: the mesh stack's device list, as built (None elsewhere)
        self.mesh_devices: Optional[List[str]] = None
        self._armed: List[object] = []  # guarded-by: self._fault_mu
        self._fault_mu = threading.Lock()

    # -- stack builders ---------------------------------------------------

    def _build(self) -> _StackHandle:
        return getattr(self, f"_build_{self.spec.stack}")()

    def _solo(self, **cfg_kwargs) -> "object":
        from .config import Config
        from .instance import V1Instance
        cfg = Config(cache_size=cfg_kwargs.pop("cache_size", 1 << 12),
                     sweep_interval_ms=0, device=self.device, **cfg_kwargs)
        return V1Instance(cfg, engine=self._engine)

    def _build_object(self) -> _StackHandle:
        inst = self._solo()
        return _StackHandle(
            [inst],
            lambda c, reqs, now: inst.get_rate_limits(reqs, now_ms=now),
            inst.close)

    def _build_wire(self) -> _StackHandle:
        inst = self._solo()
        ser, de = _wire_codec()

        def issue(c, reqs, now):
            return de(inst.get_rate_limits_wire(ser(reqs), now_ms=now))

        return _StackHandle([inst], issue, inst.close)

    def _build_clustered(self) -> _StackHandle:
        from . import cluster as cluster_mod
        from .config import BehaviorConfig
        cluster = cluster_mod.start(
            self.spec.daemons,
            behaviors=BehaviorConfig(
                batch_wait_ms=5, batch_timeout_ms=400,
                peer_retry_limit=1, peer_retry_backoff_ms=5,
                peer_circuit_threshold=2, peer_circuit_cooldown_ms=250,
                peer_eject_after_ms=300, peer_readmit_after_ms=250,
                global_sync_wait_ms=100),
            device=self.device)
        insts = [cluster.instance_at(i)
                 for i in range(self.spec.daemons)]

        def issue(c, reqs, now):
            return insts[c % len(insts)].get_rate_limits(reqs,
                                                         now_ms=now)

        return _StackHandle(insts, issue, cluster.stop, cluster=cluster)

    def _mesh_device_list(self) -> List[str]:
        """JAX's ``make_mesh(n=2)``: two cards where two are visible,
        else ``[device] * 2``, the two-shard rehearsal on one card (or
        the CPU); the run's row prints the list."""
        if self.device == "cuda":
            import torch

            if torch.cuda.device_count() >= 2:
                return ["cuda:0", "cuda:1"]
        return [self.device] * 2

    def _build_mesh(self) -> _StackHandle:
        from .mesh import make_mesh
        self.mesh_devices = self._mesh_device_list()
        had = os.environ.get("GUBER_MESH_GLOBAL_CAP")
        if had is None:
            os.environ["GUBER_MESH_GLOBAL_CAP"] = "256"
        from .config import BehaviorConfig, Config
        from .instance import V1Instance
        try:
            inst = V1Instance(
                Config(cache_size=1 << 12, sweep_interval_ms=0,
                       global_mode="mesh", batch_rows=64,
                       device=self.device,
                       behaviors=BehaviorConfig(global_sync_wait_ms=100)),
                mesh=make_mesh(self.mesh_devices))
        except BaseException:
            if had is None:
                os.environ.pop("GUBER_MESH_GLOBAL_CAP", None)
            raise

        def close():
            inst.close()
            if had is None:
                os.environ.pop("GUBER_MESH_GLOBAL_CAP", None)

        return _StackHandle(
            [inst],
            lambda c, reqs, now: inst.get_rate_limits(reqs, now_ms=now),
            close)

    def _build_tiered(self) -> _StackHandle:
        inst = self._solo(cache_size=256, tier_cold=True)
        return _StackHandle(
            [inst],
            lambda c, reqs, now: inst.get_rate_limits(reqs, now_ms=now),
            inst.close)

    # -- fault timeline ---------------------------------------------------

    def _fault_spec(self, raw: str, handle: _StackHandle) -> str:
        """Substitute ``{addr:N}`` placeholders with daemon N's gRPC
        address (clustered stacks only)."""
        out = raw
        while "{addr:" in out:
            i = out.index("{addr:")
            j = out.index("}", i)
            n = int(out[i + 6:j])
            if handle.cluster is None:
                raise ValueError(f"{raw!r} needs a clustered stack")
            out = out[:i] + handle.cluster.grpc_address(n) + out[j + 1:]
        return out

    def _faults_at(self, tick: int, handle: _StackHandle) -> None:
        for f in self.spec.faults:
            if int(f.get("at_tick", 0)) != tick:
                continue
            on = f.get("on", "all")
            targets = (handle.instances if on == "all"
                       else [handle.instances[i] for i in on])
            if f.get("clear"):
                for inst in targets:
                    inst.faults.clear()
                with self._fault_mu:
                    self._armed = [i for i in self._armed
                                   if i not in targets]
            else:
                spec = self._fault_spec(f["arm"], handle)
                seed = int(f.get("seed", self.spec.seed))
                for inst in targets:
                    inst.faults.arm(spec, seed=seed)
                with self._fault_mu:
                    self._armed.extend(targets)

    def _clear_faults(self, handle: _StackHandle) -> None:
        with self._fault_mu:
            armed, self._armed = self._armed, []
        for inst in armed:
            inst.faults.clear()

    # -- oracles ----------------------------------------------------------

    def _oracle_parity(self, judge: JudgeTap) -> dict:
        """Replay the identical schedule on a reference lane — a solo
        object instance on the host whose engine is the pure-Python
        exact-integer Oracle — and byte-compare decision digests."""
        from .oracle import OracleEngine
        ref = ScenarioRunner(replace(self.spec, stack="object",
                                     faults=[], oracles=[]),
                             engine=OracleEngine(), device="cpu")
        handle = ref._build()
        try:
            rj = JudgeTap(delim=judge._delim)
            ref._drive(handle, rj)
            rj.finalize()
        finally:
            handle.close()
        ok = rj.digest.hex() == judge.digest.hex()
        return {"ok": ok, "reference_digest": rj.digest.hex(),
                "rows": rj.digest.rows}

    def _probe(self, handle: _StackHandle, tmpl: RateLimitRequest,
               now_ms: int, entry: int = 0):
        """A hits=0 status query for one key (debits nothing)."""
        q = replace(tmpl, hits=0, created_at=0)
        return handle.issue(entry, [q], now_ms)[0]

    def _oracle_conservation(self, handle: _StackHandle,
                             judge: JudgeTap, end_now: int,
                             fast: bool) -> dict:
        """Exact hit conservation for every non-GLOBAL token key:
        ``limit - remaining`` at a hits=0 probe must equal the judge's
        admitted-hit ledger, after degraded reconcile converges.  The
        virtual probe time sits inside every bucket's window (durations
        dwarf the scenario span), so remaining reflects debits only.
        Probes rotate through EVERY entry point and must agree — the
        cross-daemon observability from the resilience suite, and the
        light traffic each caller's routing gate needs to readmit a
        healed peer before its queued degraded hits can flush."""
        keys = [k for k, t in judge.templates.items()
                if int(t.algorithm) == int(Algorithm.TOKEN_BUCKET)
                and not (int(t.behavior) & int(Behavior.GLOBAL))]
        entries = max(len(handle.instances), 1)

        def audit():
            bad = []
            for k in keys:
                t = judge.templates[k]
                want = judge.admitted.get(k, 0)
                for e in range(entries):
                    r = self._probe(handle, t, end_now, entry=e)
                    debited = int(t.limit) - int(r.remaining)
                    if debited != want or r.error:
                        bad.append({"key": k, "entry": e,
                                    "debited": debited,
                                    "admitted": want,
                                    "error": r.error or ""})
            return bad

        # the budget is a deadline, not a sleep: a settled run exits on
        # the first audit, so fast mode only pays this under real load
        deadline = time.perf_counter() + \
            (15.0 if fast else self.SETTLE_TIMEOUT_S)
        bad = audit()
        while bad and time.perf_counter() < deadline:
            for inst in handle.instances:
                gm = getattr(inst, "global_manager", None)
                loop = getattr(gm, "_hits_loop", None)
                if loop is not None:
                    loop.poke()
            time.sleep(0.2)
            bad = audit()
        return {"ok": not bad, "keys": len(keys),
                "mismatches": bad[:5]}

    def _oracle_fairness(self, handle: _StackHandle,
                         judge: JudgeTap) -> dict:
        """Jain's index over per-tenant admitted hits, plus exact
        tenant-ledger conservation: the analytics plane's per-tenant
        (requests, hits) must equal the judge's own counts.  Solo
        stacks only for the exact cross-check — forwarding counts rows
        on both sides."""
        jain = jain_index([t["admitted_hits"]
                           for t in judge.tenants.values()])
        out = {"jain_index": round(jain, 6),
               "tenants": len(judge.tenants)}
        floor = float(self.spec.expect.get("jain_min", 0.0))
        ceil = float(self.spec.expect.get("jain_max", 1.0))
        out["ok"] = floor <= jain <= ceil
        ana = getattr(handle.instances[0], "analytics", None)
        if ana is not None and len(handle.instances) == 1:
            ana.flush(timeout=10)
            snap = ana.tenants_snapshot()
            mism = []
            if snap.get("enabled"):
                led = snap.get("tenants", {})
                for name, mine in judge.tenants.items():
                    got = led.get(name)
                    if (got is None
                            or got["requests"] != mine["requests"]
                            or got["hits"] != mine["hits"]):
                        mism.append({"tenant": name, "judge": mine,
                                     "ledger": got})
                out["ledger_requests"] = \
                    snap.get("totals", {}).get("requests")
                out["ledger_conserved"] = not mism
                out["ledger_mismatches"] = mism[:5]
                out["ok"] = out["ok"] and not mism
        return out

    def _oracle_slo(self, handle: _StackHandle) -> dict:
        """SLO burn-engine verdict snapshot: tick every engine once,
        record breached series.  Breaches are telemetry, not failure —
        unless the spec sets ``expect.slo_clean``."""
        breached = []
        present = False
        for inst in handle.instances:
            eng = getattr(inst, "slo", None)
            if eng is None:
                continue
            present = True
            eng.tick()
            breached.extend(v["slo"] for v in eng.verdicts()
                            if v.get("breached"))
        ok = present and (not breached
                          if self.spec.expect.get("slo_clean") else True)
        return {"ok": ok, "engines": present,
                "breached": sorted(set(breached))}

    def _oracle_fleet_audit(self, handle: _StackHandle,
                            fast: bool) -> dict:
        """The live auditors' verdict: fold every daemon's
        OWN audit vector (instance.audit_doc — the same document
        GET /debug/audit serves) with fleet.fold_audits and require
        fleet drift == 0 once reconcile settles.  No test-harness
        walking: the daemons prove conservation themselves.  Stacks
        without a GLOBAL backend trivially conserve (all-zero
        vectors), so the oracle is armed per-spec on clustered/mesh
        scenarios where the flush discipline actually runs."""
        from . import fleet

        def fold():
            return fleet.fold_audits(
                [inst.audit_doc() for inst in handle.instances])

        deadline = time.perf_counter() + \
            (15.0 if fast else self.SETTLE_TIMEOUT_S)
        f = fold()
        while not f["conserved"] and time.perf_counter() < deadline:
            for inst in handle.instances:
                gm = getattr(inst, "global_manager", None)
                loop = getattr(gm, "_hits_loop", None)
                if loop is not None:
                    loop.poke()
            time.sleep(0.2)
            f = fold()
        ring = fleet.ring_verdict(
            [inst.audit_doc() for inst in handle.instances])
        return {"ok": f["conserved"] and ring["consistent"],
                "drift": f["drift"],
                "injected": f["totals"]["injected"],
                "applied": f["totals"]["applied"],
                "lost": f["totals"]["lost"],
                "max_drain_age_s": f["max_drain_age_s"],
                "ring_consistent": ring["consistent"]}

    def _oracle_trace_assembly(self, handle: _StackHandle) -> dict:
        """Force-sampled spans from every instance must assemble into
        at least one multi-span trace carrying a wave child — the
        end-to-end proof that the trace plane stitched the run."""
        from .tracing import assemble
        spans = []
        for inst in handle.instances:
            spans.extend(inst.span_recorder.spans())
        traces = assemble(spans)

        def _stitched_wave(nodes, depth=0):
            # a wave span BELOW a root proves parent/child stitching
            for n in nodes:
                if depth > 0 and str(n.get("name", "")).startswith(
                        "wave"):
                    return True
                if _stitched_wave(n.get("children") or [], depth + 1):
                    return True
            return False

        good = [t for t in traces
                if t["spans"] >= 2 and _stitched_wave(t["roots"])]
        return {"ok": bool(good), "spans": len(spans),
                "traces": len(traces), "assembled": len(good)}

    # -- drive ------------------------------------------------------------

    def _skew(self, client: int) -> int:
        return int(self.spec.skew_ms[client]) if self.spec.skew_ms else 0

    def _drive(self, handle: _StackHandle, judge: JudgeTap) -> None:
        sched = compile_schedule(self.spec)
        for tick, per_client in enumerate(sched):
            self._faults_at(tick, handle)
            now = NOW0 + tick * self.spec.tick_ms
            for ci, reqs in enumerate(per_client):
                if not reqs:
                    continue
                c_now = now + self._skew(ci)
                resps = handle.issue(ci, reqs, c_now)
                judge.observe(reqs, resps, c_now)

    def run(self, fast: bool = False) -> dict:
        spec = self.spec
        t0 = time.perf_counter()
        handle = self._build()
        try:
            if "trace_assembly" in spec.oracles:
                for inst in handle.instances:
                    inst.span_recorder.sample = 1.0
            rec = handle.instances[0].recorder
            rec.record("scenario_started", name=spec.name,
                       stack=spec.stack, seed=spec.seed,
                       ticks=spec.ticks)
            judge = JudgeTap()
            self._drive(handle, judge)
            judge.finalize()
            # settle: faults off first, then judge in an order that
            # keeps the exact cross-checks exact — the fairness ledger
            # snapshot must land BEFORE conservation's hits=0 probes
            # add rows to it
            self._clear_faults(handle)
            end_now = NOW0 + spec.ticks * spec.tick_ms
            oracles: Dict[str, dict] = {}
            if "fairness" in spec.oracles:
                oracles["fairness"] = self._oracle_fairness(handle,
                                                            judge)
            if "parity" in spec.oracles:
                oracles["parity"] = self._oracle_parity(judge)
            if "conservation" in spec.oracles:
                oracles["conservation"] = self._oracle_conservation(
                    handle, judge, end_now, fast)
            if "slo" in spec.oracles:
                oracles["slo"] = self._oracle_slo(handle)
            if "fleet_audit" in spec.oracles:
                oracles["fleet_audit"] = self._oracle_fleet_audit(
                    handle, fast)
            if "trace_assembly" in spec.oracles:
                oracles["trace_assembly"] = \
                    self._oracle_trace_assembly(handle)
            ok = (not judge.errors
                  and all(o["ok"] for o in oracles.values()))
            row = {
                "schema": SCENARIO_SCHEMA,
                "name": spec.name, "stack": spec.stack,
                "seed": spec.seed, "ticks": spec.ticks,
                "device": self.device,
                "requests": judge.total,
                "admitted_hits": sum(judge.admitted.values()),
                "over_limit": judge.over_limit,
                "error_rows": len(judge.errors),
                "errors": judge.errors[:5],
                "keys": len(judge.templates),
                "decision_digest": judge.digest.hex(),
                "oracles": oracles, "ok": ok,
                "wall_ms": round(
                    (time.perf_counter() - t0) * 1e3, 3),
            }
            if "fairness" in oracles:
                row["jain_index"] = oracles["fairness"]["jain_index"]
            if self.mesh_devices is not None:
                row["mesh_devices"] = list(self.mesh_devices)
            rec.record("scenario_finished", name=spec.name, ok=ok,
                       requests=judge.total,
                       digest=row["decision_digest"][:16])
            m = handle.instances[0].metrics
            m.scenario_runs.labels(
                verdict="ok" if ok else "failed").inc()
            return row
        finally:
            self._clear_faults(handle)
            handle.close()


def run_scenarios(specs: List[ScenarioSpec], fast: bool = False,
                  progress=None, device: str = "cuda") -> dict:
    """Run a spec list on ``device``; the aggregate document
    ``cmd/scenario_lab.py`` prints."""
    rows: Dict[str, dict] = {}
    for spec in specs:
        if progress is not None:
            progress(spec)
        rows[spec.name] = ScenarioRunner(spec, fast=fast,
                                         device=device).run(fast=fast)
    return {"schema": SCENARIO_SCHEMA,
            "scenarios": rows,
            "count": len(rows),
            "all_ok": all(r["ok"] for r in rows.values())}
