"""The port's fleet audit (fleet.py) against the JAX package's on the
CPU: the audit tap's ledger, the drift bound and its gate, the pure
folds (``fold_audits``, ``ring_verdict``, ``RingWatch``, the merges of
top keys, tenants, SLOs, memory and health) on the same seeded
documents, and the audit documents of a port pair and a JAX pair fed
the same GLOBAL stream, through a degraded outage (parked hits) to
recovery: equal counters and folds at every stage.  Exact throughout."""
import json
import time
import urllib.request

import numpy as np
import pytest

from gubernator_tpu import fleet as jf
from gubernator_tpu_torch import fleet as pf
from gubernator_tpu_torch.config import BehaviorConfig, DaemonConfig
from gubernator_tpu_torch.types import Behavior, RateLimitRequest

NOW0 = 1_791_000_000_000


class _Recorder:
    def __init__(self):
        self.events = []

    def record(self, kind, **fields):
        self.events.append(dict(fields, kind=kind))


def tap_script(tap):
    tap.inject(100)
    tap.inject(40, degraded=True)
    tap.inject(0)
    tap.inject(-5, degraded=True)
    tap.apply(60, 10)
    tap.apply(30, absorbed=True)
    tap.apply(0, 3)
    tap.lose(20, deg=30)
    tap.lose(-1)
    return tap.snapshot()


def test_audit_tap_equals_jax():
    got = tap_script(pf.AuditTap())
    assert got == tap_script(jf.AuditTap())
    assert got["injected"] == got["applied"] + got["lost"] + 30
    assert got["absorbed"] == 30 and got["deg_applied"] == 30


@pytest.mark.parametrize("wait_ms,env", [(100, ""), (40, ""), (500, ""),
                                         (100, "2s"), (100, "junk"),
                                         (100, "300ms")])
def test_drift_bound_equals_jax(wait_ms, env, monkeypatch):
    from gubernator_tpu.config import BehaviorConfig as JaxBehaviors

    monkeypatch.setenv("GUBER_FLEET_DRIFT_BOUND", env)
    assert pf.drift_bound_s(BehaviorConfig(global_sync_wait_ms=wait_ms)) \
        == jf.drift_bound_s(JaxBehaviors(global_sync_wait_ms=wait_ms))


@pytest.mark.parametrize("value", ["", "1", "0", "no"])
def test_audit_gate_equals_jax(value, monkeypatch):
    monkeypatch.setenv("GUBER_FLEET_AUDIT", value)
    assert pf.audit_enabled() == jf.audit_enabled()


def audit_docs(seed, n=3):
    """Seeded /debug/audit documents: backlogs, losses, ages, a mesh
    lane on some, memberships that agree or not, ejected peers."""
    rng = np.random.default_rng(seed)
    members = ["a:1", "b:1", "c:1"]
    docs = []
    for i in range(n):
        inj = int(rng.integers(0, 1000))
        backlog = int(rng.integers(0, 50)) if rng.random() < 0.5 else 0
        queued = int(rng.integers(0, backlog + 1))
        lost = int(rng.integers(0, backlog - queued + 1))
        g = {"injected": inj, "applied": inj - backlog,
             "deg_injected": 5, "deg_applied": 3, "absorbed": 7,
             "lost": lost, "queued": queued, "deg_queued": 1,
             "backlog": backlog, "in_flight": backlog - queued - lost,
             "deg_pending": 2}
        lanes = {"global": g}
        drift = backlog
        if rng.random() < 0.3:
            mb = int(rng.integers(0, 9))
            lanes["mesh"] = {"injected": mb + 50, "folded": 50,
                             "backlog": mb}
            drift += mb
        mem = members if rng.random() < 0.8 else members[:2]
        ej = ["c:1"] if rng.random() < 0.2 else []
        docs.append({"instance": members[i], "enabled": True,
                     "drift": drift, "conserved": drift == 0,
                     "lost": lost,
                     "drain_age_s": float(rng.random() * 3),
                     "bound_s": 0.2, "flush_window_ms": int(
                         rng.choice([100, 200])),
                     "lanes": lanes,
                     "ring": {"generation": int(rng.integers(0, 9)),
                              "self": members[i], "membership": mem,
                              "routing": [a for a in mem if a not in ej],
                              "ejected": ej}})
    return docs


@pytest.mark.parametrize("seed", range(6))
def test_audit_folds_and_ring_equal_jax(seed):
    docs = audit_docs(seed)
    assert pf.fold_audits(docs) == jf.fold_audits(docs)
    assert pf.ring_verdict(docs) == jf.ring_verdict(docs)
    health = [{"status": "healthy", "peer_count": 3},
              {"status": "unhealthy", "peer_count": 2}, {}]
    assert pf.merge_status(health, docs) == jf.merge_status(health, docs)
    assert pf.merge_status(health) == jf.merge_status(health)
    f = pf.fold_audits(docs)
    assert f["drift"] == sum(d["drift"] for d in docs)


def test_ring_watch_latches_as_jax():
    seqs = [audit_docs(s) for s in range(8)]
    got = []
    for mod in (pf, jf):
        rec, w = _Recorder(), mod.RingWatch()
        verdicts = [w.check(d, recorder=rec) for d in seqs]
        verdicts.append(w.check(seqs[0]))  # without a recorder
        got.append((verdicts, rec.events))
    assert got[0] == got[1]
    kinds = [e["kind"] for e in got[0][1]]
    assert kinds and all(a != b for a, b in zip(kinds, kinds[1:]))


def slo_docs(seed):
    rng = np.random.default_rng(seed)
    docs = []
    for _ in range(3):
        rows = []
        for slo in ("error_ratio", "decision_p99", "tenant_shed_ratio"):
            r = {"slo": slo, "kind": "ratio", "objective": 0.999,
                 "fast_burn": float(rng.random() * 4),
                 "slow_burn": float(rng.random() * 4),
                 "breached": bool(rng.random() < 0.3)}
            if slo == "tenant_shed_ratio":
                r["tenant"] = str(rng.choice(["acme", "beta"]))
            if slo == "decision_p99":
                r["value"], r["target"] = float(rng.random()), 0.25
            rows.append(r)
        docs.append({"ticks": int(rng.integers(1, 99)), "slos": rows})
    return docs


@pytest.mark.parametrize("seed", range(4))
def test_slo_memory_and_tenant_merges_equal_jax(seed):
    assert pf.merge_slo(slo_docs(seed)) == jf.merge_slo(slo_docs(seed))
    rng = np.random.default_rng(seed)
    mem = [{"device_bytes": int(rng.integers(0, 1 << 30)),
            "host_bytes": int(rng.integers(0, 1 << 20)),
            "pressure": float(rng.random()), "pressure_target": 0.85,
            "consumers": {"hot_table": {"bytes": 100},
                          "bad": {"error": "x"}, "odd": 5}}
           for _ in range(3)]
    assert pf.merge_memory(mem) == jf.merge_memory(mem)
    tdocs = []
    for d in range(3):
        tenants = {}
        for t in ("acme", "beta", "__other__"):
            tenants[t] = {f: int(rng.integers(0, 50))
                          for f in pf.TENANT_FIELDS}
        totals = {f: sum(c[f] for c in tenants.values())
                  for f in pf.TENANT_FIELDS}
        if d == 1 and seed % 2:
            totals["hits"] += 1  # a daemon whose rows do not conserve
        tdocs.append({"enabled": d != 2 or seed != 3, "tenants": tenants,
                      "totals": totals, "overflowed": d == 0})
    got = pf.merge_tenants(tdocs)
    assert got == jf.merge_tenants(tdocs)
    assert got["conserved"] == (seed % 2 == 0)
    assert pf.TENANT_FIELDS == jf.TENANT_FIELDS


def test_topkeys_merge_equals_jax_and_the_union():
    from gubernator_tpu.analytics import HeavyHitterSketch as JaxSketch
    from gubernator_tpu_torch.analytics import HeavyHitterSketch

    rng = np.random.default_rng(19)
    truth = HeavyHitterSketch(k=64, width=256)
    docs = []
    for d in range(3):
        kh = np.arange(d * 1000 + 1, d * 1000 + 61, dtype=np.uint64)
        sk = JaxSketch(k=64, width=256)
        for w in range(4):
            pick = rng.integers(0, 60, size=120)
            hits = rng.integers(1, 40, size=120).astype(np.int64)
            for s in (sk, truth):
                s.update(kh[pick], hits, hits > 35, NOW0 + 1000 * w)
        docs.append({"k": 64, "width": 256,
                     "total_hits_observed": int(sk.total_weight),
                     "keys": [dict(e, khash=f"0x{e['khash']:016x}",
                                   owner=f"d{d}:1050")
                              for e in sk.topk(256)]})
    got = pf.merge_topkeys(docs, k=64)
    assert got == jf.merge_topkeys(docs, k=64)
    assert got["total_hits_observed"] == truth.total_weight
    assert got["admission_error_bound"] == 0
    assert {e["khash"]: e["hits"] for e in got["keys"]} == {
        f"0x{e['khash']:016x}": e["hits"] for e in truth.topk(64)}


# ---- the audit documents of a live pair, port against JAX --------------

TIMING = dict(batch_timeout_ms=200, batch_wait_ms=20,
              global_sync_wait_ms=40, global_broadcast_interval_ms=40,
              global_timeout_ms=2000, peer_eject_after_ms=600_000)


def counters(doc):
    """A document without what differs between two clusters: addresses,
    ages and the ring's generation."""
    return {"enabled": doc["enabled"], "drift": doc["drift"],
            "conserved": doc["conserved"], "lost": doc["lost"],
            "bound_s": doc["bound_s"],
            "flush_window_ms": doc["flush_window_ms"],
            "lanes": doc["lanes"]}


def run_pair(start, mkreq, arm, clear):
    """Daemon 0 of a pair sends, to keys owned by daemon 1: GLOBAL hits
    (reconciled), then, with its sends to daemon 1 failing, plain rows
    (served degraded, their hits queued degraded) and GLOBAL hits (the
    flush fails: parked or requeued), then recovery.  The audit
    documents at each stage, once settled."""
    c = start()
    try:
        inst = c.instance_at(0)
        owned = [k for k in (f"fk{i}" for i in range(400))
                 if c.owner_daemon_of(f"fleet/api_{k}") is c.daemons[1]]
        glob, plain = owned[:6], owned[6:12]

        def send(keys, beh, hits):
            inst.get_rate_limits([mkreq(k, beh, hits) for k in keys])

        def settle(pred):
            deadline = time.monotonic() + 30
            while True:
                doc = inst.audit_doc()
                if pred(doc) or time.monotonic() > deadline:
                    return doc
                time.sleep(0.05)

        stages = []
        for r in range(4):
            send(glob, Behavior.GLOBAL, 3)
        stages.append(settle(lambda d: d["conserved"]
                             and d["lanes"]["global"]["injected"] == 72))
        arm(inst, c.daemons[1].advertise_address)
        send(plain, 0, 2)
        send(glob, Behavior.GLOBAL, 1)
        stages.append(settle(
            lambda d: d["lanes"]["global"]["injected"] == 90
            and d["lanes"]["global"]["in_flight"] == 0))
        clear(inst)
        stages.append(settle(lambda d: d["conserved"]
                             and d["lanes"]["global"]["injected"] == 90))
        return stages, [d.instance.audit_doc() for d in c.daemons]
    finally:
        c.stop()


def test_pair_audit_documents_equal_jax(monkeypatch):
    from gubernator_tpu import cluster as jax_cluster
    from gubernator_tpu.config import BehaviorConfig as JaxBehaviors
    from gubernator_tpu.config import DaemonConfig as JaxDaemonConfig
    from gubernator_tpu.parallel import make_mesh
    from gubernator_tpu.types import RateLimitRequest as JaxReq
    from gubernator_tpu_torch import cluster

    def preq(k, beh, hits):
        return RateLimitRequest(name="fleet/api", unique_key=k, hits=hits,
                                limit=10_000, duration=600_000,
                                behavior=beh)

    def jreq(k, beh, hits):
        return JaxReq(name="fleet/api", unique_key=k, hits=hits,
                      limit=10_000, duration=600_000, behavior=int(beh))

    def arm(inst, addr):
        inst.faults.arm(f"peer_send@{addr}:error")

    def clear(inst):
        inst.faults.clear()

    port = run_pair(lambda: cluster.start_with([DaemonConfig(
        grpc_listen_address="127.0.0.1:0",
        http_listen_address="127.0.0.1:0", cache_size=4096, batch_rows=64,
        device="cpu", behaviors=BehaviorConfig(**TIMING))
        for _ in range(2)]), preq, arm, clear)
    for var in ("GUBER_ANALYTICS", "GUBER_SLO", "GUBER_MEM_LEDGER"):
        monkeypatch.setenv(var, "0")
    ref = run_pair(lambda: jax_cluster.start_with([JaxDaemonConfig(
        grpc_listen_address="127.0.0.1:0",
        http_listen_address="127.0.0.1:0", cache_size=4096,
        behaviors=JaxBehaviors(**TIMING)) for _ in range(2)],
        mesh=make_mesh(n=1)), jreq, arm, clear)
    (pst, pend), (jst, jend) = port, ref
    assert [counters(d) for d in pst] == [counters(d) for d in jst]
    assert [counters(d) for d in pend] == [counters(d) for d in jend]
    healthy, outage, recovered = (d["lanes"]["global"] for d in pst)
    assert healthy["applied"] == 72 and healthy["deg_injected"] == 0
    assert outage["deg_injected"] == 12 and outage["queued"] == 18
    assert outage["backlog"] == 18 and pst[1]["drift"] == 18
    assert recovered["applied"] == 90 and recovered["deg_pending"] == 0
    for stage in (pend,):
        f = pf.fold_audits(stage)
        assert f["conserved"] and f["totals"]["injected"] == 90
    ring = pf.ring_verdict(pend)
    assert ring["consistent"] and ring == {**ring, "ejected": []}


def test_debug_audit_endpoint_and_drift_gauge(monkeypatch):
    from gubernator_tpu_torch.daemon import spawn_daemon

    d = spawn_daemon(DaemonConfig(device="cpu", cache_size=1024,
                                  http_listen_address="127.0.0.1:0",
                                  grpc_listen_address="127.0.0.1:0"))
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{d.http_port}/debug/audit") as f:
            doc = json.loads(f.read())
        assert doc["enabled"] and doc["conserved"] and doc["drift"] == 0
        assert doc["instance"] == d.advertise_address
        assert doc["bound_s"] == 0.2 and doc["flush_window_ms"] == 100
        assert set(doc["lanes"]) == {"global"}
        assert d.instance.metrics.registry.get_sample_value(
            "gubernator_fleet_conservation_drift") == 0
        value, target = d.instance.auditor.slo_sample()
        assert value >= 0 and target == 0.2
    finally:
        d.close()
    monkeypatch.setenv("GUBER_FLEET_AUDIT", "0")
    d = spawn_daemon(DaemonConfig(device="cpu", cache_size=1024,
                                  http_listen_address="127.0.0.1:0",
                                  grpc_listen_address="127.0.0.1:0"))
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{d.http_port}/debug/audit") as f:
            doc = json.loads(f.read())
        assert doc["enabled"] is False and doc["drift"] == 0
        assert "fleet_conservation" not in d.instance.slo.names()
    finally:
        d.close()
