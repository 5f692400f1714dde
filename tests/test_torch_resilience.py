"""The cluster's failure path held to the JAX package's, on the CPU:

- **degraded serves** (gate off, ``peer_send@<daemon 2>:error`` armed on
  daemon 0 of a 3-daemon cluster of each package): one seeded stream
  through daemon 0 answers, row for row, the same status, remaining,
  reset time, error and ``degraded`` / ``degraded_peer`` metadata on the
  wire and on the object lane; once the fault clears and the hits flush,
  daemon 2's rows answer the same too (on the object lane but for their
  reset time: that flush applies at the owner's clock in both packages).  The two clusters listen on
  different ports, so their rings differ: each stream picks its keys by
  the daemon that owns them in its cluster, and addresses are compared
  as daemon numbers;
- **the health gate** (one instance of each package, the same three
  peer addresses, ``time.monotonic`` patched in both packages' peer
  clients): ``route_healthy`` and ``_routing_picker`` eject and readmit
  at the same instants, route every key to the same owner and count the
  same generations; a peer that flaps inside the window is never
  ejected;
- **rows rehomed here** serve degraded on both client lanes, and **the
  owner side of a rehome** (``_peer_degraded_rewrite`` and its object
  twin) flags the rows JAX flags and queues the same hits.

Decisions are compared exactly; the peer circuit's threshold is raised
where a test needs every failed flush to read ``fault injected``."""
import time

import numpy as np
import pytest

from gubernator_tpu import peer_client as jax_pc
from gubernator_tpu.config import Config as JaxConfig
from gubernator_tpu.oracle import Oracle as JaxOracle
from gubernator_tpu.proto import gubernator_pb2 as jax_pb
from gubernator_tpu.types import PeerInfo as JaxPeer
from gubernator_tpu.types import RateLimitRequest as JaxReq
from gubernator_tpu_torch import cluster as cluster_mod
from gubernator_tpu_torch import peer_client as port_pc
from gubernator_tpu_torch.config import BehaviorConfig, Config
from gubernator_tpu_torch.instance import V1Instance
from gubernator_tpu_torch.proto import gubernator_pb2 as pb
from gubernator_tpu_torch.types import PeerInfo, RateLimitRequest
from gubernator_tpu_torch.wire import encode_get_rate_limits

from test_torch_cluster import (FIELDS, jax_env,  # noqa: F401
                                port_cfgs, start_jax)

NOW = 1_765_000_000_000
GLOBAL, RESET, DRAIN = 2, 8, 32
#: degraded serves on, the gate off, and a circuit that never opens (a
#: failed flush always reads "fault injected")
NO_GATE = dict(peer_health_gate=False, peer_circuit_threshold=1 << 30)
KEYS_PER_ROLE = 12


@pytest.fixture(scope="module")
def clusters(jax_env):  # noqa: F811
    port = cluster_mod.start_with(port_cfgs(3, **NO_GATE))
    try:
        ref = start_jax(3, **NO_GATE)
    except BaseException:
        port.stop()
        raise
    yield port, ref
    port.stop()
    ref.stop()


def role_keys(c, name: str):
    """unique keys by the daemon (0, 1, 2) that owns them in ``c``."""
    out = {0: [], 1: [], 2: []}
    idx = {d.advertise_address: i for i, d in enumerate(c.daemons)}
    i = 0
    while min(len(v) for v in out.values()) < KEYS_PER_ROLE:
        role = idx[c.instance_at(0).owner_of(f"{name}_k{i}")
                   .info.grpc_address]
        if len(out[role]) < KEYS_PER_ROLE:
            out[role].append(f"k{i}")
        i += 1
    return out


def stream(seed: int, unique_per_batch: bool):
    """Five batches of 30 (role, key number, hits, behavior) rows; each
    key keeps one config (limit, duration, algorithm) for the whole
    stream.  RESET and DRAIN rows (never served degraded) ride along.
    The object lane's batches name a key once (its forwards may ride
    two concurrent flushes, in either order, in both packages)."""
    rng = np.random.default_rng(seed)
    cfg = {(r, j): (int(rng.integers(4, 12)), 60_000 * int(rng.integers(
        1, 4)), int(rng.integers(0, 2))) for r in range(3)
        for j in range(KEYS_PER_ROLE)}
    out = []
    for _ in range(5):
        rows, seen = [], set()
        while len(rows) < 30:
            r, j = int(rng.integers(0, 3)), int(rng.integers(0,
                                                             KEYS_PER_ROLE))
            if unique_per_batch and (r, j) in seen:
                continue
            seen.add((r, j))
            u = rng.random()
            beh = RESET if u < 0.08 else DRAIN if u < 0.14 else 0
            rows.append((r, j, int(rng.integers(0, 4)), beh))
        out.append(rows)
    return out, cfg


def requests(rows, cfg, keys, name):
    return [RateLimitRequest(
        name=name, unique_key=keys[r][j], hits=h, limit=cfg[r, j][0],
        duration=cfg[r, j][1], algorithm=cfg[r, j][2], behavior=beh)
        for r, j, h, beh in rows]


def to_jax(r):
    return JaxReq(**{f: getattr(r, f) for f in FIELDS},
                  created_at=r.created_at)


def norm(c, text: str) -> str:
    for i, d in enumerate(c.daemons):
        text = text.replace(d.advertise_address, f"<daemon {i}>")
    return text


def answers(c, resps):
    return [(int(r.status), r.limit, r.remaining, r.reset_time,
             norm(c, r.error),
             tuple(sorted((k, norm(c, v)) for k, v in r.metadata.items())))
            for r in resps]


def queued_hits(gm) -> int:
    """A GLOBAL manager's queued hit total (port: ``queued()``; JAX:
    ``queued_hits()``)."""
    return gm.queued()["hits"] if hasattr(gm, "queued") else \
        gm.queued_hits()[0]


def drain(c):
    """Flush every daemon's GLOBAL hits: closing a manager runs its last
    ticks and waits for their RPCs (in both packages); the next request
    that needs one builds a fresh manager."""
    for d in c.daemons:
        gm = d.instance.global_manager
        if gm is not None:
            gm.close()
            d.instance.global_manager = None


def owner_expected(batches, cfg, keys, name):
    """The owner's rows of the dead daemon's keys after the drain, by the
    JAX package's Oracle: each key's degraded hits arrive as one request
    of their sum stamped with its latest degraded serve's time (the
    flush's prototype is the key's latest request), then the hits=0
    probe at NOW + 10 s."""
    acc, last = {}, {}
    for b, rows in enumerate(batches):
        for r, j, h, beh in rows:
            if r == 2 and beh == 0:
                acc[j] = acc.get(j, 0) + h
                last[j] = NOW + 1_000 * b
    oracle = JaxOracle()
    out = []
    for j in range(KEYS_PER_ROLE):
        limit, duration, algo = cfg[2, j]
        req = dict(name=name, unique_key=keys[2][j], limit=limit,
                   duration=duration, algorithm=algo)
        if acc.get(j, 0) > 0:
            oracle.check(JaxReq(hits=acc[j], **req), last[j])
        r = oracle.check(JaxReq(hits=0, **req), NOW + 10_000)
        out.append((int(r.status), r.limit, r.remaining, r.reset_time,
                    r.error, ()))
    return out


@pytest.mark.parametrize("lane", ["wire", "object"])
def test_degraded_serves_answer_as_jax(clusters, lane):
    name = f"res_{lane}"
    batches, cfg = stream(11 if lane == "wire" else 12,
                          unique_per_batch=lane == "object")
    got, owner_rows, counted = [], [], []
    for c, conv, resp_cls in ((clusters[0], lambda r: r,
                               pb.GetRateLimitsResp),
                              (clusters[1], to_jax,
                               jax_pb.GetRateLimitsResp)):
        keys = role_keys(c, name)
        inst0, dead = c.instance_at(0), c.daemon_at(2).advertise_address
        served0 = inst0.metrics.registry.get_sample_value(
            "gubernator_degraded_served_total", {"peer_addr": dead}) or 0
        inst0.faults.arm(f"peer_send@{dead}:error")
        rows_out = []
        try:
            for b, rows in enumerate(batches):
                reqs = requests(rows, cfg, keys, name)
                now = NOW + 1_000 * b
                if lane == "wire":
                    out = resp_cls.FromString(inst0.get_rate_limits_wire(
                        encode_get_rate_limits(reqs), now_ms=now)).responses
                else:
                    out = inst0.get_rate_limits([conv(r) for r in reqs],
                                                now_ms=now)
                rows_out.append(answers(c, out))
            # every flush that failed while armed has requeued its hits
            # before the fault clears: a flush still retrying then would
            # deliver part of a key's hits apart from the rest, and a
            # summed aggregate over the remaining goes OVER whole
            want = sum(h for rows in batches for r, _, h, beh in rows
                       if r == 2 and beh == 0)
            deadline = time.monotonic() + 30.0
            while (queued_hits(inst0.global_manager) != want
                   and time.monotonic() < deadline):
                time.sleep(0.02)
        finally:
            inst0.faults.clear()
        drain(c)
        probe = [RateLimitRequest(name=name, unique_key=keys[2][j], hits=0,
                                  limit=cfg[2, j][0], duration=cfg[2, j][1],
                                  algorithm=cfg[2, j][2])
                 for j in range(KEYS_PER_ROLE)]
        owner_rows.append(answers(c, c.instance_at(2).get_rate_limits(
            [conv(r) for r in probe], now_ms=NOW + 10_000)))
        got.append(rows_out)
        counted.append(inst0.metrics.registry.get_sample_value(
            "gubernator_degraded_served_total", {"peer_addr": dead})
            - served0)
    flat = [r for b in got[0] for r in b]
    assert any(("degraded", "true") in r[5] for r in flat)
    assert any(r[4].startswith("while fetching rate limit from peer "
                               "<daemon 2>: fault injected") for r in flat)
    for b, (p, j) in enumerate(zip(*got)):
        assert p == j, b
    if lane == "object":
        # the port's object-lane hits flush carries the prototype's
        # created_at, as the wire lane's does, so its owner applies the
        # hits at the callers' time base; JAX's flush rebuilds the TLV
        # without it and applies them at the owner's wall clock
        # (ROADMAP §C.2): the port is held to the exact owner rows, and
        # JAX to them where no clock enters (token keys, reset aside)
        want = owner_expected(batches, cfg, role_keys(clusters[0], name),
                              name)
        assert owner_rows[0] == want
        token = [j for j in range(KEYS_PER_ROLE) if cfg[2, j][2] == 0]
        assert token
        assert [owner_rows[1][j][:3] + owner_rows[1][j][4:]
                for j in token] == [want[j][:3] + want[j][4:]
                                    for j in token]
    else:
        assert owner_rows[0] == owner_rows[1]
    assert counted[0] == counted[1] == sum(
        ("degraded", "true") in r[5] for r in flat)


# ---- the gate, one instance of each package, on a patched clock --------

ME, A, B = "127.0.0.1:1", "127.0.0.1:2", "127.0.0.1:3"


class Clock:
    """``time`` for the peer clients, with ``monotonic`` set by hand."""

    def __init__(self):
        self.t = 1_000.0

    def monotonic(self):
        return self.t

    def __getattr__(self, name):
        return getattr(time, name)


@pytest.fixture()
def gated(monkeypatch, jax_env):  # noqa: F811
    from gubernator_tpu.instance import V1Instance as JaxInstance

    clock = Clock()
    monkeypatch.setattr(port_pc, "time", clock)
    monkeypatch.setattr(jax_pc, "time", clock)
    port = V1Instance(Config(device="cpu", cache_size=4096, batch_rows=64,
                             sweep_interval_ms=0, advertise_address=ME,
                             hot_set_capacity=0))
    ref = JaxInstance(JaxConfig(cache_size=4096, batch_rows=64,
                                sweep_interval_ms=0, hot_set_capacity=0,
                                advertise_address=ME))
    probes = []
    for inst in (port, ref):
        # the prober would dial the fake addresses on its own schedule
        monkeypatch.setattr(inst, "_ensure_probe_loop",
                            lambda inst=inst: probes.append(inst))
    port.set_peers([PeerInfo(grpc_address=a) for a in (ME, A, B)])
    ref.set_peers([JaxPeer(grpc_address=a) for a in (ME, A, B)])
    yield clock, port, ref, probes
    port.close()
    ref.close()


def peer(inst, addr):
    return next(p for p in inst.peers() if p.info.grpc_address == addr)


def gate_state(inst):
    routing = inst._routing_picker()
    with inst._peer_mu:
        membership = inst._picker
    return (sorted(inst._gate_bad), inst._ring_gen,
            routing is membership,
            [inst._route_owner_of(f"g_k{i}").info.grpc_address
             for i in range(300)],
            [e["kind"] for e in inst.recorder.events()
             if e["kind"].startswith("ring_")],
            peer(inst, B).lane_stats()["circuit"]["route_ejected"])


def test_gate_ejects_and_readmits_at_the_same_instants(gated):
    clock, port, ref, probes = gated
    timeline = []

    def at(t, action=None):
        clock.t = t
        for inst in (port, ref):
            if action is not None:
                getattr(peer(inst, B), action)()
        states = [gate_state(port), gate_state(ref)]
        assert states[0] == states[1], t
        timeline.append((t, states[0][0], states[0][1]))
        return states[0]

    at(1_000.0)
    for _ in range(3):
        at(1_000.0, "_record_failure")  # the circuit opens at 1000
    assert at(1_002.999)[0] == []
    s = at(1_003.0)
    assert s[0] == [B] and not s[2] and B not in s[3]
    at(1_004.0, "_record_failure")  # a failed half-open probe
    at(1_005.0, "_record_success")  # recovered at 1005
    assert at(1_007.999)[0] == [B]
    s = at(1_008.0)
    assert s[0] == [] and s[2] and B in s[3]
    # a flap inside the eject window moves no key
    for _ in range(3):
        at(1_010.0, "_record_failure")
    at(1_012.0, "_record_success")
    assert at(1_020.0)[0] == []
    assert [g for _, _, g in timeline][-1] == 3
    assert len(probes) >= 2
    assert timeline[-1][2] - timeline[0][2] == 2


def test_route_healthy_hysteresis_as_jax(gated):
    clock, port, ref, _ = gated
    seqs = []
    for inst in (port, ref):
        p = peer(inst, A)
        seq = []
        clock.t = 2_000.0
        for _ in range(3):
            p._record_failure()
        for t, act in ((2_000.5, None), (2_001.0, None), (2_001.5,
                       "_record_failure"), (2_002.0, "_record_success"),
                       (2_002.4, None), (2_002.6, None), (2_003.0, None)):
            clock.t = t
            if act:
                getattr(p, act)()
            seq.append(p.route_healthy(1.0, 0.5))
        seqs.append(seq)
    assert seqs[0] == seqs[1] == [True, False, False, False, False, True,
                                  True]


def eject_b(clock, *insts):
    for inst in insts:
        for _ in range(3):
            peer(inst, B)._record_failure()
    clock.t += 3.0
    for inst in insts:
        inst._routing_picker()
        assert inst._gate_bad == frozenset({B})


def rehome_rows(inst, n: int):
    """Keys whose membership owner is B and whose routing owner is this
    daemon (rows rehomed here by the ejection)."""
    out = []
    i = 0
    while len(out) < n:
        k = f"k{i}"
        if (inst.owner_of(f"rh_{k}").info.grpc_address == B
                and inst._route_owner_of(f"rh_{k}").info.grpc_address == ME):
            out.append(k)
        i += 1
    return out


def resp_rows(resps):
    return [(int(r.status), r.limit, r.remaining, r.reset_time, r.error,
             tuple(sorted(r.metadata.items()))) for r in resps]


@pytest.mark.parametrize("lane", ["wire", "object"])
def test_rows_rehomed_here_serve_degraded_as_jax(gated, lane):
    clock, port, ref, _ = gated
    eject_b(clock, port, ref)
    keys = rehome_rows(port, 6)
    assert keys == rehome_rows(ref, 6)
    reqs = [RateLimitRequest(name="rh", unique_key=k, hits=h, limit=5,
                             duration=60_000, behavior=beh)
            for k in keys for h, beh in ((1, 0), (2, 0), (1, RESET))]
    got = []
    for inst, conv, cls in ((port, lambda r: r, pb.GetRateLimitsResp),
                            (ref, to_jax, jax_pb.GetRateLimitsResp)):
        if lane == "wire":
            out = cls.FromString(inst.get_rate_limits_wire(
                encode_get_rate_limits(reqs), now_ms=NOW)).responses
        else:
            out = inst.get_rate_limits([conv(r) for r in reqs], now_ms=NOW)
        got.append((resp_rows(out), queued_hits(inst.global_manager),
                    inst.metrics.registry.get_sample_value(
                        "gubernator_degraded_served_total",
                        {"peer_addr": B})))
    assert got[0] == got[1]
    assert ("degraded_peer", B) in got[0][0][0][5]
    assert got[0][0][2][5] == ()  # RESET: served, never degraded


def owner_side_batch(inst):
    """A forwarded batch: keys whose membership owner is B (plain,
    GLOBAL, RESET) and keys this daemon owns."""
    mine, of_b = [], []
    i = 0
    while len(of_b) < 6 or len(mine) < 3:
        k = f"o{i}"
        owner = inst.owner_of(f"os_{k}").info.grpc_address
        if owner == B and len(of_b) < 6:
            of_b.append(k)
        elif owner == ME and len(mine) < 3:
            mine.append(k)
        i += 1
    beh = [0, 0, GLOBAL, RESET, 0, DRAIN]
    reqs = [RateLimitRequest(name="os", unique_key=k, hits=1 + j % 2,
                             limit=7, duration=60_000, behavior=beh[j],
                             created_at=NOW - 5)
            for j, k in enumerate(of_b)]
    reqs += [RateLimitRequest(name="os", unique_key=k, hits=1, limit=7,
                              duration=60_000) for k in mine]
    return reqs


@pytest.mark.parametrize("lane", ["wire", "object"])
def test_owner_side_rewrite_flags_as_jax(gated, lane):
    """get_peer_rate_limits(_wire) while this daemon's gate has ejected
    B: rows whose membership owner is B are flagged and their hits
    queued for B; GLOBAL, RESET and DRAIN rows and owned rows are not."""
    clock, port, ref, _ = gated
    eject_b(clock, port, ref)
    reqs = owner_side_batch(port)
    assert reqs == owner_side_batch(ref)
    got = []
    for inst, conv, cls in ((port, lambda r: r, pb.GetRateLimitsResp),
                            (ref, to_jax, jax_pb.GetRateLimitsResp)):
        if lane == "wire":
            out = cls.FromString(inst.get_peer_rate_limits_wire(
                encode_get_rate_limits(reqs), now_ms=NOW)).responses
        else:
            out = inst.get_peer_rate_limits([conv(r) for r in reqs],
                                            now_ms=NOW)
        got.append((resp_rows(out), queued_hits(inst.global_manager),
                    inst.metrics.registry.get_sample_value(
                        "gubernator_degraded_served_total",
                        {"peer_addr": B})))
    assert got[0] == got[1]
    flags = [("degraded_peer", B) in r[5] for r in got[0][0]]
    assert flags == [True, True, False, False, True, False] + [False] * 3
    assert got[0][2] == 3


def test_healthy_gate_returns_the_membership_ring(gated):
    """Nothing ejected: the routing ring IS the membership ring (no new
    ring a call), and the owner side keeps its fused lane."""
    _, port, ref, _ = gated
    for inst in (port, ref):
        with inst._peer_mu:
            membership = inst._picker
        assert inst._routing_picker() is membership
        assert not inst._gate_bad
    data = encode_get_rate_limits([RateLimitRequest(
        name="hg", unique_key="k", hits=1, limit=5, duration=60_000)])
    lanes = port.metrics.wire_lane_counter
    before = lanes.labels(lane="peer_wire")._value.get()
    assert port.get_peer_rate_limits_wire(data, now_ms=NOW) == \
        ref.get_peer_rate_limits_wire(data, now_ms=NOW)
    assert lanes.labels(lane="peer_wire")._value.get() == before + 1


def test_gate_off_routes_by_membership(monkeypatch):
    inst = V1Instance(Config(device="cpu", cache_size=4096,
                             advertise_address=ME,
                             behaviors=BehaviorConfig(
                                 peer_health_gate=False)))
    try:
        inst.set_peers([PeerInfo(grpc_address=a) for a in (ME, A, B)])
        p = peer(inst, B)
        monkeypatch.setattr(p, "route_healthy",
                            lambda *a: pytest.fail("gate read"))
        with inst._peer_mu:
            membership = inst._picker
        assert inst._routing_picker() is membership
    finally:
        inst.close()


def test_probe_sends_an_empty_globals_flush(monkeypatch):
    """``probe`` enqueues one 0-item flush on the globals lane, and none
    while the circuit is open."""
    client = port_pc.PeerClient(PeerInfo(grpc_address=B), BehaviorConfig())
    sent = []
    monkeypatch.setattr(client._globals_lane, "enqueue",
                        lambda data, n: sent.append((data, n)) or "f")
    assert client.probe() == "f" and sent == [(b"", 0)]
    monkeypatch.setattr(client._globals_lane, "enqueue",
                        lambda data, n: (_ for _ in ()).throw(
                            port_pc.ErrCircuitOpen("open")))
    assert client.probe() is None
    assert client.lane_stats()["circuit"]["route_ejected"] is False
    assert client.circuit_open() is False
    client.shutdown()
