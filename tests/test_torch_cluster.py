"""3-daemon clusters of both packages on the CPU, real gRPC over loopback
(the port's ``cluster.start_with`` on ``device="cpu"``, the JAX
package's on ``make_mesh(n=1)``), driven through daemon 0:

- a sequential seeded stream over both lanes answers, row for row, as
  the JAX cluster and as one JAX instance do, and each key's state lives
  on its owner alone;
- NO_BATCHING rows are forwarded (in an RPC of their own);
- GLOBAL hits converge on the owner and broadcast back to every replica,
  through a non-owner and through the owner, over both lanes, to the
  JAX cluster's values (tests/test_functional.py's and
  tests/test_wire_clustered_global.py's flows);
- a stopped peer's rows answer the legacy error row the JAX daemons
  answer with ``peer_degraded_fallback=False`` (both packages pinned to
  it there, on purpose), and the failed GLOBAL flush turns health
  unhealthy with JAX's message.

Every other test runs both packages' default behaviors (degraded serves
and the health gate on), which are equal.

Exact equality everywhere; convergence is polled by attempt count."""
import time

import numpy as np
import pytest

from gubernator_tpu import cluster as jax_cluster_mod
from gubernator_tpu.config import BehaviorConfig as JaxBehaviors
from gubernator_tpu.config import DaemonConfig as JaxDaemonConfig
from gubernator_tpu.proto import gubernator_pb2 as jax_pb
from gubernator_tpu.types import RateLimitRequest as JaxReq
from gubernator_tpu_torch import cluster as cluster_mod
from gubernator_tpu_torch.config import BehaviorConfig, DaemonConfig
from gubernator_tpu_torch.hashing import hash_request_keys
from gubernator_tpu_torch.proto import gubernator_pb2 as pb
from gubernator_tpu_torch.types import RateLimitRequest
from gubernator_tpu_torch.wire import encode_get_rate_limits

NOW = 1_765_000_000_000
CAP = 1 << 12
FIELDS = ("name", "unique_key", "hits", "limit", "duration", "algorithm",
          "behavior", "burst")
TIMING = dict(batch_timeout_ms=30, batch_wait_ms=30, global_sync_wait_ms=40,
              global_broadcast_interval_ms=40, global_timeout_ms=2000)
#: the legacy answer to a failed forward: error rows, no gate
LEGACY = dict(peer_degraded_fallback=False, peer_health_gate=False)
GLOBAL, NO_BATCHING = 2, 1
#: attempts of 50 ms (plus an RPC round trip each) before a convergence
#: check gives up
ATTEMPTS = 200


@pytest.fixture(scope="module")
def jax_env():
    with pytest.MonkeyPatch.context() as mp:
        for var in ("GUBER_ANALYTICS", "GUBER_SLO", "GUBER_MEM_LEDGER"):
            mp.setenv(var, "0")
        yield


def port_cfgs(n: int, **extra):
    return [DaemonConfig(grpc_listen_address="127.0.0.1:0",
                         http_listen_address="127.0.0.1:0", cache_size=CAP,
                         batch_rows=64, device="cpu",
                         behaviors=BehaviorConfig(**TIMING, **extra))
            for _ in range(n)]


def jax_cfgs(n: int, **extra):
    return [JaxDaemonConfig(grpc_listen_address="127.0.0.1:0",
                            http_listen_address="127.0.0.1:0",
                            cache_size=CAP,
                            behaviors=JaxBehaviors(**TIMING, **extra))
            for _ in range(n)]


def start_jax(n: int, **extra):
    from gubernator_tpu.parallel import make_mesh

    return jax_cluster_mod.start_with(jax_cfgs(n, **extra),
                                      mesh=make_mesh(n=1))


@pytest.fixture(scope="module")
def port_cluster():
    c = cluster_mod.start_with(port_cfgs(3))
    yield c
    c.stop()


@pytest.fixture(scope="module")
def jax_cluster(jax_env):
    c = start_jax(3)
    yield c
    c.stop()


@pytest.fixture(scope="module")
def jax_single(jax_env):
    from gubernator_tpu.config import Config as JaxConfig
    from gubernator_tpu.instance import V1Instance as JaxInstance

    inst = JaxInstance(JaxConfig(cache_size=CAP, batch_rows=64,
                                 sweep_interval_ms=0, hot_set_capacity=0))
    yield inst
    inst.close()


def to_jax(r):
    return JaxReq(**{f: getattr(r, f) for f in FIELDS},
                  created_at=r.created_at)


def stream(seed: int, name: str, object_lane: bool):
    """Six batches of 40 requests over 60 keys: TOKEN and LEAKY, hits
    0-3, small limits that run out, RESET_REMAINING and DRAIN rows; each
    batch at its own ``now``.  On the object lane a key appears once a
    batch: its forwards ride the lane one request an entry, so two of
    them may go out in two concurrent flushes and apply on the owner in
    either order (in both packages).  The wire lane forwards an owner's
    rows as one entry, in order, so its batches repeat keys and carry
    NO_BATCHING rows (the object lane's take a typed RPC without the
    caller's clock, and have a test of their own)."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(6):
        reqs = []
        ks = (rng.choice(60, 40, replace=False) if object_lane
              else rng.integers(0, 60, 40))
        for k in ks.tolist():
            beh = 0
            beh |= 8 if rng.random() < 0.03 else 0
            beh |= 32 if rng.random() < 0.05 else 0
            beh |= NO_BATCHING if not object_lane and rng.random() < 0.1 \
                else 0
            reqs.append(RateLimitRequest(
                name=name, unique_key=f"k{k}", hits=int(rng.integers(0, 4)),
                limit=int(3 + k % 6), duration=[5_000, 60_000][k % 2],
                algorithm=k % 3 == 0, behavior=beh,
                burst=int(k % 4) * 2))
        out.append((reqs, NOW + 700 * b))
    return out


def rows(resps):
    return [(int(r.status), r.limit, r.remaining, r.reset_time, r.error)
            for r in resps]


def run_object(inst, batches, convert=lambda r: r):
    return [rows(inst.get_rate_limits([convert(r) for r in reqs],
                                      now_ms=now)) for reqs, now in batches]


def run_wire(inst, batches, resp_cls):
    return [rows(resp_cls.FromString(inst.get_rate_limits_wire(
        encode_get_rate_limits(reqs), now_ms=now)).responses)
        for reqs, now in batches]


def owners_hold_only_their_rows(c, name: str, keys) -> None:
    kh = hash_request_keys([name] * len(keys), keys)
    holders = np.zeros(len(keys), np.int64)
    for i, d in enumerate(c.daemons):
        inst = d.instance
        with inst._engine_mu:
            found, _ = inst.engine.gather_rows(kh)
        for j in np.nonzero(found)[0]:
            owner = c.owner_daemon_of(f"{name}_{keys[j]}")
            assert owner is d, (keys[j], i)
        holders += found
    assert (holders == 1).all()


@pytest.mark.parametrize("lane", ["object", "wire"])
def test_stream_answers_as_jax_cluster_and_one_instance(
        lane, port_cluster, jax_cluster, jax_single):
    name = f"cl_{lane}"
    batches = stream(7, name, object_lane=lane == "object")
    port0, jax0 = port_cluster.instance_at(0), jax_cluster.instance_at(0)
    fwd0 = port0.forwarded_rows
    items0 = sum(p.lane_stats()["forward"]["items"] for p in port0.peers())
    if lane == "object":
        got = run_object(port0, batches)
        want = run_object(jax0, batches, to_jax)
        single = run_object(jax_single, batches, to_jax)
    else:
        got = run_wire(port0, batches, pb.GetRateLimitsResp)
        want = run_wire(jax0, batches, jax_pb.GetRateLimitsResp)
        single = run_wire(jax_single, batches, jax_pb.GetRateLimitsResp)
    assert got == want
    assert got == single
    assert any(r[0] == 1 for b in got for r in b)  # some went OVER
    # about two thirds of the rows were forwarded, all through the lanes
    n_rows = sum(len(r) for r, _ in batches)
    fwd = port0.forwarded_rows - fwd0
    assert 0.4 * n_rows < fwd < 0.9 * n_rows
    assert port0.forward_failures == 0
    nobatch = sum(r.behavior == NO_BATCHING for reqs, _ in batches
                  for r in reqs)
    assert sum(p.lane_stats()["forward"]["items"]
               for p in port0.peers()) - items0 <= fwd <= \
        sum(p.lane_stats()["forward"]["items"]
            for p in port0.peers()) - items0 + nobatch
    keys = sorted({r.unique_key for reqs, _ in batches for r in reqs})
    owners_hold_only_their_rows(port_cluster, name, keys)
    owners_hold_only_their_rows(jax_cluster, name, keys)


def remote_key(c, name: str) -> str:
    """A unique_key whose owner is not daemon 0."""
    for i in range(100):
        owner = c.owner_daemon_of(f"{name}_nb{i}")
        if owner is not c.daemon_at(0):
            return f"nb{i}"
    raise LookupError("every key on daemon 0")


def test_no_batching_is_forwarded(port_cluster, jax_cluster):
    name = "cl_nobatch"
    results = []
    for c, conv in ((port_cluster, lambda r: r), (jax_cluster, to_jax)):
        key = remote_key(c, name)
        req = RateLimitRequest(name=name, unique_key=key, hits=1, limit=3,
                               duration=60_000, behavior=NO_BATCHING)
        inst0 = c.instance_at(0)
        seen = [(int(r.status), r.remaining, r.limit) for r in (
            inst0.get_rate_limits([conv(req)])[0] for _ in range(4))]
        # the owner holds the state: its own query sees every hit
        probe = RateLimitRequest(name=name, unique_key=key, hits=0,
                                 limit=3, duration=60_000)
        r = c.owner_daemon_of(f"{name}_{key}").instance.get_rate_limits(
            [conv(probe)])[0]
        results.append((seen, (int(r.status), r.remaining)))
        owners_hold_only_their_rows(c, name, [key])
    assert results[0] == results[1]
    assert results[0][0] == [(0, 2, 3), (0, 1, 3), (0, 0, 3), (1, 0, 3)]
    port0 = port_cluster.instance_at(0)
    assert sum(p.lane_stats()["single_calls"] for p in port0.peers()) >= 4


def converge(c, probe, want: int, lane: str, resp_cls):
    """Poll every daemon with a hits=0 probe until each answers
    ``want``; returns the last answers."""
    got = None
    for _ in range(ATTEMPTS):
        if lane == "object":
            got = [d.instance.get_rate_limits([probe])[0].remaining
                   for d in c.daemons]
        else:
            got = [resp_cls.FromString(d.instance.get_rate_limits_wire(
                encode_get_rate_limits([probe]))).responses[0].remaining
                for d in c.daemons]
        if got == [want] * len(c.daemons):
            break
        time.sleep(0.05)
    return got


@pytest.mark.parametrize("lane", ["object", "wire"])
@pytest.mark.parametrize("entry", ["non-owner", "owner"])
def test_global_converges_on_owner_and_broadcasts_back(
        lane, entry, port_cluster, jax_cluster):
    name, key = f"clg_{lane}_{entry}", "acct:77"
    finals = []
    for c, conv, resp_cls in (
            (port_cluster, lambda r: r, pb.GetRateLimitsResp),
            (jax_cluster, to_jax, jax_pb.GetRateLimitsResp)):
        owner = c.owner_daemon_of(f"{name}_{key}")
        entry_d = owner if entry == "owner" else next(
            d for d in c.daemons if d is not owner)
        reqs = [RateLimitRequest(name=name, unique_key=key, hits=h,
                                 limit=100, duration=86_400_000,
                                 behavior=GLOBAL) for h in (2, 3, 0, 1)]
        if lane == "object":
            got = [r.remaining for r in
                   entry_d.instance.get_rate_limits([conv(r) for r in reqs])]
        else:
            got = [r.remaining for r in resp_cls.FromString(
                entry_d.instance.get_rate_limits_wire(
                    encode_get_rate_limits(reqs))).responses]
        # answered from the local replica at once
        assert got == [98, 95, 95, 94]
        probe = RateLimitRequest(name=name, unique_key=key, hits=0,
                                 limit=100, duration=86_400_000,
                                 behavior=GLOBAL)
        finals.append(converge(c, conv(probe), 94, lane, resp_cls))
    assert finals == [[94] * 3, [94] * 3]
    gm = port_cluster.owner_daemon_of(
        f"{name}_{key}").instance.global_manager
    assert gm is not None and gm.snapshot_stats()["broadcasts"] > 0
    for d in port_cluster.daemons:
        m = d.instance.global_manager
        assert m is None or m.snapshot_stats()["flush_failures"] == 0


def test_typed_peer_calls_reach_the_owner_and_the_replica(port_cluster):
    """The typed PeersV1 calls of the peer client: GetPeerRateLimits
    applies on its owner, UpdatePeerGlobals overwrites the replica with
    the owner's row, and a poke flushes the GLOBAL loops at once."""
    name, key = "cl_typed", "t1"
    owner = port_cluster.owner_daemon_of(f"{name}_{key}")
    other = next(d for d in port_cluster.daemons if d is not owner)
    to_owner = next(p for p in other.instance.peers()
                    if p.info.grpc_address == owner.advertise_address)
    to_other = next(p for p in owner.instance.peers()
                    if p.info.grpc_address == other.advertise_address)
    req = RateLimitRequest(name=name, unique_key=key, hits=3, limit=10,
                           duration=86_400_000, behavior=GLOBAL)
    [r] = to_owner.get_peer_rate_limits([req])
    assert (int(r.status), r.remaining, r.error) == (0, 7, "")
    msgs = owner.instance.build_global_updates([req])
    assert [m.update.remaining for m in msgs] == [7]
    to_other.update_peer_globals(msgs)
    probe = RateLimitRequest(name=name, unique_key=key, hits=0, limit=10,
                             duration=86_400_000, behavior=GLOBAL)
    assert other.instance.get_rate_limits([probe])[0].remaining == 7
    # a replica hit reaches the owner on a poke, not a timer's tick
    other.instance.get_rate_limits([RateLimitRequest(
        name=name, unique_key=key, hits=2, limit=10, duration=86_400_000,
        behavior=GLOBAL)])
    other.instance.global_manager.poke()
    got = None
    for _ in range(ATTEMPTS):
        got = owner.instance.get_rate_limits([probe])[0].remaining
        if got == 5:
            break
        time.sleep(0.05)
    assert got == 5


def test_static_discovery_joins_a_daemon_to_its_peers():
    """GUBER_PEER_DISCOVERY_TYPE=static with GUBER_PEERS naming another
    daemon: the daemon's ring holds both, itself added."""
    from gubernator_tpu_torch.config import setup_daemon_config
    from gubernator_tpu_torch.daemon import spawn_daemon

    first = spawn_daemon(port_cfgs(1)[0])
    try:
        cfg = setup_daemon_config(env={
            "GUBER_GRPC_ADDRESS": "127.0.0.1:0",
            "GUBER_HTTP_ADDRESS": "127.0.0.1:0", "GUBER_DEVICE": "cpu",
            "GUBER_CACHE_SIZE": "4096",
            "GUBER_PEERS": first.advertise_address})
        assert cfg.peer_discovery_type == "static"
        second = spawn_daemon(cfg)
        try:
            assert sorted(p.info.grpc_address
                          for p in second.instance.peers()) == sorted(
                [first.advertise_address, second.advertise_address])
            assert second.instance.health_check().peer_count == 2
            assert first.instance.health_check().peer_count == 0
        finally:
            second.close()
    finally:
        first.close()


def test_mixed_batch_answers_global_locally_and_forwards_the_rest(
        port_cluster):
    name = "clg_mixed"
    inst0 = port_cluster.instance_at(0)
    reqs = []
    for i in range(10):
        reqs.append(RateLimitRequest(name=name, unique_key=f"g{i}", hits=1,
                                     limit=100, duration=86_400_000,
                                     behavior=GLOBAL))
        reqs.append(RateLimitRequest(name=name, unique_key=f"p{i}", hits=1,
                                     limit=100, duration=86_400_000))
    fwd0 = inst0.forwarded_rows
    out = pb.GetRateLimitsResp.FromString(inst0.get_rate_limits_wire(
        encode_get_rate_limits(reqs), now_ms=NOW)).responses
    assert [r.remaining for r in out] == [99] * 20 and not any(
        r.error for r in out)
    remote = sum(port_cluster.owner_daemon_of(f"{name}_p{i}")
                 is not port_cluster.daemon_at(0) for i in range(10))
    assert inst0.forwarded_rows - fwd0 == remote
    assert inst0.health_check().peer_count == 3


def test_stopped_peer_answers_the_legacy_error_as_jax(jax_env):
    """Two daemons, the second stopped: daemon 0's rows owned by it
    answer the error row JAX answers with peer_degraded_fallback=False
    (over both lanes), and the GLOBAL hits that cannot reach it leave
    health unhealthy with JAX's message."""
    answers, health = [], []
    for start, conv, resp_cls in (
            (lambda: cluster_mod.start_with(port_cfgs(2, **LEGACY)),
             lambda r: r, pb.GetRateLimitsResp),
            (lambda: start_jax(2, **LEGACY), to_jax,
             jax_pb.GetRateLimitsResp)):
        c = start()
        try:
            dead = c.daemon_at(1)
            addr = dead.advertise_address
            key = next(f"s{i}" for i in range(100) if c.owner_daemon_of(
                f"cl_stop_s{i}") is dead)
            dead.close()
            req = RateLimitRequest(name="cl_stop", unique_key=key, hits=1,
                                   limit=5, duration=60_000)
            inst0 = c.instance_at(0)
            obj = inst0.get_rate_limits([conv(req)], now_ms=NOW)[0]
            wire = resp_cls.FromString(inst0.get_rate_limits_wire(
                encode_get_rate_limits([req]), now_ms=NOW)).responses[0]
            prefix = f"while fetching rate limit from peer {addr}: "
            answers.append([
                (int(r.status), r.limit, r.remaining, r.reset_time,
                 r.error.startswith(prefix),
                 "UNAVAILABLE" in r.error or "circuit open" in r.error)
                for r in (obj, wire)])
            g = RateLimitRequest(name="cl_stop", unique_key=key, hits=2,
                                 limit=5, duration=60_000, behavior=GLOBAL)
            assert inst0.get_rate_limits([conv(g)])[0].remaining == 3
            h = inst0.health_check()
            for _ in range(ATTEMPTS):
                if h.status != "healthy":
                    break
                time.sleep(0.05)
                h = inst0.health_check()
            health.append((h.status, h.message.startswith(
                f"global hits sync to {addr}: "), h.peer_count))
        finally:
            c.stop()
    assert answers[0] == answers[1] == [(0, 0, 0, 0, True, True)] * 2
    assert health[0] == health[1] == ("unhealthy", True, 2)
