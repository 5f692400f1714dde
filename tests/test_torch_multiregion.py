"""MULTI_REGION in both packages: 2 regions x 2 daemons (``dc-east``,
``dc-west``, tests/test_multiregion.py's layout), the port's on
``device="cpu"``, the JAX package's on ``make_mesh(n=1)``, real gRPC
over loopback.

The same seeded streams go to both, over both lanes: first to an east
daemon (its answers compared row for row), then, once every MULTI_REGION
key converged across the regions, to a west daemon.  Converged counters
must be equal in both regions and both packages, a further quiet wait
changes nothing (the copy sent to the other region drops the flag: no
ping-pong), an armed ``mr_sync`` tick loses no hit, and in a batch mixing
MULTI_REGION and plain rows only the former replicate.  Every comparison
is exact.  Replicated hits apply at the receiving owner's own clock (the
typed peer RPC carries no caller clock, in both packages), so the
streams run at the wall clock with day-long TOKEN buckets, and answers
after a replication are compared without their reset time."""
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
from gubernator_tpu_torch.proto import gubernator_pb2 as pb
from gubernator_tpu_torch.types import RateLimitRequest
from gubernator_tpu_torch.wire import encode_get_rate_limits

DAY = 86_400_000
MR = 16
FIELDS = ("name", "unique_key", "hits", "limit", "duration", "algorithm",
          "behavior", "burst")
TIMING = dict(batch_timeout_ms=30, batch_wait_ms=30,
              multi_region_sync_wait_ms=50, multi_region_timeout_ms=5000)
REGIONS = ["dc-east", "dc-east", "dc-west", "dc-west"]
#: attempts before a wait gives up (a convergence check sleeps 50 ms
#: between them); generous, because a JAX daemon busy compiling under a
#: loaded CPU takes seconds to apply a replicated batch
ATTEMPTS = 1200


@pytest.fixture(scope="module")
def jax_env():
    with pytest.MonkeyPatch.context() as mp:
        for var in ("GUBER_ANALYTICS", "GUBER_SLO", "GUBER_MEM_LEDGER"):
            mp.setenv(var, "0")
        yield


@pytest.fixture(scope="module")
def port_regions():
    c = cluster_mod.start_with([DaemonConfig(
        grpc_listen_address="127.0.0.1:0", http_listen_address="127.0.0.1:0",
        cache_size=1 << 10, batch_rows=64, device="cpu", data_center=dc,
        behaviors=BehaviorConfig(**TIMING)) for dc in REGIONS])
    yield c
    c.stop()


@pytest.fixture(scope="module")
def jax_regions(jax_env):
    from gubernator_tpu.parallel import make_mesh

    c = jax_cluster_mod.start_with([JaxDaemonConfig(
        grpc_listen_address="127.0.0.1:0", http_listen_address="",
        cache_size=1 << 10, data_center=dc,
        behaviors=JaxBehaviors(**TIMING)) for dc in REGIONS],
        mesh=make_mesh(n=1))
    yield c
    c.stop()


def to_jax(r):
    return JaxReq(**{f: getattr(r, f) for f in FIELDS})


def pair(port_regions, jax_regions):
    return ((port_regions, lambda r: r, pb.GetRateLimitsResp),
            (jax_regions, to_jax, jax_pb.GetRateLimitsResp))


def stream(seed: int, name: str, object_lane: bool):
    """Five batches of 30 requests over 40 keys, each batch at its own
    ``now``: keys below 24 are MULTI_REGION at a limit of 100, the rest
    plain at limits of 6-10 (some run out); TOKEN, day-long, hits 0-3.
    A replicated apply of more hits than remain would go OVER as one
    request, and when a tick fires decides how hits are summed, so the
    MULTI_REGION keys never run out: their converged counters are
    exact.  On the object lane
    a key appears once a batch (two forwards of one key may apply on its
    owner in either order, in both packages)."""
    rng = np.random.default_rng(seed)
    t0 = int(time.time() * 1000)
    out = []
    for b in range(5):
        ks = (rng.choice(40, 30, replace=False) if object_lane
              else rng.integers(0, 40, 30))
        out.append(([RateLimitRequest(
            name=name, unique_key=f"k{k}", hits=int(rng.integers(0, 4)),
            limit=100 if k < 24 else 6 + k % 5, duration=DAY,
            behavior=MR if k < 24 else 0)
            for k in ks.tolist()], t0 + 300 * b))
    return out


def rows(resps, reset: bool = True):
    return [(int(r.status), r.limit, r.remaining,
             r.reset_time if reset else None, r.error) for r in resps]


def run(inst, batches, lane, conv, resp_cls, reset=True):
    out = []
    for reqs, now in batches:
        if lane == "object":
            resps = inst.get_rate_limits([conv(r) for r in reqs], now_ms=now)
        else:
            resps = resp_cls.FromString(inst.get_rate_limits_wire(
                encode_get_rate_limits(reqs), now_ms=now)).responses
        out.append(rows(resps, reset))
    return out


def probe_all(c, name, keys, limit_of, conv, resp_cls):
    """Each daemon's remaining of each key (hits=0 probes, wire lane)."""
    reqs = [RateLimitRequest(name=name, unique_key=k, hits=0,
                             limit=limit_of(k), duration=DAY,
                             behavior=MR) for k in keys]
    return [[int(r.remaining) for r in resp_cls.FromString(
        d.instance.get_rate_limits_wire(encode_get_rate_limits(reqs)))
        .responses] for d in c.daemons]


def converged(c, name, keys, limit_of, conv, resp_cls):
    """Poll until every daemon answers each key alike twice in a row;
    returns the answers (east daemon 0's row)."""
    last = None
    for _ in range(ATTEMPTS):
        got = probe_all(c, name, keys, limit_of, conv, resp_cls)
        if all(row == got[0] for row in got) and got == last:
            return got[0]
        last = got
        time.sleep(0.05)
    raise AssertionError(f"regions did not converge: {got}")


def test_region_pickers_split(port_regions, jax_regions):
    for c, _, _ in pair(port_regions, jax_regions):
        pickers = c.instance_at(0).region_pickers()
        assert set(pickers) == {"dc-east", "dc-west"}
        assert [len(pickers[dc].peers()) for dc in ("dc-east", "dc-west")] \
            == [2, 2]


@pytest.mark.parametrize("lane", ["object", "wire"])
def test_streams_answer_and_converge_as_jax(lane, port_regions,
                                            jax_regions):
    """East answers row for row as JAX's east; the MULTI_REGION keys
    converge in both regions to the same counters as JAX's; then the
    same for a stream to the west; plain keys stay per region."""
    name = f"mr_{lane}"
    east, west = stream(3, name, lane == "object"), stream(
        4, name, lane == "object")
    mr_keys = [f"k{k}" for k in range(24)]
    plain = [f"k{k}" for k in range(24, 40)]
    limit_of = lambda k: 100 if int(k[1:]) < 24 else 6 + int(k[1:]) % 5  # noqa: E731
    results = []
    for c, conv, resp_cls in pair(port_regions, jax_regions):
        got_east = run(c.instance_at(0), east, lane, conv, resp_cls)
        after_east = converged(c, name, mr_keys, limit_of, conv, resp_cls)
        got_west = run(c.instance_at(2), west, lane, conv, resp_cls,
                       reset=False)
        after_west = converged(c, name, mr_keys, limit_of, conv, resp_cls)
        # plain keys: each region keeps its own count
        per_region = probe_all(c, name, plain, limit_of, conv, resp_cls)
        results.append((got_east, after_east, got_west, after_west,
                        per_region))
    assert results[0] == results[1]
    got_east, after_east, _, after_west, per_region = results[0]
    assert any(r[0] == 1 for b in got_east for r in b)  # some went OVER
    # exactly the limit less the hits sent to both regions
    for batches, want in ((east, after_east), (east + west, after_west)):
        sent = {k: 0 for k in mr_keys}
        for reqs, _ in batches:
            for r in reqs:
                if r.unique_key in sent:
                    sent[r.unique_key] += r.hits
        assert want == [100 - sent[k] for k in mr_keys]
    assert per_region[0] == per_region[1] and per_region[2] == per_region[3]
    assert per_region[0] != per_region[2]


@pytest.mark.parametrize("lane", ["object", "wire"])
def test_no_ping_pong(lane, port_regions, jax_regions):
    """After convergence a quiet wait of ten sync ticks changes nothing
    in either region (the replicated copy drops MULTI_REGION)."""
    name = f"mr_pp_{lane}"
    key = "pp"
    req = RateLimitRequest(name=name, unique_key=key, hits=5, limit=100,
                           duration=DAY, behavior=MR)
    for c, conv, resp_cls in pair(port_regions, jax_regions):
        run(c.instance_at(1), [([req], int(time.time() * 1000))], lane,
            conv, resp_cls)
        assert converged(c, name, [key], lambda k: 100, conv,
                         resp_cls) == [95]
        time.sleep(10 * TIMING["multi_region_sync_wait_ms"] / 1000)
        assert probe_all(c, name, [key], lambda k: 100, conv,
                         resp_cls) == [[95]] * 4


@pytest.mark.parametrize("lane", ["object", "wire"])
def test_mr_sync_fault_loses_no_hit(lane, port_regions, jax_regions):
    """An armed mr_sync aborts each tick before the queues are taken:
    the region owner's queue holds every hit sent, and once the fault
    clears the other region converges to the exact total."""
    name = f"mr_fault_{lane}"
    for c, conv, resp_cls in pair(port_regions, jax_regions):
        key = next(f"f{i}" for i in range(200)
                   if c.owner_daemon_of(f"{name}_f{i}") is c.daemon_at(0))
        inst = c.instance_at(0)
        inst.faults.arm("mr_sync:error", seed=5)
        try:
            req = RateLimitRequest(name=name, unique_key=key, hits=3,
                                   limit=100, duration=DAY, behavior=MR)
            for _ in range(4):
                run(inst, [([req], int(time.time() * 1000))], lane, conv,
                    resp_cls)
            mr = inst._ensure_mr_manager()
            fired0 = sum(p["fired"] for p in inst.faults.describe()["points"])
            mr.poke()
            for _ in range(ATTEMPTS):
                if sum(p["fired"] for p in
                       inst.faults.describe()["points"]) > fired0:
                    break
                time.sleep(0.02)
            with mr._mu:
                queued = sum(a for _, a, _ in mr._hits.values()) + sum(
                    a for _, a, _ in mr._hits_raw.values())
            assert queued == 12
            assert inst.health_check().status == "unhealthy"
        finally:
            inst.faults.clear()
        assert converged(c, name, [key], lambda k: 100, conv,
                         resp_cls) == [88]


@pytest.mark.parametrize("lane", ["object", "wire"])
def test_mixed_multi_region_and_plain_batch(lane, port_regions,
                                            jax_regions):
    """A MULTI_REGION row and a plain row in one batch: both served, only
    the first replicates (the plain key starts afresh in the west)."""
    name = f"mr_mix_{lane}"
    results = []
    for c, conv, resp_cls in pair(port_regions, jax_regions):
        now = int(time.time() * 1000)
        got = run(c.instance_at(0), [([
            RateLimitRequest(name=name, unique_key="m", hits=4, limit=100,
                             duration=DAY, behavior=MR),
            RateLimitRequest(name=name, unique_key="p", hits=1, limit=9,
                             duration=DAY)], now)], lane, conv, resp_cls)
        m = converged(c, name, ["m"], lambda k: 100, conv, resp_cls)
        west = run(c.instance_at(2), [([RateLimitRequest(
            name=name, unique_key="p", hits=1, limit=9, duration=DAY)],
            now + 1)], lane, conv, resp_cls, reset=False)
        results.append((got[0][0][:3], got[0][1][:3], m, west))
    assert results[0] == results[1]
    assert results[0][2] == [96] and results[0][3][0][0][2] == 8


def test_region_picker_resolves_as_jax():
    """The port's RegionPeerPicker puts every key on the JAX picker's
    peer, per region, for the same peers (a peer with no datacenter is
    local); the vectorized lookups index the local region's peers."""
    from gubernator_tpu.peers import RegionPeerPicker as JaxPicker
    from gubernator_tpu.types import PeerInfo as JaxInfo
    from gubernator_tpu_torch.hashing import hash_keys
    from gubernator_tpu_torch.peers import RegionPeerPicker
    from gubernator_tpu_torch.types import PeerInfo

    class Peer:
        def __init__(self, info):
            self.info = info

    spec = [("10.0.0.1:81", "east"), ("10.0.0.2:81", "east"),
            ("10.0.0.3:81", "west"), ("10.0.0.4:81", ""),
            ("10.0.0.5:81", "west")]
    port, ref = RegionPeerPicker("east"), JaxPicker("east")
    for addr, dc in spec:
        port.add(Peer(PeerInfo(grpc_address=addr, datacenter=dc)))
        ref.add(Peer(JaxInfo(grpc_address=addr, datacenter=dc)))
    assert sorted(port.regions) == sorted(ref.regions) == ["east", "west"]
    keys = [f"n_k{i}" for i in range(500)]
    assert [port.get(k).info.grpc_address for k in keys] == \
        [ref.get(k).info.grpc_address for k in keys]
    for dc in ("east", "west"):
        assert [port.regions[dc].get(k).info.grpc_address
                for k in keys] == [ref.regions[dc].get(k).info.grpc_address
                                   for k in keys]
    kh = hash_keys(keys)
    assert [p.info.grpc_address for p in port.owner_peers()] == \
        [p.info.grpc_address for p in ref.owner_peers()]
    assert (port.owner_indices(kh) == ref.owner_indices(kh)).all()
    assert len(port.peers()) == 5 and port.new().regions == {}


def test_config_keys_parse_as_jax():
    """GUBER_DATA_CENTER, GUBER_INSTANCE_ID, GUBER_CLIENT_ADDRESS and the
    GUBER_MULTI_REGION_* keys read as the JAX package reads them, and a
    daemon's region reaches its instance and its PeerInfo."""
    from gubernator_tpu.config import setup_daemon_config as jax_setup
    from gubernator_tpu_torch.config import setup_daemon_config

    env = {"GUBER_DATA_CENTER": "dc-west", "GUBER_INSTANCE_ID": "w-1",
           "GUBER_CLIENT_ADDRESS": "127.0.0.1:7000",
           "GUBER_MULTI_REGION_SYNC_WAIT": "250ms",
           "GUBER_MULTI_REGION_TIMEOUT": "2s",
           "GUBER_MULTI_REGION_BATCH_LIMIT": "77"}
    port, ref = setup_daemon_config(env=env), jax_setup(env=env)
    for f in ("data_center", "instance_id", "client_listen_address"):
        assert getattr(port, f) == getattr(ref, f), f
    for f in ("multi_region_sync_wait_ms", "multi_region_timeout_ms",
              "multi_region_batch_limit"):
        assert getattr(port.behaviors, f) == getattr(ref.behaviors, f), f
    assert (port.behaviors.multi_region_sync_wait_ms,
            port.behaviors.multi_region_timeout_ms,
            port.behaviors.multi_region_batch_limit) == (250, 2000, 77)
    assert port.instance_config().data_center == "dc-west"
