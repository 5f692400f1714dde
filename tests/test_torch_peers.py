"""The port's peer rings, peer config and static discovery against the JAX
package's: for 1–5 peers and 10,000 seeded keys, ``ConsistentHash`` and
``ReplicatedConsistentHash`` (with the default hash and with
``crc64_hash``) name the same owner as JAX's through ``get``,
``get_by_hash``, ``get_by_raw_hash`` and ``owner_indices``; the
GUBER_PEERS / GUBER_BATCH_* / GUBER_GLOBAL_* keys parse to JAX's
values."""
import numpy as np
import pytest

from gubernator_tpu import config as jax_config
from gubernator_tpu import peers as jax_peers
from gubernator_tpu.types import PeerInfo as JaxPeerInfo
from gubernator_tpu_torch import config, discovery, peers
from gubernator_tpu_torch.hashing import fnv1a64, mixed_fnv1a64
from gubernator_tpu_torch.interval import IntervalLoop
from gubernator_tpu_torch.netutil import resolve_host_ip, split_host_port
from gubernator_tpu_torch.types import PeerInfo

N_KEYS = 10_000


class Peer:
    def __init__(self, info):
        self.info = info


def seeded_keys(seed: int):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 1 << 40, N_KEYS)
    names = rng.choice(["api", "login", "upload_bytes", "t/9"], N_KEYS)
    return [f"{n}_acct:{i}" for n, i in zip(names, ids)]


def addresses(n_peers: int, seed: int):
    rng = np.random.default_rng(100 + seed)
    return [f"10.{rng.integers(0, 255)}.{rng.integers(0, 255)}."
            f"{rng.integers(1, 255)}:{rng.integers(1024, 65535)}"
            for _ in range(n_peers)]


def build(mod, info_cls, kind, hash_name, addrs):
    cls = getattr(mod, kind)
    picker = cls(mod.crc64_hash) if hash_name == "crc64" else cls()
    for a in addrs:
        picker.add(Peer(info_cls(grpc_address=a)))
    return picker


@pytest.mark.parametrize("hash_name", ["default", "crc64"])
@pytest.mark.parametrize("kind", ["ConsistentHash",
                                  "ReplicatedConsistentHash"])
@pytest.mark.parametrize("n_peers", [1, 2, 3, 4, 5])
def test_ring_owners_match_jax(n_peers, kind, hash_name):
    addrs = addresses(n_peers, n_peers)
    port = build(peers, PeerInfo, kind, hash_name, addrs)
    ref = build(jax_peers, JaxPeerInfo, kind, hash_name, addrs)
    keys = seeded_keys(n_peers)
    got = [port.get(k).info.grpc_address for k in keys]
    want = [ref.get(k).info.grpc_address for k in keys]
    assert got == want
    assert len(set(got)) == n_peers  # every peer owns some keys
    assert [p.info.grpc_address for p in port.peers()] == \
        [p.info.grpc_address for p in ref.peers()]
    if hash_name != "default":
        return
    # the hash-level lookups the wire lanes use (default hash only)
    raw = np.array([fnv1a64(k.encode()) for k in keys], np.uint64)
    mixed = np.array([mixed_fnv1a64(k.encode()) for k in keys], np.uint64)
    assert [port.get_by_hash(int(h)).info.grpc_address
            for h in mixed] == want
    assert [port.get_by_raw_hash(int(h)).info.grpc_address
            for h in raw] == want
    idx = port.owner_indices(mixed)
    np.testing.assert_array_equal(idx, ref.owner_indices(mixed))
    owners = port.owner_peers()
    assert [owners[i].info.grpc_address for i in idx] == want


def test_ring_rejects_lookups_without_peers():
    for kind in ("ConsistentHash", "ReplicatedConsistentHash"):
        picker = getattr(peers, kind)()
        with pytest.raises(RuntimeError, match="no peers"):
            picker.get("k")
        with pytest.raises(RuntimeError, match="no peers"):
            picker.owner_indices(np.zeros(1, np.uint64))


def test_replicated_ring_moves_few_keys_when_a_peer_joins():
    keys = seeded_keys(7)
    addrs = addresses(5, 7)
    four = build(peers, PeerInfo, "ReplicatedConsistentHash", "default",
                 addrs[:4])
    five = four.new()
    for a in addrs:
        five.add(Peer(PeerInfo(grpc_address=a)))
    moved = [k for k in keys if four.get(k).info.grpc_address
             != five.get(k).info.grpc_address]
    # only keys that move to the new peer move
    assert all(five.get(k).info.grpc_address == addrs[4] for k in moved)
    assert 0.1 * N_KEYS < len(moved) < 0.35 * N_KEYS


ENV = {"GUBER_PEERS": "127.0.0.1:9001, 127.0.0.1:9002;127.0.0.1:9102@dc2",
       "GUBER_BATCH_TIMEOUT": "1s", "GUBER_BATCH_WAIT": "250ms",
       "GUBER_BATCH_LIMIT": "500", "GUBER_GLOBAL_SYNC_WAIT": "1m30s",
       "GUBER_GLOBAL_TIMEOUT": "2000", "GUBER_GLOBAL_BATCH_LIMIT": "64",
       "GUBER_GLOBAL_BROADCAST_INTERVAL": "75ms",
       "GUBER_ADVERTISE_ADDRESS": "127.0.0.1:9001"}

BEHAVIOR_KEYS = ("batch_timeout_ms", "batch_wait_ms", "batch_limit",
                 "global_sync_wait_ms", "global_timeout_ms",
                 "global_batch_limit", "global_broadcast_interval_ms",
                 "peer_inflight", "peer_coalesce_us", "peer_retry_limit",
                 "peer_retry_backoff_ms", "peer_circuit_threshold",
                 "peer_circuit_cooldown_ms")


@pytest.mark.parametrize("env", [{}, ENV], ids=["defaults", "set"])
def test_peer_config_keys_parse_as_jax(env):
    got = config.setup_daemon_config(env=dict(env))
    want = jax_config.setup_daemon_config(env=dict(env))
    for k in BEHAVIOR_KEYS:
        assert getattr(got.behaviors, k) == getattr(want.behaviors, k), k
    assert got.peer_discovery_type == want.peer_discovery_type
    assert got.static_peers == want.static_peers
    assert got.advertise_address == want.advertise_address
    assert [vars(p) for p in config.parse_peer_list(got.static_peers)] == \
        [vars(p) for p in jax_config.parse_peer_list(want.static_peers)]


@pytest.mark.parametrize("s", ["0", "250", "250ms", "1.5s", "1m30s", "2h",
                               "-3s", "10us"])
def test_parse_duration_matches_jax(s):
    assert config.parse_duration_ms(s) == jax_config.parse_duration_ms(s)


def test_static_discovery_adds_self_and_other_types_raise():
    seen = []
    cfg = config.setup_daemon_config(env={"GUBER_PEERS": "127.0.0.1:1,"
                                                         "127.0.0.1:2"})
    me = PeerInfo(grpc_address="127.0.0.1:3")
    d = discovery.make_discovery(cfg, me, seen.append)
    assert [p.grpc_address for p in seen[0]] == \
        ["127.0.0.1:1", "127.0.0.1:2", "127.0.0.1:3"]
    d.close()
    d._notify([me])  # closed: no further notification
    assert len(seen) == 1
    assert discovery.make_discovery(config.DaemonConfig(), me,
                                    seen.append) is None
    # every backend is ported now; an unknown type still raises
    cfg.peer_discovery_type = "carrier-pigeon"
    with pytest.raises(ValueError, match="unknown peer discovery type"):
        discovery.make_discovery(cfg, me, seen.append)


def test_netutil_resolves_loopback_and_rejects_bad_addresses():
    assert resolve_host_ip("127.0.0.1:80") == "127.0.0.1:80"
    assert resolve_host_ip("localhost:1051") == "127.0.0.1:1051"
    assert split_host_port("[::1]:5") == ("[::1]", 5)
    with pytest.raises(ValueError):
        split_host_port("no-port")


def test_interval_loop_ticks_pokes_and_flushes_on_close():
    import threading

    ticks = []
    ev = threading.Event()

    def fn():
        ticks.append(1)
        ev.set()

    loop = IntervalLoop(60_000, fn, name="t")
    loop.poke()
    assert ev.wait(10)
    n = len(ticks)
    loop.close()
    assert len(ticks) == n + 1  # the final flush
    assert not loop._thread.is_alive()


def test_defaults_equal_jax():
    """The port's BehaviorConfig(), Config() and DaemonConfig() defaults
    equal the JAX package's on every field both have (the failure path's
    included: degraded serves and the health gate on, eject and readmit
    at 3000 ms, no handover), and the device is the port's own field."""
    import dataclasses

    from gubernator_tpu import config as jax_config
    from gubernator_tpu_torch import config as port_config

    for name in ("BehaviorConfig", "Config", "DaemonConfig"):
        port = getattr(port_config, name)()
        ref = getattr(jax_config, name)()
        shared = ({f.name for f in dataclasses.fields(port)}
                  & {f.name for f in dataclasses.fields(ref)}) - {
            "behaviors"}
        assert len(shared) >= 6, name
        for f in sorted(shared):
            assert getattr(port, f) == getattr(ref, f), (name, f)
    b = port_config.BehaviorConfig()
    assert (b.peer_degraded_fallback, b.peer_health_gate,
            b.peer_eject_after_ms, b.peer_readmit_after_ms) == (
        True, True, 3000, 3000)
    assert port_config.Config().handover_on_reshard is False


def test_failure_path_options_serve():
    """An instance with every failure-path option on serves, and the
    config keys parse as the JAX package parses them."""
    from gubernator_tpu.config import setup_daemon_config as jax_setup
    from gubernator_tpu_torch.config import (BehaviorConfig, Config,
                                             setup_daemon_config)
    from gubernator_tpu_torch.instance import V1Instance
    from gubernator_tpu_torch.types import RateLimitRequest

    inst = V1Instance(Config(
        device="cpu", cache_size=4096, handover_on_reshard=True,
        behaviors=BehaviorConfig(peer_degraded_fallback=True,
                                 peer_health_gate=True)))
    try:
        r = inst.get_rate_limits([RateLimitRequest(
            name="n", unique_key="k", limit=5, duration=60_000)])[0]
        assert (r.error, r.remaining) == ("", 4)
    finally:
        inst.close()
    env = {"GUBER_PEER_EJECT_AFTER": "1.5s",
           "GUBER_PEER_READMIT_AFTER": "250ms",
           "GUBER_HANDOVER_ON_RESHARD": "true",
           "GUBER_PEER_HEALTH_GATE": "0",
           "GUBER_PEER_DEGRADED_FALLBACK": "off"}
    port, ref = setup_daemon_config(env=env), jax_setup(env=env)
    for f in ("peer_eject_after_ms", "peer_readmit_after_ms",
              "peer_health_gate", "peer_degraded_fallback"):
        assert getattr(port.behaviors, f) == getattr(ref.behaviors, f), f
    assert port.handover_on_reshard is ref.handover_on_reshard is True
    assert port.instance_config().handover_on_reshard is True
    assert (port.behaviors.peer_eject_after_ms,
            port.behaviors.peer_readmit_after_ms) == (1500, 250)
