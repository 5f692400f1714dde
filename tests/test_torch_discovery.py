"""The port's discovery backends (gubernator_tpu_torch/discovery.py) held
to the JAX package's: each scenario runs once per package against the
same fakes and inputs (a peers file, a patched getaddrinfo, the etcd and
Kubernetes API fakes of tests/test_discovery_backends.py), and the
notify sequences (every peer list on_change received, as (grpc, http,
datacenter) tuples) must be equal.  Gossip runs on localhost UDP; its RNG
is seeded from ``hash(gossip_addr)``, which varies by process, so the
gossip cases compare membership outcomes (the cases of
tests/test_gossip_hardening.py), and a mixed cluster of JAX and port
nodes must converge on one list.  Tolerance: exact lists."""
import json
import os
import socket
import threading
import time

import pytest

import gubernator_tpu_torch.discovery as port_disc
from gubernator_tpu_torch.config import DaemonConfig
from gubernator_tpu_torch.types import PeerInfo

from test_discovery_backends import FakeEtcd, FakeK8s  # noqa: E402


def jax_pkg():
    import gubernator_tpu.discovery as d
    from gubernator_tpu.types import PeerInfo as P

    return d, P


PKGS = {"port": lambda: (port_disc, PeerInfo), "jax": jax_pkg}


class Seq:
    """Thread-safe on_change history as (grpc, http, dc) tuples."""

    def __init__(self):
        self.mu = threading.Lock()
        self.lists = []

    def __call__(self, peers):
        with self.mu:
            self.lists.append([(p.grpc_address, p.http_address,
                                p.datacenter) for p in peers])

    def latest(self):
        with self.mu:
            return self.lists[-1] if self.lists else []


def wait_until(pred, timeout=10.0, step=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(step)
    return False


def both(scenario):
    """The scenario's notify sequence for each package, asserted equal."""
    out = {name: scenario(*mk()) for name, mk in PKGS.items()}
    assert out["port"] == out["jax"]
    return out["port"]


# ---- file ---------------------------------------------------------------

def test_file_discovery_edits_equal_jax(tmp_path):
    edits = ["# peers\n10.0.0.1:1051\n10.0.0.2:1051;10.0.0.2:1050@dc2\n",
             json.dumps([{"grpc_address": "10.0.0.3:1051"},
                         {"grpc_address": "10.0.0.4:1051",
                          "http_address": "10.0.0.4:1050",
                          "datacenter": "dc9"}]),
             "10.0.0.3:1051\n",
             "10.0.0.3:1051\n",  # same contents, new mtime: no notify
             "\n"]

    def scenario(mod, _peer):
        p = tmp_path / f"peers-{mod.__name__}.txt"
        p.write_text(edits[0])
        os.utime(p, (1_000, 1_000))
        seq = Seq()
        fd = mod.FileDiscovery(seq, str(p), poll_interval_ms=3_600_000,
                               default_dc="dc-local")
        try:
            for i, text in enumerate(edits[1:], start=1):
                p.write_text(text)
                os.utime(p, (1_000 + i, 1_000 + i))
                fd._poll()
            fd._poll()  # mtime unchanged: nothing
        finally:
            fd.close()
        return seq.lists

    lists = both(scenario)
    assert lists[0][1] == ("10.0.0.2:1051", "10.0.0.2:1050", "dc2")
    assert lists[0][0][2] == "dc-local"
    assert lists[-1] == []


def test_file_discovery_missing_file_is_quiet(tmp_path):
    def scenario(mod, _peer):
        seq = Seq()
        fd = mod.FileDiscovery(seq, str(tmp_path / "none"),
                               poll_interval_ms=3_600_000)
        fd.close()
        return seq.lists

    assert both(scenario) == []


# ---- dns ----------------------------------------------------------------

def test_dns_discovery_equals_jax(monkeypatch):
    answers = [
        ["10.0.0.2", "10.0.0.1", "10.0.0.1"],
        socket.gaierror("temporary failure"),
        ["10.0.0.1", "fd00::5"],
        ["10.0.0.1", "fd00::5"],
        [],
    ]

    def scenario(mod, _peer):
        script = iter(answers)

        def fake(host, port, *a, **k):
            assert host == "peers.example"
            ans = next(script)
            if isinstance(ans, Exception):
                raise ans
            fam = {False: socket.AF_INET, True: socket.AF_INET6}
            return [(fam[":" in ip], socket.SOCK_STREAM, 6, "",
                     (ip, port)) for ip in ans]

        monkeypatch.setattr(socket, "getaddrinfo", fake)
        seq = Seq()
        dd = mod.DnsDiscovery(seq, "peers.example", 1051,
                              poll_interval_ms=3_600_000,
                              default_dc="east")
        try:
            for _ in answers[1:]:
                dd._poll()
        finally:
            dd.close()
        return seq.lists

    lists = both(scenario)
    assert lists[0] == [("10.0.0.1:1051", "", "east"),
                        ("10.0.0.2:1051", "", "east")]
    assert ("[fd00::5]:1051", "", "east") in lists[1]
    assert lists[-1] == []


# ---- etcd ---------------------------------------------------------------

def etcd_scenario(mod, peer):
    """Two registrations, a watch-driven join and leave, a departure."""
    import base64

    fake = FakeEtcd()
    sa, sb = Seq(), Seq()
    try:
        a = mod.EtcdDiscovery(sa, ["127.0.0.1:1", fake.url], "/gub/peers/",
                              peer(grpc_address="10.0.0.1:1051"),
                              ttl_s=3600)
        assert wait_until(lambda: fake.watchers, 5)
        b = mod.EtcdDiscovery(sb, [fake.url], "/gub/peers/",
                              peer(grpc_address="10.0.0.2:1051"),
                              ttl_s=3600, watch=False)
        assert wait_until(lambda: len(sa.latest()) == 2, 5)
        fake.handle("/v3/kv/put", {
            "key": base64.b64encode(b"/gub/peers/10.0.0.3:1051").decode(),
            "value": base64.b64encode(json.dumps(
                {"grpc_address": "10.0.0.3:1051",
                 "datacenter": "dc3"}).encode()).decode()})
        assert wait_until(lambda: len(sa.latest()) == 3, 5)
        fake.handle("/v3/kv/deleterange", {
            "key": base64.b64encode(b"/gub/peers/10.0.0.3:1051").decode()})
        assert wait_until(lambda: len(sa.latest()) == 2, 5)
        b.close()
        assert wait_until(lambda: len(sa.latest()) == 1, 5)
        # a lost lease answers keepalive with TTL 0: re-register
        fake.leases.clear()
        fake.kv.clear()
        a._keepalive()
        assert fake.kv and a.lease_id in fake.leases
        a.close()
        assert not fake.kv, "close() must deregister"
    finally:
        fake.close()
    return sa.lists, sb.lists


def test_etcd_discovery_equals_jax():
    a, b = both(etcd_scenario)
    assert [len(x) for x in a] == [1, 2, 3, 2, 1]
    assert b[0] == [("10.0.0.1:1051", "", ""), ("10.0.0.2:1051", "", "")]


def test_etcd_requires_endpoints_and_range_end():
    for name, mk in PKGS.items():
        mod, peer = mk()
        with pytest.raises(ValueError):
            mod.EtcdDiscovery(lambda p: None, [], "/p/",
                              peer(grpc_address="x:1"))
        for raw, end in ((b"/gub/", b"/gub0"), (b"a\xff", b"b"),
                         (b"\xff\xff", b"\x00"), (b"", b"\x00")):
            assert mod.EtcdDiscovery._range_end(raw) == end, name


def test_etcd_peers_take_the_region():
    fake = FakeEtcd()
    seq = Seq()
    try:
        d = port_disc.EtcdDiscovery(
            seq, [fake.url], "/gub/peers/",
            PeerInfo(grpc_address="10.0.0.1:1051"), ttl_s=3600,
            watch=False, default_dc="west")
        import base64

        fake.kv[b"/gub/peers/10.0.0.9:1051"] = json.dumps(
            {"grpc_address": "10.0.0.9:1051"}).encode()
        d._poll()
        d.close()
        assert base64  # the fake stores raw bytes
    finally:
        fake.close()
    assert ("10.0.0.9:1051", "", "west") in seq.latest()


# ---- k8s ----------------------------------------------------------------

def test_k8s_pod_selector_and_watch_equal_jax():
    def scenario(mod, _peer):
        fake = FakeK8s(pods=[
            {"status": {"podIP": "10.1.0.5", "phase": "Running"}},
            {"status": {"podIP": "10.1.0.6", "phase": "Running"}},
            {"status": {"podIP": "10.1.0.7", "phase": "Pending"}},
            {"status": {"phase": "Running"}},
        ])
        seq = Seq()
        try:
            d = mod.K8sDiscovery(seq, "default", "app in (gub,gub2)", 1051,
                                 api_base=fake.url, token="tok-123",
                                 poll_interval_ms=3_600_000)
            assert fake.auth_seen[-1] == "Bearer tok-123"
            assert "labelSelector=app%20in%20%28gub%2Cgub2%29" in \
                fake.paths[0]
            assert wait_until(lambda: fake.watchers, 5)
            fake.pods.append({"status": {"podIP": "10.1.0.8",
                                         "phase": "Running"}})
            fake.emit("ADDED")
            assert wait_until(lambda: len(seq.latest()) == 3, 5)
            fake.emit("BOOKMARK", {"metadata": {"resourceVersion": "7"}})
            fake.pods.pop(0)
            fake.emit("DELETED")
            assert wait_until(lambda: len(seq.latest()) == 2, 5)
            d.close()
        finally:
            fake.close()
        return seq.lists

    lists = both(scenario)
    assert [p[0] for p in lists[0]] == ["10.1.0.5:1051", "10.1.0.6:1051"]
    assert [p[0] for p in lists[-1]] == ["10.1.0.6:1051", "10.1.0.8:1051"]


def test_k8s_named_endpoints_equal_jax():
    def scenario(mod, _peer):
        fake = FakeK8s(endpoints={
            "subsets": [{"addresses": [{"ip": "10.2.0.2"},
                                       {"ip": "10.2.0.1"}]}]})
        seq = Seq()
        try:
            d = mod.K8sDiscovery(seq, "default", "", 1051,
                                 service="gubernator-tpu-peers",
                                 api_base=fake.url, token="t",
                                 poll_interval_ms=3_600_000, watch=False)
            assert any(p.endswith("/endpoints/gubernator-tpu-peers")
                       for p in fake.paths)
            fake.endpoints = {"subsets": None}
            d._poll()
            d.close()
        finally:
            fake.close()
        return seq.lists

    assert both(scenario) == [[("10.2.0.1:1051", "", ""),
                               ("10.2.0.2:1051", "", "")], []]


def test_k8s_refusals_equal_jax(monkeypatch):
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
    for name, mk in PKGS.items():
        mod, _ = mk()
        with pytest.raises(ValueError, match="POD_SELECTOR or"):
            mod.K8sDiscovery(lambda p: None, "default", "", 1051,
                             api_base="http://127.0.0.1:1")
        with pytest.raises(RuntimeError, match="not in a cluster"):
            mod.K8sDiscovery(lambda p: None, "default", "app=x", 1051)
        with pytest.raises(RuntimeError, match="no CA cert"):
            mod.K8sDiscovery(lambda p: None, "default", "app=x", 1051,
                             api_base="https://127.0.0.1:1")


def test_k8s_peers_take_the_region():
    fake = FakeK8s(pods=[{"status": {"podIP": "10.4.0.1",
                                     "phase": "Running"}}])
    seq = Seq()
    try:
        d = port_disc.K8sDiscovery(seq, "ns", "app=g", 81,
                                   api_base=fake.url, watch=False,
                                   poll_interval_ms=3_600_000,
                                   default_dc="north")
        d.close()
    finally:
        fake.close()
    assert seq.latest() == [("10.4.0.1:81", "", "north")]


# ---- gossip (SWIM) ------------------------------------------------------

ALL3 = ["10.0.0.0:81", "10.0.0.1:81", "10.0.0.2:81"]


def addrs(seq):
    return sorted(p[0] for p in seq.latest())


def spawn(n, mods=None, interval_ms=100, suspect_ms=400, dead_ms=1200):
    """n gossip nodes on loopback, each seeded with node 0; node i's
    gRPC identity is 10.0.0.i:81 and its package ``mods[i]``."""
    nodes, seqs = [], []
    for i in range(n):
        mod, peer = (mods[i] if mods else (port_disc, PeerInfo))
        seq = Seq()
        node = mod.GossipDiscovery(
            seq, "127.0.0.1:0", peer(grpc_address=f"10.0.0.{i}:81"),
            known_hosts=[nodes[0].gossip_addr] if nodes else [],
            interval_ms=interval_ms, suspect_ms=suspect_ms,
            dead_ms=dead_ms)
        nodes.append(node)
        seqs.append(seq)
    return nodes, seqs


def test_gossip_three_converge_then_drop_a_closed_node():
    nodes, seqs = spawn(3)
    try:
        assert wait_until(lambda: all(addrs(s) == ALL3 for s in seqs), 15)
        nodes[2].close()
        two = ALL3[:2]
        assert wait_until(lambda: addrs(seqs[0]) == two
                          and addrs(seqs[1]) == two, 10)
        t0 = len(seqs[0].lists)
        time.sleep(1.5)  # no ghost: hearsay never refreshes a member
        assert all(sorted(p[0] for p in m) == two
                   for m in seqs[0].lists[t0:])
    finally:
        for node in nodes:
            node.close()


def test_gossip_mixed_packages_converge_on_one_list():
    """Two JAX nodes and one port node: one wire format, one list."""
    mods = [jax_pkg(), (port_disc, PeerInfo), jax_pkg()]
    nodes, seqs = spawn(3, mods)
    try:
        assert wait_until(lambda: all(addrs(s) == ALL3 for s in seqs), 15)
        assert seqs[0].latest() == seqs[1].latest() == seqs[2].latest()
        nodes[1].close()
        assert wait_until(lambda: addrs(seqs[0]) == [ALL3[0], ALL3[2]]
                          and addrs(seqs[2]) == [ALL3[0], ALL3[2]], 10)
    finally:
        for node in nodes:
            node.close()


def test_gossip_stable_under_30pct_loss():
    import random

    nodes, seqs = spawn(3)
    try:
        assert wait_until(lambda: all(addrs(s) == ALL3 for s in seqs), 15)
        for i, node in enumerate(nodes):
            rng, orig = random.Random(100 + i), node._send

            def lossy(addr, payload, rng=rng, orig=orig):
                if rng.random() >= 0.30:
                    orig(addr, payload)

            node._send = lossy
        marks = [len(s.lists) for s in seqs]
        time.sleep(3.0)
        for s, m in zip(seqs, marks):
            assert all(sorted(p[0] for p in x) == ALL3
                       for x in s.lists[m:])
    finally:
        for node in nodes:
            node.close()


def test_gossip_joiner_converges_by_state_push():
    nodes, seqs = spawn(2)
    try:
        assert wait_until(lambda: all(addrs(s) == ALL3[:2] for s in seqs),
                          15)
        seq3 = Seq()
        t0 = time.monotonic()
        nodes.append(port_disc.GossipDiscovery(
            seq3, "127.0.0.1:0", PeerInfo(grpc_address="10.0.0.2:81"),
            known_hosts=[nodes[0].gossip_addr], interval_ms=100,
            suspect_ms=400, dead_ms=1200))
        assert wait_until(lambda: addrs(seq3) == ALL3, 5)
        assert time.monotonic() - t0 < 5
    finally:
        for node in nodes:
            node.close()


def test_gossip_one_lossy_path_does_not_evict():
    nodes, seqs = spawn(3)
    try:
        assert wait_until(lambda: all(addrs(s) == ALL3 for s in seqs), 15)
        a_addr, orig = nodes[0].gossip_addr, nodes[2]._send

        def filtered(addr, payload):
            if addr == a_addr and b'"ack"' not in payload:
                return
            orig(addr, payload)

        nodes[2]._send = filtered
        mark = len(seqs[0].lists)
        time.sleep(3.0)
        assert all(sorted(p[0] for p in x) == ALL3
                   for x in seqs[0].lists[mark:])
    finally:
        for node in nodes:
            node.close()


def test_gossip_healed_partition_remerges_and_dead_retention_bounds():
    nodes, seqs = spawn(3)
    try:
        assert wait_until(lambda: all(addrs(s) == ALL3 for s in seqs), 15)
        nodes[2]._seeds = []
        c_addr = nodes[2].gossip_addr
        ab = {nodes[0].gossip_addr, nodes[1].gossip_addr}
        originals = [n._send for n in nodes]
        for node, blocked in zip(nodes, ({c_addr}, {c_addr}, ab)):
            def f(addr, payload, _orig=node._send, _blocked=blocked):
                if addr not in _blocked:
                    _orig(addr, payload)

            node._send = f
        assert wait_until(lambda: addrs(seqs[0]) == ALL3[:2]
                          and addrs(seqs[2]) == ALL3[2:], 15)
        for node, orig in zip(nodes, originals):
            node._send = orig
        assert wait_until(lambda: all(addrs(s) == ALL3 for s in seqs), 15)
    finally:
        for node in nodes:
            node.close()
    seq0, seq1 = Seq(), Seq()
    n0 = port_disc.GossipDiscovery(
        seq0, "127.0.0.1:0", PeerInfo(grpc_address="10.0.0.0:81"), [],
        interval_ms=100, suspect_ms=300, dead_ms=900, dead_retain_ms=1500)
    n1 = port_disc.GossipDiscovery(
        seq1, "127.0.0.1:0", PeerInfo(grpc_address="10.0.0.1:81"),
        [n0.gossip_addr], interval_ms=100, suspect_ms=300, dead_ms=900)
    try:
        assert wait_until(lambda: addrs(seq0) == ALL3[:2], 15)
        n1.close()
        assert wait_until(lambda: addrs(seq0) == ALL3[:1], 10)
        assert wait_until(lambda: not n0._dead, 10)
    finally:
        n0.close()
        n1.close()


def test_gossip_receiver_survives_garbage():
    nodes, seqs = spawn(2)
    try:
        assert wait_until(lambda: all(addrs(s) == ALL3[:2] for s in seqs),
                          15)
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        host, _, port = nodes[0].gossip_addr.rpartition(":")
        for payload in (b"\xff\x00garbage", b"[1,2,3]", b'"str"',
                        b'{"t":"ping-req","from":"x","target":123}',
                        b'{"t":"ping","from":42}',
                        b'{"from":"x:1","members":[1,2]}',
                        b'{"members":{"1.2.3.4:9":null}}',
                        b'{"from":"9.9.9.9:1","members":'
                        b'{"9.9.9.9:1":"notadict"}}'):
            s.sendto(payload, (host, int(port)))
        s.close()
        time.sleep(1.0)
        assert nodes[0]._rx.is_alive()
        assert addrs(seqs[0]) == ALL3[:2]
    finally:
        for node in nodes:
            node.close()


def test_gossip_notifications_stop_at_close():
    nodes, seqs = spawn(2)
    try:
        assert wait_until(lambda: all(addrs(s) == ALL3[:2] for s in seqs),
                          15)
        nodes[0].close()
        n = len(seqs[0].lists)
        nodes[0]._notify([PeerInfo(grpc_address="late:1")])
        assert len(seqs[0].lists) == n
    finally:
        for node in nodes:
            node.close()


# ---- make_discovery -----------------------------------------------------

def test_make_discovery_builds_each_type(tmp_path, monkeypatch):
    me = PeerInfo(grpc_address="127.0.0.1:0", datacenter="dc-a")
    peers = tmp_path / "peers"
    peers.write_text("127.0.0.1:7001\n")
    seq = Seq()
    d = port_disc.make_discovery(DaemonConfig(
        peer_discovery_type="file", peers_file=str(peers),
        data_center="dc-a"), me, seq)
    d.close()
    assert seq.latest() == [("127.0.0.1:7001", "", "dc-a")]
    monkeypatch.setattr(socket, "getaddrinfo", lambda *a, **k: [
        (socket.AF_INET, socket.SOCK_STREAM, 6, "", ("10.9.0.1", 7003))])
    seq = Seq()
    d = port_disc.make_discovery(DaemonConfig(
        peer_discovery_type="dns", dns_fqdn="x",
        grpc_listen_address="0.0.0.0:7003"), me, seq)
    d.close()
    assert seq.latest() == [("10.9.0.1:7003", "", "")]
    monkeypatch.undo()
    # gossip binds the gRPC port + 1
    probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    probe.bind(("127.0.0.1", 0))
    gport = probe.getsockname()[1]
    probe.close()
    seq = Seq()
    d = port_disc.make_discovery(
        DaemonConfig(peer_discovery_type="member-list"),
        PeerInfo(grpc_address=f"127.0.0.1:{gport - 1}"), seq)
    try:
        assert d.gossip_addr == f"127.0.0.1:{gport}"
    finally:
        d.close()
    fake = FakeEtcd()
    try:
        seq = Seq()
        d = port_disc.make_discovery(DaemonConfig(
            peer_discovery_type="etcd", etcd_endpoints=[fake.url]), me, seq)
        d.close()
        assert seq.lists[0] == [("127.0.0.1:0", "", "dc-a")]
    finally:
        fake.close()


@pytest.mark.parametrize("kind", ["carrier-pigeon", "consul", "STATIC"])
def test_unknown_discovery_types_raise_as_jax(kind):
    from gubernator_tpu.config import DaemonConfig as JaxDaemonConfig
    from gubernator_tpu.discovery import make_discovery as jax_make
    from gubernator_tpu.types import PeerInfo as JaxPeer

    with pytest.raises(ValueError, match="unknown peer discovery type"):
        port_disc.make_discovery(DaemonConfig(peer_discovery_type=kind),
                                 PeerInfo(grpc_address="x:1"),
                                 lambda p: None)
    with pytest.raises(ValueError, match="unknown peer discovery type"):
        jax_make(JaxDaemonConfig(peer_discovery_type=kind),
                 JaxPeer(grpc_address="x:1"), lambda p: None)


def test_discovery_config_keys_equal_jax():
    from gubernator_tpu.config import ENV_REGISTRY
    from gubernator_tpu.config import setup_daemon_config as jax_setup

    from gubernator_tpu_torch.config import HELP, setup_daemon_config

    env = {"GUBER_PEER_DISCOVERY_TYPE": "etcd",
           "GUBER_PEERS_FILE": "/p", "GUBER_DNS_FQDN": "f.example",
           "GUBER_DNS_RESOLVE_INTERVAL": "1m30s",
           "GUBER_ETCD_ENDPOINTS": "a:1, b:2,", "GUBER_ETCD_PREFIX": "/x/",
           "GUBER_K8S_NAMESPACE": "ns", "GUBER_K8S_POD_SELECTOR": "app=g",
           "GUBER_K8S_SERVICE": "svc", "GUBER_K8S_INSECURE": "true",
           "GUBER_MEMBERLIST_KNOWN_HOSTS": "h:1,h:2"}
    got, want = setup_daemon_config(env=env), jax_setup(env=env)
    for f in ("peer_discovery_type", "peers_file", "dns_fqdn",
              "dns_resolve_interval_ms", "etcd_endpoints", "etcd_prefix",
              "k8s_namespace", "k8s_pod_selector", "k8s_service",
              "k8s_insecure_skip_verify", "memberlist_known_hosts"):
        assert getattr(got, f) == getattr(want, f), f
    for key, text in HELP.items():
        assert ENV_REGISTRY[key] == text, key
    assert DaemonConfig().etcd_prefix == "/gubernator/peers/"
