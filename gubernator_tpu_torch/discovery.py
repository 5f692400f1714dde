"""Peer discovery: a membership source → the instance's set_peers (the
port of gubernator_tpu/discovery.py; etcd.go › EtcdPool, memberlist.go ›
MemberListPool, kubernetes.go › K8sPool, dns.go › DNSPool).

Each source resolves the current peer set and calls ``on_change`` with
the full list whenever it differs from the last one.  All are built on
the standard library alone:

- ``static``: GUBER_PEERS;
- ``file``: a peers file re-read when its mtime changes (lines as
  GUBER_PEERS entries, or a JSON array of objects);
- ``dns``: A/AAAA records of one name, every address a peer at this
  daemon's gRPC port;
- ``member-list`` / ``memberlist`` / ``gossip``: UDP heartbeats on the
  gRPC port + 1 with SWIM rules (``GossipDiscovery``);
- ``etcd``: a leased registration and range polls over etcd's v3 JSON
  gateway, with a watch stream;
- ``k8s``: the API server's pods (by label selector) or a service's
  endpoints, polled and watched.

Every source takes the daemon's region (``default_dc``) for a peer that
names none.  An unknown type raises.
"""
from __future__ import annotations

import json
import logging
import os
import random
import socket
import threading
import time
from typing import Callable, List, Optional, Sequence

from .config import DaemonConfig, parse_peer_list
from .interval import IntervalLoop
from .netutil import split_host_port
from .types import PeerInfo

log = logging.getLogger("gubernator_tpu_torch.discovery")

OnChange = Callable[[List[PeerInfo]], None]


class Discovery:
    """Deduplicated change notification.  The lock serializes notifiers
    (the gossip receiver against its tick, a watch against a poll), so a
    stale list is never applied after a newer one; ``mark_closed``
    fences late notifiers: a thread that outlives ``close()`` must not
    call ``on_change`` on a closed daemon."""

    def __init__(self, on_change: OnChange):
        self._on_change = on_change
        self._last: Optional[tuple] = None  # guarded-by: self._notify_mu
        self._notify_mu = threading.Lock()
        self._discovery_closed = False  # guarded-by: self._notify_mu

    def _notify(self, peers: Sequence[PeerInfo]) -> None:
        key = tuple(sorted((p.grpc_address, p.http_address, p.datacenter)
                           for p in peers))
        with self._notify_mu:
            if self._discovery_closed or key == self._last:
                return
            self._last = key
            self._on_change(list(peers))

    def mark_closed(self) -> None:
        """Called first by every close(): no on_change after it returns."""
        with self._notify_mu:
            self._discovery_closed = True

    def close(self) -> None:
        self.mark_closed()


class StaticDiscovery(Discovery):
    """A fixed peer list from the config (GUBER_PEERS)."""

    def __init__(self, on_change: OnChange, peers: Sequence[PeerInfo]):
        super().__init__(on_change)
        self._notify(peers)


class FileDiscovery(Discovery):
    """Re-read a peers file when its mtime changes: one
    "grpc_addr[;http_addr][@dc]" per line, or a JSON array of objects."""

    def __init__(self, on_change: OnChange, path: str,
                 poll_interval_ms: int = 3000, default_dc: str = ""):
        super().__init__(on_change)
        self.path = path
        self.default_dc = default_dc
        self._mtime = -1.0
        self._poll()
        self._loop = IntervalLoop(poll_interval_ms, self._poll,
                                  name="file-discovery")

    def _poll(self) -> None:
        try:
            mtime = os.stat(self.path).st_mtime
        except OSError:
            return
        if mtime == self._mtime:
            return
        self._mtime = mtime
        with open(self.path) as f:
            text = f.read()
        text_s = text.strip()
        if text_s.startswith("["):
            peers = [PeerInfo(grpc_address=o.get("grpc_address", ""),
                              http_address=o.get("http_address", ""),
                              datacenter=o.get("datacenter",
                                               self.default_dc))
                     for o in json.loads(text_s)]
        else:
            lines = [ln.strip() for ln in text.splitlines()
                     if ln.strip() and not ln.strip().startswith("#")]
            peers = parse_peer_list(lines, self.default_dc)
        self._notify(peers)

    def close(self) -> None:
        self.mark_closed()
        self._loop.close()


class DnsDiscovery(Discovery):
    """Periodic A/AAAA resolution of one name: every address is a peer
    at ``grpc_port``."""

    def __init__(self, on_change: OnChange, fqdn: str, grpc_port: int,
                 poll_interval_ms: int = 30_000, default_dc: str = ""):
        super().__init__(on_change)
        self.fqdn = fqdn
        self.grpc_port = grpc_port
        self.default_dc = default_dc
        self._poll()
        self._loop = IntervalLoop(poll_interval_ms, self._poll,
                                  name="dns-discovery")

    def _poll(self) -> None:
        try:
            infos = socket.getaddrinfo(self.fqdn, self.grpc_port,
                                       proto=socket.IPPROTO_TCP)
        except socket.gaierror as e:
            log.warning("dns discovery %s: %s", self.fqdn, e)
            return
        addrs = sorted({i[4][0] for i in infos})
        self._notify([PeerInfo(
            # an IPv6 literal needs brackets in host:port
            grpc_address=(f"[{a}]:{self.grpc_port}" if ":" in a
                          else f"{a}:{self.grpc_port}"),
            datacenter=self.default_dc) for a in addrs])

    def close(self) -> None:
        self.mark_closed()
        self._loop.close()


class GossipDiscovery(Discovery):
    """UDP heartbeat membership with SWIM-style failure confirmation
    (the in-tree stand-in for hashicorp/memberlist):

    - **Liveness is direct evidence only.**  ``last_seen`` refreshes only
      on datagrams FROM that address; hearsay (another node listing the
      member) only introduces unknown members, so two nodes cannot keep
      a dead one alive by telling each other about it.
    - **Suspicion before eviction.**  A member silent past
      ``suspect_ms`` is pinged directly and through up to
      ``indirect_probes`` live members (ping-req); any datagram from it
      clears the suspicion.  It is evicted at ``dead_ms`` (default 3 ×
      suspect) of unbroken silence.
    - **State push on first contact.**  A datagram from an unknown
      address is answered with our whole member map at once.
    - **Rejoin probes.**  Evicted members stay in a dead list for
      ``dead_retain_ms``; each tick one random dead address is sent the
      heartbeat too, so two halves of a healed partition find each
      other again.

    Heartbeats go to every member (not SWIM's random sample): fine for
    the tens of nodes the reference targets.
    """

    def __init__(self, on_change: OnChange, bind: str, self_info: PeerInfo,
                 known_hosts: Sequence[str], interval_ms: int = 1000,
                 suspect_ms: int = 5000, dead_ms: Optional[int] = None,
                 indirect_probes: int = 3,
                 dead_retain_ms: Optional[int] = None,
                 default_dc: str = ""):
        super().__init__(on_change)
        self.self_info = self_info
        self.default_dc = default_dc
        host, _, port = bind.rpartition(":")
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind((host or "0.0.0.0", int(port)))
        self._sock.settimeout(0.25)
        self.gossip_addr = \
            f"{host or '127.0.0.1'}:{self._sock.getsockname()[1]}"
        self.suspect_s = suspect_ms / 1000.0
        self.dead_s = (dead_ms / 1000.0 if dead_ms is not None
                       else 3 * self.suspect_s)
        self.indirect_probes = indirect_probes
        #: gossip_addr → (PeerInfo dict, last_seen monotonic): written by
        #: the receiver, read by the tick
        self._members: dict = {}  # guarded-by: self._members_mu
        #: gossip_addr → eviction time: the rejoin-probe targets, kept
        #: for dead_retain_s
        self._dead: dict = {}  # guarded-by: self._members_mu
        self.dead_retain_s = (dead_retain_ms / 1000.0
                              if dead_retain_ms is not None
                              else 30 * self.dead_s)
        self._members_mu = threading.Lock()
        self._seeds = list(known_hosts)
        self._stop = threading.Event()
        self._rng = random.Random(hash(self.gossip_addr))
        self._rx = threading.Thread(target=self._recv_loop, daemon=True,
                                    name="gossip-rx")
        self._rx.start()
        self._loop = IntervalLoop(interval_ms, self._tick, name="gossip-tx")
        self._notify([self_info])
        self._tick()  # join now, not after the first interval

    def _send(self, addr: str, payload: bytes) -> None:
        host, _, port = addr.rpartition(":")
        try:
            self._sock.sendto(payload, (host, int(port)))
        except (OSError, ValueError):
            pass

    def _payload(self) -> bytes:
        now = time.monotonic()
        members = {self.gossip_addr: _peer_dict(self.self_info)}
        with self._members_mu:
            snapshot = list(self._members.items())
        for addr, (info, seen) in snapshot:
            # vouch only for members with recent direct evidence:
            # suspects stay ours while probed, but are not advertised
            if now - seen <= self.suspect_s:
                members[addr] = info
        return json.dumps({"t": "gossip", "from": self.gossip_addr,
                           "members": members}).encode()

    def _tick(self) -> None:
        payload = self._payload()
        now = time.monotonic()
        with self._members_mu:
            known = list(self._members.keys())
            suspects = [a for a, (_, seen) in self._members.items()
                        if now - seen > self.suspect_s]
            alive = [a for a, (_, seen) in self._members.items()
                     if now - seen <= self.suspect_s]
            dead_pool = [a for a in self._dead if a not in self._members]
        # one rejoin probe a tick: across a healed partition the first
        # datagram through re-introduces us (the state push does the
        # rest)
        rejoin = self._rng.sample(dead_pool, 1) if dead_pool else []
        for t in set(self._seeds) | set(known) | set(rejoin):
            if t != self.gossip_addr:
                self._send(t, payload)
        # the probe round for silent members: a direct ping and
        # ping-reqs through random live members
        for s in suspects:
            self._send(s, json.dumps(
                {"t": "ping", "from": self.gossip_addr}).encode())
            relays = self._rng.sample(
                alive, min(self.indirect_probes, len(alive)))
            for r in relays:
                self._send(r, json.dumps(
                    {"t": "ping-req", "from": self.gossip_addr,
                     "target": s}).encode())
        self._prune_and_notify()

    def _recv_loop(self) -> None:
        while not self._stop.is_set():
            try:
                data, _ = self._sock.recvfrom(65536)
            except socket.timeout:
                continue
            except OSError:
                return
            try:
                self._handle_datagram(data)
            except Exception as e:  # noqa: BLE001 - the receiver survives
                # unauthenticated UDP: a malformed datagram must not kill
                # the receiver (a dead receiver evicts the whole cluster)
                log.warning("gossip: dropped malformed datagram: %s", e)

    def _handle_datagram(self, data: bytes) -> None:
        try:
            msg = json.loads(data)
        except ValueError:
            return
        if not isinstance(msg, dict):
            return
        sender = msg.get("from")
        if sender is not None and not isinstance(sender, str):
            return
        kind = msg.get("t", "gossip")
        members = msg.get("members", {})
        if not isinstance(members, dict):
            members = {}
        now = time.monotonic()
        first_contact = False
        with self._members_mu:
            if sender and sender != self.gossip_addr:
                # direct evidence: refresh (or meet) the sender
                prev = self._members.get(sender)
                first_contact = prev is None
                info = members.get(sender)
                if not isinstance(info, dict):
                    info = prev[0] if prev else None
                if info is not None:
                    self._members[sender] = (info, now)
                    self._dead.pop(sender, None)  # rejoined
            # hearsay only introduces members, and only well-formed ones
            for addr, info in members.items():
                if isinstance(addr, str) and isinstance(info, dict) \
                        and addr != self.gossip_addr \
                        and addr != sender and addr not in self._members:
                    self._members[addr] = (info, now)
        if kind == "ping" and sender:
            # ack the origin directly (a datagram from us is the direct
            # evidence it needs), or the sender when it probes for itself
            origin = msg.get("origin") or sender
            if isinstance(origin, str):
                self._send(origin, json.dumps(
                    {"t": "ack", "from": self.gossip_addr}).encode())
        elif kind == "ping-req" and isinstance(msg.get("target"), str):
            self._send(msg["target"], json.dumps(
                {"t": "ping", "from": self.gossip_addr,
                 "origin": sender}).encode())
        if first_contact and kind == "gossip":
            self._send(sender, self._payload())  # push state to a joiner
        self._prune_and_notify()

    def _prune_and_notify(self) -> None:
        """Evict members silent past the dead window (dropped, not only
        filtered, or their addresses would be heartbeated forever);
        suspects stay members while their probe round runs."""
        now = time.monotonic()
        with self._members_mu:
            dead = [a for a, (_, seen) in self._members.items()
                    if now - seen > self.dead_s]
            for a in dead:
                del self._members[a]
                self._dead[a] = now  # a rejoin-probe target
            for a in [a for a, t in self._dead.items()
                      if now - t > self.dead_retain_s]:
                del self._dead[a]
            live = [_peer_info(i, self.default_dc)
                    for i, _ in self._members.values()]
        self._notify(sorted(live + [self.self_info],
                            key=lambda p: p.grpc_address))

    def close(self) -> None:
        self.mark_closed()
        self._stop.set()
        self._loop.close()
        self._rx.join(timeout=2)
        self._sock.close()


def _peer_dict(p: PeerInfo) -> dict:
    return {"grpc_address": p.grpc_address, "http_address": p.http_address,
            "datacenter": p.datacenter}


def _peer_info(d: dict, default_dc: str = "") -> PeerInfo:
    return PeerInfo(grpc_address=d.get("grpc_address", ""),
                    http_address=d.get("http_address", ""),
                    datacenter=d.get("datacenter", default_dc))


class EtcdDiscovery(Discovery):
    """Membership in etcd over its v3 JSON gateway (no client library):
    this daemon registers under ``prefix`` with a TTL lease kept alive
    every ttl/3, and the peer set follows a watch stream on the prefix,
    with a range poll every ttl/3 behind it (reconnects, missed
    events)."""

    def __init__(self, on_change: OnChange, endpoints: Sequence[str],
                 prefix: str, self_info: PeerInfo, ttl_s: int = 30,
                 watch: bool = True, default_dc: str = ""):
        import base64

        super().__init__(on_change)
        if not endpoints:
            raise ValueError("etcd discovery needs GUBER_ETCD_ENDPOINTS")
        self._b64 = lambda b: base64.b64encode(b).decode()
        self._unb64 = base64.b64decode
        self.endpoints = [e if e.startswith("http") else f"http://{e}"
                          for e in endpoints]
        self.prefix = prefix
        self.self_info = self_info
        self.default_dc = default_dc
        self.ttl_s = ttl_s
        self.lease_id: Optional[str] = None
        #: serializes fetch → notify between the watch and the poll: an
        #: older range applied after a newer one would resurrect a stale
        #: membership
        self._poll_mu = threading.Lock()
        self._register()
        self._poll()
        period = max(ttl_s * 1000 // 3, 1000)
        self._keep = IntervalLoop(period, self._keepalive, name="etcd-lease")
        self._loop = IntervalLoop(period, self._poll, name="etcd-poll")
        self._watch_stop = threading.Event()
        self._watcher: Optional[threading.Thread] = None
        if watch:
            self._watcher = threading.Thread(
                target=self._watch_loop, daemon=True, name="etcd-watch")
            self._watcher.start()

    def _watch_loop(self) -> None:
        """A /v3/watch stream (newline-delimited JSON frames): a frame
        with events triggers a range poll (the authoritative range keeps
        it right under coalesced events and compaction).  Errors back
        off and reconnect; the interval poll bounds staleness anyway."""
        import urllib.request

        key = self._b64(self.prefix.encode())
        range_end = self._b64(self._range_end(self.prefix.encode()))
        body = json.dumps({"create_request": {
            "key": key, "range_end": range_end}}).encode()
        while not self._watch_stop.is_set():
            for ep in self.endpoints:
                try:
                    req = urllib.request.Request(
                        f"{ep}/v3/watch", data=body,
                        headers={"Content-Type": "application/json"})
                    with urllib.request.urlopen(req, timeout=30) as f:
                        while not self._watch_stop.is_set():
                            line = f.readline()
                            if not line:
                                break  # the stream closed: reconnect
                            try:
                                frame = json.loads(line)
                            except ValueError:
                                continue
                            if (frame.get("result") or {}).get("events") \
                                    and not self._watch_stop.is_set():
                                self._poll()
                except Exception:  # noqa: BLE001 - reconnect below
                    pass
                if self._watch_stop.is_set():
                    return
            self._watch_stop.wait(1.0)  # back off before reconnecting

    def _call(self, rpc: str, body: dict) -> dict:
        """POST /v3/<rpc> to the first endpoint that answers."""
        import urllib.request

        last: Exception = RuntimeError("no etcd endpoints")
        for ep in self.endpoints:
            try:
                req = urllib.request.Request(
                    f"{ep}/v3/{rpc}", data=json.dumps(body).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=5) as f:
                    return json.loads(f.read() or b"{}")
            except Exception as e:  # noqa: BLE001 - try the next endpoint
                last = e
        raise last

    def _self_key(self) -> bytes:
        return (self.prefix + self.self_info.grpc_address).encode()

    def _register(self) -> None:
        lease = self._call("lease/grant", {"TTL": str(self.ttl_s)})
        self.lease_id = lease["ID"]
        self._call("kv/put", {
            "key": self._b64(self._self_key()),
            "value": self._b64(json.dumps(
                _peer_dict(self.self_info)).encode()),
            "lease": self.lease_id,
        })

    def _keepalive(self) -> None:
        try:
            resp = self._call("lease/keepalive", {"ID": self.lease_id})
            # the gateway answers an expired lease with HTTP 200 and a
            # TTL <= 0 or none: a failure
            ttl = int((resp.get("result") or {}).get("TTL") or 0)
            if ttl > 0:
                return
            log.warning("etcd lease %s expired; re-registering",
                        self.lease_id)
        except Exception as e:  # noqa: BLE001 - re-register below
            log.warning("etcd keepalive: %s; re-registering", e)
        try:
            self._register()
        except Exception as e2:  # noqa: BLE001
            log.warning("etcd re-register failed: %s", e2)

    @staticmethod
    def _range_end(start: bytes) -> bytes:
        """The end of a prefix range: the last byte incremented, carrying
        over 0xff bytes; an all-0xff or empty prefix scans to the end of
        the keyspace (b"\\x00")."""
        end = bytearray(start)
        while end:
            if end[-1] < 0xFF:
                end[-1] += 1
                return bytes(end)
            end.pop()
        return b"\x00"

    def _poll(self) -> None:
        with self._poll_mu:
            start = self.prefix.encode()
            try:
                resp = self._call("kv/range", {
                    "key": self._b64(start),
                    "range_end": self._b64(self._range_end(start))})
            except Exception as e:  # noqa: BLE001 - keep the last list
                log.warning("etcd range: %s", e)
                return
            peers = []
            for kv in resp.get("kvs", []):
                try:
                    peers.append(_peer_info(
                        json.loads(self._unb64(kv["value"])),
                        self.default_dc))
                except (ValueError, KeyError):
                    continue
            # an empty successful range is real (our own lease may have
            # just expired): report it; the next keepalive re-registers
            self._notify(sorted(peers, key=lambda p: p.grpc_address))

    def close(self) -> None:
        self.mark_closed()
        self._watch_stop.set()
        self._keep.close()
        self._loop.close()
        try:
            self._call("kv/deleterange",
                       {"key": self._b64(self._self_key())})
        except Exception:  # noqa: BLE001 - the lease expiry cleans up
            pass
        if self._watcher is not None:
            # a daemon thread, maybe in a blocking read: do not linger
            self._watcher.join(timeout=0.2)


class K8sDiscovery(Discovery):
    """Membership from the Kubernetes API server (no client library):
    the in-cluster service-account token and CA, the pods of a label
    selector or the endpoints of a service, a ``?watch=1`` stream (the
    raw form of client-go's informers) and an interval poll behind it;
    every address is a peer at ``grpc_port``."""

    SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"

    def __init__(self, on_change: OnChange, namespace: str, selector: str,
                 grpc_port: int, service: str = "", api_base: str = "",
                 token: str = "", ca_file: str = "",
                 insecure_skip_verify: bool = False,
                 poll_interval_ms: int = 15_000, watch: bool = True,
                 default_dc: str = ""):
        super().__init__(on_change)
        self.grpc_port = grpc_port
        self.default_dc = default_dc
        self.namespace = namespace or self._read(f"{self.SA_DIR}/namespace",
                                                 "default")
        self.selector = selector
        self.service = service
        if not selector and not service:
            raise ValueError(
                "k8s discovery needs GUBER_K8S_POD_SELECTOR or "
                "GUBER_K8S_SERVICE — listing every Endpoints object in "
                "the namespace would pull foreign services into the ring")
        if not api_base:
            host = os.environ.get("KUBERNETES_SERVICE_HOST")
            port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
            if not host:
                raise RuntimeError(
                    "k8s discovery: not in a cluster (no "
                    "KUBERNETES_SERVICE_HOST) and no api_base given; use "
                    "GUBER_PEER_DISCOVERY_TYPE=dns with a headless "
                    "service instead")
            api_base = f"https://{host}:{port}"
        self.api_base = api_base
        self.token = token or self._read(f"{self.SA_DIR}/token", "")
        self.ca_file = ca_file or (
            f"{self.SA_DIR}/ca.crt"
            if os.path.exists(f"{self.SA_DIR}/ca.crt") else "")
        self.insecure = insecure_skip_verify
        if (self.api_base.startswith("https") and not self.ca_file
                and not self.insecure):
            # never send the bearer token to an unverified server: an
            # impersonated API server could steal it and inject peers
            raise RuntimeError(
                "k8s discovery: HTTPS API server but no CA cert found; "
                "provide ca_file or set GUBER_K8S_INSECURE=true "
                "(insecure_skip_verify) explicitly")
        self._poll_mu = threading.Lock()  # the watch against the poll
        #: the list's resourceVersion: a watch resumes from it, so a
        #: reconnect replays nothing
        self._rv: Optional[str] = None
        self._poll()
        self._loop = IntervalLoop(poll_interval_ms, self._poll,
                                  name="k8s-discovery")
        self._watch_stop = threading.Event()
        self._watcher: Optional[threading.Thread] = None
        if watch:
            self._watcher = threading.Thread(
                target=self._watch_loop, daemon=True, name="k8s-watch")
            self._watcher.start()

    @staticmethod
    def _read(path: str, default: str) -> str:
        try:
            with open(path) as f:
                return f.read().strip()
        except OSError:
            return default

    def _ssl_ctx(self):
        import ssl

        ctx = ssl.create_default_context(cafile=self.ca_file or None)
        if not self.ca_file and self.insecure:
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
        return ctx

    def _request(self, path: str):
        import urllib.request

        req = urllib.request.Request(self.api_base + path)
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        return req

    def _get(self, path: str) -> dict:
        import urllib.request

        with urllib.request.urlopen(self._request(path), timeout=10,
                                    context=self._ssl_ctx()) as f:
            return json.loads(f.read())

    def _watch_path(self) -> str:
        from urllib.parse import quote

        if self.selector:
            base = (f"/api/v1/namespaces/{self.namespace}/pods"
                    f"?labelSelector={quote(self.selector)}&watch=1")
        else:
            base = (f"/api/v1/namespaces/{self.namespace}/endpoints"
                    f"?fieldSelector=metadata.name%3D{quote(self.service)}"
                    "&watch=1")
        # a server-side timeout cycles idle streams; resuming from the
        # last list's resourceVersion replays nothing
        base += "&timeoutSeconds=300&allowWatchBookmarks=true"
        if self._rv:
            base += f"&resourceVersion={quote(str(self._rv))}"
        return base

    def _watch_loop(self) -> None:
        """The ``?watch=1`` stream: a real event triggers a poll (which
        also refreshes the resume point), BOOKMARK only advances the
        resume point, ERROR (410 Gone) drops it."""
        import urllib.request

        while not self._watch_stop.is_set():
            try:
                req = self._request(self._watch_path())
                with urllib.request.urlopen(req, timeout=330,
                                            context=self._ssl_ctx()) as f:
                    while not self._watch_stop.is_set():
                        line = f.readline()
                        if not line:
                            break  # the stream closed: reconnect
                        try:
                            ev = json.loads(line)
                        except ValueError:
                            continue
                        kind = ev.get("type")
                        if kind == "ERROR":
                            self._rv = None
                            break
                        if kind == "BOOKMARK":
                            rv = ((ev.get("object") or {})
                                  .get("metadata", {})
                                  .get("resourceVersion"))
                            if rv:
                                self._rv = rv
                            continue
                        if kind and not self._watch_stop.is_set():
                            self._poll()
            except Exception:  # noqa: BLE001 - reconnect below
                pass
            self._watch_stop.wait(1.0)  # back off before reconnecting

    def _poll(self) -> None:
        with self._poll_mu:
            self._poll_locked()

    def _poll_locked(self) -> None:
        from urllib.parse import quote

        try:
            if self.selector:
                obj = self._get(
                    f"/api/v1/namespaces/{self.namespace}/pods"
                    f"?labelSelector={quote(self.selector)}")
                ips = sorted({
                    item["status"]["podIP"]
                    for item in obj.get("items", [])
                    if item.get("status", {}).get("podIP")
                    and item["status"].get("phase") == "Running"})
            else:
                obj = self._get(
                    f"/api/v1/namespaces/{self.namespace}/endpoints/"
                    f"{quote(self.service)}")
                ips = sorted({
                    addr["ip"]
                    for subset in obj.get("subsets", []) or []
                    for addr in subset.get("addresses", []) or []})
        except Exception as e:  # noqa: BLE001 - keep the last list
            log.warning("k8s discovery poll: %s", e)
            return
        rv = (obj.get("metadata") or {}).get("resourceVersion")
        if rv:
            self._rv = rv
        # an empty successful list is real membership (no pod ready):
        # the daemon then serves alone instead of forwarding to dead
        # addresses
        self._notify([PeerInfo(grpc_address=f"{ip}:{self.grpc_port}",
                               datacenter=self.default_dc)
                      for ip in ips])

    def close(self) -> None:
        self.mark_closed()
        self._watch_stop.set()
        self._loop.close()
        if self._watcher is not None:
            self._watcher.join(timeout=0.2)


def make_discovery(cfg: DaemonConfig, self_info: PeerInfo,
                   on_change: OnChange) -> Optional[Discovery]:
    """The configured source (daemon.go › SpawnDaemon); a static list
    that leaves this daemon out gets it added.  An unknown type raises."""
    t = cfg.peer_discovery_type
    dc = cfg.data_center
    if t in ("none", ""):
        return None
    if t == "static":
        peers = parse_peer_list(cfg.static_peers, dc)
        if self_info.grpc_address not in [p.grpc_address for p in peers]:
            peers.append(self_info)
        return StaticDiscovery(on_change, peers)
    if t == "file":
        return FileDiscovery(on_change, cfg.peers_file, default_dc=dc)
    if t == "dns":
        _, grpc_port = split_host_port(cfg.grpc_listen_address)
        return DnsDiscovery(on_change, cfg.dns_fqdn, grpc_port,
                            cfg.dns_resolve_interval_ms, dc)
    if t in ("member-list", "memberlist", "gossip"):
        host, grpc_port = split_host_port(self_info.grpc_address)
        return GossipDiscovery(on_change, f"{host}:{grpc_port + 1}",
                               self_info, cfg.memberlist_known_hosts,
                               default_dc=dc)
    if t == "etcd":
        return EtcdDiscovery(on_change, cfg.etcd_endpoints, cfg.etcd_prefix,
                             self_info, default_dc=dc)
    if t == "k8s":
        _, grpc_port = split_host_port(cfg.grpc_listen_address)
        return K8sDiscovery(on_change, cfg.k8s_namespace,
                            cfg.k8s_pod_selector, grpc_port,
                            service=cfg.k8s_service,
                            insecure_skip_verify=cfg.k8s_insecure_skip_verify,
                            default_dc=dc)
    raise ValueError(f"unknown peer discovery type: {t!r}")
