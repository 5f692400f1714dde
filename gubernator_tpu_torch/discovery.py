"""Peer discovery: a membership source → the instance's set_peers (the
port's copy of gubernator_tpu/discovery.py's static source).

Only ``none`` and ``static`` (GUBER_PEERS) are ported; any other
``peer_discovery_type`` raises rather than serving without peers.
"""
from __future__ import annotations

import threading
from typing import Callable, List, Optional, Sequence

from .config import DaemonConfig, parse_peer_list
from .types import PeerInfo

OnChange = Callable[[List[PeerInfo]], None]


class Discovery:
    """Deduplicated change notification: ``on_change`` fires with the
    full peer list whenever it differs from the last one, and never
    after ``close()``."""

    def __init__(self, on_change: OnChange):
        self._on_change = on_change
        self._last: Optional[tuple] = None  # guarded-by: self._mu
        self._mu = threading.Lock()
        self._closed = False  # guarded-by: self._mu

    def _notify(self, peers: Sequence[PeerInfo]) -> None:
        key = tuple(sorted((p.grpc_address, p.http_address, p.datacenter)
                           for p in peers))
        with self._mu:
            if self._closed or key == self._last:
                return
            self._last = key
            self._on_change(list(peers))

    def close(self) -> None:
        with self._mu:
            self._closed = True


class StaticDiscovery(Discovery):
    """A fixed peer list from the config (GUBER_PEERS)."""

    def __init__(self, on_change: OnChange, peers: Sequence[PeerInfo]):
        super().__init__(on_change)
        self._notify(peers)


def make_discovery(cfg: DaemonConfig, self_info: PeerInfo,
                   on_change: OnChange) -> Optional[Discovery]:
    """The configured source (daemon.go › SpawnDaemon); a static list
    that leaves this daemon out gets it added, and an entry without
    ``@dc`` is in this daemon's region."""
    t = cfg.peer_discovery_type
    if t in ("none", ""):
        return None
    if t == "static":
        peers = parse_peer_list(cfg.static_peers, cfg.data_center)
        if self_info.grpc_address not in [p.grpc_address for p in peers]:
            peers.append(self_info)
        return StaticDiscovery(on_change, peers)
    raise ValueError(f"peer discovery type {t!r} is not ported yet "
                     "(want none or static)")
