"""In-process cluster of port daemons (the port's copy of
gubernator_tpu/cluster.py; cluster/cluster.go › Start / StartWith).

Boots N real daemons in one process, each with its own engine on the
chosen device and real gRPC over loopback, and joins them by their
advertise addresses.  Every listener binds port 0, so no port is picked
and then lost to another process; ``restart`` binds the stopped
daemon's bound addresses again.  The JAX package's subprocess group
(SO_REUSEPORT front door) is not ported.
"""
from __future__ import annotations

from dataclasses import replace
from typing import List, Optional

from .config import BehaviorConfig, DaemonConfig
from .daemon import Daemon, spawn_daemon
from .types import PeerInfo


class Cluster:
    def __init__(self, daemons: List[Daemon]):
        self.daemons = daemons

    # cluster.go's names
    def peer_at(self, i: int) -> PeerInfo:
        return self.daemons[i].peer_info()

    def instance_at(self, i: int):
        return self.daemons[i].instance

    def daemon_at(self, i: int) -> Daemon:
        return self.daemons[i]

    def owner_daemon_of(self, key: str) -> Daemon:
        """The daemon owning ``key`` (name + "_" + unique_key), by
        daemon 0's ring."""
        addr = self.daemons[0].instance.owner_of(key).info.grpc_address
        for d in self.daemons:
            if d.advertise_address == addr:
                return d
        raise LookupError(f"no daemon for owner {addr}")

    def restart(self, i: int) -> Daemon:
        """Stop daemon ``i`` and spawn it again on the addresses it had
        bound (a fresh table), then give every daemon the peer list
        again (cluster.go › Restart)."""
        old = self.daemons[i]
        http = f"{old.cfg.http_listen_address.rsplit(':', 1)[0]}:" \
               f"{old.http_port}"
        cfg = replace(old.cfg, grpc_listen_address=old.advertise_address,
                      http_listen_address=http,
                      advertise_address=old.advertise_address)
        old.close()
        d = spawn_daemon(cfg)
        self.daemons[i] = d
        infos = [dm.peer_info() for dm in self.daemons]
        for dm in self.daemons:
            dm.set_peers(infos)
        return d

    def stop(self) -> None:
        for d in self.daemons:
            d.close()


def start(n: int, behaviors: Optional[BehaviorConfig] = None,
          cache_size: int = 1 << 12, batch_rows: int = 64,
          device: str = "cuda", **cfg_kwargs) -> Cluster:
    """Boot ``n`` daemons on 127.0.0.1 (port 0) and join them
    (cluster.go › Start)."""
    return start_with([DaemonConfig(
        grpc_listen_address="127.0.0.1:0",
        http_listen_address="127.0.0.1:0", cache_size=cache_size,
        batch_rows=batch_rows, device=device,
        behaviors=behaviors or BehaviorConfig(), **cfg_kwargs)
        for _ in range(n)])


def start_with(cfgs: List[DaemonConfig]) -> Cluster:
    """Boot one daemon per config and join them (cluster.go ›
    StartWith); a daemon that fails to start stops the ones before it."""
    daemons: List[Daemon] = []
    try:
        for cfg in cfgs:
            daemons.append(spawn_daemon(cfg))
        infos = [d.peer_info() for d in daemons]
        for d in daemons:
            d.set_peers(infos)
    except BaseException:
        for d in daemons:
            d.close()
        raise
    return Cluster(daemons)
