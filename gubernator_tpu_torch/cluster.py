"""Clusters of port daemons (the port's copy of gubernator_tpu/cluster.py;
cluster/cluster.go › Start / StartWith).

- ``start`` / ``start_with``: N real daemons in one process, each with
  its own engine on the chosen device and real gRPC over loopback,
  joined by their advertise addresses.  Every listener binds port 0, so
  no port is picked and then lost to another process; ``restart`` binds
  the stopped daemon's bound addresses again.  A ``DaemonConfig`` with a
  ``data_center`` puts its daemon in that region (MULTI_REGION).
- ``start_subprocess_group``: N daemon PROCESSES, each its own
  interpreter and engine (``python -m gubernator_tpu_torch.cmd.daemon``
  with ``GUBER_DEVICE``; on ``cuda`` they share the one card), behind
  one SO_REUSEPORT client port, ring-split over the peer wire: the
  front door of a host whose one interpreter bounds the rate.
"""
from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
from dataclasses import replace
from typing import Callable, List, Optional

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


def free_port(host: str = "127.0.0.1") -> int:
    """A port the OS reports free now (another process may take it
    before it is bound: ``start_subprocess_group`` retries then)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def reserve_reuseport(host: str = "127.0.0.1", port: int = 0
                      ) -> socket.socket:
    """A bound, NOT listening socket with SO_REUSEPORT on ``port`` (0:
    any): it keeps the port from other binders while the group's
    daemons bind it with SO_REUSEPORT too, and it takes no connection
    (the kernel spreads connections over listening sockets only)."""
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        s.bind((host, port))
    except BaseException:
        s.close()
        raise
    return s


class SubprocessGroup:
    """A SO_REUSEPORT daemon group: ``n`` OS processes share one
    client-facing gRPC port (the kernel spreads inbound connections over
    them), clustered over their own peer ports (the JAX package's
    SubprocessGroup)."""

    def __init__(self, procs, client_address: str,
                 grpc_addresses: List[str], http_addresses: List[str],
                 log_paths: List[str]):
        self.procs = procs
        self.client_address = client_address
        self.grpc_addresses = grpc_addresses
        self.http_addresses = http_addresses
        self.log_paths = log_paths

    def log_tail(self, i: int, nbytes: int = 2000) -> str:
        try:
            with open(self.log_paths[i], "rb") as f:
                return f.read()[-nbytes:].decode(errors="replace")
        except OSError:
            return ""

    def kill(self, i: int) -> None:
        """SIGKILL worker ``i`` (a real process death: no drain, no
        snapshot) and reap it."""
        p = self.procs[i]
        if p.poll() is None:
            p.send_signal(signal.SIGKILL)
        p.wait(timeout=30)

    def stop(self, remove_logs: bool = True, grace_s: float = 30.0) -> None:
        """SIGTERM every live worker (each drains and closes), SIGKILL
        those still alive after ``grace_s``."""
        for p in self.procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        deadline = time.monotonic() + grace_s
        for p in self.procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=10)
        if remove_logs:
            for lp in self.log_paths:
                try:
                    os.unlink(lp)
                except OSError:
                    pass


#: a worker that died of a port another process took first (the group
#: start draws new ports and tries again, this many times in all)
_BIND_FAILURES = ("failed to bind", "Address already in use")
_START_ATTEMPTS = 3


def _prebuild(device: str) -> None:
    """Build the host library, and on CUDA the kernels, in this process
    before any worker starts: the workers then load what is built (the
    build lock holds across processes all the same).  Nothing here
    touches the GPU, so no worker is forked from a CUDA process."""
    from .ops import build

    build.load_wire_library()
    if device.startswith("cuda"):
        build.load_library()


def start_subprocess_group(
        n: int, device: str = "cuda", cache_size: int = 1 << 16,
        batch_rows: int = 1024, ready_timeout: float = 120.0,
        env_extra: Optional[dict] = None, client_port: int = 0,
        worker_env: Optional[Callable[[int, List[str]], dict]] = None,
        log_dir: Optional[str] = None) -> SubprocessGroup:
    """Spawn ``n`` daemon processes sharing one SO_REUSEPORT client port,
    statically clustered over their own peer ports, and wait until each
    answers grpc.health.v1 SERVING on its peer port (the client port is
    bound before the peer listener starts).

    Each worker is ``python -m gubernator_tpu_torch.cmd.daemon`` with
    ``GUBER_DEVICE=device``: on ``cuda`` the N processes share the card,
    and a worker that finds no GPU exits non-zero, which makes this
    raise with its log tail.  ``env_extra`` adds to every worker's
    environment; ``worker_env(i, grpc_addresses)`` to worker ``i``'s,
    once the peer addresses are drawn (e.g. a snapshot of the keys the
    ring gives it).  While the workers start, this process holds the
    client port with a bound SO_REUSEPORT socket that takes no
    connection; a worker that lost its peer or HTTP port to another
    process makes the whole start try again on new ports.  Logs go to
    ``log_dir`` (default: the temporary directory)."""
    import grpc as _grpc

    _prebuild(device)
    hold = reserve_reuseport(port=client_port)
    try:
        client_address = f"127.0.0.1:{hold.getsockname()[1]}"
        for attempt in range(_START_ATTEMPTS):
            try:
                return _start_group_once(
                    n, device, cache_size, batch_rows, ready_timeout,
                    env_extra, client_address, worker_env, log_dir, _grpc)
            except _PortLost:
                if attempt == _START_ATTEMPTS - 1:
                    raise
    finally:
        hold.close()
    raise AssertionError("unreachable")


class _PortLost(RuntimeError):
    """A worker lost a drawn port to another process."""


def _start_group_once(n, device, cache_size, batch_rows, ready_timeout,
                      env_extra, client_address, worker_env, log_dir,
                      _grpc) -> SubprocessGroup:
    taken = {int(client_address.rsplit(":", 1)[1])}

    def draw_port() -> int:
        # never hand a worker the client port or another worker's port
        while True:
            p = free_port()
            if p not in taken:
                taken.add(p)
                return p

    grpc_addresses = [f"127.0.0.1:{draw_port()}" for _ in range(n)]
    http_addresses = [f"127.0.0.1:{draw_port()}" for _ in range(n)]
    procs, log_paths = [], []
    group = SubprocessGroup(procs, client_address, grpc_addresses,
                            http_addresses, log_paths)
    try:
        for i in range(n):
            env = dict(os.environ)
            env.update({
                "GUBER_CLIENT_ADDRESS": client_address,
                "GUBER_GRPC_ADDRESS": grpc_addresses[i],
                "GUBER_HTTP_ADDRESS": http_addresses[i],
                "GUBER_PEER_DISCOVERY_TYPE": "static",
                "GUBER_PEERS": ",".join(grpc_addresses),
                "GUBER_CACHE_SIZE": str(cache_size),
                "GUBER_BATCH_ROWS": str(batch_rows),
                "GUBER_INSTANCE_ID": f"group-{i}",
                "GUBER_DEVICE": device,
            })
            env.update(env_extra or {})
            if worker_env is not None:
                env.update(worker_env(i, list(grpc_addresses)))
            lf = tempfile.NamedTemporaryFile(
                mode="wb", prefix=f"guber-group-{i}-", suffix=".log",
                dir=log_dir, delete=False)
            log_paths.append(lf.name)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "gubernator_tpu_torch.cmd.daemon"],
                stdout=lf, stderr=subprocess.STDOUT, env=env))
            lf.close()
        deadline = time.monotonic() + ready_timeout
        for i, addr in enumerate(grpc_addresses):
            _await_serving(group, i, addr, deadline, ready_timeout, _grpc)
    except BaseException:
        # keep the logs: the error cites them
        group.stop(remove_logs=False, grace_s=10.0)
        raise
    return group


def _await_serving(group, i, addr, deadline, ready_timeout, _grpc) -> None:
    ch = _grpc.insecure_channel(addr)
    try:
        check = ch.unary_unary("/grpc.health.v1.Health/Check")
        while True:
            p = group.procs[i]
            if p.poll() is not None:
                tail = group.log_tail(i)
                if any(m in tail for m in _BIND_FAILURES):
                    raise _PortLost(f"group daemon {i} lost a port: {tail}")
                raise RuntimeError(f"group daemon {i} exited "
                                   f"rc={p.returncode}: {tail}")
            try:
                if check(b"", timeout=2.0) == bytes([0x08, 0x01]):
                    return
            except _grpc.RpcError:
                pass
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"group daemon {i} not SERVING within {ready_timeout}"
                    f" s (log: {group.log_paths[i]})")
            time.sleep(0.25)
    finally:
        ch.close()
