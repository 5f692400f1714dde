"""Address helpers (the port's copy of gubernator_tpu/netutil.py;
net.go › ResolveHostIP): how a daemon derives the address its peers
reach it at."""
from __future__ import annotations

import socket


def split_host_port(addr: str) -> tuple[str, int]:
    host, _, port = addr.rpartition(":")
    if not port.isdigit():
        raise ValueError(f"address must be host:port, got {addr!r}")
    return host, int(port)


def resolve_host_ip(addr: str) -> str:
    """"host:port" → "ip:port"; a wildcard or empty host becomes the
    first non-loopback local IP (the advertise address of a daemon that
    binds every interface)."""
    host, port = split_host_port(addr)
    if host in ("", "0.0.0.0", "::"):
        ip = local_ip()
    else:
        try:
            ip = socket.getaddrinfo(host, None, socket.AF_INET)[0][4][0]
        except socket.gaierror:
            ip = host
    return f"{ip}:{port}"


def local_ip() -> str:
    """The local IP of the default route: connect() on a UDP socket
    picks the route and sends nothing."""
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.connect(("192.0.2.1", 9))  # TEST-NET-1, never reached
        return s.getsockname()[0]
    except OSError:
        return "127.0.0.1"
    finally:
        s.close()
