"""Deployments of the program under test, by a configuration's
``deployment`` key, and the key population they hold.

The benchmark drives the program as a deployment does: a daemon from
``spawn_daemon`` with its table filled through the engine's restore
(the keys a deployment holds when its traffic starts).  This module is
the only one of the harness that imports the program.
"""
from __future__ import annotations

import numpy as np


def key_hashes(name: str, prefix: str, idx: np.ndarray, width: int
               ) -> np.ndarray:
    """The program's key hash of (``name``, ``prefix`` + ``idx`` in
    ``width`` digits), vectorized: FNV-1a over the joined bytes, then the
    program's finalizer (held against the program's own hashing on a
    sample in ``population``)."""
    from gubernator_tpu_torch.hashing import fnv1a64, mix64_np

    h = np.full(len(idx), fnv1a64(f"{name}_{prefix}".encode()), np.uint64)
    prime = np.uint64(0x100000001B3)
    for p in range(width - 1, -1, -1):
        digit = (idx // 10 ** p) % 10 + ord("0")
        h = (h ^ digit.astype(np.uint64)) * prime
    x = mix64_np(h)
    return np.where(x == 0, np.uint64(1), x)


def bucket_fit(bucket: np.ndarray) -> np.ndarray:
    """Mask of the entries that find room in their 8-slot bucket when
    the entries are placed in order."""
    order = np.argsort(bucket, kind="stable")
    sb = bucket[order]
    start = np.r_[True, sb[1:] != sb[:-1]]
    pos = np.arange(len(sb))
    rank = pos - np.maximum.accumulate(np.where(start, pos, 0))
    keep = np.zeros(len(bucket), bool)
    keep[order[rank < 8]] = True
    return keep


def population(cfg: dict, n_keys: int, log2_rows: int):
    """``n_keys`` key indices and hashes that all fit their 8-slot bucket
    of a 2^log2_rows-row table beside the daemon's warm-up key: indices
    past a bucket's room are skipped, so every key is resident after the
    fill."""
    from gubernator_tpu_torch.hashing import hash_request_keys

    name, prefix, width = cfg["name"], cfg["key_prefix"], cfg["key_width"]
    idx = np.arange(int(n_keys * 1.002) + 1000, dtype=np.int64)
    keys = key_hashes(name, prefix, idx, width)
    sample = idx[:: max(1, len(idx) // 997)]
    if not np.array_equal(keys[sample], hash_request_keys(
            [name] * len(sample), [f"{prefix}{i:0{width}d}" for i in sample])):
        raise RuntimeError("the vectorized key hash differs from the "
                           "program's")
    warm = hash_request_keys(["_warmup"], ["w"])
    bucket = (np.r_[warm, keys]
              & np.uint64((1 << (log2_rows - 3)) - 1)).astype(np.int64)
    sel = np.nonzero(bucket_fit(bucket)[1:])[0][:n_keys]
    if len(sel) < n_keys:
        raise RuntimeError(f"only {len(sel)} of {n_keys} keys fit")
    return idx[sel], keys[sel]


def token_rows(keys, limit: int, duration: int, t0: int) -> dict:
    """Snapshot columns of TOKEN_BUCKET keys full at ``t0``."""
    n = len(keys)
    lim = np.full(n, limit, np.int64)
    dur = np.full(n, duration, np.int64)
    return {"key": keys, "meta": np.zeros(n, np.int32), "limit": lim,
            "burst": lim.copy(), "duration": dur, "eff_ms": dur.copy(),
            "remaining": lim.copy(), "t_ms": np.full(n, t0, np.int64),
            "expire_at": t0 + dur}


class Daemon:
    """One daemon in this process (``"deployment": "daemon"``): its
    gRPC port serves the window, its /metrics is scraped around it."""

    def __init__(self, cfg: dict, device: str, log2_rows: int):
        from gubernator_tpu_torch.config import DaemonConfig
        from gubernator_tpu_torch.daemon import spawn_daemon

        self.d = spawn_daemon(DaemonConfig(
            http_listen_address="127.0.0.1:0",
            grpc_listen_address="127.0.0.1:0",
            cache_size=1 << log2_rows, batch_rows=int(cfg["batch_rows"]),
            device=device))
        self.address = f"127.0.0.1:{self.d.grpc_port}"
        self.read_addresses = [self.address]
        self.metrics_urls = [f"http://127.0.0.1:{self.d.http_port}/metrics"]

    def fill(self, keys, limit: int, duration: int, t0: int) -> int:
        inst = self.d.instance
        with inst._engine_mu:
            return inst.engine.restore(token_rows(keys, limit, duration, t0))

    def close(self) -> None:
        self.d.close()


def start(cfg: dict, device: str, log2_rows: int):
    kinds = {"daemon": Daemon}
    if cfg["deployment"] not in kinds:
        raise ValueError(f"unknown deployment {cfg['deployment']!r}")
    return kinds[cfg["deployment"]](cfg, device, log2_rows)
