"""Persistence hooks: the write-through Store and the Loader snapshot
(the port of gubernator_tpu/store.py; store.go › Store, Loader).

A ``Store`` is called around every local decision: ``get`` seeds a key
the device table misses (read-through), ``on_change`` receives each
non-error answer as a ``CacheItem`` (write-through), ``remove`` follows
an admin remove.  A ``Loader`` restores the table when an instance
starts and saves it when it closes.

Snapshots are column dicts (``_COLUMNS``: uint64 ``key`` plus the eight
value columns), the engines' ``snapshot()`` output.  ``FileLoader``
keeps them in an ``.npz`` file of the JAX package's format: a file
written by either package's FileLoader loads in the other.  The Loader
protocol itself stays item-based for users' own loaders; for a
FileLoader the instance moves columns directly (``load_arrays`` /
``save_arrays``), the same file and the same rows without one
``CacheItem`` per row.
"""
from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass, field
from typing import Iterable, Iterator, List, Optional, Protocol

import numpy as np

from .hashing import hash_key
from .types import Algorithm, RateLimitRequest


@dataclass
class CacheItem:
    """One persisted rate-limit counter (cache.go › CacheItem, its value
    fields flattened)."""

    key: str = ""
    key_hash: int = 0  # 64-bit identity; 0 = unknown (rehash from key)
    algorithm: int = int(Algorithm.TOKEN_BUCKET)
    limit: int = 0
    duration: int = 0
    eff_ms: int = 1
    burst: int = 0
    remaining: int = 0  # token: tokens; leaky: td fixed point
    t_ms: int = 0
    expire_at: int = 0
    status: int = 0


class Store(Protocol):
    """Write-through persistence, called synchronously around local
    decisions (store.go › Store)."""

    def on_change(self, req: RateLimitRequest, item: CacheItem) -> None: ...

    def get(self, req: RateLimitRequest) -> Optional[CacheItem]: ...

    def remove(self, key: str) -> None: ...


class Loader(Protocol):
    """Snapshot persistence at instance start and close
    (store.go › Loader)."""

    def load(self) -> Iterable[CacheItem]: ...

    def save(self, items: Iterator[CacheItem]) -> None: ...


@dataclass
class MockStore:
    """In-memory Store counting its calls (store.go › MockStore)."""

    called: dict = field(default_factory=lambda: {
        "on_change": 0, "get": 0, "remove": 0})
    items: dict = field(default_factory=dict)

    def on_change(self, req: RateLimitRequest, item: CacheItem) -> None:
        self.called["on_change"] += 1
        self.items[item.key or req.key] = item

    def get(self, req: RateLimitRequest) -> Optional[CacheItem]:
        self.called["get"] += 1
        return self.items.get(req.key)

    def remove(self, key: str) -> None:
        self.called["remove"] += 1
        self.items.pop(key, None)


@dataclass
class MockLoader:
    """In-memory Loader counting its calls (store.go › MockLoader)."""

    called: dict = field(default_factory=lambda: {"load": 0, "save": 0})
    contents: List[CacheItem] = field(default_factory=list)

    def load(self) -> Iterable[CacheItem]:
        self.called["load"] += 1
        return list(self.contents)

    def save(self, items: Iterator[CacheItem]) -> None:
        self.called["save"] += 1
        self.contents = list(items)


class FileLoader:
    """Loader keeping the snapshot in an ``.npz`` file.  ``load`` /
    ``save`` are the item protocol; ``load_arrays`` / ``save_arrays``
    move the same columns without building items."""

    def __init__(self, path: str):
        self.path = path

    def load(self) -> Iterable[CacheItem]:
        arrays = self.load_arrays()
        return [] if arrays is None else items_from_arrays(arrays)

    def save(self, items: Iterator[CacheItem]) -> None:
        save_arrays(self.path, arrays_from_items(list(items)))

    def load_arrays(self) -> Optional[dict]:
        """The file's columns, as ``load`` would give them through
        items, or None when there is no file yet."""
        if not os.path.exists(self.path):
            return None
        with np.load(self.path, allow_pickle=False) as z:
            return normalized_arrays({name: z[name] for name in _COLUMNS})

    def save_arrays(self, arrays: dict) -> None:
        """Write the columns ``save`` would write through items."""
        save_arrays(self.path, normalized_arrays(arrays))


_COLUMNS = ("key", "meta", "limit", "duration", "eff_ms", "burst",
            "remaining", "t_ms", "expire_at")


def save_arrays(path: str, arrays: dict) -> None:
    """Atomic ``.npz`` write (a temporary file, then a rename): a crash
    mid-save keeps the old snapshot."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def normalized_arrays(arrays: dict) -> dict:
    """The columns an item round trip (items_from_arrays, then
    arrays_from_items) leaves: store.py's dtypes, ``meta`` reduced to
    its algorithm and status bits, ``eff_ms`` at least 1.  Keys keep
    their hashes (an item from columns carries ``key_hash``)."""
    out = {"key": np.asarray(arrays["key"]).astype(np.uint64),
           "meta": (np.asarray(arrays["meta"]).astype(np.int64)
                    & 3).astype(np.int32)}
    for name in _COLUMNS[2:]:
        out[name] = np.asarray(arrays[name]).astype(np.int64)
    out["eff_ms"] = np.maximum(out["eff_ms"], 1)
    return out


def items_from_arrays(arrays: dict) -> List[CacheItem]:
    """Column dict → CacheItems (``key`` empty, ``key_hash`` set)."""
    n = len(arrays["key"])
    cols = {name: np.asarray(arrays[name]).tolist() for name in _COLUMNS}
    out = []
    for i in range(n):
        meta = int(cols["meta"][i])
        out.append(CacheItem(
            key="", key_hash=int(cols["key"][i]),
            algorithm=meta & 1, status=(meta >> 1) & 1,
            limit=cols["limit"][i], duration=cols["duration"][i],
            eff_ms=cols["eff_ms"][i], burst=cols["burst"][i],
            remaining=cols["remaining"][i], t_ms=cols["t_ms"][i],
            expire_at=cols["expire_at"][i]))
    return out


def arrays_from_items(items: List[CacheItem]) -> dict:
    """CacheItems → column dict; an item without ``key_hash`` is keyed
    by the hash of its ``key`` ("name_uniquekey")."""
    n = len(items)
    arrays = {
        "key": np.zeros(n, np.uint64),
        "meta": np.zeros(n, np.int32),
        "limit": np.zeros(n, np.int64),
        "duration": np.zeros(n, np.int64),
        "eff_ms": np.ones(n, np.int64),
        "burst": np.zeros(n, np.int64),
        "remaining": np.zeros(n, np.int64),
        "t_ms": np.zeros(n, np.int64),
        "expire_at": np.zeros(n, np.int64),
    }
    for i, it in enumerate(items):
        kh = it.key_hash
        if kh == 0 and it.key:
            name, _, uniq = it.key.partition("_")
            kh = hash_key(name, uniq)
        arrays["key"][i] = np.uint64(kh)
        arrays["meta"][i] = (it.algorithm & 1) | ((it.status & 1) << 1)
        arrays["limit"][i] = it.limit
        arrays["duration"][i] = it.duration
        arrays["eff_ms"][i] = max(it.eff_ms, 1)
        arrays["burst"][i] = it.burst
        arrays["remaining"][i] = it.remaining
        arrays["t_ms"][i] = it.t_ms
        arrays["expire_at"][i] = it.expire_at
    return arrays
