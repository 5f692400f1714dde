"""Peer picking: which daemon owns a key (the port's copy of
gubernator_tpu/peers.py).

Keys map to daemons by a hash ring over the peers' gRPC addresses; a
daemon that does not own a key forwards it to the owner.  Pickers map a
key string, or an already-hashed key, to a peer object (anything with an
``.info: PeerInfo``).  A picker is immutable once built: set_peers builds
a new one and swaps it in.  The ring must put every key on the same
owner as the JAX package's for the same peer list; the tests hold it
there.  ``RegionPeerPicker`` keeps one ring per region (datacenter):
keys resolve in the local region, and the MULTI_REGION manager reaches
every other region's owner through ``regions``.
"""
from __future__ import annotations

import bisect
import hashlib
from typing import Callable, Dict, Generic, List, TypeVar

import numpy as np

from .hashing import mix64, mixed_fnv1a64

P = TypeVar("P")
HashFn = Callable[[bytes], int]


def crc64_hash(data: bytes) -> int:
    """The alternate hash option (the reference offers fnv1 or crc64):
    an 8-byte blake2b, as the JAX package uses; a picker needs only
    determinism and uniformity."""
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(), "big")


class ConsistentHash(Generic[P]):
    """Modulo picker (hash.go › ConsistantHash): ``peers[hash % n]`` over
    the peers sorted by address.  Even, but remaps almost every key on a
    membership change; the replicated ring below is the default."""

    def __init__(self, hash_fn: HashFn = mixed_fnv1a64):
        self._hash = hash_fn
        self._peers: List[P] = []

    def new(self) -> "ConsistentHash[P]":
        return ConsistentHash(self._hash)

    def add(self, peer: P) -> None:
        self._peers.append(peer)
        self._peers.sort(key=lambda p: p.info.grpc_address)  # type: ignore

    def peers(self) -> List[P]:
        return list(self._peers)

    def get(self, key: str) -> P:
        if not self._peers:
            raise RuntimeError("picker has no peers")
        return self.get_by_hash(self._hash(key.encode("utf-8")))

    def get_by_hash(self, h: int) -> P:
        """Owner of an already-hashed key (valid with the default hash:
        the table's key hashes are mixed FNV-1a of the identity)."""
        if not self._peers:
            raise RuntimeError("picker has no peers")
        return self._peers[h % len(self._peers)]

    def get_by_raw_hash(self, h: int) -> P:
        """Owner of a RAW FNV-1a key hash (the wire lanes' GLOBAL queue
        key): the finalizer, then get_by_hash."""
        return self.get_by_hash(mix64(h))

    def owner_indices(self, hashes: np.ndarray) -> np.ndarray:
        """Vectorized get_by_hash: int32 index into ``owner_peers()``
        per uint64 key hash (the clustered wire lane's ring split)."""
        if not self._peers:
            raise RuntimeError("picker has no peers")
        kh = np.asarray(hashes, np.uint64)
        return (kh % np.uint64(len(self._peers))).astype(np.int32)

    def owner_peers(self) -> List[P]:
        """The peer list ``owner_indices`` results index into."""
        return list(self._peers)


class ReplicatedConsistentHash(Generic[P]):
    """Virtual-node ring (replicated_hash.go › ReplicatedConsistentHash):
    each peer is hashed onto the ring ``replicas`` times; a key belongs
    to the first ring point at or after its hash.  A membership change
    remaps only the keys next to the changed peer's points."""

    DEFAULT_REPLICAS = 512

    def __init__(self, hash_fn: HashFn = mixed_fnv1a64,
                 replicas: int = DEFAULT_REPLICAS):
        self._hash = hash_fn
        self.replicas = replicas
        self._ring: List[int] = []  # sorted ring point hashes
        self._ring_peer: List[P] = []  # the peer at the same index
        self._points: Dict[int, P] = {}
        self._peers: List[P] = []
        self._ring_np = np.zeros(0, np.uint64)
        self._ring_peer_idx = np.zeros(0, np.int32)

    def new(self) -> "ReplicatedConsistentHash[P]":
        return ReplicatedConsistentHash(self._hash, self.replicas)

    def add(self, peer: P) -> None:
        addr = peer.info.grpc_address  # type: ignore
        self._peers.append(peer)
        for i in range(self.replicas):
            self._points[self._hash(f"{addr}{i}".encode("utf-8"))] = peer
        items = sorted(self._points.items())
        self._ring = [h for h, _ in items]
        self._ring_peer = [p for _, p in items]
        pos = {id(p): i for i, p in enumerate(self._peers)}
        self._ring_np = np.asarray(self._ring, dtype=np.uint64)
        self._ring_peer_idx = np.asarray(
            [pos[id(p)] for p in self._ring_peer], dtype=np.int32)

    def peers(self) -> List[P]:
        return list(self._peers)

    def get(self, key: str) -> P:
        if not self._ring:
            raise RuntimeError("picker has no peers")
        return self.get_by_hash(self._hash(key.encode("utf-8")))

    def get_by_hash(self, h: int) -> P:
        """Owner of an already-hashed key (see ConsistentHash)."""
        if not self._ring:
            raise RuntimeError("picker has no peers")
        idx = bisect.bisect_left(self._ring, h)
        return self._ring_peer[0 if idx == len(self._ring) else idx]

    def get_by_raw_hash(self, h: int) -> P:
        """Owner of a RAW FNV-1a key hash (see ConsistentHash)."""
        return self.get_by_hash(mix64(h))

    def owner_indices(self, hashes: np.ndarray) -> np.ndarray:
        """Vectorized get_by_hash: searchsorted(side="left") is
        bisect_left, so this agrees with get() bit for bit."""
        if not self._ring:
            raise RuntimeError("picker has no peers")
        idx = np.searchsorted(self._ring_np, np.asarray(hashes, np.uint64),
                              side="left")
        idx = np.where(idx == len(self._ring_np), 0, idx)
        return self._ring_peer_idx[idx]

    def owner_peers(self) -> List[P]:
        """The peer list ``owner_indices`` results index into."""
        return list(self._peers)


class RegionPeerPicker(Generic[P]):
    """One inner picker per region (region_picker.go ›
    RegionPeerPicker): ``get`` and the vectorized lookups resolve in the
    local region (``local_dc``); a peer without a datacenter is local.
    ``regions`` maps each region to its picker, for the MULTI_REGION
    manager's sends to the other regions."""

    def __init__(self, local_dc: str):
        self.local_dc = local_dc
        self.regions: Dict[str, ReplicatedConsistentHash] = {}

    def new(self) -> "RegionPeerPicker[P]":
        return RegionPeerPicker(self.local_dc)

    def add(self, peer: P) -> None:
        dc = peer.info.datacenter or self.local_dc  # type: ignore
        picker = self.regions.get(dc)
        if picker is None:
            picker = self.regions[dc] = ReplicatedConsistentHash()
        picker.add(peer)  # type: ignore

    def peers(self) -> List[P]:
        out: List[P] = []
        for picker in self.regions.values():
            out.extend(picker.peers())  # type: ignore
        return out

    def _local_picker(self):
        """The local region's picker, or any region's when the local one
        has no peers (the JAX package's fallback)."""
        picker = self.regions.get(self.local_dc)
        if picker is None:
            for picker in self.regions.values():
                break
            else:
                raise RuntimeError("picker has no peers")
        return picker

    def get(self, key: str) -> P:
        return self._local_picker().get(key)  # type: ignore

    def owner_indices(self, hashes: np.ndarray) -> np.ndarray:
        """Vectorized ``get`` over the local region's ring; the indices
        refer to ``owner_peers()`` (the local region's peers, not
        ``peers()``, which spans every region)."""
        return self._local_picker().owner_indices(hashes)  # type: ignore

    def owner_peers(self) -> List[P]:
        return self._local_picker().peers()  # type: ignore
