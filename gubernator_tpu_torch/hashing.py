"""Key hashing (the port of gubernator_tpu/hashing.py).

The rate-limit identity is ``name + "_" + unique_key``, hashed on the
host to 64 bits (FNV-1a 64 + a splitmix64 finalizer).  Bucket placement
in the device table depends on these bits, so they must stay identical
to the JAX package's: the tests hash the same request lists through
both.  Hash value 0 is remapped to 1 (key 0 marks an empty slot).

``hash_keys`` / ``hash_request_keys`` / ``hash_key`` run in the host
library (csrc/wire.cpp › gw_hash_keys / gw_hash_pairs, the port of the
JAX extension's fnv1a64_batch / fnv1a64_pair_batch, finalizer included);
a library that cannot be built raises, as the wire lane does.  The
Python loops ``hash_keys_plain`` / ``hash_request_keys_plain`` are their
plain versions, for the tests.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


def fnv1a64(data: bytes) -> int:
    h = 0xCBF29CE484222325
    for b in data:
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def mix64_np(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64-style avalanche finalizer (uint64 → uint64)."""
    x = x.astype(np.uint64)  # astype copies; in-place ops below are safe
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    return x


def mix64(x: int) -> int:
    """Scalar splitmix64 finalizer (the constants of mix64_np)."""
    m = 0xFFFFFFFFFFFFFFFF
    x &= m
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & m
    x ^= x >> 27
    x = (x * 0x94D049BB133111EB) & m
    x ^= x >> 31
    return x


def mixed_fnv1a64(data: bytes) -> int:
    """FNV-1a + the finalizer: the peer ring's hash (raw FNV clusters
    on short similar keys)."""
    return mix64(fnv1a64(data))


def hash_key(name: str, unique_key: str) -> int:
    """64-bit identity hash of one rate limit, never 0."""
    return int(hash_request_keys([name], [unique_key])[0])


def hash_keys(keys: Sequence[str]) -> np.ndarray:
    """Batch hash → uint64[len(keys)], never 0 (native)."""
    from .ops.native import hash_keys as native_hash_keys

    return native_hash_keys(keys, mixed=True)


def hash_request_keys(names: Sequence[str], unique_keys: Sequence[str]
                      ) -> np.ndarray:
    """Batch identity hash of (name, unique_key) pairs, never 0, without
    building the joined strings (native)."""
    from .ops.native import hash_pairs

    return hash_pairs(names, unique_keys, mixed=True)


def hash_keys_plain(keys: Sequence[str]) -> np.ndarray:
    """The plain version of ``hash_keys``: a Python FNV loop, then
    mix64_np."""
    raw = np.empty(len(keys), dtype=np.uint64)
    for i, k in enumerate(keys):
        raw[i] = fnv1a64(k.encode("utf-8"))
    x = mix64_np(raw)
    return np.where(x == 0, np.uint64(1), x)


def hash_request_keys_plain(names: Sequence[str],
                            unique_keys: Sequence[str]) -> np.ndarray:
    """The plain version of ``hash_request_keys``."""
    if len(names) != len(unique_keys):
        raise ValueError("length mismatch")
    return hash_keys_plain([n + "_" + k for n, k in zip(names, unique_keys)])


def shard_of(key_hash: np.ndarray | int, num_shards: int) -> np.ndarray | int:
    """Shard index by hash range (top 32 bits): ``((h >> 32) * n) >> 32``."""
    if isinstance(key_hash, (int, np.integer)):
        return int(((int(key_hash) >> 32) * num_shards) >> 32)
    kh = key_hash.astype(np.uint64)
    return ((kh >> np.uint64(32)) * np.uint64(num_shards)
            >> np.uint64(32)).astype(np.int32)
