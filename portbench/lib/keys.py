"""Key draws: which key each row of each call names, from the seed.

A traffic file's ``keys`` gives the distribution of key ranks over the
configuration's population (rank 0 the hottest).  The rows of a run are
a pool of calls drawn once at set-up; the generator cycles through it.
"""
from __future__ import annotations

import numpy as np


def rng_of(seed: int, stream: int) -> np.random.Generator:
    """One independent stream of draws of the run's seed (any integer)."""
    return np.random.default_rng([stream, seed % (1 << 64)])


def zipf_ranks(rng, a: float, n_keys: int, size: int) -> np.ndarray:
    """Zipf(a) ranks over [0, n_keys), by rejection of the tail."""
    out = np.empty(0, np.int64)
    while len(out) < size:
        z = rng.zipf(a, size=2 * size)
        out = np.concatenate([out, z[z <= n_keys] - 1])
    return out[:size]


def draw_ranks(spec: dict, rng, n_keys: int, size: int) -> np.ndarray:
    """``size`` key ranks by a traffic file's ``keys`` entry:
    ``{"dist": "zipf", "a": 1.1}``."""
    dist = spec["dist"]
    if dist == "zipf":
        return zipf_ranks(rng, float(spec["a"]), n_keys, size)
    raise ValueError(f"unknown key distribution {dist!r}")


def call_pool(traffic: dict, seed: int, n_keys: int) -> np.ndarray:
    """[pool_calls, checks_per_call] key ranks of the run's calls."""
    p, c = int(traffic["pool_calls"]), int(traffic["checks_per_call"])
    return draw_ranks(traffic["keys"], rng_of(seed, 1), n_keys,
                      p * c).reshape(p, c)


def read_ranks(traffic: dict, seed: int, n_keys: int,
               pool: np.ndarray) -> np.ndarray:
    """The ranks read back after the window: the hottest ones, a sample
    of the pool's rows and a sample of the whole population (mostly
    keys never sent), without repeats."""
    rb = traffic["readback"]
    rng = rng_of(seed, 2)
    parts = [np.arange(min(int(rb["hottest"]), n_keys)),
             rng.choice(pool.ravel(), int(rb["sent"])),
             rng.integers(0, n_keys, int(rb["population"]))]
    out = np.unique(np.concatenate(parts))
    return out[rng.permutation(len(out))]
