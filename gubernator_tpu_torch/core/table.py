"""The two counter tables the port serves from, on one device.

- The bucketized table, ``rows[CAP, WORDS]`` int32: the same layout as
  gubernator_tpu/ops/pallas_step.py, word for word, so a table compares
  with the JAX one directly: 8-slot buckets of 128-byte rows (bucket b
  = rows[8b : 8b+8]); a key lives in bucket ``key & (CAP/8 - 1)``; an
  empty slot has both key words 0.  64-bit fields are (lo, hi) int32
  word pairs.  The bucket engine (engine.py) and K1 serve from it.
- The struct-of-arrays table, ``TableState``: the counterpart of
  gubernator_tpu/core/table.py › TableState, column for column, so a
  table compares with the JAX one directly: nine parallel [CAP] columns,
  key→row by open addressing over ``key`` (core/step.py).  The classic
  engine (sharded.py) serves from it; K2 sweeps it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

SLOTS = 8  # probe window = one bucket
WORDS = 32  # i32 words per row (128 B)

#: value bound for the i32 counter words (limit changes add two limits
#: before clipping, so 2^30 keeps every intermediate in i32)
VALUE_BOUND = 1 << 30
#: leaky eff_ms bound (~24.8 days): keeps every td quotient < 2^31
EFF_BOUND = 1 << 31

# ---- row word layout (i32 words within a 32-word slot) -----------------
W_KLO, W_KHI = 0, 1
W_REM, W_STATUS, W_LIMIT = 2, 3, 4
W_TLO, W_THI = 5, 6
W_XLO, W_XHI = 7, 8  # expire_at
W_ELO, W_EHI = 9, 10  # eff_ms
W_DLO, W_DHI = 11, 12  # duration
W_ALG = 13  # 0 token / 1 leaky
W_TDLO, W_TDHI = 14, 15  # leaky remaining, td units (= remaining × eff)
#: words 16..31 are reserved: never read, never written by a decision
USED_WORDS = 16


def init_table(capacity: int, device) -> torch.Tensor:
    """A zeroed ``[capacity, WORDS]`` int32 table on ``device``."""
    if capacity < SLOTS or capacity & (capacity - 1):
        raise ValueError(f"capacity must be a power of two >= {SLOTS}")
    return torch.zeros((capacity, WORDS), dtype=torch.int32, device=device)


def join64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(hi, lo) int32 words → int64."""
    return (hi.to(torch.int64) << 32) | (lo.to(torch.int64) & 0xFFFFFFFF)


def split64(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int64 → (hi, lo) int32 words, wrapping as numpy's astype does.
    The low word is sign-adjusted in int64 first, so the int32 cast is
    exact on every backend."""
    lo = ((x & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000
    return (x >> 32).to(torch.int32), lo.to(torch.int32)


# ---- the struct-of-arrays table ----------------------------------------

class TableState(NamedTuple):
    """Parallel [capacity] columns on one device; one row per key.

    ``key`` is the int64 bit-view of the 64-bit identity hash (0 =
    empty slot).  ``remaining`` holds tokens for TOKEN rows and the td
    fixed point (remaining × eff) for LEAKY rows; ``t_ms`` is created_at
    for token rows and updated_at for leaky rows.  The step and K2
    update the columns in place."""

    key: torch.Tensor  # int64[cap] (uint64 bits), 0 = empty
    meta: torch.Tensor  # int32[cap], bit0 alg, bit1 stored status
    limit: torch.Tensor  # int64[cap]
    duration: torch.Tensor  # int64[cap], as given (ms or Gregorian ordinal)
    eff_ms: torch.Tensor  # int64[cap], effective ms denominator
    burst: torch.Tensor  # int64[cap]
    remaining: torch.Tensor  # int64[cap]
    t_ms: torch.Tensor  # int64[cap]
    expire_at: torch.Tensor  # int64[cap], 0 = never written (expired)


def init_soa_table(capacity: int, device) -> TableState:
    """An empty SoA table on ``device``; ``capacity`` must be a power of
    two (probe masking).  ``eff_ms`` starts at 1, as in the JAX table."""
    if capacity & (capacity - 1) or capacity <= 0:
        raise ValueError(f"capacity must be a power of two, got {capacity}")

    def z(dtype=torch.int64):
        return torch.zeros(capacity, dtype=dtype, device=device)

    return TableState(key=z(), meta=z(torch.int32), limit=z(), duration=z(),
                      eff_ms=torch.ones(capacity, dtype=torch.int64,
                                        device=device),
                      burst=z(), remaining=z(), t_ms=z(), expire_at=z())


def occupancy(state: TableState) -> torch.Tensor:
    """Live (non-empty) rows, as a 0-d device tensor."""
    return (state.key != 0).sum()
