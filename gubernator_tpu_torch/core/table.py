"""The bucketized counter table: ``rows[CAP, WORDS]`` int32 on the device.

Same layout as gubernator_tpu/ops/pallas_step.py, word for word, so a
table compares with the JAX one directly: 8-slot buckets of 128-byte
rows (bucket b = rows[8b : 8b+8]); a key lives in bucket
``key & (CAP/8 - 1)``; an empty slot has both key words 0.  64-bit
fields are (lo, hi) int32 word pairs.
"""
from __future__ import annotations

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
