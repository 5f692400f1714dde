"""Carrying table state across the two packages.

The JAX package's bucket table (``PallasTable.rows`` or
``PallasServingEngine.state``) and this package's table share one word
layout (core/table.py), so a table moves across as its int32 words, and
an engine restores from the column dict that either package's
``snapshot()`` writes (the store.py format).
"""
from __future__ import annotations

import numpy as np
import torch

from .core.table import WORDS


def table_from_jax(rows: np.ndarray, device) -> torch.Tensor:
    """A JAX bucket table, as numpy, → this package's table on
    ``device``."""
    a = np.ascontiguousarray(np.asarray(rows), dtype=np.int32)
    if a.ndim != 2 or a.shape[1] != WORDS:
        raise ValueError(f"want a [CAP, {WORDS}] int32 table, got {a.shape}")
    return torch.from_numpy(a.copy()).to(device)


def table_to_numpy(rows: torch.Tensor) -> np.ndarray:
    """This package's table → numpy int32 [CAP, 32] (host copy)."""
    return rows.detach().cpu().numpy().copy()


def restore_from_snapshot(engine, arrays: dict) -> int:
    """Restore a store.py column dict (either package's ``snapshot()``)
    into ``engine``; returns the rows placed."""
    return engine.restore(arrays)
