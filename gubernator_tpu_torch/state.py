"""Carrying table state across the two packages.

- The bucket table: the JAX package's (``PallasTable.rows`` or
  ``PallasServingEngine.state``) and this package's share one word
  layout (core/table.py), so a table moves across as its int32 words.
- The SoA table: the JAX ``TableState`` and this package's share their
  nine columns; a table moves across as numpy columns, with ``key`` as
  uint64 on the JAX side and its int64 bit-view here.

Either engine restores from the column dict that either package's
``snapshot()`` writes (the store.py format).
"""
from __future__ import annotations

import numpy as np
import torch

from .core.table import WORDS, TableState


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


def soa_from_jax(cols, device) -> TableState:
    """A JAX SoA ``TableState`` as numpy columns (a mapping or the
    NamedTuple itself; uint64 key) → this package's table on
    ``device``."""
    get = cols.get if hasattr(cols, "get") else (
        lambda f: getattr(cols, f))
    out = {}
    for f in TableState._fields:
        a = np.asarray(get(f))
        dtype = np.int32 if f == "meta" else np.int64
        a = a.view(np.int64) if f == "key" else a.astype(dtype)
        out[f] = torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)
    return TableState(**out)


def soa_to_numpy(state: TableState) -> dict:
    """This package's SoA table → numpy columns named as the JAX
    ``TableState``'s (host copies; uint64 key)."""
    out = {f: getattr(state, f).detach().cpu().numpy().copy()
           for f in TableState._fields}
    out["key"] = out["key"].view(np.uint64)
    return out


def restore_from_snapshot(engine, arrays: dict) -> int:
    """Restore a store.py column dict (either package's ``snapshot()``)
    into either of this package's engines; returns the rows placed."""
    return engine.restore(arrays)
