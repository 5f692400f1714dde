"""The expired-row sweep of the SoA table: K2's wrapper.

Replaces gubernator_tpu/ops/pallas_sweep.py › sweep_expired_pallas (the
TPU kernel ``_sweep_kernel``): every row with ``expire_at <= now`` gets
``key = 0`` and ``expire_at = 0``, and the rows that are neither expired
nor empty are counted in the same pass.  An expired row and an empty row
behave the same on their next access, so the sweep changes no decision.

- ``sweep_cuda`` launches K2 (csrc/sweep.cu) on a CUDA table;
- ``sweep_plain`` is the same function in plain PyTorch;
- ``sweep`` picks by the table's device.  Nothing falls back.

All three update ``state.key`` and ``state.expire_at`` in place (the JAX
sweep returns a new state) and return the live count as a 0-d int64
device tensor; the caller reads it with one ``.item()``.

A sweep on the card is one launch and allocates nothing: each stream of
a device has a ring of ``RING`` counters, zeroed once, and each launch
adds its count into its slot and zeroes the next one, which the next
launch on the stream takes.  So the tensor ``sweep_cuda`` returns is a
view of its slot: it holds this sweep's count for ``RING - 2`` further
sweeps on its stream, then reads 0 and, after one more, that sweep's
count.  Read it before then (the engines read it at once).
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ..core.table import TableState

#: counters in each stream's ring
RING = 64
#: (device index, stream handle) -> [the ring, its next slot]
_rings: dict = {}
_rings_mu = threading.Lock()


def sweep_plain(state: TableState, now) -> torch.Tensor:
    """The plain PyTorch version of K2."""
    dead = state.expire_at <= int(now)
    state.key.masked_fill_(dead, 0)
    state.expire_at.masked_fill_(dead, 0)
    return (state.key != 0).sum()


def sweep_cuda(state: TableState, now) -> torch.Tensor:
    """Launch K2 on the current stream.  Returns the live count as a view
    of this sweep's slot in the stream's ring, valid for ``RING - 2``
    further sweeps on the stream (the module's docstring).  Raises on a
    refused launch; never falls back."""
    from .build import load_library

    key, exp = state.key, state.expire_at
    if key.device.type != "cuda" or exp.device != key.device:
        raise ValueError("sweep_cuda takes a CUDA table")
    if key.dtype != torch.int64 or exp.dtype != torch.int64 \
            or key.shape != exp.shape or key.dim() != 1 \
            or not (key.is_contiguous() and exp.is_contiguous()):
        raise ValueError("key and expire_at must be contiguous int64 "
                         "columns of one length")
    lib = load_library()
    stream = torch.cuda.current_stream(key.device).cuda_stream
    with _rings_mu, torch.cuda.device(key.device):
        ring = _rings.get((key.device.index, stream))
        if ring is None:
            ring = _rings[(key.device.index, stream)] = [torch.zeros(
                RING, dtype=torch.int64, device=key.device), 0]
        counts, slot = ring
        rc = lib.guber_sweep(
            key.data_ptr(), exp.data_ptr(), ctypes.c_int64(key.numel()),
            ctypes.c_int64(int(now)), counts.data_ptr() + 8 * slot,
            counts.data_ptr() + 8 * ((slot + 1) % RING), stream)
        if rc != 0:
            raise RuntimeError(f"K2 launch failed: CUDA error {rc} "
                               f"({lib.guber_error_string(rc).decode()})")
        ring[1] = (slot + 1) % RING
        sweep_cuda.launches += 1
    return counts[slot]


#: K2 launches since the last reset (chip_smoke.py proves the classic
#: path went through the kernel with it)
sweep_cuda.launches = 0


def sweep(state: TableState, now) -> torch.Tensor:
    """The sweep: the plain version for a CPU table, K2 for a CUDA one.
    The count it returns for a CUDA table holds for ``RING - 2`` further
    sweeps on its stream: read it before then."""
    dev = state.key.device.type
    if dev == "cuda":
        return sweep_cuda(state, now)
    if dev == "cpu":
        return sweep_plain(state, now)
    raise ValueError(f"no sweep for device {state.key.device}")
