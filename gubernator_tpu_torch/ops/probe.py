"""The toolchain probe: K3's wrapper.

Replaces tools/pallas_probe.py › toy (the TPU kernel ``toy.k``): an int32
elementwise add that wraps at overflow.  ``chip_smoke.py`` runs it first,
as the check that nvcc, the library load and a launch work at all.
``probe_add`` launches K3 (csrc/probe.cu) for CUDA tensors and takes the
plain ``x + y`` for CPU tensors.  Nothing falls back.
"""
from __future__ import annotations

import ctypes

import torch


def probe_add_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of K3."""
    return x + y


def probe_add_cuda(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Launch K3 on the current stream; raises on a refused launch."""
    from .build import load_library

    if x.device.type != "cuda" or y.device != x.device:
        raise ValueError("probe_add_cuda takes CUDA tensors on one device")
    if x.dtype != torch.int32 or y.dtype != torch.int32 \
            or x.shape != y.shape:
        raise ValueError("probe_add takes two int32 tensors of one shape")
    x, y = x.contiguous(), y.contiguous()
    lib = load_library()
    out = torch.empty_like(x)
    if x.numel():
        with torch.cuda.device(x.device):
            rc = lib.guber_probe_add(
                x.data_ptr(), y.data_ptr(), out.data_ptr(),
                ctypes.c_int64(x.numel()),
                torch.cuda.current_stream(x.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"K3 launch failed: CUDA error {rc} "
                               f"({lib.guber_error_string(rc).decode()})")
        probe_add_cuda.launches += 1
    return out


#: K3 launches since the last reset
probe_add_cuda.launches = 0


def probe_add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """int32 ``x + y`` with wrap: K3 on CUDA, the plain add on the CPU."""
    if x.device.type == "cuda":
        return probe_add_cuda(x, y)
    if x.device.type == "cpu":
        return probe_add_plain(x, y)
    raise ValueError(f"no probe_add for device {x.device}")
