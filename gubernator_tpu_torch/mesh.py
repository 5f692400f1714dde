"""The device mesh: the port of gubernator_tpu/parallel/mesh.py.

The key universe is range-sharded across the mesh by the top bits of
the key hash (hashing.shard_of): shard d owns one contiguous hash range
and its block of the table lives on ``mesh.devices[d]``.  A ``Mesh`` is
that ordered sequence of ``torch.device``s; the engines hold one table
block per entry (sharded.py, engine.py), the replica tiers one replica
per entry (hotset.py, meshglobal.py), and what the JAX package does with
``psum`` / ``pmax`` over the ``shard`` axis is a sum / max over those
per-device tensors, gathered to ``devices[0]``.

``make_mesh()`` takes every visible CUDA device once, as JAX's
``make_mesh()`` takes every local device.  A mesh may repeat a device:
``make_mesh(["cuda:0"] * 4)`` runs four shards on one GPU and
``make_mesh(["cpu"] * 4)`` four on the CPU.  That is a rehearsal of
n > 1 (the counterpart of the JAX tests'
``--xla_force_host_platform_device_count``): the routing, the per-shard
launches and the folds are those of n devices, the bandwidth is one.
``XLA_EXEC_MU`` works around an XLA:CPU wedge and has no counterpart.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

SHARD_AXIS = "shard"


class Mesh:
    """A 1-D mesh: shard d on ``devices[d]``."""

    def __init__(self, devices: Sequence):
        devs = tuple(torch.device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        for d in devs:
            if d.type == "cuda":
                if not torch.cuda.is_available():
                    raise RuntimeError("CUDA is not available; pass CPU "
                                       "devices to build a CPU mesh")
                if (d.index or 0) >= torch.cuda.device_count():
                    raise ValueError(f"no device {d}")
            elif d.type != "cpu":
                raise ValueError(f"unsupported device {d}")
        # a bare "cuda" is the current device: name it, so that two
        # entries for one card compare equal
        self.devices = tuple(
            torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in devs)
        self.n = len(self.devices)

    @property
    def shape(self) -> dict:
        """``{"shard": n}``, as a JAX mesh's ``shape``."""
        return {SHARD_AXIS: self.n}

    @property
    def rehearsal(self) -> bool:
        """Whether some device holds more than one shard."""
        return len(set(self.devices)) < self.n

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def make_mesh(devices: Optional[Sequence] = None,
              n: Optional[int] = None) -> Mesh:
    """A mesh over ``devices`` (default: every visible CUDA device once;
    raises without a GPU), cut to the first ``n`` when given."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass devices "
                               "(e.g. ['cpu'] * 4) to build a CPU mesh")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = list(devices)
    if n is not None:
        if n > len(devs):
            raise ValueError(f"asked for {n} shards of {len(devs)} devices")
        devs = devs[:n]
    return Mesh(devs)


def resolve_mesh(mesh: Optional[Mesh], device) -> Mesh:
    """The mesh an engine serves on: ``mesh`` when given, else the
    one-device mesh of ``device``."""
    return mesh if mesh is not None else Mesh([device])
