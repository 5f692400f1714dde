"""The multi-host bootstrap over ``torch.distributed`` (the port of
gubernator_tpu/parallel/multihost.py).

Traffic classes, as in the JAX package: within a host the engines'
folds are sums over the mesh's per-device tensors (mesh.py); across
regions and pods daemons peer over the gRPC wire (peer_client.py,
global_manager.py, multiregion.py); across the processes of ONE logical
mesh spanning hosts, this module: a process group (``initialize``), a
global mesh whose shards are every process's devices (``global_mesh``),
each process feeding the shards it hosts (``process_local_batch``), and
the folds across the process boundary as ``all_reduce`` (``psum``,
``pmax``).  The backend is NCCL for CUDA devices and gloo for CPU ones;
nothing tells a process of its cluster, so the caller names the
coordinator (``host:port`` of process 0), the process count and its
rank, as with ``jax.distributed.initialize``.

Scope is JAX's: the bootstrap, the folds and the decision step across
processes (``sharded_step``), not daemon-level serving across hosts.
"""
from __future__ import annotations

import datetime
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from .core.step import StepOutput, decide_batch
from .mesh import SHARD_AXIS

#: this process's place in the group, set by ``initialize``
_GROUP: dict = {}


class GlobalMesh:
    """A 1-D mesh over every process's shards: process p hosts shards
    [p·L, (p+1)·L) on its ``local_devices`` (L of them, the same count
    in every process)."""

    def __init__(self, process_index: int, process_count: int,
                 local_devices: Sequence[torch.device]):
        self.process_index = process_index
        self.process_count = process_count
        self.local_devices = tuple(local_devices)
        self.local_count = len(self.local_devices)
        self.n = process_count * self.local_count
        self.local_shards = range(process_index * self.local_count,
                                  (process_index + 1) * self.local_count)

    @property
    def shape(self) -> dict:
        return {SHARD_AXIS: self.n}


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, local_device_count: Optional[int] = None,
               device: str = "cuda", timeout_s: float = 60.0) -> None:
    """Join (or, as process 0, form) the process group.

    ``coordinator_address`` is process 0's ``host:port`` (a
    ``tcp://`` prefix is optional).  ``device="cuda"`` hosts this
    process's shards on its visible GPUs (every one, or
    ``local_device_count`` of them, repeating the GPUs when there are
    fewer: a rehearsal) over NCCL; ``device="cpu"`` hosts
    ``local_device_count`` (default 1) CPU shards over gloo.  A
    rendezvous that does not complete within ``timeout_s`` raises."""
    import torch.distributed as dist

    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' "
                               "for a gloo group of CPU shards")
        gpus = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
        count = local_device_count or len(gpus)
        local = [gpus[i % len(gpus)] for i in range(count)]
        torch.cuda.set_device(local[0])
        backend = "nccl"
    elif dev.type == "cpu":
        local = [torch.device("cpu")] * (local_device_count or 1)
        backend = "gloo"
    else:
        raise ValueError(f"unsupported device {dev}")
    addr = (coordinator_address if "://" in coordinator_address
            else "tcp://" + coordinator_address)
    dist.init_process_group(
        backend, init_method=addr, world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))
    _GROUP.update(rank=process_id, world=num_processes, local=local,
                  backend=backend)
    counts = psum_scalar(len(local))
    if counts != len(local) * num_processes:
        shutdown()
        raise ValueError("every process must host the same number of "
                         "shards")


def shutdown() -> None:
    """Leave the process group."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    _GROUP.clear()


def global_mesh() -> GlobalMesh:
    """The mesh over every process's shards."""
    if not _GROUP:
        raise RuntimeError("call multihost.initialize first")
    return GlobalMesh(_GROUP["rank"], _GROUP["world"], _GROUP["local"])


def process_local_batch(mesh: GlobalMesh, host_cols: np.ndarray,
                        axis: int = 0) -> List[torch.Tensor]:
    """This process's shards' blocks of a global array, from its slice
    ``host_cols`` (its L blocks in shard order along ``axis``): one
    tensor per local shard, on that shard's device (JAX's
    make_array_from_process_local_data; packed wave matrices are
    [cols, B], sharded on axis 1)."""
    arr = np.asarray(host_cols)
    blocks = np.split(arr, mesh.local_count, axis=axis)
    return [torch.from_numpy(np.ascontiguousarray(b)).to(dev)
            for b, dev in zip(blocks, mesh.local_devices)]


def _reduce(parts: Sequence[torch.Tensor], op: str) -> torch.Tensor:
    import torch.distributed as dist

    dev = _GROUP["local"][0]
    acc = parts[0].to(dev).clone()
    for p in parts[1:]:
        p = p.to(dev)
        acc = acc + p if op == "sum" else torch.maximum(acc, p)
    dist.all_reduce(acc, op=dist.ReduceOp.SUM if op == "sum"
                    else dist.ReduceOp.MAX)
    return acc


def psum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The sum over every shard of the mesh of this process's shard
    tensors ``parts`` (one each), the same in every process, on its
    first local device."""
    return _reduce(parts, "sum")


def pmax(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The max over every shard (see ``psum``)."""
    return _reduce(parts, "max")


def psum_scalar(x: int) -> int:
    """An integer summed over the processes."""
    dev = _GROUP["local"][0]
    return int(_reduce([torch.tensor(int(x), dtype=torch.int64,
                                     device=dev)], "sum"))


def sharded_step(mesh: GlobalMesh, tables: Sequence,
                 batches: Sequence, now_ms: int,
                 step: Callable = decide_batch
                 ) -> tuple[List[StepOutput], tuple[int, int]]:
    """One decision step over the global mesh: each local shard's
    ``step(table, batch, now)`` on its device (core/step.py's SoA step,
    or ops/decide.py › decide, K1 on a CUDA table, over bucket rows),
    and the over / insert counters summed over every shard of every
    process (JAX's make_sharded_step psums them).  Returns (the local
    shards' outputs, (over, insert))."""
    outs = [step(t, b, now_ms) for t, b in zip(tables, batches)]
    dev = _GROUP["local"][0]
    counts = psum([torch.stack([o.over_count.to(torch.int64),
                                o.insert_count.to(torch.int64)]).to(dev)
                   for o in outs])
    over, ins = counts.cpu().tolist()
    return outs, (int(over), int(ins))
