"""gubernator_tpu_torch: the PyTorch / CUDA port of gubernator_tpu.

Runs on an NVIDIA GPU and, when asked with ``device="cpu"``, on the CPU
through each kernel's plain PyTorch version.  Two engines serve: the
bucket engine (engine.py; its decision step is the hand-written CUDA
kernel csrc/decide.cu) and the classic SoA engine (sharded.py; the step
is plain PyTorch, the expiry sweep the kernel csrc/sweep.cu), each with
a host cold tier behind its table (tiering.py), the heavy-hitter
analytics (analytics.py) and the Store / Loader hooks (store.py).
Daemons join in a cluster (cluster.py: in one process, or as a group of
processes behind one SO_REUSEPORT client port) and across regions
(multiregion.py).  The kernels and the host library are built at first
use.  Imports torch, numpy and the standard
library; nothing of JAX or of the JAX package.
"""
from .daemon import spawn_daemon
from .engine import BucketEngine
from .instance import V1Instance
from .sharded import ShardedEngine
from .store import CacheItem, FileLoader, MockLoader, MockStore
from .types import RateLimitRequest, RateLimitResponse

__all__ = ["BucketEngine", "CacheItem", "FileLoader", "MockLoader",
           "MockStore", "RateLimitRequest", "RateLimitResponse",
           "ShardedEngine", "V1Instance", "spawn_daemon"]
