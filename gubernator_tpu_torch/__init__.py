"""gubernator_tpu_torch: the PyTorch / CUDA port of gubernator_tpu.

Runs on an NVIDIA GPU (the decision step is a hand-written CUDA kernel,
csrc/decide.cu, built at first use) and, when asked with
``device="cpu"``, on the CPU through the kernel's plain PyTorch version.
Imports torch, numpy and the standard library; nothing of JAX or of the
JAX package.
"""
from .daemon import spawn_daemon
from .engine import BucketEngine
from .instance import V1Instance
from .types import RateLimitRequest, RateLimitResponse

__all__ = ["BucketEngine", "RateLimitRequest", "RateLimitResponse",
           "V1Instance", "spawn_daemon"]
