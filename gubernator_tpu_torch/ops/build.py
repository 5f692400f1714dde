"""Build and bind the port's CUDA kernels (csrc/*.cu) at first use.

K1 (decide.cu), K2 (sweep.cu) and K3 (probe.cu) go into one library.
Each source compiles with its own ``nvcc -c`` (all started together),
then one link makes ``build/gubernator_tpu_torch/libgubertorch.so`` in
the checkout.  A file lock serializes concurrent builds, and a hash
of the sources and flags decides when to rebuild.  The library has a
plain C interface and is loaded with ctypes (no PyTorch headers, so a
build takes seconds).  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "gubernator_tpu_torch"
LIB_NAME = "libgubertorch.so"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_mu = threading.Lock()
_lib: ctypes.CDLL | None = None
#: what the last build did: seconds, whether it compiled, nvcc's output
#: (ptxas registers / spills per kernel)
build_info: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit (set CUDA_HOME)")
    return str(path)


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(ARCH + FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def _compile(nvcc: str, sources: list[Path], lib: Path) -> str:
    """One nvcc per source, in parallel, then one link; returns the
    compilers' combined output."""
    objs = [BUILD_DIR / (src.stem + ".o") for src in sources]
    procs = [subprocess.Popen([nvcc, *ARCH, *FLAGS, "-c", str(src), "-o",
                               str(obj)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    logs = []
    for src, p in zip(sources, procs):
        text, _ = p.communicate()
        logs.append(text)
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{text}")
    tmp = lib.with_suffix(".so.tmp")
    link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp),
                           *map(str, objs)], capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, lib)
    return "".join(logs)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p = ctypes.c_void_p
    i64 = ctypes.c_int64
    lib.guber_decide.argtypes = [p, p, p, p, p, p, i64, i64, i64, p, p, p]
    lib.guber_decide.restype = ctypes.c_int
    lib.guber_decide_smem.argtypes = []
    lib.guber_decide_smem.restype = i64
    lib.guber_sweep.argtypes = [p, p, i64, i64, p, p, p]
    lib.guber_sweep.restype = ctypes.c_int
    lib.guber_probe_add.argtypes = [p, p, p, ctypes.c_int64, p]
    lib.guber_probe_add.restype = ctypes.c_int
    lib.guber_error_string.argtypes = [ctypes.c_int]
    lib.guber_error_string.restype = ctypes.c_char_p
    return lib


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built from csrc/ if it is missing or
    stale.  Raises when it cannot be built."""
    global _lib
    if _lib is not None:
        return _lib
    with _mu:
        if _lib is not None:
            return _lib
        sources = sorted(CSRC.glob("*.cu"))
        digest = _digest(sources)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        lib_path = BUILD_DIR / LIB_NAME
        stamp = BUILD_DIR / "sources.sha256"
        t0 = time.perf_counter()
        built = False
        log = ""
        with open(BUILD_DIR / "build.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not (lib_path.exists() and stamp.exists()
                    and stamp.read_text() == digest):
                log = _compile(nvcc_path(), sources, lib_path)
                stamp.write_text(digest)
                built = True
        build_info.update(seconds=time.perf_counter() - t0, built=built,
                          log=log, path=str(lib_path))
        _lib = _bind(ctypes.CDLL(str(lib_path)))
        return _lib
