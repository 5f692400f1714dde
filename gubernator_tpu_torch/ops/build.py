"""Build and bind the port's native libraries at first use.

Two libraries, each with a plain C interface, loaded with ctypes:

- the CUDA kernels (csrc/*.cu): K1 (decide.cu), K2 (sweep.cu) and K3
  (probe.cu).  Each source compiles with its own ``nvcc -c`` (all
  started together), then one link makes
  ``build/gubernator_tpu_torch/libgubertorch.so`` in the checkout (no
  PyTorch headers, so a build takes seconds);
- the host library (csrc/wire.cpp, ops/native.py; csrc/cold.cpp, the
  tier's cold store; csrc/sketch.cpp, the heavy-hitter sketch's fold;
  csrc/tenants.cpp, the tenant ledger's attribution),
  built with the host C++ compiler and the running
  interpreter's Python headers into ``libguberwire.so``.  It needs no
  CUDA, so the CPU-only tests build and use it too.  Its key-hashing
  entry points take Python objects and are bound a second time through
  ``ctypes.PyDLL`` (``load_wire_pylib``), which keeps the GIL.

A file lock serializes concurrent builds, and a hash of each library's
sources and flags decides when to rebuild it.  A failed build raises.
Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import sysconfig
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "gubernator_tpu_torch"
LIB_NAME = "libgubertorch.so"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
WIRE_LIB_NAME = "libguberwire.so"
WIRE_SOURCE = CSRC / "wire.cpp"
COLD_SOURCE = CSRC / "cold.cpp"
SKETCH_SOURCE = CSRC / "sketch.cpp"
TENANTS_SOURCE = CSRC / "tenants.cpp"
CXX_FLAGS = ["-std=c++17", "-O3", "-fPIC", "-shared"]


def _py_include() -> list[str]:
    """The running interpreter's headers (wire.cpp's hashing reads
    Python strings); the library resolves their symbols from the
    process, so nothing links against libpython."""
    return ["-I" + sysconfig.get_paths()["include"]]


_mu = threading.Lock()
_lib: ctypes.CDLL | None = None
_wire_lib: ctypes.CDLL | None = None
_wire_pylib: ctypes.PyDLL | None = None
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


def cxx_path() -> str:
    """The host C++ compiler: $CXX, else ``c++``, else ``g++``."""
    for name in (os.environ.get("CXX"), "c++", "g++"):
        found = shutil.which(name) if name else None
        if found:
            return found
    raise RuntimeError("no host C++ compiler (c++ or g++) to build the "
                       "wire library; set CXX")


def _digest(sources: list[Path], flags: list[str]) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
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


def _build_once(lib_path: Path, stamp: Path, digest: str, build) -> tuple:
    """Run ``build()`` under the build lock unless ``lib_path`` matches
    ``digest``; returns (seconds, built, compiler output)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    built = False
    log = ""
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (lib_path.exists() and stamp.exists()
                and stamp.read_text() == digest):
            log = build()
            stamp.write_text(digest)
            built = True
    return time.perf_counter() - t0, built, log


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
        digest = _digest(sources, ARCH + FLAGS)
        lib_path = BUILD_DIR / LIB_NAME
        seconds, built, log = _build_once(
            lib_path, BUILD_DIR / "sources.sha256", digest,
            lambda: _compile(nvcc_path(), sources, lib_path))
        build_info.update(seconds=seconds, built=built, log=log,
                          path=str(lib_path))
        _lib = _bind(ctypes.CDLL(str(lib_path)))
        return _lib


def _host_sources() -> list[Path]:
    return [WIRE_SOURCE, COLD_SOURCE, SKETCH_SOURCE, TENANTS_SOURCE]


def _compile_wire(cxx: str, lib: Path) -> str:
    tmp = lib.with_suffix(".so.tmp")
    sources = _host_sources()
    r = subprocess.run([cxx, *CXX_FLAGS, *_py_include(), *map(str, sources),
                        "-o", str(tmp)], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(
            f"{cxx} failed on {', '.join(s.name for s in sources)}:\n"
            f"{r.stdout}{r.stderr}")
    os.replace(tmp, lib)
    return r.stdout + r.stderr


def _bind_wire(lib: ctypes.CDLL) -> ctypes.CDLL:
    p = ctypes.c_void_p
    i64 = ctypes.c_int64
    u64 = ctypes.c_uint64
    buf = ctypes.c_char_p
    lib.gw_count_req_items.argtypes = [buf, i64]
    lib.gw_count_req_items.restype = i64
    lib.gw_parse_get_rate_limits.argtypes = [buf, i64, i64] + [p] * 11
    lib.gw_parse_get_rate_limits.restype = i64
    lib.gw_pack_wire_wave.argtypes = [buf, i64, i64, p, p, i64,
                                      u64, u64, u64, u64] + [p] * 5
    lib.gw_pack_wire_wave.restype = i64
    lib.gw_resp_bound.argtypes = [i64, i64, i64]
    lib.gw_resp_bound.restype = i64
    lib.gw_build_responses.argtypes = [p, p, p, p, i64, i64, p, p, p, i64,
                                       buf, p, i64]
    lib.gw_build_responses.restype = i64
    lib.gw_stamp_bound.argtypes = [i64, i64]
    lib.gw_stamp_bound.restype = i64
    lib.gw_stamp_req_tlvs.argtypes = [buf, i64, p, p, p, i64, i64, p, i64]
    lib.gw_stamp_req_tlvs.restype = i64
    lib.gw_split_resp_items.argtypes = [buf, i64, i64, p, p, p]
    lib.gw_split_resp_items.restype = i64
    lib.gc_new.argtypes = [i64]
    lib.gc_new.restype = p
    lib.gc_free.argtypes = [p]
    lib.gc_free.restype = None
    lib.gc_put.argtypes = [p, u64, p]
    lib.gc_put.restype = ctypes.c_int
    lib.gc_put_many.argtypes = [p, p, p, i64]
    lib.gc_put_many.restype = i64
    lib.gc_get.argtypes = [p, u64, p]
    lib.gc_get.restype = ctypes.c_int
    lib.gc_get_many.argtypes = [p, p, i64, p, p]
    lib.gc_get_many.restype = None
    lib.gc_pop.argtypes = [p, u64, p]
    lib.gc_pop.restype = ctypes.c_int
    lib.gc_len.argtypes = [p]
    lib.gc_len.restype = i64
    lib.gc_contains.argtypes = [p, p, i64, p]
    lib.gc_contains.restype = None
    lib.gc_snapshot.argtypes = [p, p, p, i64]
    lib.gc_snapshot.restype = i64
    lib.gc_clear.argtypes = [p]
    lib.gc_clear.restype = ctypes.c_int
    lib.gs_update.argtypes = [i64] + [p] * 10 + [i64, i64] + [p] * 6
    lib.gs_update.restype = i64
    lib.gs_admit_merge.argtypes = [i64] + [p] * 6 + [p, p, p, i64, i64]
    lib.gs_admit_merge.restype = None
    lib.gs_admit_level.argtypes = [i64] + [p] * 6 + [p, p, i64, i64]
    lib.gs_admit_level.restype = None
    lib.gt_new.argtypes = [i64]
    lib.gt_new.restype = p
    lib.gt_free.argtypes = [p]
    lib.gt_free.restype = None
    lib.gt_len.argtypes = [p]
    lib.gt_len.restype = i64
    lib.gt_lookup.argtypes = [p, p, i64, p]
    lib.gt_lookup.restype = i64
    lib.gt_note.argtypes = [p, p, p, i64]
    lib.gt_note.restype = None
    lib.gt_fold.argtypes = [p, p, i64, p, p, p, i64]
    lib.gt_fold.restype = None
    lib.gt_fold_idx.argtypes = [p, i64, p, p, p, i64]
    lib.gt_fold_idx.restype = None
    lib.gt_tenant_set.argtypes = [p, buf, i64, i64]
    lib.gt_tenant_set.restype = None
    lib.gt_wire_learn.argtypes = [p, buf, i64, buf, i64, p, p, i64]
    lib.gt_wire_learn.restype = i64
    lib.gt_wire_learn_many.argtypes = [p, p, p, i64, buf, i64, p, p, i64,
                                       p]
    lib.gt_wire_learn_many.restype = i64
    return lib


def load_wire_library() -> ctypes.CDLL:
    """The host library, built from csrc/wire.cpp, csrc/cold.cpp,
    csrc/sketch.cpp and csrc/tenants.cpp with the host C++ compiler if it
    is missing or stale.  Raises when it cannot be built: neither the
    wire lane, the key hashing, the native cold store, the sketch's fold
    nor the tenant attribution has a substitute."""
    global _wire_lib
    if _wire_lib is not None:
        return _wire_lib
    with _mu:
        if _wire_lib is not None:
            return _wire_lib
        cxx = cxx_path()
        lib_path = BUILD_DIR / WIRE_LIB_NAME
        _build_once(lib_path, BUILD_DIR / "wire.sha256",
                    _digest(_host_sources(),
                            [cxx] + CXX_FLAGS + _py_include()),
                    lambda: _compile_wire(cxx, lib_path))
        _wire_lib = _bind_wire(ctypes.CDLL(str(lib_path)))
        return _wire_lib


def load_wire_pylib() -> ctypes.PyDLL:
    """The host library's entry points that take Python objects
    (``gw_hash_keys``, ``gw_hash_pairs``, ``gt_learn_objects``) or must
    not release the GIL (``gt_peek``, a serving thread's tenant hint: a
    thread that releases it may wait a switch interval to get it back),
    bound through ``ctypes.PyDLL``:
    the GIL stays held and a Python exception they set is raised."""
    global _wire_pylib
    if _wire_pylib is not None:
        return _wire_pylib
    load_wire_library()  # builds it if needed
    with _mu:
        if _wire_pylib is None:
            lib = ctypes.PyDLL(str(BUILD_DIR / WIRE_LIB_NAME))
            obj, p = ctypes.py_object, ctypes.c_void_p
            i64, c_int = ctypes.c_int64, ctypes.c_int
            lib.gw_hash_keys.argtypes = [obj, p, i64, c_int]
            lib.gw_hash_keys.restype = i64
            lib.gw_hash_pairs.argtypes = [obj, obj, p, i64, c_int]
            lib.gw_hash_pairs.restype = i64
            lib.gt_learn_objects.argtypes = [p, obj, p, i64,
                                             ctypes.c_char_p, i64, p, i64]
            lib.gt_learn_objects.restype = i64
            lib.gt_peek.argtypes = [p, ctypes.c_uint64]
            lib.gt_peek.restype = i64
            _wire_pylib = lib
        return _wire_pylib
