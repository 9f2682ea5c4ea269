"""Build and load the port's CUDA kernels and its host library.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface. It is
compiled by ``nvcc`` for ``sm_90a`` into a shared library under
``build/ufm_torch/`` at the repository root (git-ignored) the first time it is
needed, and loaded with :mod:`ctypes`. The host libraries, framework-free
C++ (``csrc/host/``: the serving runtime's scheduler ``ufm_runtime.cc`` and
the image loader ``ufm_loader.cc`` with its PNG / JPEG decoders
``image_decode.h``; no system library beyond the C++ runtime), are compiled
the same way by the host C++ compiler (:func:`load_host_library`).
A library's file name carries a hash of the sources, headers and flags, so an
edited source is rebuilt.
Nothing here runs at import time: the CPU tests import every module of the
package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

__all__ = [
    "KERNEL_SOURCES",
    "HOST_SOURCES",
    "build",
    "load_library",
    "load_host_library",
    "launch_error_cause",
    "BUILD_LOGS",
]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ufm_torch"

# every kernel source of the package, by library name
KERNEL_SOURCES = (
    "flash_attention_fwd", "flash_attention_bwd", "window_refinement_fwd", "gelu_bf16_fwd", "linear_gelu_bf16_fwd",
    "flash_attention_fwd_any", "flash_attention_bwd_any", "window_refinement_bwd", "gelu_bf16_bwd",
    "linear_gelu_bf16_bwd", "linear_swiglu_bf16_fwd",
)

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# host libraries (csrc/host/<name>.cc), built by the host C++ compiler
HOST_SOURCES = ("ufm_runtime", "ufm_loader")
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-pthread", "-shared")

# extra flags of one library: at ptxas's default -O3 the window kernel's
# direct path (hoisted global tap loads) takes all 128 registers a thread and
# ptxas spills a few loop-carried values to local memory; at -O1 it uses 118
# and spills nothing (2% slower on a smooth flow, 9% on an iid one, H100;
# PERF.md)
LIBRARY_FLAGS = {"window_refinement_fwd": ("-Xptxas", "-O1")}

# nvcc's output (ptxas register / spill report) for each library built here
BUILD_LOGS: Dict[str, str] = {}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA kernels are "
            "built from source on the machine with the GPU"
        )
    return nvcc


def _cxx() -> str:
    for name in ("c++", "g++"):
        path = shutil.which(name)
        if path:
            return path
    raise RuntimeError(
        "no host C++ compiler (c++ or g++ on PATH): the host libraries "
        "(ufm_torch/csrc/host/*.cc) are built from source at first use"
    )


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LIBRARY_FLAGS.get(name, ())).encode())
    h.update((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _host_library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update((CSRC_DIR / "host" / f"{name}.cc").read_bytes())
    for header in sorted((CSRC_DIR / "host").glob("*.h")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _compile(jobs) -> None:
    """Run each (name, library path, compiler command without ``-o``) at
    once; each library appears whole (renamed into place) or not at all.
    Raises with the compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, path, cmd in jobs:
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
        procs.append((name, path, tmp, subprocess.Popen([*cmd, "-o", str(tmp)], stdout=subprocess.PIPE,
                                                        stderr=subprocess.STDOUT, text=True)))
    failures = []
    for name, path, tmp, proc in procs:
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            failures.append(f"{Path(proc.args[0]).name} failed building {name} (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
    if failures:
        raise RuntimeError("\n".join(failures))


def build(names: Iterable[str] = KERNEL_SOURCES, force: bool = False) -> List[Path]:
    """Compile every library in ``names`` that is not built yet (with
    ``force``, every one), one ``nvcc`` per source, all started together.
    Raises with nvcc's output on failure."""
    names = list(names)
    paths = [_library_path(n) for n in names]
    todo = [(n, p) for n, p in zip(names, paths) if force or not p.exists()]
    if todo:
        nvcc = _nvcc()
        _compile([(n, p, [nvcc, *NVCC_FLAGS, *LIBRARY_FLAGS.get(n, ()), str(CSRC_DIR / f"{n}.cu")]) for n, p in todo])
    return paths


def launch_error_cause(err: int) -> str:
    """What a nonzero return code of a kernel's C entry point means: a
    cudaError_t, or 10000 (no cuTensorMapEncodeTiled in the driver) / 20000 +
    the CUresult of a refused tensor map (the kErr* codes of sm90_async.cuh)."""
    if err >= 20000:
        return f"cuTensorMapEncodeTiled refused a tensor map (CUresult {err - 20000})"
    if err >= 10000:
        return "the CUDA driver has no cuTensorMapEncodeTiled"
    return f"cudaError {err}"


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for kernel source ``name``, built on first use."""
    with _lock:
        if name not in _loaded:
            (path,) = build([name])
            _loaded[name] = ctypes.CDLL(str(path))
        return _loaded[name]


def load_host_library(name: str) -> ctypes.CDLL:
    """The loaded host library ``csrc/host/<name>.cc``, built on first use by
    the host C++ compiler (``-O2 -std=c++17 -fPIC -pthread -shared``; no
    library linked beyond the C++ runtime)."""
    with _lock:
        if name not in _loaded:
            path = _host_library_path(name)
            if not path.exists():
                source = str(CSRC_DIR / "host" / f"{name}.cc")
                _compile([(name, path, [_cxx(), *CXX_FLAGS, source])])
            _loaded[name] = ctypes.CDLL(str(path))
        return _loaded[name]
