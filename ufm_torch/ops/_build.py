"""Build and load the port's CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface. It is
compiled by ``nvcc`` for ``sm_90a`` into a shared library under
``build/ufm_torch/`` at the repository root (git-ignored) the first time it is
needed, and loaded with :mod:`ctypes`. The library's file name carries a hash
of the sources and flags, so an edited source is rebuilt. Nothing here runs at
import time: the CPU tests import every module of the package.
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

__all__ = ["KERNEL_SOURCES", "build", "load_library", "BUILD_LOGS"]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ufm_torch"

# every kernel source of the package, by library name
KERNEL_SOURCES = ("flash_attention_fwd", "flash_attention_bwd", "window_refinement_fwd")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

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


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNEL_SOURCES, force: bool = False) -> List[Path]:
    """Compile every library in ``names`` that is not built yet (with
    ``force``, every one), one ``nvcc`` per source, all started together.
    Raises with nvcc's output on failure."""
    names = list(names)
    paths = [_library_path(n) for n in names]
    todo = [(n, p) for n, p in zip(names, paths) if force or not p.exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name, path in todo:
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs.append((name, path, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures = []
    for name, path, tmp, proc in procs:
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            failures.append(f"nvcc failed building {name}.cu (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for kernel source ``name``, built on first use."""
    with _lock:
        if name not in _loaded:
            (path,) = build([name])
            _loaded[name] = ctypes.CDLL(str(path))
        return _loaded[name]
