"""The MLP's ``fc1`` product with the bf16 exact GELU as its epilogue: the
Hopper kernel and its plain PyTorch version.

The backbone MLP is ``fc1 -> GELU -> fc2`` (``ufm_tpu/nn/layers.py::Mlp``,
with ``ufm_tpu/ops/gelu.py::fast_exact_gelu`` as the activation). On the card
the GELU runs in the epilogue of ``fc1``'s product, so the hidden activation
is written once, already activated:

    h = bf16(x @ W.T + b)     (fp32 accumulation, rounded once)
    y = gelu_bf16(h)          (the JAX package's bits for every finite h)

- :func:`linear_gelu_reference` is the plain version,
  ``fast_exact_gelu_reference(F.linear(x, w, b))`` on any device: the CPU
  implementation of the dispatcher op ``ufm_torch::linear_gelu_bf16``
  (:mod:`ufm_torch.ops.library`), bit for bit what the port's MLP computed
  with the two ops, and what the checks use.
- :func:`launch` is the op's CUDA implementation: one launch of
  ``ufm_torch/csrc/linear_gelu_bf16_fwd.cu``. It raises on anything the
  kernel does not take and never falls back to the plain version.
- :func:`linear_gelu_bf16` calls the op; the device of the tensors picks the
  implementation.

Training runs the same launch with ``h`` written beside ``y``
(:func:`launch_preact`, the op ``ufm_torch::linear_gelu_bf16_preact``, plain
version :func:`linear_gelu_preact_reference`): the op's gradient reads ``h``
(:mod:`ufm_torch.ops.library`).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from ufm_torch.ops import _build
from ufm_torch.ops.gelu import fast_exact_gelu_reference

__all__ = [
    "linear_gelu_reference", "linear_gelu_preact_reference", "launch", "launch_preact", "linear_gelu_bf16",
    "SCHEDULES", "LAUNCHES",
]

# kernel launches since the count was last reset (``LAUNCHES = 0``)
LAUNCHES = 0

# the kernel's schedules (csrc/linear_gelu_bf16_fwd.cu): "pingpong" is the
# op's; the others exist to be timed beside it
SCHEDULES = {"pingpong": 0, "serial": 1, "cooperative": 2}

_fn = None


def linear_gelu_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version: ``F.linear`` then the bf16 GELU's plain chain, on
    bf16 ``x`` (..., K), ``w`` (N, K) and ``b`` (N,) on any device."""
    _check(x, w, b)
    return fast_exact_gelu_reference(F.linear(x, w, b))


def linear_gelu_preact_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """The plain version of the training launch: ``(y, h)`` with ``h =
    F.linear(x, w, b)`` (bf16) and ``y`` the bf16 GELU's plain chain of it."""
    _check(x, w, b)
    h = F.linear(x, w, b)
    return fast_exact_gelu_reference(h), h


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> None:
    for name, t in (("x", x), ("w", w), ("b", b)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"linear_gelu_bf16 takes bfloat16, got {name} {t.dtype}")
    if x.dim() < 1 or w.dim() != 2 or b.dim() != 1 or x.shape[-1] != w.shape[1] or b.shape[0] != w.shape[0]:
        raise ValueError(
            f"linear_gelu_bf16 takes x (..., K), w (N, K) and b (N,), got x {tuple(x.shape)}, "
            f"w {tuple(w.shape)}, b {tuple(b.shape)}"
        )


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load_library("linear_gelu_bf16_fwd").ufm_linear_gelu_bf16_fwd
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def launch(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, preact_out: Optional[torch.Tensor] = None,
           schedule: str = "pingpong") -> torch.Tensor:
    """The op's CUDA implementation, one kernel launch: bf16 CUDA ``x``
    (..., K), ``w`` (N, K) and ``b`` (N,) -> a fresh contiguous (..., N)
    tensor. ``w`` and ``b`` must be contiguous (a parameter is); a
    non-contiguous ``x`` is read through a contiguous copy. K and N must be
    multiples of 8 and every base address 16-byte aligned (TMA's
    conditions). ``preact_out``, a contiguous bf16 tensor of the output's
    shape, also receives the rounded pre-activation ``h`` (the training
    launch, :func:`launch_preact`). An empty ``x`` launches nothing."""
    global LAUNCHES
    for name, t in (("x", x), ("w", w), ("b", b)):
        if not t.is_cuda:
            raise ValueError(
                f"the linear + GELU kernel runs only on CUDA tensors ({name} is on {t.device}); "
                "the plain version is linear_gelu_reference"
            )
    _check(x, w, b)
    if w.device != x.device or b.device != x.device:
        raise ValueError(f"x, w and b must share a device, got {x.device}, {w.device}, {b.device}")
    n, k = w.shape
    if k % 8 or n % 8:
        raise ValueError(f"the linear + GELU kernel takes K and N multiples of 8, got K={k}, N={n}")
    if not (w.is_contiguous() and b.is_contiguous()):
        raise ValueError("the linear + GELU kernel takes a contiguous w and b")
    x2 = x.reshape(-1, k).contiguous()
    m = x2.shape[0]
    out = torch.empty((*x.shape[:-1], n), dtype=torch.bfloat16, device=x.device)
    pre_ptr = None
    if preact_out is not None:
        if preact_out.dtype != torch.bfloat16 or preact_out.shape != out.shape or not preact_out.is_contiguous() \
                or preact_out.device != x.device:
            raise ValueError(f"preact_out must be a contiguous bf16 {tuple(out.shape)} tensor on {x.device}")
        pre_ptr = preact_out.data_ptr()
    if m >= 2**31:
        raise ValueError(f"the linear + GELU kernel takes fewer than 2^31 rows, got {m}")
    for name, t in (("x", x2), ("w", w), ("b", b), ("preact_out", preact_out)):
        if t is not None and t.numel() and t.data_ptr() % 16:
            raise ValueError(f"the linear + GELU kernel needs 16-byte aligned operands ({name} is not)")
    if m == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(x.device):
        err = fn(x2.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), pre_ptr, m, n, k, SCHEDULES[schedule],
                 torch.cuda.current_stream(x.device).cuda_stream)
        LAUNCHES += 1
    if err != 0:
        raise RuntimeError(f"linear + GELU kernel launch failed: {_build.launch_error_cause(err)} at "
                           f"M={m}, N={n}, K={k}")
    return out


def launch_preact(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """The training launch: :func:`launch` with a fresh ``h`` as its
    ``preact_out``; returns ``(y, h)``."""
    h = torch.empty((*x.shape[:-1], w.shape[0]), dtype=torch.bfloat16, device=x.device)
    return launch(x, w, b, preact_out=h), h


def linear_gelu_bf16(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``gelu_bf16(F.linear(x, w, b))`` through the op
    ``ufm_torch::linear_gelu_bf16``: the fused kernel for CUDA tensors, the
    plain version for CPU tensors. Refuses any dtype but bfloat16."""
    _check(x, w, b)
    return torch.ops.ufm_torch.linear_gelu_bf16.default(x, w, b)
