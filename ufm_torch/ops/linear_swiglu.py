"""The SwiGLU FFN's ``w12`` product with the gate as its epilogue: the Hopper
kernel and its plain PyTorch version.

DINOv2's ``SwiGLUFFNFused`` (the FFN of ``dinov2_vitg14_reg``) is ``w12 ->
chunk -> silu(x1) * x2 -> w3``. On the card the gate runs in the epilogue of
``w12``'s product, so only the gated hidden activation is written, once:

    h1 = bf16(x @ W1.T + b1)     (fp32 accumulation, rounded once)
    h2 = bf16(x @ W2.T + b2)     (likewise)
    y  = bf16(silu(h1) * h2)     (silu and the product in fp32, rounded once)

where ``W1`` / ``b1`` are the first half of ``w12``'s rows and bias (``x1``)
and ``W2`` / ``b2`` the second (``x2``).

- :func:`linear_swiglu_reference` is the plain version: ``F.linear``, then
  the gate in fp32 on the rounded halves. It is the CPU implementation of the
  dispatcher op ``ufm_torch::linear_swiglu_bf16`` (:mod:`ufm_torch.ops.library`)
  and, bit for bit, what :class:`ufm_torch.nn.layers.SwiGLUFFN` computes
  without the op (its training route).
- :func:`launch` is the op's CUDA implementation: one launch of
  ``ufm_torch/csrc/linear_swiglu_bf16_fwd.cu``. It raises on anything the
  kernel does not take and never falls back to the plain version.
- :func:`linear_swiglu_bf16` calls the op; the device of the tensors picks the
  implementation.

The op has no gradient: the FFN takes it only where none is recorded
(inference), and the plain composition under grad mode.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ufm_torch.ops import _build

__all__ = ["linear_swiglu_reference", "launch", "linear_swiglu_bf16", "LAUNCHES"]

# kernel launches since the count was last reset (``LAUNCHES = 0``)
LAUNCHES = 0

_fn = None


def _check(x: torch.Tensor, w12: torch.Tensor, b12: torch.Tensor) -> None:
    for name, t in (("x", x), ("w12", w12), ("b12", b12)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"linear_swiglu_bf16 takes bfloat16, got {name} {t.dtype}")
    if x.dim() < 1 or w12.dim() != 2 or b12.dim() != 1 or x.shape[-1] != w12.shape[1] \
            or b12.shape[0] != w12.shape[0] or w12.shape[0] % 2:
        raise ValueError(
            f"linear_swiglu_bf16 takes x (..., K), w12 (2H, K) and b12 (2H,), got x {tuple(x.shape)}, "
            f"w12 {tuple(w12.shape)}, b12 {tuple(b12.shape)}"
        )


def linear_swiglu_reference(x: torch.Tensor, w12: torch.Tensor, b12: torch.Tensor) -> torch.Tensor:
    """The plain version on bf16 ``x`` (..., K), ``w12`` (2H, K) and ``b12``
    (2H,) on any device: ``h1, h2 = F.linear(x, w12, b12).chunk(2)``, then
    ``bf16(silu(float(h1)) * float(h2))``, (..., H)."""
    _check(x, w12, b12)
    h1, h2 = F.linear(x, w12, b12).chunk(2, dim=-1)
    return (F.silu(h1.float()) * h2.float()).to(torch.bfloat16)


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load_library("linear_swiglu_bf16_fwd").ufm_linear_swiglu_bf16_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def launch(x: torch.Tensor, w12: torch.Tensor, b12: torch.Tensor) -> torch.Tensor:
    """The op's CUDA implementation, one kernel launch: bf16 CUDA ``x``
    (..., K), ``w12`` (2H, K) and ``b12`` (2H,) -> a fresh contiguous (..., H)
    tensor. ``w12`` and ``b12`` must be contiguous (a parameter is); a
    non-contiguous ``x`` is read through a contiguous copy. K and H must be
    multiples of 8 and every base address 16-byte aligned (TMA's
    conditions), fewer than 2^31 rows. An empty ``x`` launches nothing."""
    global LAUNCHES
    for name, t in (("x", x), ("w12", w12), ("b12", b12)):
        if not t.is_cuda:
            raise ValueError(
                f"the linear + SwiGLU kernel runs only on CUDA tensors ({name} is on {t.device}); "
                "the plain version is linear_swiglu_reference"
            )
    _check(x, w12, b12)
    if w12.device != x.device or b12.device != x.device:
        raise ValueError(f"x, w12 and b12 must share a device, got {x.device}, {w12.device}, {b12.device}")
    n2, k = w12.shape
    hidden = n2 // 2
    if k % 8 or hidden % 8:
        raise ValueError(f"the linear + SwiGLU kernel takes K and H multiples of 8, got K={k}, H={hidden}")
    if not (w12.is_contiguous() and b12.is_contiguous()):
        raise ValueError("the linear + SwiGLU kernel takes a contiguous w12 and b12")
    x2 = x.reshape(-1, k).contiguous()
    m = x2.shape[0]
    if m >= 2**31:
        raise ValueError(f"the linear + SwiGLU kernel takes fewer than 2^31 rows, got {m}")
    out = torch.empty((*x.shape[:-1], hidden), dtype=torch.bfloat16, device=x.device)
    for name, t in (("x", x2), ("w12", w12), ("b12", b12)):
        if t.numel() and t.data_ptr() % 16:
            raise ValueError(f"the linear + SwiGLU kernel needs 16-byte aligned operands ({name} is not)")
    if m == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(x.device):
        err = fn(x2.data_ptr(), w12.data_ptr(), b12.data_ptr(), out.data_ptr(), m, hidden, k,
                 torch.cuda.current_stream(x.device).cuda_stream)
        LAUNCHES += 1
    if err != 0:
        raise RuntimeError(f"linear + SwiGLU kernel launch failed: {_build.launch_error_cause(err)} at "
                           f"M={m}, H={hidden}, K={k}")
    return out


def linear_swiglu_bf16(x: torch.Tensor, w12: torch.Tensor, b12: torch.Tensor) -> torch.Tensor:
    """``silu(x1) * x2`` of ``F.linear(x, w12, b12)``'s halves, rounded once,
    through the op ``ufm_torch::linear_swiglu_bf16``: the fused kernel for
    CUDA tensors, the plain version for CPU tensors. Refuses any dtype but
    bfloat16."""
    _check(x, w12, b12)
    return torch.ops.ufm_torch.linear_swiglu_bf16.default(x, w12, b12)
