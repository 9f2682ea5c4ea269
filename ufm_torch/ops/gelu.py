"""Exact GELU on bf16: the Hopper kernel and its plain PyTorch version.

The counterpart of ``ufm_tpu/ops/gelu.py``. The backbone's MLP activation is
``jax.nn.gelu(approximate=False)``, which on bf16 is the op-for-op chain

    bf16(bf16(0.5 x) * bf16(erfc(bf16(-x * bf16(sqrt(0.5))))))

and the JAX package evaluates it in one pass, with a cheap polynomial erfc
(:func:`fast_erfc_f32`) whose bf16 rounding is ``lax.erfc``'s on every finite
bf16 input. On the CPU, XLA also flushes every fp32 operand and result below
the smallest normal (2^-126) to a zero of the same sign; PyTorch keeps them.
Both versions here flush where XLA does, so on every finite bf16 input they
give the JAX package's bits (``tests/golden/gelu_bf16_table.npz`` holds its
output over all 65,536 bf16 bit patterns).

- :func:`fast_exact_gelu_reference` is the plain version: the chain above in
  separate PyTorch ops, with the flushes. It is the CPU implementation of the
  dispatcher op ``ufm_torch::gelu_bf16`` (:mod:`ufm_torch.ops.library`) and
  what the checks use.
- :func:`launch` is the op's CUDA implementation: one launch of
  ``ufm_torch/csrc/gelu_bf16_fwd.cu``, which computes the same function in
  registers (one read of x, one write of the result; its Horner steps are
  fused multiply-adds where the plain version rounds each product, which
  moves no bf16 result). It raises on anything the kernel does not take and
  never falls back to the plain version.
- :func:`gelu_bf16` calls the op; the device of the tensor picks the
  implementation.

The op's gradient is one ``aten.gelu_backward(grad, x, approximate="none")``
on the saved input: the exact derivative in fp32, rounded once.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ufm_torch.ops import _build

__all__ = [
    "fast_erfc_f32",
    "fast_exact_gelu_reference",
    "launch",
    "gelu_bf16",
    "LAUNCHES",
]

# kernel launches since the count was last reset (``LAUNCHES = 0``)
LAUNCHES = 0

# the constants of ufm_tpu/ops/gelu.py, rounded to fp32 as jnp.float32 rounds
# them: erf(t) ~= t * P(t^2) on |t| <= 2.08 (_MAIN); erfc(t) * exp(t^2) ~=
# (1/t) * Q(1/t) on t in [2.0, 9.45] (_TAIL)
_MAIN = tuple(float(np.float32(c)) for c in (
    1.1283790340269568,
    -0.37612158492502534,
    0.11280848820744023,
    -0.026795094373444406,
    0.00513593435833268,
    -0.0007917506866845558,
    9.279795205957126e-05,
    -7.212098793187407e-06,
    2.7061106485692593e-07,
))
_TAIL = tuple(float(np.float32(c)) for c in (
    0.5640888375906445,
    0.00260326249353484,
    -0.3077097789312337,
    0.11669566632991554,
    0.2176132143140603,
    -0.1875587612113739,
))
_LOG2E = float(np.float32(1.4426950408889634))
# erfc(t) rounds to exactly 2.0 in bf16 for t <= -_SAT; the main / tail split
# on the positive side
_SAT = 2.046875
# |t| is clamped here before squaring (past it the tail's exp2 is 0 either way)
_CLAMP = 32.0
# sqrt(0.5) rounded to bf16 (1.0110101b x 2^-1): jax.nn.gelu rounds the
# constant to the input dtype first
_SQRT_HALF_BF16 = 0.70703125
# fp32 values below this in magnitude are subnormal: XLA's CPU flushes them
_SMALLEST_NORMAL = 2.0**-126

_fn = None


def _flush(t: torch.Tensor) -> torch.Tensor:
    """``t`` with its subnormal values replaced by a zero of the same sign."""
    return torch.where(t.abs() < _SMALLEST_NORMAL, t * 0.0, t)


def fast_erfc_f32(t: torch.Tensor) -> torch.Tensor:
    """fp32 erfc of fp32 ``t`` by the JAX package's polynomial (main range
    and tail, the same constants, the same clamp), with the tail's products
    flushed where XLA flushes them: its bf16 rounding is the JAX package's
    ``fast_erfc_f32`` on every bf16 value."""
    ta = torch.clamp(t.abs(), max=_CLAMP)
    u = ta * ta
    p = torch.full_like(u, _MAIN[-1])
    for c in _MAIN[-2::-1]:
        p = p * u + c
    main = 1.0 - t * p

    in_tail = t > _SAT
    inv = torch.rsqrt(torch.where(in_tail, u, 1.0))  # 1 where unselected: no inf
    q = torch.full_like(u, _TAIL[-1])
    for c in _TAIL[-2::-1]:
        q = q * inv + c
    tail = _flush(_flush(_flush(torch.exp2(u * -_LOG2E)) * inv) * q)

    out = torch.where(in_tail, tail, main)
    return torch.where(t <= -_SAT, 2.0, out)


def fast_exact_gelu_reference(x: torch.Tensor) -> torch.Tensor:
    """The plain version: the chain of the module docstring in separate
    PyTorch ops on bf16 ``x`` (any device, any layout), each fp32 result
    flushed as XLA flushes it and rounded to bf16. Slow on purpose: it
    spells out every rounding the kernel makes in registers."""
    if x.dtype != torch.bfloat16:
        raise ValueError(f"the bf16 GELU takes bfloat16, got {x.dtype}")
    xf = x.float()
    h = _flush(xf * 0.5).to(torch.bfloat16)
    t = _flush(xf * -_SQRT_HALF_BF16).to(torch.bfloat16)
    e = fast_erfc_f32(t.float()).to(torch.bfloat16)
    return _flush(h.float() * e.float()).to(torch.bfloat16)


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load_library("gelu_bf16_fwd").ufm_gelu_bf16_fwd
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def launch(x: torch.Tensor) -> torch.Tensor:
    """The op's CUDA implementation, one kernel launch: bf16 CUDA ``x`` ->
    a fresh contiguous tensor of its shape. A non-contiguous ``x`` is read
    through a contiguous copy (one more kernel: the MLPs' hidden activation
    is contiguous); a base address that is not 16-byte aligned takes the
    kernel's scalar path; an empty tensor launches nothing."""
    global LAUNCHES
    if not x.is_cuda:
        raise ValueError(
            f"the bf16 GELU kernel runs only on CUDA tensors (x is on {x.device}); "
            "the plain version is fast_exact_gelu_reference"
        )
    if x.dtype != torch.bfloat16:
        raise ValueError(f"the bf16 GELU kernel takes bfloat16, got {x.dtype}; other dtypes take F.gelu")
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), out.data_ptr(), x.numel(), torch.cuda.current_stream(x.device).cuda_stream)
        LAUNCHES += 1
    if err != 0:
        raise RuntimeError(f"bf16 GELU kernel launch failed: {_build.launch_error_cause(err)} at {tuple(x.shape)}")
    return out


def gelu_bf16(x: torch.Tensor) -> torch.Tensor:
    """The JAX package's bf16 exact GELU of ``x`` through the op
    ``ufm_torch::gelu_bf16``: the kernel for a CUDA tensor, the plain version
    for a CPU tensor. Refuses any dtype but bfloat16."""
    if x.dtype != torch.bfloat16:
        raise ValueError(f"gelu_bf16 takes bfloat16, got {x.dtype}; other dtypes take F.gelu")
    return torch.ops.ufm_torch.gelu_bf16.default(x)
