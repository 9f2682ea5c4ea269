"""Exact GELU on bf16 and its gradient: the Hopper kernels and their plain
PyTorch versions.

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

The gradient is the JAX package's, bit for bit: ``jax.vjp`` of
``fast_exact_gelu`` as XLA's CPU runs it (``tests/golden/gelu_bf16_vjp_table.npz``
holds it over every bf16 input under unit and seeded normal cotangents).
:func:`fast_exact_gelu_vjp_reference` is its plain version and the CPU
implementation of the op ``ufm_torch::gelu_bf16_bwd``;
:func:`launch_backward` its CUDA implementation, one launch of
``ufm_torch/csrc/gelu_bf16_bwd.cu`` (read g and x, write dx);
:func:`gelu_bf16_bwd` calls the op.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ufm_torch.ops import _build

__all__ = [
    "fast_erfc_f32",
    "fast_exact_gelu_reference",
    "fast_exact_gelu_vjp_reference",
    "launch",
    "launch_backward",
    "gelu_bf16",
    "gelu_bf16_bwd",
    "LAUNCHES",
    "BWD_LAUNCHES",
]

# kernel launches since the count was last reset (``LAUNCHES = 0``): the
# forward's and the gradient's
LAUNCHES = 0
BWD_LAUNCHES = 0

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
# log(2) rounded to fp32: the VJP's exp2'(v) = log(2) exp2(v)
_LN2 = float(np.float32(np.log(2.0)))

_fn = None
_bwd_fn = None


def _flush(t: torch.Tensor) -> torch.Tensor:
    """``t`` with its subnormal values replaced by a zero of the same sign."""
    return torch.where(t.abs() < _SMALLEST_NORMAL, t * 0.0, t)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """fp32 ``a * b + c`` rounded once, as a fused multiply-add rounds it,
    then flushed. The product is exact in fp64; the fp64 sum is rounded to
    odd (its last bit set where it was inexact, from the sum's exact error)
    so that its rounding to fp32 is the exact sum's."""
    prod = a.double() * b
    c = torch.as_tensor(c, dtype=torch.float64, device=a.device)
    s = prod + c
    back = s - prod
    err = (prod - (s - back)) + (c - back)
    to_odd = (err != 0) & torch.isfinite(err) & (s.view(torch.int64) & 1 == 0)
    s = torch.where(to_odd, torch.nextafter(s, torch.where(err > 0, torch.inf, -torch.inf).double()), s)
    return _flush(s.float())


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


def fast_exact_gelu_vjp_reference(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The plain version of the GELU's gradient: ``jax.vjp`` of the JAX
    package's ``fast_exact_gelu`` at bf16 ``x``, applied to the bf16
    cotangent ``g`` (any device, any layout, one shape), as bf16.

    JAX has no rule of its own for the GELU: its VJP is the transposed chain
    of the forward, about 60 fp32 ops. This is that chain op by op, in the
    order of the program XLA compiles from its jaxpr, which differs from the
    jaxpr in three places: the recomputed ``t = -x c`` and the cotangent
    ``h g`` of ``erfc`` stay fp32 (XLA drops their bf16 roundings as excess
    precision; both are exact products of two bf16 values), and ``exp2(-u
    log2(e))`` becomes ``exp(-u)`` (``log2(e) log(2)`` folds to 1 in fp32).
    A product with one use and the sum that takes it are one fused
    multiply-add (:func:`_fma`) where XLA's CPU code contracts them (LLVM):
    both Horner loops, ``1 - t P``, the transposed steps' sums and the exp
    term's. Each fp32 result is flushed as XLA's CPU flushes it (subnormal
    operands read as zeros: only ``x`` and ``g`` can be), each bf16 op
    rounded;
    ``clamp``, ``where`` and ``abs`` route their cotangents by JAX's rules
    (half to each side of the tie at ``|t| = 32``, zeros to the unselected
    branches, whose signs reach a zero gradient). ``rsqrt`` and ``exp`` are
    the correctly rounded ones (fp64, then rounded): XLA's CPU evaluates them
    to an ulp, which moves no bf16 gradient of a finite input under unit or
    normal cotangents (``tests/test_torch_port_gelu_vjp.py``), and a kernel
    reproduces the rounded values on any device. Slow on purpose."""
    if x.dtype != torch.bfloat16 or g.dtype != torch.bfloat16:
        raise ValueError(f"the bf16 GELU's gradient takes bfloat16 x and g, got {x.dtype} and {g.dtype}")
    if x.shape != g.shape:
        raise ValueError(f"x {tuple(x.shape)} and g {tuple(g.shape)} must share a shape")

    def bf16(v):
        return v.to(torch.bfloat16).float()

    f = _flush
    xf, gf = f(x.float()), f(g.float())
    # the forward, as the VJP recomputes it
    t = f(-xf * _SQRT_HALF_BF16)
    ta = t.abs()
    tc = torch.clamp(ta, max=_CLAMP)
    u = f(tc * tc)
    ex = f(torch.exp(-u.double()).float())
    in_tail = t > _SAT
    ul = torch.where(in_tail, u, 1.0)
    inv = f((1.0 / torch.sqrt(ul.double())).float())
    ex_inv = f(ex * inv)
    tail_h = [torch.full_like(u, _TAIL[-1])]  # Horner's partial values, the top first
    for c in _TAIL[-2::-1]:
        tail_h.append(_fma(tail_h[-1], inv, c))
    q = tail_h[-1]
    main_h = [torch.full_like(u, _MAIN[-1])]
    for c in _MAIN[-2::-1]:
        main_h.append(_fma(main_h[-1], u, c))
    p = main_h[-1]
    sat = t <= -_SAT
    e = bf16(torch.where(sat, 2.0, torch.where(in_tail, f(ex_inv * q), _fma(-t, p, 1.0))))
    dx_h = bf16(f(bf16(f(gf * e)) * 0.5))
    g_e = torch.where(sat, 0.0, f(bf16(f(xf * 0.5)) * gf))
    g_main = torch.where(in_tail, 0.0, g_e)
    g_tail = torch.where(in_tail, g_e, 0.0)

    # tail = exp(-u) inv Q(inv)
    g_p = -g_main
    g_ex_inv = f(g_tail * q)
    g_q = f(ex_inv * g_tail)
    g_inv = _fma(ex, g_ex_inv, f(tail_h[-2] * g_q))
    for k in range(1, len(_TAIL) - 1):  # Q's Horner steps, transposed
        g_q = f(g_q * inv)
        g_inv = _fma(tail_h[-2 - k], g_q, g_inv)
    g_u = _fma(-f(f(f(g_ex_inv * inv) * _LN2) * ex), _LOG2E,
               torch.where(in_tail, f(g_inv * f(f(inv / ul) * -0.5)), 0.0))
    # main = 1 - t P(u)
    g_t = f(t * g_p)
    for k in range(len(_MAIN) - 1):  # P's Horner steps, transposed
        g_u = _fma(main_h[-2 - k], g_t, g_u)
        g_t = f(g_t * u)
    # u = tc tc, tc = min(|t|, 32): half the cotangent to each side of the tie
    g_tc = f(tc * g_u)
    d_clamp = torch.where(ta == tc, 1.0, 0.0) / torch.where(tc == _CLAMP, 2.0, 1.0)
    g_ta = f(f(g_tc + g_tc) * d_clamp)
    nonneg = t >= 0
    d_t = f(_fma(g_p, p, torch.where(nonneg, g_ta, 0.0)) + -torch.where(nonneg, 0.0, g_ta))
    # t = -x c, then h = 0.5 x's share
    dx_t = -bf16(f(bf16(d_t) * _SQRT_HALF_BF16))
    return f(dx_h + dx_t).to(torch.bfloat16)


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


def _bwd_kernel():
    global _bwd_fn
    if _bwd_fn is None:
        fn = _build.load_library("gelu_bf16_bwd").ufm_gelu_bf16_bwd
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bwd_fn = fn
    return _bwd_fn


def launch_backward(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The gradient op's CUDA implementation, one kernel launch: bf16 CUDA
    cotangent ``g`` and input ``x`` of one shape -> a fresh contiguous dx.
    Non-contiguous operands are read through contiguous copies; base
    addresses that are not all 16-byte aligned take the kernel's scalar
    path; an empty tensor launches nothing."""
    global BWD_LAUNCHES
    for name, t in (("g", g), ("x", x)):
        if not t.is_cuda:
            raise ValueError(
                f"the bf16 GELU gradient kernel runs only on CUDA tensors ({name} is on {t.device}); "
                "the plain version is fast_exact_gelu_vjp_reference"
            )
        if t.dtype != torch.bfloat16:
            raise ValueError(f"the bf16 GELU gradient kernel takes bfloat16, got {name} {t.dtype}")
    if g.shape != x.shape or g.device != x.device:
        raise ValueError(f"g {tuple(g.shape)} on {g.device} and x {tuple(x.shape)} on {x.device} must match")
    g, x = g.contiguous(), x.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    fn = _bwd_kernel()
    with torch.cuda.device(x.device):
        err = fn(g.data_ptr(), x.data_ptr(), out.data_ptr(), x.numel(),
                 torch.cuda.current_stream(x.device).cuda_stream)
        BWD_LAUNCHES += 1
    if err != 0:
        raise RuntimeError(f"bf16 GELU gradient kernel launch failed: {_build.launch_error_cause(err)} "
                           f"at {tuple(x.shape)}")
    return out


def gelu_bf16_bwd(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The JAX package's gradient of the bf16 exact GELU at ``x`` under the
    cotangent ``g`` through the op ``ufm_torch::gelu_bf16_bwd``: the kernel
    for CUDA tensors, the plain version for CPU tensors."""
    if g.dtype != torch.bfloat16 or x.dtype != torch.bfloat16:
        raise ValueError(f"gelu_bf16_bwd takes bfloat16, got g {g.dtype}, x {x.dtype}")
    return torch.ops.ufm_torch.gelu_bf16_bwd.default(g, x)
