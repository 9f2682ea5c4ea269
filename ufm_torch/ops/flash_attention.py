"""Flash attention: the Hopper kernels and their plain PyTorch versions.

:func:`flash_attention` launches the hand-written CUDA forward
(``ufm_torch/csrc/flash_attention_fwd.cu``), the port of
``ufm_tpu/ops/flash_attention.py``'s Pallas forward. When grad is enabled and
an input requires grad it goes through :class:`FlashAttentionFunction`, whose
forward also writes each row's log-sum-exp and whose backward launches the
hand-written CUDA backward (``ufm_torch/csrc/flash_attention_bwd.cu``), the
port of the Pallas ``_flash_attention_bwd_impl``. Both take CUDA tensors only
and raise on anything the kernels do not take; they never fall back to
:func:`attention_reference` / :func:`attention_backward_reference`, the plain
versions of the same functions, which the CPU path and the kernel checks use.

Inputs are (B, S, H, D) like the JAX package. q, k and v may be strided views
(the fused qkv projection, reshaped (B, S, 3, H, D)): the kernels read them
in place through TMA tensor maps, which need D contiguous, a 16-byte aligned
base and the other strides multiples of 16 bytes (:func:`tma_layout_error`).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from ufm_torch.ops import _build

__all__ = [
    "flash_attention",
    "flash_attention_forward",
    "flash_attention_backward",
    "FlashAttentionFunction",
    "attention_reference",
    "attention_backward_reference",
    "LAUNCHES",
    "BWD_LAUNCHES",
    "HEAD_DIM",
    "tma_layout_error",
]

HEAD_DIM = 64  # the kernels' only head_dim (the main path's)

# forward kernel launches since the count was last reset (``LAUNCHES = 0``)
LAUNCHES = 0
# backward calls since the count was last reset (``BWD_LAUNCHES = 0``); each
# call runs two CUDA kernels in order: delta, then one grid of dK/dV and dQ
# blocks
BWD_LAUNCHES = 0

_fwd_fn = None
_bwd_fn = None


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain softmax attention over (B, S, H, D): logits in the input dtype
    times ``scale``, softmax in fp32, weights cast back, then times v (the math
    of ``ufm_tpu/ops/attention.py::_xla_attention``)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    weights = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def attention_backward_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor, scale: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain attention gradient (dq, dk, dv) for the output gradient ``g``:
    the math of ``ufm_tpu/ops/flash_attention.py::_xla_attention_bwd`` (logits
    in the input dtype, then fp32 einsums throughout, each gradient cast back
    to its input's dtype)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    p = torch.softmax(logits, dim=-1)
    g32, v32 = g.float(), v.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p, g32)
    dp = torch.einsum("bqhd,bkhd->bhqk", g32, v32)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _fwd_kernel():
    global _fwd_fn
    if _fwd_fn is None:
        fn = _build.load_library("flash_attention_fwd").ufm_flash_attention_fwd_bf16
        fn.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 12
            + [ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _fwd_fn = fn
    return _fwd_fn


def _bwd_kernel():
    global _bwd_fn
    if _bwd_fn is None:
        fn = _build.load_library("flash_attention_bwd").ufm_flash_attention_bwd_bf16
        fn.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 24
            + [ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _bwd_fn = fn
    return _bwd_fn


def _check_tensor(name: str, t: torch.Tensor) -> None:
    if not t.is_cuda:
        raise ValueError(
            f"flash_attention runs only on CUDA tensors ({name} is on {t.device}); "
            "the plain version is dot_product_attention(..., impl='torch')"
        )
    if t.dtype != torch.bfloat16:
        raise ValueError(f"flash_attention takes bfloat16, got {name}.dtype={t.dtype}")
    if t.dim() != 4 or t.shape[-1] != HEAD_DIM:
        raise ValueError(f"flash_attention takes (B, S, H, {HEAD_DIM}) tensors, got {name}.shape={tuple(t.shape)}")
    why = _layout_error(t)
    if why is not None:
        raise ValueError(f"flash_attention cannot read {name} in place: {why}")


# TMA's limits on a tensor map: global strides below 2^40 bytes, coordinates
# (int32) below 2^31
_TMA_MAX_STRIDE_BYTES = 1 << 40
_TMA_MAX_DIM = 1 << 31


def tma_layout_error(
    shape: Sequence[int], strides: Sequence[int], data_ptr: int, itemsize: int
) -> Optional[str]:
    """Why the kernels' rank-4 TMA tensor map cannot cover a (B, S, H, D)
    view with these element strides, base address and item size, or None
    when it can: D contiguous, the base 16-byte aligned, and the B, S and H
    strides positive multiples of 16 bytes below 2^40 (a dimension of size 1
    is never stepped, so its stride is free; the C side replaces it)."""
    if len(shape) != 4 or len(strides) != 4:
        return f"expected a rank-4 (B, S, H, D) view, got shape {tuple(shape)}"
    if strides[-1] != 1:
        return f"the head dim is not contiguous (strides {tuple(strides)})"
    if data_ptr % 16:
        return f"the base address is not 16-byte aligned (offset {data_ptr % 16})"
    for dim, (n, st) in zip("BSH", zip(shape[:3], strides[:3])):
        if n >= _TMA_MAX_DIM:
            return f"{dim} = {n} exceeds TMA's coordinate range"
        nbytes = st * itemsize
        if n > 1 and (nbytes <= 0 or nbytes % 16 or nbytes >= _TMA_MAX_STRIDE_BYTES):
            return f"the {dim} stride is {nbytes} bytes, not a positive multiple of 16 below 2^40"
    return None


def _layout_error(t: torch.Tensor) -> Optional[str]:
    return tma_layout_error(tuple(t.shape), t.stride(), t.data_ptr(), t.element_size())


def _launch_error(what: str, err: int, q: torch.Tensor, k: torch.Tensor) -> RuntimeError:
    # the C entry points return a cudaError_t, or 10000 (no cuTensorMapEncodeTiled
    # in the driver) / 20000 + the CUresult of a refused tensor map
    if err >= 20000:
        cause = f"cuTensorMapEncodeTiled refused a tensor map (CUresult {err - 20000})"
    elif err >= 10000:
        cause = "the CUDA driver has no cuTensorMapEncodeTiled"
    else:
        cause = f"cudaError {err}"
    return RuntimeError(f"{what} failed: {cause} at q {tuple(q.shape)}, k {tuple(k.shape)}")


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_tensor(name, t)
    if k.shape != v.shape or q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if k.shape[1] == 0:
        raise ValueError("flash_attention needs at least one key")


def flash_attention_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, with_lse: bool = False
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One forward launch: (out (B, Sq, H, 64) bf16, lse (B, H, Sq) fp32 or
    None). ``lse`` is each row's natural-log log-sum-exp of the scaled scores,
    written only when ``with_lse`` (the training forward); inference passes a
    null pointer and launches the kernel instance without it."""
    global LAUNCHES
    _check(q, k, v)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) if with_lse else None
    if sq == 0:
        return out, lse
    fn = _fwd_kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None if lse is None else lse.data_ptr(),
            b, h, sq, sk,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            float(scale), stream,
        )
        LAUNCHES += 1
    if err != 0:
        raise _launch_error("flash_attention kernel launch", err, q, k)
    return out, lse


def flash_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    g: torch.Tensor,
    scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One backward call (two CUDA kernels: delta, then dK/dV and dQ): (dq, dk, dv),
    fresh contiguous (B, S, H, 64) bf16 tensors, from the forward's inputs,
    output and ``lse`` and the output gradient ``g``. ``g`` is read through
    its strides; one whose rows the kernel cannot read in place (a
    non-contiguous head dim, unaligned rows) is copied to a contiguous tensor
    first."""
    global BWD_LAUNCHES
    _check(q, k, v)
    if _layout_error(g) is not None:
        g = g.contiguous()
    for name, t in (("out", out), ("g", g)):
        _check_tensor(name, t)
        if t.shape != q.shape:
            raise ValueError(f"{name}.shape={tuple(t.shape)} != q.shape={tuple(q.shape)}")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if lse.dtype != torch.float32 or lse.shape != (b, h, sq) or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous float32 {(b, h, sq)} tensor, got {lse.dtype} {tuple(lse.shape)}")
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, sk, h, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, sk, h, d), dtype=v.dtype, device=q.device)
    if sq == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)  # scratch
    fn = _bwd_kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), g.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, h, sq, sk,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3], *g.stride()[:3],
            *dq.stride()[:3], *dk.stride()[:3], *dv.stride()[:3],
            float(scale), stream,
        )
        BWD_LAUNCHES += 1
    if err != 0:
        raise _launch_error("flash_attention backward launch", err, q, k)
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention with a kernel backward (the port of the JAX package's
    ``jax.custom_vjp`` around the Pallas forward and backward). The forward
    saves q, k, v, the output and the row log-sum-exp; the backward is one
    :func:`flash_attention_backward` call."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = flash_attention_forward(q, k, v, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, lse, g, ctx.scale)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: Optional[float] = None) -> torch.Tensor:
    """Softmax attention on the card: q (B, Sq, H, 64), k/v (B, Sk, H, 64)
    bf16 -> (B, Sq, H, 64) bf16, a fresh contiguous tensor. With grad enabled
    and an input that requires grad, the output carries the kernel backward
    (:class:`FlashAttentionFunction`); otherwise it is one plain forward
    launch."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFunction.apply(q, k, v, float(scale))
    return flash_attention_forward(q, k, v, scale)[0]
