"""Flash-attention forward: the Hopper kernel and its plain PyTorch version.

:func:`flash_attention` launches the hand-written CUDA kernel
(``ufm_torch/csrc/flash_attention_fwd.cu``), the port of
``ufm_tpu/ops/flash_attention.py``'s Pallas forward. It takes CUDA tensors
only and raises on anything the kernel does not take; it never falls back to
:func:`attention_reference`, the plain version of the same function, which the
CPU path and the kernel checks use.

Inputs are (B, S, H, D) like the JAX package. q, k and v may be strided views
(the fused qkv projection, reshaped (B, S, 3, H, D)); only D must be
contiguous.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ufm_torch.ops import _build

__all__ = ["flash_attention", "attention_reference", "LAUNCHES", "HEAD_DIM"]

HEAD_DIM = 64  # the kernel's only head_dim (the main path's)

# kernel launches since the count was last reset (``LAUNCHES = 0``)
LAUNCHES = 0

_fn = None


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain softmax attention over (B, S, H, D): logits in the input dtype
    times ``scale``, softmax in fp32, weights cast back, then times v (the math
    of ``ufm_tpu/ops/attention.py::_xla_attention``)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    weights = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load_library("flash_attention_fwd").ufm_flash_attention_fwd_bf16
        fn.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 12
            + [ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(
                f"flash_attention runs only on CUDA tensors ({name} is on {t.device}); "
                "the plain version is dot_product_attention(..., impl='torch')"
            )
        if t.dtype != torch.bfloat16:
            raise ValueError(f"flash_attention takes bfloat16, got {name}.dtype={t.dtype}")
        if t.dim() != 4 or t.shape[-1] != HEAD_DIM:
            raise ValueError(f"flash_attention takes (B, S, H, {HEAD_DIM}) tensors, got {name}.shape={tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention needs a contiguous head dim, got {name}.stride()={t.stride()}")
        # cp.async moves 16-byte chunks: every row must start 16-byte aligned
        if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]):
            raise ValueError(f"flash_attention needs 16-byte aligned rows, got {name}.stride()={t.stride()}")
    if k.shape != v.shape or q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if k.shape[1] == 0:
        raise ValueError("flash_attention needs at least one key")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: Optional[float] = None) -> torch.Tensor:
    """Softmax attention on the card: q (B, Sq, H, 64), k/v (B, Sk, H, 64)
    bf16 -> (B, Sq, H, 64) bf16, a fresh contiguous tensor. Forward only:
    raises when grad is enabled and q, k or v requires grad."""
    global LAUNCHES
    _check(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError(
            "flash_attention has no backward kernel yet (training is not ported, ROADMAP.md): "
            "run the forward under torch.no_grad() or torch.inference_mode(), or use impl='torch'"
        )
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if scale is None:
        scale = d**-0.5
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    if sq == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, sq, sk,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            float(scale), stream,
        )
        LAUNCHES += 1
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err} at q {tuple(q.shape)}, k {tuple(k.shape)}")
    return out
