"""Multi-head attention dispatch (counterpart of ``ufm_tpu/ops/attention.py``).

Both transformer stacks route their softmax-attention core through
:func:`dot_product_attention`. By default it calls the dispatcher op
``ufm_torch::flash_attention_fwd`` (:mod:`ufm_torch.ops.library`), and the
tensors' device picks the implementation inside the op: a CUDA tensor takes
the Hopper flash-attention kernels (which raise on what they do not take;
with grad enabled, the forward and backward kernel pair), a CPU tensor the
plain PyTorch version, whose gradient is the plain backward. So a traced or
exported model holds the op, not either implementation. ``impl="cuda"`` asks
for the kernels (and raises on a CPU tensor); ``impl="torch"`` asks for the
plain version, decomposed into PyTorch ops, on any device (tests and the chip
check use it to hold the kernels to it). There is no path from the kernels
to the plain version.

Shapes follow the JAX package: q/k/v are (batch, seq, heads, head_dim).
"""

from __future__ import annotations

from typing import Optional

import torch

from ufm_torch.ops import library
from ufm_torch.ops.flash_attention import attention_reference, flash_attention

__all__ = ["dot_product_attention", "IMPLS"]

IMPLS = ("cuda", "torch")


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: Optional[float] = None,
    impl: Optional[str] = None,
) -> torch.Tensor:
    """Softmax attention over (B, S, H, D) tensors; returns (B, Sq, H, D)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if impl is None:
        return library.attention(q, k, v, float(scale))
    if impl == "cuda":
        return flash_attention(q, k, v, scale=scale)
    if impl == "torch":
        return attention_reference(q, k, v, scale)
    raise ValueError(f"unknown attention impl: {impl!r} (expected one of {IMPLS} or None)")
