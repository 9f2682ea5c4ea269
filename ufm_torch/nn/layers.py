"""Shared transformer building blocks (counterpart of ``ufm_tpu/nn/layers.py``).

The primitives behind both transformer stacks: the ViT feature encoder and the
two-view info-sharing transformer. Parameter names follow the JAX package
(``attn.qkv``, ``mlp.fc1``, ``ls1.gamma``, ...) with ``weight`` for
``kernel``/``scale``, so :mod:`ufm_torch.checkpoint.convert` is a fixed
renaming plus layout changes.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from ufm_torch.ops.attention import dot_product_attention

__all__ = ["Mlp", "Attention", "LayerScale", "TransformerBlock", "run_blocks", "as_dtype", "LN_EPS"]

LN_EPS = 1e-6  # flax LayerNorm's epsilon (torch's default is 1e-5)


def as_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    """``"bfloat16"`` (a config's spelling) or a torch dtype -> torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    out = getattr(torch, str(dtype), None)
    if not isinstance(out, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return out

# sqrt(0.5) rounded to bf16 (1.0110101b x 2^-1), exact in fp32: jax.nn.gelu
# rounds the constant to the input dtype first
_SQRT_HALF_BF16 = 0.70703125


def _gelu_chain_bf16(x: torch.Tensor) -> torch.Tensor:
    return (x * 0.5) * torch.special.erfc(x * -_SQRT_HALF_BF16)


class _GeluChainBf16(torch.autograd.Function):
    """The chain forward; the backward is one ``gelu_backward`` on the saved
    input (the exact derivative in fp32, rounded once). Autograd through the
    chain itself would save three bf16 intermediates of every MLP's hidden
    activation and run about ten elementwise kernels per backward."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _gelu_chain_bf16(x)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return torch.ops.aten.gelu_backward(grad, x, approximate="none")


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU as the JAX package computes it. On bf16 it is
    ``jax.nn.gelu(approximate=False)``'s op-for-op chain
    ``bf16(bf16(0.5 x) * bf16(erfc(bf16(-x * bf16(sqrt(0.5))))))``: four
    elementwise ops, each rounding its fp32 result to bf16 (``x * -c`` is
    ``-x * c`` exactly), where ``F.gelu`` on bf16 rounds once; its gradient
    is ``F.gelu``'s. Other dtypes take ``F.gelu``."""
    if x.dtype != torch.bfloat16:
        return F.gelu(x, approximate="none")
    if torch.is_grad_enabled() and x.requires_grad:
        return _GeluChainBf16.apply(x)
    return _gelu_chain_bf16(x)


_ACTIVATIONS = {
    "gelu_exact": gelu_exact,  # the JAX package's MLP activation, bit for bit on bf16
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
}


class Mlp(nn.Module):
    """Transformer MLP: fc1 -> act -> fc2."""

    def __init__(self, dim: int, hidden_dim: int, out_dim: Optional[int] = None, act: str = "gelu_exact"):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, out_dim or dim)
        self.act = _ACTIVATIONS[act]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class Attention(nn.Module):
    """Multi-head self-attention with a fused qkv projection.

    The softmax core goes through :func:`dot_product_attention` (the Hopper
    kernel for CUDA tensors). ``impl`` is the attention implementation to
    request; ``None`` lets the tensors' device decide. The model sets it on
    every block at once (``UniFlowMatch.attention_impl``).
    """

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True, proj_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim, bias=proj_bias)
        self.impl: Optional[str] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, c = x.shape
        qkv = self.qkv(x).reshape(b, s, 3, self.num_heads, c // self.num_heads)
        # strided views of the fused projection: the kernel reads them in place
        out = dot_product_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], impl=self.impl)
        return self.proj(out.reshape(b, s, c))


class LayerScale(nn.Module):
    """Per-channel learnable residual scaling (DINOv2-style)."""

    def __init__(self, dim: int, init_value: float = 1e-5):
        super().__init__()
        self.init_value = init_value
        self.gamma = nn.Parameter(torch.full((dim,), init_value))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma


class TransformerBlock(nn.Module):
    """Pre-norm transformer block with optional LayerScale."""

    def __init__(
        self,
        dim: int,
        num_heads: int,
        mlp_ratio: float = 4.0,
        qkv_bias: bool = True,
        layerscale_init: Optional[float] = None,
        mlp_act: str = "gelu_exact",
    ):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads, qkv_bias=qkv_bias)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), act=mlp_act)
        if layerscale_init is not None:
            self.ls1 = LayerScale(dim, layerscale_init)
            self.ls2 = LayerScale(dim, layerscale_init)
        else:
            self.ls1 = self.ls2 = nn.Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


def run_blocks(
    blocks: Sequence[nn.Module], x: torch.Tensor, taps: Sequence[int], remat: bool = False
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Run ``blocks`` in order; return the final output and the outputs of the
    layers in ``taps``, in the requested order, repeats included (the loop form
    of ``ufm_tpu/nn/layers.py::scan_transformer_blocks``).

    With ``remat`` and grad enabled, each block runs under
    ``torch.utils.checkpoint`` (non-reentrant): only its input is kept for the
    backward, which runs the block's forward again (``nn.remat`` with no
    policy in the JAX package). It changes memory and time, not values."""
    tapped = {}
    wanted = set(taps)
    checkpointed = remat and torch.is_grad_enabled()
    for i, blk in enumerate(blocks):
        x = torch.utils.checkpoint.checkpoint(blk, x, use_reentrant=False) if checkpointed else blk(x)
        if i in wanted:
            tapped[i] = x
    return x, [tapped[t] for t in taps]
