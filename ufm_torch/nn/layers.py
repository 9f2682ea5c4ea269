"""Shared transformer building blocks (counterpart of ``ufm_tpu/nn/layers.py``).

The primitives behind both transformer stacks: the ViT feature encoder and the
two-view info-sharing transformer. Parameter names follow the JAX package
(``attn.qkv``, ``mlp.fc1``, ``ls1.gamma``, ...) with ``weight`` for
``kernel``/``scale``, so :mod:`ufm_torch.checkpoint.convert` is a fixed
renaming plus layout changes. The SwiGLU FFN, which the JAX package does not
have, takes DINOv2's names (``mlp.w12``, ``mlp.w3``).
"""

from __future__ import annotations

import contextvars
from functools import partial
from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

from ufm_torch.ops.attention import dot_product_attention
from ufm_torch.ops.gelu import gelu_bf16
from ufm_torch.ops.library import flash_attention_fwd, linear_gelu_bf16, linear_swiglu_bf16, mlp_bf16

__all__ = [
    "Mlp",
    "SwiGLUFFN",
    "FFN_LAYERS",
    "swiglu_hidden_dim",
    "Attention",
    "LayerScale",
    "TransformerBlock",
    "run_blocks",
    "resolve_remat_policy",
    "REMAT_POLICIES",
    "as_dtype",
    "LN_EPS",
]

LN_EPS = 1e-6  # flax LayerNorm's epsilon (torch's default is 1e-5)


def as_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    """``"bfloat16"`` (a config's spelling) or a torch dtype -> torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    out = getattr(torch, str(dtype), None)
    if not isinstance(out, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return out


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU as the JAX package computes it. On bf16 it is the
    op ``ufm_torch::gelu_bf16`` (:func:`ufm_torch.ops.gelu.gelu_bf16`: one
    kernel on the card, bit for bit ``jax.nn.gelu(approximate=False)`` as the
    JAX package's ``fast_exact_gelu`` computes it); its gradient is the op
    ``ufm_torch::gelu_bf16_bwd``, bit for bit ``jax.vjp`` of it. Other dtypes
    take ``F.gelu``, as the JAX package's take ``jax.nn.gelu``."""
    if x.dtype != torch.bfloat16:
        return F.gelu(x, approximate="none")
    return gelu_bf16(x)


_ACTIVATIONS = {
    "gelu_exact": gelu_exact,  # the JAX package's MLP activation, bit for bit on bf16
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
}


# set while a block runs under activation checkpointing (run_blocks with
# remat), in its forward and in the backward's recompute alike
_REMAT = contextvars.ContextVar("remat", default=False)


class Mlp(nn.Module):
    """Transformer MLP: fc1 -> act -> fc2.

    With the exact GELU on a bf16 ``fc1``, fc1 and the GELU are one op,
    ``ufm_torch::linear_gelu_bf16`` (on the card one kernel with the GELU in
    the product's epilogue; on the CPU the same bits as the two ops). Under
    grad mode it writes the pre-activation ``h`` beside its output in the
    same launch and keeps it for its gradient, where the two ops kept it
    for the GELU's. They stay two ops for a tensor-parallel (DTensor)
    ``fc1`` (the fused op has no sharding rule) and under activation
    checkpointing, where a remat policy decides op by op what to keep and
    the standalone GELU is what it recomputes.
    """

    def __init__(self, dim: int, hidden_dim: int, out_dim: Optional[int] = None, act: str = "gelu_exact"):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, out_dim or dim)
        self.act = _ACTIVATIONS[act]

    def _fused(self, x: torch.Tensor) -> bool:
        w, b = self.fc1.weight, self.fc1.bias
        if self.act is not gelu_exact or w.dtype != torch.bfloat16 or x.dtype != torch.bfloat16 or b is None:
            return False
        if isinstance(w, DTensor) or isinstance(x, DTensor):
            return False
        return not _REMAT.get()

    def _fused_backward(self, x: torch.Tensor) -> bool:
        params = (self.fc1.weight, self.fc1.bias, self.fc2.weight, self.fc2.bias)
        if not torch.is_grad_enabled() or not any(t.requires_grad for t in (x, *params)):
            return False
        w2, b2 = self.fc2.weight, self.fc2.bias
        return b2 is not None and w2.dtype == b2.dtype == torch.bfloat16 and not isinstance(w2, DTensor) \
            and not isinstance(b2, DTensor)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self._fused(x):
            if self._fused_backward(x):
                return mlp_bf16(x, self.fc1.weight, self.fc1.bias, self.fc2.weight, self.fc2.bias)
            return self.fc2(linear_gelu_bf16(x, self.fc1.weight, self.fc1.bias))
        return self.fc2(self.act(self.fc1(x)))


def swiglu_hidden_dim(hidden_dim: int) -> int:
    """DINOv2's ``SwiGLUFFNFused`` width for an MLP width of ``hidden_dim``:
    two thirds of it, rounded up to a multiple of 8 (ViT-g/14: 6144 -> 4096)."""
    return (int(hidden_dim * 2 / 3) + 7) // 8 * 8


class SwiGLUFFN(nn.Module):
    """DINOv2's ``SwiGLUFFNFused``: ``w12 -> chunk -> silu(x1) * x2 -> w3``,
    with biases on ``w12`` and ``w3``; ``x1`` is the first half of ``w12``'s
    output. ``hidden_dim`` is the block's MLP width before the two-thirds rule
    (:func:`swiglu_hidden_dim`).

    The gate runs in fp32 on the rounded halves and is rounded once. Where no
    gradient is recorded (inference) on a bf16 ``w12`` with a bias, ``w12``
    and the gate are one op, ``ufm_torch::linear_swiglu_bf16`` (on the card
    one kernel with the gate in the product's epilogue; on the CPU the same
    bits as the composition). Under grad mode, under activation checkpointing
    and for a tensor-parallel (DTensor) ``w12`` the FFN takes the plain
    composition, whose gradient autograd records.
    """

    def __init__(self, dim: int, hidden_dim: int, out_dim: Optional[int] = None):
        super().__init__()
        hidden = swiglu_hidden_dim(hidden_dim)
        self.w12 = nn.Linear(dim, 2 * hidden)
        self.w3 = nn.Linear(hidden, out_dim or dim)

    def _fused(self, x: torch.Tensor) -> bool:
        w, b = self.w12.weight, self.w12.bias
        if w.dtype != torch.bfloat16 or x.dtype != torch.bfloat16 or b is None or b.dtype != torch.bfloat16:
            return False
        if isinstance(w, DTensor) or isinstance(x, DTensor) or _REMAT.get():
            return False
        return not (torch.is_grad_enabled() and any(t.requires_grad for t in (x, w, b)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self._fused(x):
            return self.w3(linear_swiglu_bf16(x, self.w12.weight, self.w12.bias))
        x1, x2 = self.w12(x).chunk(2, dim=-1)
        return self.w3((F.silu(x1.float()) * x2.float()).to(x1.dtype))


# a block's ``ffn_layer`` values (DINOv2's names): "mlp" is the GELU Mlp; DINOv2
# maps both SwiGLU names to ``SwiGLUFFNFused`` (SwiGLUFFN here)
FFN_LAYERS = ("mlp", "swiglufused", "swiglu")


class Attention(nn.Module):
    """Multi-head self-attention with a fused qkv projection.

    The softmax core goes through :func:`dot_product_attention` (the Hopper
    kernel for CUDA tensors). ``impl`` is the attention implementation to
    request; ``None`` lets the tensors' device decide. The model sets it on
    every block at once (``UniFlowMatch.attention_impl``).

    The head count of a call is read from the qkv output: under tensor
    parallelism (:func:`ufm_torch.parallel.shard_params`) a rank's qkv
    projection yields its own heads only.
    """

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True, proj_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim, bias=proj_bias)
        self.impl: Optional[str] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, c = x.shape
        qkv = self.qkv(x).reshape(b, s, 3, -1, c // self.num_heads)
        # strided views of the fused projection: the kernel reads them in place
        out = dot_product_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], impl=self.impl)
        return self.proj(out.reshape(b, s, -1))


class LayerScale(nn.Module):
    """Per-channel learnable residual scaling (DINOv2-style)."""

    def __init__(self, dim: int, init_value: float = 1e-5):
        super().__init__()
        self.init_value = init_value
        self.gamma = nn.Parameter(torch.full((dim,), init_value))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma


class TransformerBlock(nn.Module):
    """Pre-norm transformer block with optional LayerScale. ``ffn_layer``
    (:data:`FFN_LAYERS`) picks the FFN: ``"mlp"`` the GELU :class:`Mlp`,
    ``"swiglufused"`` or ``"swiglu"`` the :class:`SwiGLUFFN` (which has no
    activation to pick: ``mlp_act`` is the MLP's)."""

    def __init__(
        self,
        dim: int,
        num_heads: int,
        mlp_ratio: float = 4.0,
        qkv_bias: bool = True,
        layerscale_init: Optional[float] = None,
        mlp_act: str = "gelu_exact",
        ffn_layer: str = "mlp",
    ):
        super().__init__()
        if ffn_layer not in FFN_LAYERS:
            raise ValueError(f"unknown ffn_layer {ffn_layer!r}; valid: {list(FFN_LAYERS)}")
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads, qkv_bias=qkv_bias)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        if ffn_layer == "mlp":
            self.mlp = Mlp(dim, int(dim * mlp_ratio), act=mlp_act)
        else:
            self.mlp = SwiGLUFFN(dim, int(dim * mlp_ratio))
        if layerscale_init is not None:
            self.ls1 = LayerScale(dim, layerscale_init)
            self.ls2 = LayerScale(dim, layerscale_init)
        else:
            self.ls1 = self.ls2 = nn.Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


# the JAX package's remat policy names (``jax.checkpoint_policies``, and the
# composite of ufm_tpu/nn/layers.py::resolve_remat_policy) -> the ATen ops a
# selective-checkpointing policy saves; every other op is recomputed in the
# backward. JAX's "dots" are dot_general: with batch dims (bmm, baddbmm, and
# convolutions, which XLA lowers to dots of their own) or without (mm, addmm:
# the projections and MLPs). The composite also saves the flash-attention
# forward op's outputs (the attention core and its row log-sum-exp), so the
# backward does not run the attention forward again. ``None`` saves every op.
# The GELU op (``ufm_torch::gelu_bf16``) is in no list, as JAX's activation is
# no dot: every policy but ``None`` runs it again (72 launches a UFM-Base step).
# Under checkpointing the MLP keeps fc1 and the GELU apart (``_REMAT``), so
# each policy sees the ops it sees without the fused op.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_BATCHED_DOTS = (torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default, torch.ops.aten.convolution.default)
REMAT_POLICIES = {
    "everything_saveable": None,
    "nothing_saveable": (),
    "dots_saveable": _DOTS + _BATCHED_DOTS,
    "checkpoint_dots": _DOTS + _BATCHED_DOTS,
    "dots_with_no_batch_dims_saveable": _DOTS,
    "checkpoint_dots_with_no_batch_dims": _DOTS,
    "dots_with_no_batch_dims_and_attn_out_saveable": _DOTS + (flash_attention_fwd,),
}


def _saving(ops: Optional[Tuple]) -> Callable:
    def policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
        if ops is None or op in ops:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return policy


def resolve_remat_policy(name: Optional[str]) -> Optional[Callable]:
    """A ``train_remat_policy`` name -> a selective-checkpointing policy
    (``torch.utils.checkpoint.create_selective_checkpoint_contexts``), the
    counterpart of ``jax.checkpoint_policies.<name>``. ``None`` or ``""``
    means full remat (only each block's input is kept). The JAX package's
    policy factories (``save_only_these_names``, ``save_from_both_policies``,
    ...) are refused like unknown names."""
    if not name:
        return None
    if name not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {name!r}; valid: {sorted(REMAT_POLICIES)}")
    return _saving(REMAT_POLICIES[name])


def _remat_block(blk: nn.Module, x: torch.Tensor) -> torch.Tensor:
    token = _REMAT.set(True)
    try:
        return blk(x)
    finally:
        _REMAT.reset(token)


def run_blocks(
    blocks: Sequence[nn.Module],
    x: torch.Tensor,
    taps: Sequence[int],
    remat: bool = False,
    remat_policy: Optional[str] = None,
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Run ``blocks`` in order; return the final output and the outputs of the
    layers in ``taps``, in the requested order, repeats included (the loop form
    of ``ufm_tpu/nn/layers.py::scan_transformer_blocks``).

    With ``remat`` and grad enabled, each block runs under
    ``torch.utils.checkpoint`` (non-reentrant): only its input is kept for the
    backward, which runs the block's forward again (``nn.remat`` with no
    policy in the JAX package). ``remat_policy`` (a name of
    :data:`REMAT_POLICIES`) keeps the outputs of the ops it names as well,
    and the backward recomputes only the rest. It changes memory and time,
    not values. Under checkpointing the blocks' MLPs take fc1 and the GELU
    as two ops (:class:`Mlp`)."""
    policy = resolve_remat_policy(remat_policy)
    checkpointed = remat and torch.is_grad_enabled()
    kwargs = {"use_reentrant": False}
    if policy is not None:
        kwargs["context_fn"] = partial(create_selective_checkpoint_contexts, policy)
    tapped = {}
    wanted = set(taps)
    for i, blk in enumerate(blocks):
        x = torch.utils.checkpoint.checkpoint(_remat_block, blk, x, **kwargs) if checkpointed else blk(x)
        if i in wanted:
            tapped[i] = x
    return x, [tapped[t] for t in taps]
