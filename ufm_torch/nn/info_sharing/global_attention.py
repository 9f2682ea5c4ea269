"""Two-view info-sharing transformer ("global attention").

Counterpart of ``ufm_tpu/nn/info_sharing/global_attention.py``: both views'
patch tokens are concatenated into one (B, 2S, C) sequence, so every token
attends to both views in one flash-attention call per layer. View identity is
a learned per-view embedding, position a fixed 2D sin-cos embedding. Returns
``(final, [tap_a, tap_b])``; each exposes ``.features[view]`` as a
(B, Hp, Wp, dim) map, normalized by the one shared ``norm``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from ufm_torch.ops.cache import device_constant
from ufm_torch.nn.layers import LN_EPS, TransformerBlock, as_dtype, resolve_remat_policy, run_blocks

__all__ = [
    "MultiViewTransformerInput",
    "MultiViewTransformerOutput",
    "MultiViewGlobalAttentionTransformer",
    "INFO_SHARING_CLASSES",
]


@dataclasses.dataclass
class MultiViewTransformerInput:
    """``features``: one (B, Hp, Wp, C) map per view."""

    features: List[torch.Tensor]


@dataclasses.dataclass
class MultiViewTransformerOutput:
    """``features``: one (B, Hp, Wp, C) map per view."""

    features: List[torch.Tensor]


def _sincos_pos_embed_2d(h: int, w: int, dim: int) -> np.ndarray:
    """Standard 2D sin-cos positional embedding, (h*w, dim), computed in
    float64 and returned as float32."""
    assert dim % 4 == 0, f"sin-cos pos embed needs dim % 4 == 0, got {dim}"
    quarter = dim // 4
    omega = 1.0 / (10000.0 ** (np.arange(quarter, dtype=np.float64) / quarter))
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float64), np.arange(w, dtype=np.float64), indexing="ij")
    out = []
    for grid in (ys.reshape(-1), xs.reshape(-1)):
        ang = np.outer(grid, omega)
        out.extend([np.sin(ang), np.cos(ang)])
    return np.concatenate(out, axis=1).astype(np.float32)


@device_constant
def _sincos_pos_embed(h: int, w: int, dim: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):  # cached: usable by training after the predict API
        return torch.from_numpy(_sincos_pos_embed_2d(h, w, dim)).to(device=device, dtype=dtype)


class MultiViewGlobalAttentionTransformer(nn.Module):
    """Joint self-attention transformer over two views' tokens.

    ``intermediate_layer_idx`` selects which block outputs are tapped and
    returned as intermediates (the UFM DPT head consumes exactly two taps).
    """

    def __init__(
        self,
        input_embed_dim: int = 1024,
        dim: int = 768,
        depth: int = 12,
        num_heads: int = 12,
        mlp_ratio: float = 4.0,
        qkv_bias: bool = True,
        layerscale_init: Optional[float] = None,
        num_views: int = 2,
        intermediate_layer_idx: Sequence[int] = (5, 8),
        norm_intermediate: bool = True,
        use_pos_embed: bool = True,
        mlp_act: str = "gelu_exact",
        dtype: Union[str, torch.dtype] = torch.float32,
        # training memory knob: checkpoint every block (run_blocks), keeping
        # what ``remat_policy`` saves (nn/layers.py::REMAT_POLICIES)
        remat: bool = False,
        remat_policy: Optional[str] = None,
    ):
        super().__init__()
        resolve_remat_policy(remat_policy)  # an unknown name fails here
        self.remat = remat
        self.remat_policy = remat_policy
        self.dim = dim
        self.num_views = num_views
        self.norm_intermediate = norm_intermediate
        self.use_pos_embed = use_pos_embed
        self.taps = tuple(int(t) % depth for t in intermediate_layer_idx)
        if input_embed_dim != dim:
            self.input_proj = nn.Linear(input_embed_dim, dim)
        self.view_embed = nn.Parameter(torch.zeros(num_views, dim))
        self.blocks = nn.ModuleList(
            TransformerBlock(dim, num_heads, mlp_ratio, qkv_bias, layerscale_init, mlp_act) for _ in range(depth)
        )
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.dtype = as_dtype(dtype)
        self.to(self.dtype)

    def forward(
        self, inp: MultiViewTransformerInput
    ) -> Tuple[MultiViewTransformerOutput, List[MultiViewTransformerOutput]]:
        feats = inp.features
        if len(feats) != self.num_views:
            raise ValueError(f"expected {self.num_views} views, got {len(feats)}")
        b, hp, wp, c_in = feats[0].shape
        s = hp * wp

        tokens = torch.stack([f.reshape(b, s, c_in) for f in feats], dim=1).to(self.dtype)  # (B, V, S, C)
        if hasattr(self, "input_proj"):
            tokens = self.input_proj(tokens)
        tokens = tokens + self.view_embed[None, :, None, :]
        if self.use_pos_embed:
            tokens = tokens + _sincos_pos_embed(hp, wp, self.dim, self.dtype, tokens.device)[None, None]
        x = tokens.reshape(b, self.num_views * s, self.dim)

        def split_views(y: torch.Tensor) -> MultiViewTransformerOutput:
            y = y.reshape(b, self.num_views, hp, wp, self.dim)
            return MultiViewTransformerOutput(features=[y[:, v] for v in range(self.num_views)])

        x, tap_outs = run_blocks(self.blocks, x, self.taps, remat=self.remat, remat_policy=self.remat_policy)
        intermediates = [split_views(self.norm(t) if self.norm_intermediate else t) for t in tap_outs]
        return split_views(self.norm(x)), intermediates


# Registry mirroring the reference lookup `INFO_SHARING_CLASSES[name][1]`:
# value = (description, class).
INFO_SHARING_CLASSES = {
    "global_attention": ("joint self-attention over all views", MultiViewGlobalAttentionTransformer),
    "global_attention_transformer": (
        "joint self-attention over all views",
        MultiViewGlobalAttentionTransformer,
    ),
}
