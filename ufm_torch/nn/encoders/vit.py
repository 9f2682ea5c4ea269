"""DINOv2-style ViT feature encoder (counterpart of ``ufm_tpu/nn/encoders/vit.py``).

The encoder takes a normalized channel-last image batch and returns a list of
tapped per-layer feature maps, (B, Hp, Wp, C) each. The patch embedding is a
stride-14 convolution; attention goes through the shared dispatch (the Hopper
flash-attention kernel on the card). DINOv2's register variants
(``num_register_tokens``, arXiv:2309.16588) place R learned tokens after the
class token, without a position embedding, and the taps drop them with it;
``ffn_layer`` picks the blocks' FFN (``"swiglufused"``: DINOv2 ViT-g/14's).
Parameters live in the compute dtype given at construction (bf16 for the
flagship backbone); training keeps fp32 master copies of them in the
optimizer (``ufm_torch/training/trainer.py``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from ufm_torch.ops.cache import device_constant
from ufm_torch.nn.layers import LN_EPS, TransformerBlock, as_dtype, resolve_remat_policy, run_blocks

__all__ = ["ViTEncoderInput", "ViTEncoderOutput", "ViTEncoder", "interpolate_pos_embed"]


@dataclasses.dataclass
class ViTEncoderInput:
    """Input: ``image`` is (B, H, W, 3), normalized per ``data_norm_type``."""

    image: torch.Tensor
    data_norm_type: str = "dinov2"


@dataclasses.dataclass
class ViTEncoderOutput:
    """One tapped feature level: ``features`` is (B, Hp, Wp, C)."""

    features: torch.Tensor


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    # Keys (1981) cubic convolution kernel, a = -0.5
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1.0)
    out = np.where(x >= 1.0, ((np.float32(-0.5) * x + np.float32(2.5)) * x - np.float32(4.0)) * x + np.float32(2.0), out)
    return np.where(x >= 2.0, np.float32(0.0), out).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _cubic_resize_matrix_np(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) weights of ``jax.image.resize(method="cubic")`` with
    its default ``antialias=True``: the Keys kernel, widened by the downscale
    factor when downsampling, columns renormalized, samples outside the input
    zeroed. Computed in float32 as JAX computes them, so the port reproduces
    JAX's weights rather than ``F.interpolate``'s (a = -0.75, no antialias)."""
    if in_size == out_size:
        return np.eye(in_size, dtype=np.float32)
    inv_scale = np.float32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample_f = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * inv_scale - np.float32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    w = _keys_cubic(x)  # (in, out)
    total = w.sum(axis=0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps, w / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.ascontiguousarray(np.where(inside[None, :], w, 0).astype(np.float32).T)


@device_constant
def _cubic_resize_matrix(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    # cached on the device: a forward pass never waits on a host-to-device
    # copy; built outside inference mode so that training may use it after
    # the predict API
    with torch.inference_mode(False):
        return torch.from_numpy(_cubic_resize_matrix_np(in_size, out_size)).to(device)


def interpolate_pos_embed(pos_embed: torch.Tensor, grid_hw: Tuple[int, int]) -> torch.Tensor:
    """Cubic-resize a (1, G*G, C) learned pos-embed grid to (1, H*W, C), in fp32."""
    n = pos_embed.shape[1]
    g = int(round(n**0.5))
    if g * g != n:
        raise ValueError(f"pos_embed grid is not square: {n}")
    h, w = grid_hw
    if (h, w) == (g, g):
        return pos_embed
    c = pos_embed.shape[-1]
    grid = pos_embed.reshape(g, g, c).float()
    wh = _cubic_resize_matrix(g, h, grid.device)
    ww = _cubic_resize_matrix(g, w, grid.device)
    grid = torch.einsum("oh,hwc->owc", wh, grid)
    grid = torch.einsum("ow,hwc->hoc", ww, grid)
    return grid.reshape(1, h * w, c).to(pos_embed.dtype)


class ViTEncoder(nn.Module):
    """Plain ViT with per-layer taps ("feature returner").

    Defaults are a DINOv2 ViT-L/14 backbone. Keyword names are the JAX
    module's fields, so the encoder factory accepts the same config keys.
    """

    def __init__(
        self,
        patch_size: int = 14,
        embed_dim: int = 1024,
        depth: int = 24,
        num_heads: int = 16,
        mlp_ratio: float = 4.0,
        qkv_bias: bool = True,
        layerscale_init: Optional[float] = 1e-5,
        pretrain_grid_size: int = 37,  # DINOv2 pretraining: 518 / 14
        use_cls_token: bool = True,
        # Which block outputs to return, in order. None -> only the final block.
        intermediate_layer_idx: Optional[Sequence[int]] = None,
        norm_intermediate: bool = True,
        data_norm_type: str = "dinov2",
        mlp_act: str = "gelu_exact",
        num_register_tokens: int = 0,
        ffn_layer: str = "mlp",
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
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.depth = depth
        self.use_cls_token = use_cls_token
        if num_register_tokens < 0:
            raise ValueError(f"num_register_tokens must be >= 0, got {num_register_tokens}")
        self.num_register_tokens = int(num_register_tokens)
        self.norm_intermediate = norm_intermediate
        self.data_norm_type = data_norm_type
        taps = tuple(intermediate_layer_idx) if intermediate_layer_idx is not None else (depth - 1,)
        self.taps = tuple(int(t) % depth for t in taps)

        self.patch_embed = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)
        self.pos_embed = nn.Parameter(torch.zeros(1, pretrain_grid_size**2, embed_dim))
        if use_cls_token:
            self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
            self.cls_pos_embed = nn.Parameter(torch.zeros(1, 1, embed_dim))
        if self.num_register_tokens:
            self.register_tokens = nn.Parameter(torch.zeros(1, self.num_register_tokens, embed_dim))
        self.blocks = nn.ModuleList(
            TransformerBlock(embed_dim, num_heads, mlp_ratio, qkv_bias, layerscale_init, mlp_act, ffn_layer)
            for _ in range(depth)
        )
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.dtype = as_dtype(dtype)
        self.to(self.dtype)

    def forward(self, inp: ViTEncoderInput) -> List[ViTEncoderOutput]:
        image = inp.image
        b, h, w, _ = image.shape
        if h % self.patch_size or w % self.patch_size:
            raise ValueError(f"image size {(h, w)} not divisible by patch size {self.patch_size}")
        hp, wp = h // self.patch_size, w // self.patch_size

        x = self.patch_embed(image.to(self.dtype).permute(0, 3, 1, 2))  # (B, C, hp, wp)
        x = x.flatten(2).transpose(1, 2)  # (B, hp*wp, C), row-major over (hp, wp)
        x = x + interpolate_pos_embed(self.pos_embed, (hp, wp))
        lead = []  # the class token, then the registers (no position embedding)
        if self.use_cls_token:
            lead.append((self.cls_token + self.cls_pos_embed).expand(b, 1, self.embed_dim))
        if self.num_register_tokens:
            lead.append(self.register_tokens.expand(b, -1, -1))
        if lead:
            x = torch.cat([*lead, x], dim=1)

        _, outputs = run_blocks(self.blocks, x, self.taps, remat=self.remat, remat_policy=self.remat_policy)

        skip = int(self.use_cls_token) + self.num_register_tokens
        results = []
        for feat in outputs:
            if self.norm_intermediate:
                feat = self.norm(feat)
            if skip:
                feat = feat[:, skip:]
            results.append(ViTEncoderOutput(features=feat.reshape(b, hp, wp, self.embed_dim)))
        return results
