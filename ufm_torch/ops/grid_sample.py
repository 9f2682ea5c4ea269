"""``grid_sample`` with torch's semantics, channel-last (counterpart of
``ufm_tpu/ops/grid_sample.py``).

The refinement's materializing reference samples a P x P window of target
features bicubically (``padding_mode="zeros"``, ``align_corners=False``).
Taps are gathered from the flattened (H*W) axis and combined with separable
weights; a tap outside the image contributes exactly zero, including the case
where the tap is out of range but the sample centre is not.

Layout: features (B, H, W, C), grid (B, *S, 2) in xy order with values in
[-1, 1] (``align_corners=False``: x = ((gx + 1) * W - 1) / 2).

The cubic here is torch's cubic convolution (A = -0.75). The pos-embed resize
of the encoder (``ufm_torch/nn/encoders/vit.py``) uses Keys' A = -0.5: the two
share no code.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["grid_sample", "cubic_weights", "cubic_weights_derivative"]

_CUBIC_A = -0.75  # torch's cubic convolution constant


def cubic_weights(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cubic-convolution weights (A = -0.75) of the taps at offsets
    [-1, 0, 1, 2] from the floor tap; ``t`` is the fractional distance."""
    a = _CUBIC_A

    def k1(x):  # |x| <= 1
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0

    def k2(x):  # 1 < |x| < 2
        return (((x - 5.0) * x + 8.0) * x - 4.0) * a

    return k2(t + 1.0), k1(t), k1(1.0 - t), k2(2.0 - t)


def cubic_weights_derivative(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The derivatives of :func:`cubic_weights` in ``t`` (the window
    refinement's flow gradient)."""
    a = _CUBIC_A

    def d1(x):  # k1'
        return (3.0 * (a + 2.0) * x - 2.0 * (a + 3.0)) * x

    def d2(x):  # k2'
        return ((3.0 * x - 10.0) * x + 8.0) * a

    return d2(t + 1.0), d1(t), -d1(1.0 - t), -d2(2.0 - t)


def _unnormalize(coord: torch.Tensor, size: int) -> torch.Tensor:
    # align_corners=False: [-1, 1] maps to [-0.5, size - 0.5] pixel centres
    return ((coord + 1.0) * size - 1.0) / 2.0


def _gather_2d(flat: torch.Tensor, ix: torch.Tensor, iy: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Zero-padded gather. flat: (B, H*W, C); ix/iy: (B, *S) integer."""
    valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    lin = iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)
    idx = lin.reshape(lin.shape[0], -1, 1).expand(-1, -1, flat.shape[-1])
    out = torch.gather(flat, 1, idx).reshape(*ix.shape, flat.shape[-1])
    return torch.where(valid[..., None], out, 0.0)


def grid_sample(
    features: torch.Tensor,
    grid: torch.Tensor,
    mode: str = "bilinear",
    padding_mode: str = "zeros",
    align_corners: bool = False,
) -> torch.Tensor:
    """Sample ``features`` (B, H, W, C) at ``grid`` (B, *S, 2) xy in [-1, 1];
    returns (B, *S, C). Only ``padding_mode="zeros"`` and
    ``align_corners=False`` exist (what the reference uses)."""
    if padding_mode != "zeros":
        raise NotImplementedError("only padding_mode='zeros' is supported")
    if align_corners:
        raise NotImplementedError("only align_corners=False is supported")

    b, h, w, c = features.shape
    flat = features.reshape(b, h * w, c)
    gx = _unnormalize(grid[..., 0], w)
    gy = _unnormalize(grid[..., 1], h)

    if mode == "nearest":
        ix = torch.floor(gx + 0.5).long()
        iy = torch.floor(gy + 0.5).long()
        return _gather_2d(flat, ix, iy, h, w)

    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    tx = gx - x0
    ty = gy - y0
    x0 = x0.long()
    y0 = y0.long()

    if mode == "bilinear":
        acc = 0.0
        for dy, wy in ((0, 1.0 - ty), (1, ty)):
            for dx, wx in ((0, 1.0 - tx), (1, tx)):
                acc = acc + _gather_2d(flat, x0 + dx, y0 + dy, h, w) * (wx * wy)[..., None]
        return acc

    if mode == "bicubic":
        wxs = cubic_weights(tx)
        wys = cubic_weights(ty)
        acc = 0.0
        for dy in range(4):
            row = 0.0
            for dx in range(4):
                row = row + _gather_2d(flat, x0 + (dx - 1), y0 + (dy - 1), h, w) * wxs[dx][..., None]
            acc = acc + row * wys[dy][..., None]
        return acc

    raise ValueError(f"unknown mode: {mode}")
