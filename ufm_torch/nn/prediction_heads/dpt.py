"""DPT dense prediction head (counterpart of ``ufm_tpu/nn/prediction_heads/dpt.py``).

:class:`DPTFeature` reassembles 4 token levels into a fused convolutional
pyramid; :class:`DPTRegressionProcessor` decodes the fused map to a dense
regression at the requested output resolution. Both take and return
channel-last maps like the JAX modules and run their convolutions in NCHW: a
channel-last tensor permuted to NCHW is a channels-last view, so the permutes
at the boundaries copy nothing. Upsampling inside is align-corners bilinear
as host-built matrices (:mod:`ufm_torch.ops.resize`), not ``F.interpolate``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ufm_torch.nn.prediction_heads.base import PredictionHeadLayeredInput, RegressionOutput
from ufm_torch.ops.resize import resize_chw

__all__ = ["DPTFeature", "DPTRegressionProcessor"]


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class _ResidualConvUnit(nn.Module):
    """relu -> conv3x3 -> relu -> conv3x3, residual."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv1 = nn.Conv2d(dim, dim, 3, padding=1)
        self.conv2 = nn.Conv2d(dim, dim, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class _FeatureFusionBlock(nn.Module):
    """RefineNet-style fusion: (skip RCU) + RCU + 2x upsample + 1x1. The top
    level fuses no skip and has no ``rcu_skip``."""

    def __init__(self, dim: int, has_skip: bool):
        super().__init__()
        if has_skip:
            self.rcu_skip = _ResidualConvUnit(dim)
        self.rcu = _ResidualConvUnit(dim)
        self.project = nn.Conv2d(dim, dim, 1)

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        if skip is not None:
            if x.shape[-2:] != skip.shape[-2:]:  # odd patch grids: align to the skip level
                x = resize_chw(x, skip.shape[-2:], antialias=False, align_corners=True)
            x = x + self.rcu_skip(skip)
        x = self.rcu(x)
        x = resize_chw(x, (x.shape[-2] * 2, x.shape[-1] * 2), antialias=False, align_corners=True)
        return self.project(x)


class DPTFeature(nn.Module):
    """Reassemble 4 feature levels and fuse them top-down.

    ``input_dims`` gives the channel width of each incoming level (UFM feeds
    [encoder_last, info_tap0, info_tap1, info_final]). Output: the fused
    (B, 8*Hp, 8*Wp, feature_dim) map.
    """

    def __init__(
        self,
        input_dims: Sequence[int] = (1024, 768, 768, 768),
        proj_dims: Sequence[int] = (96, 192, 384, 768),
        feature_dim: int = 256,
    ):
        super().__init__()
        for i, (d, p) in enumerate(zip(input_dims, proj_dims)):
            setattr(self, f"proj_{i}", nn.Conv2d(d, p, 1))
            setattr(self, f"scratch_{i}", nn.Conv2d(p, feature_dim, 3, padding=1, bias=False))
        self.resize_0 = nn.ConvTranspose2d(proj_dims[0], proj_dims[0], 4, stride=4)
        self.resize_1 = nn.ConvTranspose2d(proj_dims[1], proj_dims[1], 2, stride=2)
        self.resize_3 = nn.Conv2d(proj_dims[3], proj_dims[3], 3, stride=2, padding=1)
        for i in range(4):
            setattr(self, f"fusion_{i}", _FeatureFusionBlock(feature_dim, has_skip=i != 3))

    def forward(self, inp: PredictionHeadLayeredInput) -> torch.Tensor:
        feats = inp.list_features
        if len(feats) != 4:
            raise ValueError(f"DPT expects 4 levels, got {len(feats)}")
        levels = []
        for i, f in enumerate(feats):
            f = getattr(self, f"proj_{i}")(_nchw(f.float()))
            if i in (0, 1, 3):
                f = getattr(self, f"resize_{i}")(f)
            levels.append(getattr(self, f"scratch_{i}")(f))
        l0, l1, l2, l3 = levels
        x = self.fusion_3(l3)
        x = self.fusion_2(x, l2)
        x = self.fusion_1(x, l1)
        x = self.fusion_0(x, l0)
        return _nhwc(x)


class DPTRegressionProcessor(nn.Module):
    """Decode the fused DPT map to ``output_dim`` channels at target res."""

    def __init__(self, input_dim: int = 256, hidden_dims: Tuple[int, int] = (128, 64), output_dim: int = 2):
        super().__init__()
        self.conv1 = nn.Conv2d(input_dim, hidden_dims[0], 3, padding=1)
        self.conv2 = nn.Conv2d(hidden_dims[0], hidden_dims[1], 3, padding=1)
        self.conv3 = nn.Conv2d(hidden_dims[1], output_dim, 1)

    def forward(self, x: torch.Tensor, target_output_shape: Tuple[int, int]) -> RegressionOutput:
        x = self.conv1(_nchw(x))
        x = resize_chw(x, target_output_shape, antialias=False, align_corners=True)
        x = self.conv3(F.relu(self.conv2(x)))
        return RegressionOutput(value=_nhwc(x))
