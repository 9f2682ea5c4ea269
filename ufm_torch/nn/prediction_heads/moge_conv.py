"""MoGe-style convolutional regression head, the alternative to DPT
(counterpart of ``ufm_tpu/nn/prediction_heads/moge_conv.py``).

A light conv decoder: a 1x1 projection of the last feature level, then one
stage per entry of ``dims`` (bilinear 2x upsampling, 3x3 conv, ReLU), a
bilinear resize to the target resolution and a 3x3 output conv. Channel-last
in and out like the JAX module; the convolutions run in NCHW on
channels-last views, the resizes through :func:`ufm_torch.ops.resize.resize_hwc`.
"""

from __future__ import annotations

from typing import Sequence

import torch.nn as nn
import torch.nn.functional as F

from ufm_torch.nn.prediction_heads.base import PredictionHeadLayeredInput, RegressionOutput
from ufm_torch.ops.resize import resize_hwc

__all__ = ["MoGeConvFeature"]


def _conv(conv: nn.Conv2d, x):
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class MoGeConvFeature(nn.Module):
    def __init__(self, input_dim: int = 768, dims: Sequence[int] = (256, 128, 64), output_dim: int = 2):
        super().__init__()
        self.proj = nn.Conv2d(input_dim, dims[0], 1)
        chans = [dims[0], *dims]
        for i, d in enumerate(dims):
            setattr(self, f"conv{i}", nn.Conv2d(chans[i], d, 3, padding=1))
        self.out = nn.Conv2d(dims[-1], output_dim, 3, padding=1)
        self.num_stages = len(dims)

    def forward(self, inp: PredictionHeadLayeredInput) -> RegressionOutput:
        x = _conv(self.proj, inp.list_features[-1].float())  # (B, Hp, Wp, dims[0])
        for i in range(self.num_stages):
            x = resize_hwc(x, (x.shape[-3] * 2, x.shape[-2] * 2), antialias=False)
            x = F.relu(_conv(getattr(self, f"conv{i}"), x))
        x = resize_hwc(x, inp.target_output_shape, antialias=False)
        return RegressionOutput(value=_conv(self.out, x))
