"""UNet fine-feature encoder for the classification refinement (counterpart
of ``ufm_tpu/nn/unet.py``).

DoubleConv blocks, 2x2 max-pool downs (floor), 2x2 stride-2 transposed-conv
ups with skip concatenation, a nearest resize where an up-sampled map and its
skip differ in size, and a final 1x1 conv. Channel-last at the interface,
NCHW inside (the permutes are views); parameters and arithmetic in ``dtype``
(the backbone's compute dtype, bf16 for the flagship).

At the flagship's 420 rows the pyramid goes 420 -> 210 -> 105 -> 52 -> 26, so
the up path meets a 105-row skip with 104 rows: the full-width model always
takes the nearest-resize branch.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ufm_torch.nn.layers import as_dtype
from ufm_torch.ops.resize import resize_nearest_hwc

__all__ = ["UNet"]


class _DoubleConv(nn.Module):
    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_dim, dim, 3, padding=1)
        self.conv2 = nn.Conv2d(dim, dim, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.conv2(F.relu(self.conv1(x))))


class UNet(nn.Module):
    def __init__(
        self,
        out_channels: int = 16,
        features: Sequence[int] = (64, 128, 256, 512),
        dtype: Union[str, torch.dtype] = torch.float32,
    ):
        super().__init__()
        features = tuple(features)
        self.num_levels = len(features)
        dim = 3  # RGB
        for i, f in enumerate(features):
            setattr(self, f"down_{i}", _DoubleConv(dim, f))
            dim = f
        self.bottleneck = _DoubleConv(dim, 2 * dim)
        dim = 2 * dim
        for i, f in enumerate(reversed(features)):
            setattr(self, f"up_{i}", nn.ConvTranspose2d(dim, f, 2, stride=2))
            setattr(self, f"up_conv_{i}", _DoubleConv(2 * f, f))
            dim = f
        self.final = nn.Conv2d(dim, out_channels, 1)
        self.dtype = as_dtype(dtype)
        self.to(self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) -> (B, H, W, out_channels), in ``dtype``."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        skips = []
        for i in range(self.num_levels):
            x = getattr(self, f"down_{i}")(x)
            skips.append(x)
            x = F.max_pool2d(x, 2, 2)
        x = self.bottleneck(x)
        for i in range(self.num_levels):
            x = getattr(self, f"up_{i}")(x)
            skip = skips[-(i + 1)]
            if x.shape[-2:] != skip.shape[-2:]:
                x = resize_nearest_hwc(x.permute(0, 2, 3, 1), skip.shape[-2:]).permute(0, 3, 1, 2)
            x = getattr(self, f"up_conv_{i}")(torch.cat([skip, x], dim=1))
        return self.final(x).permute(0, 2, 3, 1)
