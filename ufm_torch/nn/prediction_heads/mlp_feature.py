"""Patch-MLP feature head (counterpart of
``ufm_tpu/nn/prediction_heads/mlp_feature.py``).

Maps per-patch tokens through an MLP (``fc<i>`` -> exact GELU, then
``fc_out``) to ``patch_size^2 * output_dim`` values and unshuffles them to a
full-resolution feature map: the classification-refinement feature
extractor. Runs in fp32. At the flagship's width, (2B, 30, 40, 1792) -> 512 ->
14 * 14 * 16 values a patch -> (2B, 420, 560, 16).
"""

from __future__ import annotations

from typing import Sequence

import torch.nn as nn
import torch.nn.functional as F

from ufm_torch.nn.prediction_heads.base import PredictionHeadInput, PredictionHeadOutput

__all__ = ["MLPFeature"]


class MLPFeature(nn.Module):
    def __init__(
        self,
        input_feature_dim: int = 1792,  # encoder level 0 (1024) + info-sharing final (768)
        hidden_dims: Sequence[int] = (1024,),
        output_dim: int = 16,
        patch_size: int = 14,
    ):
        super().__init__()
        self.output_dim = output_dim
        self.patch_size = patch_size
        self.num_hidden = len(hidden_dims)
        dims = [input_feature_dim, *hidden_dims]
        for i in range(self.num_hidden):
            setattr(self, f"fc{i}", nn.Linear(dims[i], dims[i + 1]))
        self.fc_out = nn.Linear(dims[-1], patch_size * patch_size * output_dim)

    @property
    def decoded_channels(self) -> int:
        """Channels of the head's decoded output (``output_dim``)."""
        return self.output_dim

    def forward(self, inp: PredictionHeadInput) -> PredictionHeadOutput:
        x = inp.last_feature.float()  # (B, Hp, Wp, C)
        b, hp, wp, _ = x.shape
        p = self.patch_size
        for i in range(self.num_hidden):
            x = F.gelu(getattr(self, f"fc{i}")(x), approximate="none")
        x = self.fc_out(x)
        # depth-to-space: (B, Hp, Wp, p*p*C) -> (B, Hp*p, Wp*p, C)
        x = x.reshape(b, hp, wp, p, p, self.output_dim).permute(0, 1, 3, 2, 4, 5)
        return PredictionHeadOutput(decoded_channels=x.reshape(b, hp * p, wp * p, self.output_dim))
