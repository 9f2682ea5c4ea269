"""Prediction-head base types: inputs, regression output, AdaptorMap.

Counterpart of ``ufm_tpu/nn/prediction_heads/base.py``: heads are composed as
``feature_processor -> regression_processor -> AdaptorMap`` and the AdaptorMap
output behaves as a dict keyed by adaptor name. All dense maps at these
interfaces are channel-last (B, H, W, C).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch

__all__ = [
    "PredictionHeadInput",
    "PredictionHeadLayeredInput",
    "PredictionHeadOutput",
    "RegressionOutput",
    "AdaptorMap",
]


@dataclasses.dataclass
class PredictionHeadInput:
    """Single-level head input: ``last_feature`` is (B, Hp, Wp, C)."""

    last_feature: torch.Tensor


@dataclasses.dataclass
class PredictionHeadLayeredInput:
    """Multi-level head input (DPT): 4 maps + the target output (H, W)."""

    list_features: List[torch.Tensor]
    target_output_shape: Tuple[int, int]


@dataclasses.dataclass
class PredictionHeadOutput:
    """Feature-head output: ``decoded_channels`` is (B, H, W, C)."""

    decoded_channels: torch.Tensor


@dataclasses.dataclass
class RegressionOutput:
    """Dense regression map prior to adaptors: ``value`` is (B, H, W, C)."""

    value: torch.Tensor


class AdaptorMap:
    """Splits a regression map channel-wise and applies each adaptor, in the
    order the adaptors are listed (the model config's ``adaptors_kwargs``
    order)."""

    def __init__(self, *adaptors: Any):
        self.adaptors = list(adaptors)
        self.total_channels = sum(a.input_channels for a in self.adaptors)

    def __call__(self, regression: RegressionOutput) -> Dict[str, Any]:
        value = regression.value
        if value.shape[-1] != self.total_channels:
            raise ValueError(f"AdaptorMap expected {self.total_channels} channels, got {value.shape[-1]}")
        out: Dict[str, Any] = {}
        offset = 0
        for adaptor in self.adaptors:
            out[adaptor.name] = adaptor(value[..., offset : offset + adaptor.input_channels])
            offset += adaptor.input_channels
        return out
