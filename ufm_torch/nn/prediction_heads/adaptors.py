"""Output adaptors: parameter-free transforms from regression channels to outputs.

Counterpart of ``ufm_tpu/nn/prediction_heads/adaptors.py``. Each adaptor
declares its channel budget and output name and returns a small dataclass.
Maps are channel-last (B, H, W, C); mask outputs drop the channel axis.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

__all__ = [
    "FlowAdaptor",
    "FlowWithConfidenceAdaptor",
    "MaskAdaptor",
    "ConfidenceAdaptor",
    "Covariance2DAdaptor",
    "FlowOutput",
    "FlowWithConfidenceOutput",
    "MaskOutput",
    "ConfidenceOutput",
    "Covariance2DOutput",
]


@dataclasses.dataclass
class FlowOutput:
    value: torch.Tensor  # (B, H, W, 2)


@dataclasses.dataclass
class FlowWithConfidenceOutput:
    value: torch.Tensor  # (B, H, W, 2)
    confidence: torch.Tensor  # (B, H, W)


@dataclasses.dataclass
class MaskOutput:
    mask: torch.Tensor  # (B, H, W) in [0, 1]
    logits: torch.Tensor  # (B, H, W)


@dataclasses.dataclass
class ConfidenceOutput:
    value: torch.Tensor  # (B, H, W, 1)


@dataclasses.dataclass
class Covariance2DOutput:
    covariance: torch.Tensor  # (B, H, W, 3): [var_x, var_y, cov_xy]
    inv_covariance: torch.Tensor  # (B, H, W, 3)
    log_det: torch.Tensor  # (B, H, W)


class FlowAdaptor:
    """Raw 2-channel flow; identity transform."""

    input_channels = 2

    def __init__(self, name: str = "flow", **_ignored):
        self.name = name

    def __call__(self, x: torch.Tensor) -> FlowOutput:
        return FlowOutput(value=x)


class FlowWithConfidenceAdaptor:
    """3 channels: flow (2) + sigmoid confidence (1)."""

    input_channels = 3

    def __init__(self, name: str = "flow", **_ignored):
        self.name = name

    def __call__(self, x: torch.Tensor) -> FlowWithConfidenceOutput:
        return FlowWithConfidenceOutput(value=x[..., :2], confidence=torch.sigmoid(x[..., 2]))


class MaskAdaptor:
    """1 channel of logits -> sigmoid mask (covisibility / non-occlusion)."""

    input_channels = 1

    def __init__(self, name: str = "non_occluded_mask", **_ignored):
        self.name = name

    def __call__(self, x: torch.Tensor) -> MaskOutput:
        logits = x[..., 0]
        return MaskOutput(mask=torch.sigmoid(logits), logits=logits)


class ConfidenceAdaptor:
    """1 channel -> confidence, channel axis kept (the model squeezes it)."""

    input_channels = 1

    def __init__(self, name: str = "keypoint_confidence", activation: str = "sigmoid", **_ignored):
        self.name = name
        self.activation = activation

    def __call__(self, x: torch.Tensor) -> ConfidenceOutput:
        if self.activation == "sigmoid":
            v = torch.sigmoid(x)
        elif self.activation == "exp":
            v = torch.exp(x)
        elif self.activation == "softplus":
            v = F.softplus(x)
        else:
            raise ValueError(f"unknown confidence activation: {self.activation}")
        return ConfidenceOutput(value=v)


class Covariance2DAdaptor:
    """3 raw channels -> SPD 2x2 flow covariance.

    ``var_x = exp(a)``, ``var_y = exp(b)``, ``cov_xy = tanh(c) * sqrt(var_x *
    var_y)``: positive definite by construction, with analytic inverse and
    log-determinant. Channel order [var_x, var_y, cov_xy].
    """

    input_channels = 3

    def __init__(self, name: str = "flow_cov", min_log_var: float = -10.0, max_log_var: float = 10.0, **_ignored):
        self.name = name
        self.min_log_var = min_log_var
        self.max_log_var = max_log_var

    def __call__(self, x: torch.Tensor) -> Covariance2DOutput:
        a = torch.clamp(x[..., 0], self.min_log_var, self.max_log_var)
        b = torch.clamp(x[..., 1], self.min_log_var, self.max_log_var)
        rho = torch.tanh(x[..., 2]) * 0.999  # keep strictly inside (-1, 1)

        var_x = torch.exp(a)
        var_y = torch.exp(b)
        cov_xy = rho * torch.exp(0.5 * (a + b))

        one_m_rho2 = 1.0 - rho * rho
        det = var_x * var_y * one_m_rho2
        log_det = a + b + torch.log(one_m_rho2)

        inv = torch.stack([var_y / det, var_x / det, -cov_xy / det], dim=-1)
        cov = torch.stack([var_x, var_y, cov_xy], dim=-1)
        return Covariance2DOutput(covariance=cov, inv_covariance=inv, log_det=log_det)
