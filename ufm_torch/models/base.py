"""Model base: output interfaces + the batched prediction pipeline.

Counterpart of ``ufm_tpu/models/base.py``: the output dataclasses and
``predict_correspondences_batched``. Public tensors follow the reference's
BCHW convention (flow (B, 2, H, W), masks (B, H, W)); inside, maps are
channel-last. The pipeline runs eagerly on the model's device: normalize
(uint8 or float input, both normalization paths), resize to the model
resolution whose aspect is closest (antialiased), forward, unmap back to the
input resolution, rescale the covariance.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ufm_torch.nn.encoders.image_normalizations import IMAGE_NORMALIZATION_DICT
from ufm_torch.utils.flow_resizing import (
    AutomaticShapeSelection,
    ResizeToFixedManipulation,
    _identity_regions,
    unmap_predicted_channels,
    unmap_predicted_flow,
)

__all__ = [
    "UFMFlowFieldOutput",
    "UFMMaskFieldOutput",
    "UFMClassificationRefinementOutput",
    "UFMOutputInterface",
    "UniFlowMatchModelsBase",
]


@dataclasses.dataclass
class UFMFlowFieldOutput:
    """Flow field prediction. BCHW."""

    flow_output: torch.Tensor
    flow_covariance: Optional[torch.Tensor] = None
    flow_covariance_inv: Optional[torch.Tensor] = None
    flow_covariance_log_det: Optional[torch.Tensor] = None


@dataclasses.dataclass
class UFMMaskFieldOutput:
    """Mask prediction. (B, H, W)."""

    mask: torch.Tensor
    logits: Optional[torch.Tensor] = None


@dataclasses.dataclass
class UFMClassificationRefinementOutput:
    """Refinement internals (filled by the UFM-Refine variant)."""

    regression_flow_output: torch.Tensor  # (B, 2, H, W)
    residual: torch.Tensor  # (B, 2, H, W)
    log_softmax: torch.Tensor  # (B, H, W, P, P)
    feature_map_0: torch.Tensor
    feature_map_1: torch.Tensor


@dataclasses.dataclass
class UFMOutputInterface:
    """Top-level output."""

    flow: Optional[UFMFlowFieldOutput] = None
    classification_refinement: Optional[UFMClassificationRefinementOutput] = None
    covisibility: Optional[UFMMaskFieldOutput] = None
    keypoint_confidence: Optional[torch.Tensor] = None


def _to_bchw(image) -> torch.Tensor:
    """Accept BCHW/BHWC/CHW/HWC numpy arrays or tensors, return a BCHW tensor."""
    t = image if isinstance(image, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(image))
    if t.dim() not in (3, 4):
        raise ValueError(f"image must have 3 or 4 dims, got {t.dim()}")
    if t.dim() == 3:
        t = t[None]
    if t.shape[1] == 3:
        pass
    elif t.shape[-1] == 3:
        t = t.permute(0, 3, 1, 2)
    else:
        raise ValueError("images must have 3 channels in either BCHW or BHWC format")
    return t


class UniFlowMatchModelsBase:
    """Prediction API shared by the model variants.

    Subclasses provide ``network_apply(img1_bhwc, img2_bhwc) -> dict`` (the
    network on normalized channel-last inputs), ``data_norm_type`` and
    ``device``.
    """

    def __init__(self, inference_resolution: Optional[Union[List[Tuple[int, int]], Tuple[int, int]]] = None):
        if inference_resolution is None:
            inference_resolution = [(560, 420)]
        if isinstance(inference_resolution[0], int):
            inference_resolution = [tuple(inference_resolution)]
        # (W, H) tuples, the reference convention
        self.inference_resolution = [tuple(r) for r in inference_resolution]
        # settable: crop / composite chains replace it
        self.image_scaler = AutomaticShapeSelection(
            *[ResizeToFixedManipulation((r[1], r[0])) for r in self.inference_resolution],
            strategy="closest_aspect",
        )

    # ---- subclass interface -------------------------------------------------
    @property
    def data_norm_type(self) -> str:
        raise NotImplementedError

    @property
    def device(self) -> torch.device:
        raise NotImplementedError

    def network_apply(self, img1_bhwc: torch.Tensor, img2_bhwc: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Run the network on normalized channel-last inputs; returns the raw
        output dict (see models/network.py)."""
        raise NotImplementedError

    # ---- public API ---------------------------------------------------------
    def predict_correspondences_batched(
        self,
        source_image,
        target_image,
        data_norm_type: Optional[str] = None,
    ) -> UFMOutputInterface:
        """Predict dense correspondences between source and target images.

        Accepts numpy arrays or tensors shaped BCHW/BHWC/CHW/HWC, dtype uint8
        or float32 (float inputs must state their ``data_norm_type``). Returns
        tensors on the model's device: flow (B, 2, H, W) in source-image pixel
        space plus covisibility (B, H, W).
        """
        src = _to_bchw(source_image)
        tgt = _to_bchw(target_image)

        if src.dtype == torch.float32:
            if data_norm_type is None:
                raise ValueError("data_norm_type must be provided for float32 images")
            if data_norm_type not in IMAGE_NORMALIZATION_DICT:
                raise ValueError(f"data_norm_type must be one of {list(IMAGE_NORMALIZATION_DICT)}")
        elif src.dtype == torch.uint8:
            data_norm_type = None
        else:
            raise ValueError("images must be uint8 or float32")

        with torch.inference_mode():
            raw = self._pipeline(src.to(self.device), tgt.to(self.device), data_norm_type)

        result = UFMOutputInterface()
        result.flow = UFMFlowFieldOutput(flow_output=raw["flow"])
        if "flow_covariance" in raw:
            result.flow.flow_covariance = raw["flow_covariance"]
        if "covisibility" in raw:
            result.covisibility = UFMMaskFieldOutput(mask=raw["covisibility"], logits=None)
        if "keypoint_confidence" in raw:
            result.keypoint_confidence = raw["keypoint_confidence"]
        return result

    def _pipeline(self, src_bchw: torch.Tensor, tgt_bchw: torch.Tensor, data_norm_type: Optional[str]):
        h0, w0 = src_bchw.shape[2], src_bchw.shape[3]
        h1, w1 = tgt_bchw.shape[2], tgt_bchw.shape[3]
        shapes, manipulation = self.image_scaler.select(h0, w0, h1, w1)
        if manipulation is None:
            raise ValueError(f"no manipulation accepts inputs {(h0, w0)}/{(h1, w1)}")
        th0, tw0, th1, tw1 = shapes
        if (th0, tw0) != (th1, tw1):
            raise ValueError("both views must map to one model resolution")

        # layout + dtype + normalization
        dev = src_bchw.device
        req = IMAGE_NORMALIZATION_DICT[self.data_norm_type]
        req_mean = torch.from_numpy(req.mean).to(dev)
        req_std = torch.from_numpy(req.std).to(dev)
        src = src_bchw.permute(0, 2, 3, 1)
        tgt = tgt_bchw.permute(0, 2, 3, 1)
        if src.dtype == torch.uint8:
            src = (src.float() / 255.0 - req_mean) / req_std
            tgt = (tgt.float() / 255.0 - req_mean) / req_std
        elif data_norm_type != self.data_norm_type:
            prev = IMAGE_NORMALIZATION_DICT[data_norm_type]
            prev_mean = torch.from_numpy(prev.mean).to(dev)
            prev_std = torch.from_numpy(prev.std).to(dev)
            src = src * (prev_std / req_std) + (prev_mean - req_mean) / req_std
            tgt = tgt * (prev_std / req_std) + (prev_mean - req_mean) / req_std

        # the selected manipulation to the model grid, with region bookkeeping
        src_s, tgt_s, src_region_source, tgt_region_source, src_region_repr, tgt_region_repr = manipulation(
            src,
            tgt,
            _identity_regions(h0, w0),
            _identity_regions(h1, w1),
            _identity_regions(h0, w0),
            _identity_regions(h1, w1),
        )
        raw = self.network_apply(src_s, tgt_s)

        out: Dict[str, torch.Tensor] = {}
        flow_unmapped, _ = unmap_predicted_flow(
            raw["flow"], src_region_repr, tgt_region_repr, src_region_source, tgt_region_source, (h0, w0), (h1, w1)
        )
        out["flow"] = flow_unmapped.permute(0, 3, 1, 2)

        if "flow_cov" in raw:
            cov_unmapped, _ = unmap_predicted_channels(raw["flow_cov"], src_region_repr, src_region_source, (h0, w0))
            w_ratio, h_ratio = w0 / tw0, h0 / th0
            scale = torch.tensor([w_ratio**2, h_ratio**2, w_ratio * h_ratio], dtype=torch.float32, device=dev)
            out["flow_covariance"] = (cov_unmapped * scale).permute(0, 3, 1, 2)

        if "covis_mask" in raw:
            covis_unmapped, _ = unmap_predicted_channels(
                raw["covis_mask"][..., None], src_region_repr, src_region_source, (h0, w0)
            )
            out["covisibility"] = covis_unmapped[..., 0]

        if "keypoint_confidence" in raw:
            conf_unmapped, _ = unmap_predicted_channels(
                raw["keypoint_confidence"][..., None], src_region_repr, src_region_source, (h0, w0)
            )
            out["keypoint_confidence"] = conf_unmapped[..., 0]
        return out
