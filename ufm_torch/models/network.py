"""The UFM network: encode -> info-share -> DPT heads -> refinement.

Counterpart of ``ufm_tpu/models/network.py``:

  1. both views are concatenated into one 2B batch for a single encoder pass,
     in the compute dtype (bf16 for the flagship), so every encoder attention
     call sees the (2B, S, H, D) shapes the TPU kernel saw;
  2. the last encoder level of both views goes through the two-view
     global-attention info-sharing transformer, which returns the final map
     plus two intermediate taps per view;
  3. a 4-level pyramid [encoder_last, tap0, tap1, final] of view 0, cast to
     fp32, feeds the DPT flow head and the DPT uncertainty head (covariance,
     keypoint confidence, covisibility);
  4. (UFM-Refine) patch-MLP classification features, optionally combined
     with UNet fine features, drive the fused window refinement
     (:func:`ufm_torch.ops.refinement.fused_refinement_attention`: the Hopper
     kernel on the GPU), which adds a residual to the regression flow.

All maps are channel-last; the output is a flat dict of tensors.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ufm_torch.models.config import UFMArchConfig
from ufm_torch.nn.encoders import (
    _BENIGN_CONFIG_KEYS,
    ViTEncoderInput,
    feature_returner_encoder_factory,
    module_fields,
)
from ufm_torch.nn.info_sharing import INFO_SHARING_CLASSES, MultiViewTransformerInput
from ufm_torch.nn.layers import as_dtype
from ufm_torch.nn.prediction_heads import (
    AdaptorMap,
    ConfidenceAdaptor,
    Covariance2DAdaptor,
    DPTFeature,
    DPTRegressionProcessor,
    FlowAdaptor,
    FlowWithConfidenceAdaptor,
    MaskAdaptor,
    MLPFeature,
    MoGeConvFeature,
    PredictionHeadInput,
    PredictionHeadLayeredInput,
)
from ufm_torch.nn.unet import UNet
from ufm_torch.ops.refinement import fused_refinement_attention
from ufm_torch.utils import profiling

__all__ = ["UFMNet", "CLASSNAME_TO_ADAPTOR_CLASS", "REFINEMENT_IMPL_FROM_CONFIG", "interleave", "is_symmetrized"]

CLASSNAME_TO_ADAPTOR_CLASS = {
    "FlowWithConfidenceAdaptor": FlowWithConfidenceAdaptor,
    "FlowAdaptor": FlowAdaptor,
    "MaskAdaptor": MaskAdaptor,
    "Covariance2DAdaptor": Covariance2DAdaptor,
    "ConfidenceAdaptor": ConfidenceAdaptor,
}

# a config's ``refinement_impl`` (the JAX package's names) -> the port's impl:
# "auto" lets the tensors' device decide; "pallas" asks for the kernel and
# "xla" for the plain version, explicitly
REFINEMENT_IMPL_FROM_CONFIG = {"auto": None, "pallas": "cuda", "xla": "torch"}


def is_symmetrized(gt1: Dict[str, Any], gt2: Dict[str, Any]) -> bool:
    """Detect (a,b),(b,a)-interleaved batches by instance ids."""
    x = gt1["instance"]
    y = gt2["instance"]
    if len(x) == len(y) and len(x) == 1:
        return False
    ok = True
    for i in range(0, len(x), 2):
        ok = ok and (x[i] == y[i + 1]) and (x[i + 1] == y[i])
    return ok


def interleave(t1: torch.Tensor, t2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Re-expand per-pair features to the interleaved layout."""
    r1 = torch.stack([t1, t2], dim=1).reshape(-1, *t1.shape[1:])
    r2 = torch.stack([t2, t1], dim=1).reshape(-1, *t1.shape[1:])
    return r1, r2


def _filter_kwargs(cls, kwargs: Dict[str, Any]) -> Dict[str, Any]:
    known = module_fields(cls)
    unknown = set(kwargs) - known - _BENIGN_CONFIG_KEYS
    if unknown:
        # an unknown load-bearing key silently dropped would build a wrong
        # network that still loads the checkpoint: hard-fail, like the encoder
        # factory does
        raise ValueError(
            f"{cls.__name__} config carries load-bearing options this implementation "
            f"does not support: {sorted(unknown)}. Refusing to build a silently-wrong "
            f"architecture; supported fields: {sorted(known)}."
        )
    return {k: v for k, v in kwargs.items() if k in known}


def _build_adaptor_map(adaptors_kwargs: Dict[str, Any]) -> AdaptorMap:
    adaptors = []
    for name, spec in adaptors_kwargs.items():
        cls = CLASSNAME_TO_ADAPTOR_CLASS[spec["class"]]
        adaptors.append(cls(name=name, **spec.get("kwargs", {})))
    return AdaptorMap(*adaptors)


class _DPTHead(nn.Module):
    """DPTFeature + DPTRegressionProcessor pipeline."""

    def __init__(self, feature_kwargs: Dict[str, Any], processor_kwargs: Dict[str, Any]):
        super().__init__()
        self.feature = DPTFeature(**_filter_kwargs(DPTFeature, feature_kwargs))
        self.processor = DPTRegressionProcessor(**_filter_kwargs(DPTRegressionProcessor, processor_kwargs))

    def forward(self, inp: PredictionHeadLayeredInput):
        return self.processor(self.feature(inp), inp.target_output_shape)


def _make_head(head_type: str, head_kwargs: Dict[str, Any]) -> nn.Module:
    if head_type == "dpt":
        return _DPTHead(head_kwargs.get("dpt_feature", {}), head_kwargs.get("dpt_processor", {}))
    if head_type == "moge_conv":
        return MoGeConvFeature(**_filter_kwargs(MoGeConvFeature, head_kwargs))
    raise ValueError(f"Head type {head_type} not supported.")


class UFMNet(nn.Module):
    """Encoder, info sharing, DPT heads and (UFM-Refine) the refinement stage
    of one UFM config. The backbone and the UNet run in ``cfg.compute_dtype``;
    the heads and the refinement are always fp32.

    ``refinement_impl`` is the refinement implementation to request (``None``,
    ``"cuda"`` or ``"torch"``, see :func:`fused_refinement_attention`); it
    starts from the config's ``refinement_impl``
    (:data:`REFINEMENT_IMPL_FROM_CONFIG`).

    ``storage_generation`` counts the moves of the parameters' storage
    (``.to()`` and its kin, ``load_state_dict(assign=True)``): a model drops
    its captured predict programs, which hold the old addresses, when it
    changes. In-place updates (``copy_``) keep it."""

    def __init__(self, cfg: UFMArchConfig):
        super().__init__()
        self.storage_generation = 0
        if cfg.info_sharing_and_head_structure != "dual+single":
            raise ValueError("Only dual+single is supported")
        self.cfg = cfg
        dt = as_dtype(cfg.compute_dtype)
        # training memory knob (no effect on a forward without grad):
        # True / "all" checkpoints the blocks of both stacks, "encoder" only
        # the encoder's, keeping what train_remat_policy saves, as
        # ufm_tpu/models/network.py does
        if cfg.train_remat not in (False, True, "all", "encoder"):
            raise ValueError(f"unknown train_remat {cfg.train_remat!r} (expected False, True, 'all' or 'encoder')")
        remat = {"remat": True, "remat_policy": cfg.train_remat_policy or None}
        remat_enc = remat if cfg.train_remat in (True, "all", "encoder") else {}
        remat_info = remat if cfg.train_remat in (True, "all") else {}
        self.encoder = feature_returner_encoder_factory(cfg.encoder_str, dtype=dt, **{**cfg.encoder_kwargs, **remat_enc})
        info_cls = INFO_SHARING_CLASSES[cfg.info_sharing_str][1]
        info_kwargs = _filter_kwargs(info_cls, cfg.info_sharing_kwargs)
        self.info_sharing = info_cls(dtype=dt, **{**info_kwargs, **remat_info})

        self.head1 = _make_head(cfg.head_type, cfg.feature_head_kwargs)
        self._head1_adaptors = _build_adaptor_map(cfg.adaptors_kwargs)
        if cfg.has_uncertainty_head:
            if cfg.uncertainty_head_type != "dpt":
                raise ValueError("Only DPT is supported for the uncertainty head")
            self.uncertainty_head = _make_head("dpt", cfg.uncertainty_head_kwargs)
            self._uncertainty_adaptors = _build_adaptor_map(cfg.uncertainty_adaptors_kwargs)

        if cfg.has_classification_head:
            if cfg.classification_head_type != "patch_mlp":
                raise NotImplementedError(
                    f"classification head {cfg.classification_head_type!r} is not supported (only 'patch_mlp')"
                )
            if cfg.refinement_impl not in REFINEMENT_IMPL_FROM_CONFIG:
                raise ValueError(
                    f"unknown refinement_impl {cfg.refinement_impl!r} (expected one of {list(REFINEMENT_IMPL_FROM_CONFIG)})"
                )
            self.refinement_impl = REFINEMENT_IMPL_FROM_CONFIG[cfg.refinement_impl]
            self.classification_head = MLPFeature(**_filter_kwargs(MLPFeature, cfg.classification_head_kwargs))
            p = cfg.refinement_range
            self.classification_bias = nn.Parameter(torch.zeros(p * p))
            if cfg.use_unet_feature:
                if cfg.feature_combine_method not in ("conv", "modulate"):
                    raise ValueError(f"unknown feature_combine_method: {cfg.feature_combine_method}")
                # the reference runs the UNet outside the heads' fp32 block:
                # it gets the backbone's compute dtype
                self.unet_feature = UNet(**{"dtype": dt, **_filter_kwargs(UNet, cfg.unet_kwargs)})
                out_c = self.classification_head.output_dim
                if cfg.feature_combine_method == "conv":
                    self.conv1 = nn.Conv2d(out_c + self.unet_feature.final.out_channels, 2 * out_c, 1)
                    self.conv2 = nn.Conv2d(2 * out_c, out_c, 1)
                else:  # "modulate": conv1 is never called, so flax makes no parameters for it
                    self.conv2 = nn.Conv2d(out_c, out_c, 1)

    def _apply(self, fn, *args, **kwargs):
        self.storage_generation += 1
        return super()._apply(fn, *args, **kwargs)

    def _load_from_state_dict(self, state_dict, prefix, local_metadata, *args, **kwargs):
        # called for this module whichever module's load_state_dict recursed here
        if local_metadata.get("assign_to_params_buffers", False):
            self.storage_generation += 1
        return super()._load_from_state_dict(state_dict, prefix, local_metadata, *args, **kwargs)

    # ---- encoding -----------------------------------------------------------
    def _encode_image_pairs(self, img1: torch.Tensor, img2: torch.Tensor):
        """One encoder pass over the concatenated 2B batch."""
        if img1.shape[1:3] != img2.shape[1:3]:
            raise ValueError("Unequal image sizes are not supported")
        stacked = torch.cat([img1, img2], dim=0)
        outputs = self.encoder(
            ViTEncoderInput(image=stacked, data_norm_type=self.cfg.encoder_kwargs.get("data_norm_type", "dinov2"))
        )
        b = img1.shape[0]
        return [o.features[:b] for o in outputs], [o.features[b:] for o in outputs]

    def _encode_symmetrized(self, img1, img2, symmetrized: bool):
        """Symmetric-pair dedup: encode each unique pair once, then mirror."""
        if symmetrized:
            f1_half, f2_half = self._encode_image_pairs(img1[::2], img2[::2])
            feat1, feat2 = [], []
            for a, b_ in zip(f1_half, f2_half):
                a2, b2 = interleave(a, b_)
                feat1.append(a2)
                feat2.append(b2)
            return feat1, feat2
        return self._encode_image_pairs(img1, img2)

    # ---- forward ------------------------------------------------------------
    def forward(self, img1: torch.Tensor, img2: torch.Tensor, symmetrized: bool = False) -> Dict[str, torch.Tensor]:
        """img1/img2: (B, H, W, 3) normalized. Returns a flat output dict."""
        out = self.backbone(img1, img2, symmetrized)
        if self.cfg.has_classification_head:
            out.update(self.refine_tail(img1, img2, out["flow"], out.pop("cls_in_0"), out.pop("cls_in_1")))
        return out

    def backbone(self, img1: torch.Tensor, img2: torch.Tensor, symmetrized: bool = False) -> Dict[str, torch.Tensor]:
        """Encoder -> info sharing -> DPT heads; ``out["flow"]`` is the
        regression flow. Refine configs also get the two classification-feature
        inputs ``cls_in_0/1`` for :meth:`refine_tail`."""
        with profiling.span("net.encoder"):
            feat1_list, feat2_list = self._encode_symmetrized(img1, img2, symmetrized)
        with profiling.span("net.info_sharing"):
            final, intermediates = self.info_sharing(
                MultiViewTransformerInput(features=[feat1_list[-1], feat2_list[-1]])
            )
        with profiling.span("net.heads"):
            return self._heads((img1.shape[1], img1.shape[2]), feat1_list, feat2_list, final, intermediates)

    def _heads(self, shape1, feat1_list, feat2_list, final, intermediates) -> Dict[str, torch.Tensor]:
        """The DPT heads on the pyramid of view 0 (and the classification
        inputs): :meth:`backbone` after info sharing."""
        c = self.cfg
        pyr1: List[torch.Tensor] = [
            feat1_list[-1].float(),
            intermediates[0].features[0].float(),
            intermediates[1].features[0].float(),
            final.features[0].float(),
        ]
        out: Dict[str, torch.Tensor] = {}

        head1_out = self._head1_adaptors(
            self.head1(PredictionHeadLayeredInput(list_features=pyr1, target_output_shape=shape1))
        )
        flow = head1_out["flow"].value  # (B, H, W, 2)
        if "flow_cov" in head1_out:
            out["flow_cov"] = head1_out["flow_cov"].covariance
            out["flow_cov_inv"] = head1_out["flow_cov"].inv_covariance
            out["flow_cov_log_det"] = head1_out["flow_cov"].log_det
        if "non_occluded_mask" in head1_out:
            out["covis_mask"] = head1_out["non_occluded_mask"].mask
            out["covis_logits"] = head1_out["non_occluded_mask"].logits

        if c.has_uncertainty_head:
            pyr_unc = [f.detach() for f in pyr1] if c.detach_uncertainty_head else pyr1
            unc_out = self._uncertainty_adaptors(
                self.uncertainty_head(PredictionHeadLayeredInput(list_features=pyr_unc, target_output_shape=shape1))
            )
            if "flow_cov" in unc_out:
                out["flow_cov"] = unc_out["flow_cov"].covariance
                out["flow_cov_inv"] = unc_out["flow_cov"].inv_covariance
                out["flow_cov_log_det"] = unc_out["flow_cov"].log_det
            if "keypoint_confidence" in unc_out:
                out["keypoint_confidence"] = unc_out["keypoint_confidence"].value[..., 0]
            if "non_occluded_mask" in unc_out:
                out["covis_mask"] = unc_out["non_occluded_mask"].mask
                out["covis_logits"] = unc_out["non_occluded_mask"].logits

        if c.has_classification_head:
            # low-level + globally shared features of each view
            out["cls_in_0"] = torch.cat([feat1_list[0].float(), pyr1[-1]], dim=-1)
            out["cls_in_1"] = torch.cat([feat2_list[0].float(), final.features[1].float()], dim=-1)

        out["flow"] = flow
        return out

    def refine_tail(
        self,
        img1: torch.Tensor,
        img2: torch.Tensor,
        flow: torch.Tensor,
        cls_in_0: torch.Tensor,
        cls_in_1: torch.Tensor,
    ) -> Dict[str, torch.Tensor]:
        """The classification refinement: patch-MLP features (+ UNet fine
        features) -> fused window attention -> flow residual. ``flow`` is the
        regression flow from :meth:`backbone`."""
        c = self.cfg
        with profiling.span("net.refine"):
            cls_features = self.classification_head(
                PredictionHeadInput(last_feature=torch.cat([cls_in_0, cls_in_1], dim=0))
            ).decoded_channels

            if c.use_unet_feature:
                unet_feat = self.unet_feature(torch.cat([img1, img2], dim=0)).float()
                if c.feature_combine_method == "conv":
                    combined = torch.cat([cls_features, unet_feat], dim=-1)
                    cls_features = self.conv2(F.relu(self.conv1(combined.permute(0, 3, 1, 2))))
                else:  # "modulate"
                    cls_features = self.conv2((cls_features * torch.tanh(unet_feat)).permute(0, 3, 1, 2))
                cls_features = cls_features.permute(0, 2, 3, 1)

            b = img1.shape[0]
            cls_feat_0, cls_feat_1 = cls_features[:b], cls_features[b:]
            residual, log_softmax = fused_refinement_attention(
                cls_feat_0, cls_feat_1, flow, self.classification_bias, c.temperature, c.refinement_range,
                impl=self.refinement_impl,
            )
            return {
                "regression_flow": flow,
                "flow": flow + residual,
                "refinement_residual": residual,
                "refinement_log_softmax": log_softmax,
                "refinement_feature_map_0": cls_feat_0,
                "refinement_feature_map_1": cls_feat_1,
            }
