"""UFM model family, public API (counterpart of ``ufm_tpu/models/ufm.py``).

``UniFlowMatch``, ``UniFlowMatchConfidence`` and
``UniFlowMatchClassificationRefinement`` keep the JAX package's constructor
signatures, ``from_config``, ``forward(view1, view2)`` and
``predict_correspondences_batched``. Each owns a :class:`UFMNet` on one
device. The device is the GPU unless the caller passes ``device="cpu"``;
without a GPU and without that request the model refuses to build rather than
move to the CPU quietly.

Precision: the encoder and info sharing run in ``compute_dtype`` (bf16 for
the flagship: their parameters are stored in bf16, where flax rounds fp32
parameters to bf16 at use), and so does UFM-Refine's UNet; the DPT heads, the
patch-MLP classification head and the window refinement run in fp32. fp32 convolutions on the
card follow PyTorch's default, which lets cuDNN use TF32
(``torch.backends.cudnn.allow_tf32``); fp32 matrix products stay full fp32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.nn as nn

from ufm_torch.models.base import (
    UFMClassificationRefinementOutput,
    UFMFlowFieldOutput,
    UFMMaskFieldOutput,
    UFMOutputInterface,
    UniFlowMatchModelsBase,
)
from ufm_torch.models.config import UFMArchConfig
from ufm_torch.models.network import UFMNet
from ufm_torch.nn.encoders.vit import ViTEncoder
from ufm_torch.nn.info_sharing import MultiViewGlobalAttentionTransformer
from ufm_torch.nn.layers import Attention, LayerScale
from ufm_torch.ops.attention import IMPLS
from ufm_torch.ops.refinement import IMPLS as REFINEMENT_IMPLS

__all__ = ["UniFlowMatch", "UniFlowMatchConfidence", "UniFlowMatchClassificationRefinement", "resolve_device"]


def resolve_device(device: Union[None, str, torch.device] = None) -> torch.device:
    """``None`` means the GPU. Raises when CUDA is absent and the caller did
    not ask for the CPU explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: ufm_torch runs on the GPU by default; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


@torch.no_grad()
def init_weights(net: nn.Module, generator: torch.Generator) -> None:
    """Seeded random init in the JAX package's scheme: dense and conv kernels
    normal with std 1/sqrt(fan_in), biases zero, LayerNorm identity,
    LayerScale at its init value, learned position / view embeddings normal
    with std 0.02, cls token and its position zero. The refinement's
    classification bias is not touched: it stays zero, as flax's ``zeros``
    init leaves it."""
    for m in net.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            w = m.weight
            if isinstance(m, nn.Linear):
                fan_in = w.shape[1]
            elif isinstance(m, nn.ConvTranspose2d):
                fan_in = w.shape[0] * w.shape[2] * w.shape[3]
            else:
                fan_in = w.shape[1] * w.shape[2] * w.shape[3]
            w.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, LayerScale):
            m.gamma.fill_(m.init_value)
        elif isinstance(m, ViTEncoder):
            m.pos_embed.normal_(0.0, 0.02, generator=generator)
            if m.use_cls_token:
                m.cls_token.zero_()
                m.cls_pos_embed.zero_()
        elif isinstance(m, MultiViewGlobalAttentionTransformer):
            m.view_embed.normal_(0.0, 0.02, generator=generator)


class UniFlowMatch(UniFlowMatchModelsBase, nn.Module):
    """Base model: flow (+ optional covisibility from head1 adaptors).

    ``device`` (keyword, default the GPU) places the network.
    """

    def __init__(
        self,
        # Encoder configurations
        encoder_str: str = "dinov2_large",
        encoder_kwargs: Optional[Dict[str, Any]] = None,
        # Info sharing & output head structure
        info_sharing_and_head_structure: str = "dual+single",
        info_sharing_str: str = "global_attention",
        info_sharing_kwargs: Optional[Dict[str, Any]] = None,
        # Skip-connections (accepted for config compatibility; unused)
        encoder_skip_connection: Optional[List[int]] = None,
        info_sharing_skip_connection: Optional[List[int]] = None,
        # Prediction heads & adaptors
        head_type: str = "dpt",
        feature_head_kwargs: Optional[Dict[str, Any]] = None,
        adaptors_kwargs: Optional[Dict[str, Any]] = None,
        # Pretrained weights
        pretrained_checkpoint_path: Optional[str] = None,
        # Inference settings
        inference_resolution: Optional[Union[Tuple[int, int], List[Tuple[int, int]]]] = (560, 420),
        compute_dtype: str = "bfloat16",
        **extra_config,
    ):
        nn.Module.__init__(self)
        UniFlowMatchModelsBase.__init__(self, inference_resolution=inference_resolution)
        device = resolve_device(extra_config.pop("device", None))
        if pretrained_checkpoint_path is not None:
            raise NotImplementedError(
                "loading checkpoints is not ported yet (ROADMAP.md Queue 1, checkpoint/); "
                "JAX parameters load with ufm_torch.checkpoint.load_jax_params"
            )
        fields = {f.name for f in dataclasses.fields(UFMArchConfig)}
        self.config = UFMArchConfig(
            encoder_str=encoder_str,
            encoder_kwargs=dict(encoder_kwargs or {}),
            info_sharing_and_head_structure=info_sharing_and_head_structure,
            info_sharing_str=info_sharing_str,
            info_sharing_kwargs=dict(info_sharing_kwargs or {}),
            head_type=head_type,
            feature_head_kwargs=dict(feature_head_kwargs or {}),
            adaptors_kwargs=dict(adaptors_kwargs or {}),
            inference_resolution=self.inference_resolution,
            compute_dtype=compute_dtype,
            **{k: v for k, v in extra_config.items() if k in fields},
        )
        self.encoder_skip_connection = encoder_skip_connection
        self.info_sharing_skip_connection = info_sharing_skip_connection
        with torch.device(device):
            self.net = UFMNet(self.config)
        self._attention_impl: Optional[str] = None

    # ---- construction -------------------------------------------------------
    @classmethod
    def from_config(
        cls,
        config: Union[UFMArchConfig, Dict[str, Any]],
        seed: int = 0,
        device: Union[None, str, torch.device] = None,
    ) -> "UniFlowMatch":
        """Build from a config with seeded random weights on ``device``
        (default: the GPU)."""
        if isinstance(config, UFMArchConfig):
            config = config.to_dict()
        model = cls(**config, device=device)
        model.init_params(seed)
        return model

    def init_params(self, seed: int = 0) -> None:
        """Seeded random weights from a ``torch.Generator`` on the model's
        device (the values differ from the JAX package's init)."""
        generator = torch.Generator(device=self.device).manual_seed(seed)
        init_weights(self.net, generator)

    @property
    def device(self) -> torch.device:
        return next(self.net.parameters()).device

    @property
    def data_norm_type(self) -> str:
        return self.config.encoder_kwargs.get("data_norm_type", "dinov2")

    @property
    def attention_impl(self) -> Optional[str]:
        """The attention implementation every transformer block requests:
        ``None`` (the tensors' device decides: the Hopper kernel on the GPU),
        ``"cuda"`` or ``"torch"`` (the plain version, for checks)."""
        return self._attention_impl

    @attention_impl.setter
    def attention_impl(self, impl: Optional[str]) -> None:
        if impl is not None and impl not in IMPLS:
            raise ValueError(f"unknown attention impl {impl!r} (expected one of {IMPLS} or None)")
        for m in self.net.modules():
            if isinstance(m, Attention):
                m.impl = impl
        self._attention_impl = impl

    @property
    def refinement_impl(self) -> Optional[str]:
        """The window-refinement implementation the refinement stage requests
        (UFM-Refine): ``None`` (the tensors' device decides: the Hopper kernel
        on the GPU), ``"cuda"`` or ``"torch"`` (the plain version, for
        checks). It starts from the config's ``refinement_impl``: ``"auto"``
        is ``None``, ``"pallas"`` is ``"cuda"`` and ``"xla"`` is ``"torch"``."""
        return getattr(self.net, "refinement_impl", None)

    @refinement_impl.setter
    def refinement_impl(self, impl: Optional[str]) -> None:
        if not self.config.has_classification_head:
            raise ValueError("refinement_impl needs a model with the refinement stage (UFM-Refine)")
        if impl is not None and impl not in REFINEMENT_IMPLS:
            raise ValueError(f"unknown refinement impl {impl!r} (expected one of {REFINEMENT_IMPLS} or None)")
        self.net.refinement_impl = impl

    # ---- forward ------------------------------------------------------------
    def network_apply(self, img1_bhwc: torch.Tensor, img2_bhwc: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.net(img1_bhwc, img2_bhwc)

    def forward(self, view1: Dict[str, Any], view2: Dict[str, Any]) -> UFMOutputInterface:
        """Reference forward contract: views are dicts with ``img``
        (B, C, H, W) normalized, optional ``instance`` ids and ``symmetrized``
        flag. Returns :class:`UFMOutputInterface` in BCHW."""
        img1 = torch.as_tensor(view1["img"], device=self.device).permute(0, 2, 3, 1)
        img2 = torch.as_tensor(view2["img"], device=self.device).permute(0, 2, 3, 1)
        symmetrized = bool(view1.get("symmetrized", False))
        return self._raw_to_interface(self.net(img1, img2, symmetrized=symmetrized))

    def _raw_to_interface(self, raw: Dict[str, torch.Tensor]) -> UFMOutputInterface:
        result = UFMOutputInterface()
        result.flow = UFMFlowFieldOutput(flow_output=raw["flow"].permute(0, 3, 1, 2))
        if "flow_cov" in raw:
            result.flow.flow_covariance = raw["flow_cov"].permute(0, 3, 1, 2)
            result.flow.flow_covariance_inv = raw["flow_cov_inv"].permute(0, 3, 1, 2)
            result.flow.flow_covariance_log_det = raw["flow_cov_log_det"]
        if "covis_mask" in raw:
            result.covisibility = UFMMaskFieldOutput(mask=raw["covis_mask"], logits=raw["covis_logits"])
        if "keypoint_confidence" in raw:
            result.keypoint_confidence = raw["keypoint_confidence"]
        if "refinement_residual" in raw:
            result.classification_refinement = UFMClassificationRefinementOutput(
                regression_flow_output=raw["regression_flow"].permute(0, 3, 1, 2),
                residual=raw["refinement_residual"].permute(0, 3, 1, 2),
                log_softmax=raw["refinement_log_softmax"],
                feature_map_0=raw["refinement_feature_map_0"].permute(0, 3, 1, 2),
                feature_map_1=raw["refinement_feature_map_1"].permute(0, 3, 1, 2),
            )
        return result


class UniFlowMatchConfidence(UniFlowMatch):
    """UFM-Base: adds the uncertainty head (covariance, keypoint confidence,
    covisibility)."""

    def __init__(
        self,
        encoder_str: str = "dinov2_large",
        encoder_kwargs: Optional[Dict[str, Any]] = None,
        info_sharing_and_head_structure: str = "dual+single",
        info_sharing_str: str = "global_attention",
        info_sharing_kwargs: Optional[Dict[str, Any]] = None,
        head_type: str = "dpt",
        feature_head_kwargs: Optional[Dict[str, Any]] = None,
        adaptors_kwargs: Optional[Dict[str, Any]] = None,
        detach_uncertainty_head: bool = True,
        uncertainty_head_type: str = "dpt",
        uncertainty_head_kwargs: Optional[Dict[str, Any]] = None,
        uncertainty_adaptors_kwargs: Optional[Dict[str, Any]] = None,
        pretrained_backbone_checkpoint_path: Optional[str] = None,
        pretrained_checkpoint_path: Optional[str] = None,
        inference_resolution: Optional[Union[Tuple[int, int], List[Tuple[int, int]]]] = (560, 420),
        **extra_config,
    ):
        if pretrained_checkpoint_path is not None:
            raise NotImplementedError("Pretrained weights are not supported for now")
        for k in ("has_uncertainty_head", "has_classification_head"):
            extra_config.pop(k, None)
        super().__init__(
            encoder_str=encoder_str,
            encoder_kwargs=encoder_kwargs,
            info_sharing_and_head_structure=info_sharing_and_head_structure,
            info_sharing_str=info_sharing_str,
            info_sharing_kwargs=info_sharing_kwargs,
            head_type=head_type,
            feature_head_kwargs=feature_head_kwargs,
            adaptors_kwargs=adaptors_kwargs,
            pretrained_checkpoint_path=pretrained_backbone_checkpoint_path,
            inference_resolution=inference_resolution,
            has_uncertainty_head=True,
            detach_uncertainty_head=detach_uncertainty_head,
            uncertainty_head_type=uncertainty_head_type,
            uncertainty_head_kwargs=dict(uncertainty_head_kwargs or {}),
            uncertainty_adaptors_kwargs=dict(uncertainty_adaptors_kwargs or {}),
            **extra_config,
        )


class UniFlowMatchClassificationRefinement(UniFlowMatch):
    """UFM-Refine: UFM-Base's backbone and heads plus the classification
    refinement (patch-MLP features, optional UNet fine features, a P x P
    window attention around the regression flow that adds a residual). The
    uncertainty head is built when ``uncertainty_head_kwargs`` is given.

    The config's ``refinement_impl`` picks the window implementation:
    ``"auto"`` lets the tensors' device decide (the Hopper kernel on the GPU,
    the plain version on the CPU), ``"pallas"`` asks for the kernel and
    ``"xla"`` for the plain version (see :attr:`refinement_impl`).
    ``refinement_matmul_precision`` is accepted and has no effect: its
    ``"default"`` is the TPU matrix unit's bf16 operand rounding, and the
    port's kernel is fp32 throughout.
    """

    def __init__(
        self,
        encoder_str: str = "dinov2_large",
        encoder_kwargs: Optional[Dict[str, Any]] = None,
        info_sharing_and_head_structure: str = "dual+single",
        info_sharing_str: str = "global_attention",
        info_sharing_kwargs: Optional[Dict[str, Any]] = None,
        head_type: str = "dpt",
        feature_head_kwargs: Optional[Dict[str, Any]] = None,
        adaptors_kwargs: Optional[Dict[str, Any]] = None,
        detach_uncertainty_head: bool = True,
        uncertainty_head_type: str = "dpt",
        uncertainty_head_kwargs: Optional[Dict[str, Any]] = None,
        uncertainty_adaptors_kwargs: Optional[Dict[str, Any]] = None,
        temperature: float = 4,
        use_unet_feature: bool = False,
        classification_head_type: str = "patch_mlp",
        classification_head_kwargs: Optional[Dict[str, Any]] = None,
        feature_combine_method: str = "conv",
        refinement_range: int = 5,
        pretrained_backbone_checkpoint_path: Optional[str] = None,
        pretrained_checkpoint_path: Optional[str] = None,
        inference_resolution: Optional[Union[Tuple[int, int], List[Tuple[int, int]]]] = (560, 420),
        **extra_config,
    ):
        if pretrained_checkpoint_path is not None:
            raise NotImplementedError("Pretrained weights are not supported for now")
        for k in ("has_uncertainty_head", "has_classification_head"):
            extra_config.pop(k, None)
        super().__init__(
            encoder_str=encoder_str,
            encoder_kwargs=encoder_kwargs,
            info_sharing_and_head_structure=info_sharing_and_head_structure,
            info_sharing_str=info_sharing_str,
            info_sharing_kwargs=info_sharing_kwargs,
            head_type=head_type,
            feature_head_kwargs=feature_head_kwargs,
            adaptors_kwargs=adaptors_kwargs,
            pretrained_checkpoint_path=pretrained_backbone_checkpoint_path,
            inference_resolution=inference_resolution,
            has_uncertainty_head=bool(uncertainty_head_kwargs),
            detach_uncertainty_head=detach_uncertainty_head,
            uncertainty_head_type=uncertainty_head_type,
            uncertainty_head_kwargs=dict(uncertainty_head_kwargs or {}),
            uncertainty_adaptors_kwargs=dict(uncertainty_adaptors_kwargs or {}),
            has_classification_head=True,
            classification_head_type=classification_head_type,
            classification_head_kwargs=dict(classification_head_kwargs or {}),
            temperature=temperature,
            use_unet_feature=use_unet_feature,
            feature_combine_method=feature_combine_method,
            refinement_range=refinement_range,
            **extra_config,
        )
