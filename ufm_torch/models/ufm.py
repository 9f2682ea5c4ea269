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
TF32 moves the flagship's flow by 0.0011 px EPE on average (0.0049 px at
most) on a 480x640 request, far inside the 0.1 px budget (``chip_smoke.py``'s
``tf32`` phase on an H100), so it stays on.

Checkpoints: ``from_pretrained`` / ``save_pretrained`` /
``from_pretrained_ckpt`` (:mod:`ufm_torch.checkpoint.io`) and the
constructors' ``pretrained_checkpoint_path`` (Lightning checkpoints).
``python -m ufm_torch.models.ufm`` is the golden-image check.
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
    with std 0.02, cls token and its position zero, register tokens normal
    with std 1e-6 (DINOv2's init; the JAX package has none). The refinement's
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
            if m.num_register_tokens:
                m.register_tokens.normal_(0.0, 1e-6, generator=generator)
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

        if pretrained_checkpoint_path is not None:
            from ufm_torch.checkpoint import load_torch_checkpoint_into

            self.init_params()  # what the checkpoint does not hold keeps the seeded init
            load_torch_checkpoint_into(self, pretrained_checkpoint_path)

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

    @classmethod
    def from_pretrained(
        cls, pretrained_model_name_or_path: str, device: Union[None, str, torch.device] = None
    ) -> "UniFlowMatch":
        """Load from a local directory (``config.json`` plus ``params.msgpack``,
        ``model.safetensors`` or ``pytorch_model.bin``) onto ``device``
        (default: the GPU). Nothing is downloaded."""
        from ufm_torch.checkpoint import load_pretrained

        return load_pretrained(cls, pretrained_model_name_or_path, device=device)

    @classmethod
    def from_pretrained_ckpt(
        cls, pretrained_model_name_or_path: str, strict: bool = True, device: Union[None, str, torch.device] = None
    ) -> "UniFlowMatch":
        """Load from a torch checkpoint with embedded ``model_args`` (unpickled:
        trusted files only)."""
        from ufm_torch.checkpoint import load_pretrained_ckpt

        return load_pretrained_ckpt(cls, pretrained_model_name_or_path, strict=strict, device=device)

    def save_pretrained(self, save_directory: str) -> None:
        """Write ``config.json`` and ``model.safetensors`` (fp32), readable by
        this package and by the JAX package's ``from_pretrained``."""
        from ufm_torch.checkpoint import save_pretrained

        save_pretrained(self, save_directory)

    def get_parameter_groups(self) -> Dict[str, Dict[str, nn.Parameter]]:
        """Parameters by group for per-group optimizer settings, with the JAX
        package's group keys: ``{group: {name: parameter}}``, names relative
        to ``self.net``; every parameter is in exactly one group."""
        tops = {name.split(".")[0] for name, _ in self.net.named_parameters()}
        members = {"encoder": ["encoder"], "info_sharing": ["info_sharing"], "output_head": ["head1"]}
        if "uncertainty_head" in tops:
            members["uncertainty_head"] = ["uncertainty_head"]
        if "classification_head" in tops:
            members["classification_head"] = ["classification_head"]
        if "unet_feature" in tops:
            members["unet_feature"] = [k for k in ("unet_feature", "conv1", "conv2", "classification_bias") if k in tops]
        elif "classification_bias" in tops:
            members["classification_head"] = ["classification_head", "classification_bias"]
        group_of = {top: group for group, keys in members.items() for top in keys}
        groups: Dict[str, Dict[str, nn.Parameter]] = {group: {} for group in members}
        for name, p in self.net.named_parameters():
            groups[group_of[name.split(".")[0]]][name] = p
        return groups

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

    def _program_key(self) -> tuple:
        return (self.attention_impl, self.refinement_impl)

    def _storage_generation(self) -> int:
        return self.net.storage_generation

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


def _golden_image_main(argv: Optional[List[str]] = None) -> str:
    """Golden-image check: ``python -m ufm_torch.models.ufm``.

    Runs a model on a bundled example pair (analytic ground-truth flow,
    ``ufm_torch.utils.example_pairs``) and writes a 2x3 panel: source /
    target / flow color (top), covisibility / covisibility-masked warped
    target / EPE heatmap (bottom), plus a JSON sidecar with the mean and p90
    EPE. A pair without ground truth (the reference's photo pairs, where
    ``UFM_REFERENCE_PAIRS`` names them) is scored by forward-backward cycle
    consistency instead. With seeded random weights the panel only shows the
    pipeline end to end. Runs on the GPU unless ``--device cpu``; the panel is
    a PNG written by the port's codec (``cv2`` only resizes a target of
    another size than the source for display).
    """
    import argparse
    import json

    import numpy as np

    parser = argparse.ArgumentParser(description=_golden_image_main.__doc__)
    parser.add_argument("--model", choices=("base", "refine"), default="base")
    parser.add_argument("--checkpoint", default=None, help="config.json + weights dir (else seeded random init)")
    parser.add_argument("--pair", default="wide_baseline", help="bundled pair name, or a reference photo pair")
    parser.add_argument("--output", default="ufm_output.png")
    parser.add_argument("--tiny", action="store_true", help="tiny seeded topology (smoke check; no checkpoint)")
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = parser.parse_args(argv)

    from ufm_torch.eval import cycle_consistency_metrics
    from ufm_torch.models.config import ufm_base_config, ufm_refine_config, ufm_tiny_config
    from ufm_torch.models.tiled import flow_and_covisibility
    from ufm_torch.utils.example_pairs import (
        REFERENCE_PAIR_NAMES,
        ensure_bundled_pairs,
        load_pair,
        reference_pair_dir,
    )
    from ufm_torch.utils.image_io import write_png
    from ufm_torch.utils.viz import flow_to_color, warp_image_with_flow

    cls = UniFlowMatchClassificationRefinement if args.model == "refine" else UniFlowMatchConfidence
    if args.checkpoint:
        model = cls.from_pretrained(args.checkpoint, device=args.device)
    elif args.tiny:
        model = cls.from_config(ufm_tiny_config(has_classification_head=args.model == "refine"), device=args.device)
    else:
        print("No --checkpoint given: using seeded random weights.")
        config = ufm_refine_config() if args.model == "refine" else ufm_base_config()
        model = cls.from_config(config, device=args.device)

    if args.pair in REFERENCE_PAIR_NAMES:
        pair_dir = reference_pair_dir()
        if pair_dir is None:
            parser.error(f"--pair {args.pair} is a reference photo pair: set UFM_REFERENCE_PAIRS to their directory")
    else:
        pair_dir = ensure_bundled_pairs()
    src, tgt, gt = load_pair(pair_dir, args.pair)

    flow, covis = flow_and_covisibility(model.predict_correspondences_batched(source_image=src, target_image=tgt))
    flow, covis = flow[0], covis[0]

    def err_heatmap(err, full_scale):
        vis = np.clip(err / full_scale, 0.0, 1.0)
        return (np.stack([np.ones_like(vis), 1.0 - vis, 1.0 - vis], axis=-1) * 255).astype(np.uint8)

    if gt is not None:
        epe = np.linalg.norm(flow - gt, axis=-1)
        print(f"EPE vs analytic ground truth: mean {epe.mean():.3f} px, p90 {np.percentile(epe, 90):.3f} px")
        err_rgb = err_heatmap(epe, 8.0)
        stats = {"epe_mean_px": float(epe.mean()), "epe_p90_px": float(np.percentile(epe, 90))}
    else:
        bwd, _ = flow_and_covisibility(model.predict_correspondences_batched(source_image=tgt, target_image=src))
        m, cyc = cycle_consistency_metrics(flow, bwd[0], covis, return_map=True)
        print(
            "Cycle consistency (no ground truth): "
            f"mean {m.get('cycle_epe', float('nan')):.3f} px, median {m.get('cycle_epe_median', float('nan')):.3f} px "
            f"over {100 * m['cycle_coverage']:.1f}% of pixels"
        )
        err_rgb = err_heatmap(cyc, 8.0)
        stats = {k: float(v) for k, v in m.items()}

    warped = warp_image_with_flow(src, None, tgt, flow).astype(np.float32)
    alpha = covis[..., None]
    composite = (alpha * warped + (1.0 - alpha) * 255.0).astype(np.uint8)
    covis_rgb = np.repeat((covis * 255).astype(np.uint8)[..., None], 3, axis=-1)
    # the panel is laid out in the source frame; a target of another size is resized for display
    if tgt.shape[:2] == src.shape[:2]:
        tgt_disp = tgt
    else:
        import cv2

        tgt_disp = cv2.resize(tgt, (src.shape[1], src.shape[0]))
    top = np.concatenate([src, tgt_disp, flow_to_color(flow)], axis=1)
    bottom = np.concatenate([covis_rgb, composite, err_rgb], axis=1)
    panel = np.concatenate([top, bottom], axis=0)
    write_png(args.output, panel)
    stats.update({"pair": args.pair, "panel_wh": [int(panel.shape[1]), int(panel.shape[0])]})
    with open(args.output + ".json", "w") as f:
        json.dump(stats, f, indent=1)
    print(f"Wrote {args.output} ({panel.shape[1]}x{panel.shape[0]}) + stats sidecar.")
    return args.output


if __name__ == "__main__":
    _golden_image_main()
