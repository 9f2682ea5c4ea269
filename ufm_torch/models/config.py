"""Architecture configuration for the UFM model family.

Field names mirror the reference constructor kwargs exactly
(uniflowmatch/models/ufm.py:130-152, 483-508, 720-751) so that a HuggingFace
``config.json`` written for the reference models maps 1:1 onto this config
(the config.json is the single source of architecture truth; reference
ufm.py:120 + SURVEY.md §3.5).

A copy of ``ufm_tpu/models/config.py``: the port never imports the JAX
package, so it keeps its own. Fields the port does not use yet (training
remat, refinement) are kept so one config dict drives both packages. The
port adds :func:`ufm_base_vitg_reg_config` (DINOv2 ViT-g/14 with registers,
which the JAX package does not build).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

__all__ = ["UFMArchConfig", "ufm_base_config", "ufm_base_vitg_reg_config", "ufm_refine_config", "ufm_tiny_config"]


def _d() -> Dict[str, Any]:
    return {}


@dataclasses.dataclass
class UFMArchConfig:
    # Encoder
    encoder_str: str = "dinov2_large"
    encoder_kwargs: Dict[str, Any] = dataclasses.field(default_factory=_d)
    # Info sharing
    info_sharing_and_head_structure: str = "dual+single"
    info_sharing_str: str = "global_attention"
    info_sharing_kwargs: Dict[str, Any] = dataclasses.field(default_factory=_d)
    # Main head
    head_type: str = "dpt"
    feature_head_kwargs: Dict[str, Any] = dataclasses.field(default_factory=_d)
    adaptors_kwargs: Dict[str, Any] = dataclasses.field(default_factory=_d)
    # Uncertainty head (confidence variant)
    has_uncertainty_head: bool = False
    detach_uncertainty_head: bool = True
    uncertainty_head_type: str = "dpt"
    uncertainty_head_kwargs: Dict[str, Any] = dataclasses.field(default_factory=_d)
    uncertainty_adaptors_kwargs: Dict[str, Any] = dataclasses.field(default_factory=_d)
    # Classification refinement (refine variant)
    has_classification_head: bool = False
    classification_head_type: str = "patch_mlp"
    classification_head_kwargs: Dict[str, Any] = dataclasses.field(default_factory=_d)
    temperature: float = 4.0
    use_unet_feature: bool = False
    # UNet dims; {} keeps the reference's hardcoded UNet(3, 16, [64,128,256,512])
    # (unet_encoder.py:26 via ufm.py:818) — overridable for tiny test models
    unet_kwargs: Dict[str, Any] = dataclasses.field(default_factory=_d)
    feature_combine_method: str = "conv"
    refinement_range: int = 5
    # Window-refinement implementation (the JAX package's names): "auto" lets
    # the tensors' device decide, "pallas" asks for the Hopper kernel,
    # "xla" for the plain version (models/network.py::REFINEMENT_IMPL_FROM_CONFIG)
    refinement_impl: str = "auto"
    # the JAX package's precision knob for its TPU kernel's selection matmul;
    # accepted for config compatibility, no effect in the port (the Hopper
    # kernel computes its taps in fp32)
    refinement_matmul_precision: str = "default"
    # Inference
    inference_resolution: Union[Tuple[int, int], List[Tuple[int, int]]] = (560, 420)  # (W, H)
    # Precision policy: backbone compute dtype; heads always fp32 (reference
    # autocast policy, base.py:273 / ufm.py:414)
    compute_dtype: str = "bfloat16"
    # Training-time memory knob: rematerialize transformer-block activations
    # in the backward pass (torch.utils.checkpoint around each block).
    # True/"all" checkpoints both stacks; "encoder" checkpoints only the
    # 24-layer encoder and keeps the info-sharing activations resident. No
    # effect on forward-only graphs. UFM-Base's batch-2 step at 420x560 on
    # an NVIDIA H100 80GB HBM3, 700.00 W (chip_smoke.py, phase `remat`):
    # peak 15.2 GB, 157 ms without remat; 10.6 GB, 257 ms with full remat.
    train_remat: Union[bool, str] = False
    # Optional policy applied with remat, by the name of its
    # jax.checkpoint_policies counterpart (nn/layers.py::REMAT_POLICIES): the
    # ops whose outputs the backward keeps, e.g.
    # "dots_with_no_batch_dims_saveable" keeps the projection / MLP matmul
    # outputs and recomputes the elementwise work; the "+attn_out" composite
    # also keeps the flash-attention forward's outputs, so the backward does
    # not launch the attention forward again. None = full remat. On the card
    # above (same phase): the dots policies 12.8 GB, 298-330 ms; "+attn_out"
    # 13.1 GB, 300 ms; everything_saveable 19.8 GB, 350 ms: each policy's
    # dispatch hook costs more host time than the recompute it saves.
    train_remat_policy: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "UFMArchConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def _dpt_kwargs(enc_dim: int, info_dim: int, output_dim: int) -> Dict[str, Any]:
    return {
        "dpt_feature": {
            "input_dims": (enc_dim, info_dim, info_dim, info_dim),
            "proj_dims": (96, 192, 384, 768),
            "feature_dim": 256,
        },
        "dpt_processor": {"input_dim": 256, "hidden_dims": (128, 64), "output_dim": output_dim},
    }


def _ufm_base(encoder_str: str, encoder_kwargs: Dict[str, Any], enc_dim: int) -> UFMArchConfig:
    """UFM-Base's info sharing and heads on an encoder of width ``enc_dim``:
    the info sharing's input projection and the DPT heads' first input take
    the encoder's width."""
    info_dim = 768
    return UFMArchConfig(
        encoder_str=encoder_str,
        encoder_kwargs=encoder_kwargs,
        info_sharing_str="global_attention",
        info_sharing_kwargs={
            "input_embed_dim": enc_dim,
            "dim": info_dim,
            "depth": 12,
            "num_heads": 12,
            "intermediate_layer_idx": (5, 8),
        },
        head_type="dpt",
        feature_head_kwargs=_dpt_kwargs(enc_dim, info_dim, 2),
        adaptors_kwargs={"flow": {"class": "FlowAdaptor", "kwargs": {}}},
        has_uncertainty_head=True,
        uncertainty_head_kwargs=_dpt_kwargs(enc_dim, info_dim, 5),
        uncertainty_adaptors_kwargs={
            "flow_cov": {"class": "Covariance2DAdaptor", "kwargs": {}},
            "keypoint_confidence": {"class": "ConfidenceAdaptor", "kwargs": {}},
            "non_occluded_mask": {"class": "MaskAdaptor", "kwargs": {}},
        },
        inference_resolution=(560, 420),
    )


def ufm_base_config(**overrides) -> UFMArchConfig:
    """Flagship UFM-Base class config: DINOv2 ViT-L/14 encoder + dual-view
    global attention + DPT flow head + DPT uncertainty head."""
    cfg = _ufm_base("dinov2_large", {"intermediate_layer_idx": (0, 23)}, 1024)
    return dataclasses.replace(cfg, **overrides)


def ufm_base_vitg_reg_config(**overrides) -> UFMArchConfig:
    """UFM-Base's info sharing and DPT heads on DINOv2 ViT-g/14 with
    registers (``dinov2_vitg14_reg``: 40 x 1536, 24 heads, the SwiGLU FFN, 4
    registers), tapped at its first and last blocks as UFM-Base taps ViT-L.
    No published UFM checkpoint uses this encoder."""
    encoder_kwargs = {"num_register_tokens": 4, "ffn_layer": "swiglufused", "intermediate_layer_idx": (0, 39)}
    return dataclasses.replace(_ufm_base("dinov2_giant", encoder_kwargs, 1536), **overrides)


def ufm_refine_config(**overrides) -> UFMArchConfig:
    """Flagship UFM-Refine class config: base + patch-MLP classification
    refinement with UNet fine features."""
    cfg = ufm_base_config()
    cfg = dataclasses.replace(
        cfg,
        has_classification_head=True,
        classification_head_kwargs={
            "input_feature_dim": 1024 + 768,
            "hidden_dims": (512,),
            "output_dim": 16,
            "patch_size": 14,
        },
        use_unet_feature=True,
        feature_combine_method="conv",
        refinement_range=5,
        temperature=4.0,
    )
    return dataclasses.replace(cfg, **overrides)


def ufm_tiny_config(**overrides) -> UFMArchConfig:
    """Tiny config for tests: same topology, minimal dims, 56x42 inputs."""
    enc_dim, info_dim = 64, 48
    cfg = UFMArchConfig(
        encoder_str="dinov2_custom",
        encoder_kwargs={
            "embed_dim": enc_dim,
            "depth": 2,
            "num_heads": 2,
            "pretrain_grid_size": 4,
            "intermediate_layer_idx": (0, 1),
        },
        info_sharing_kwargs={
            "input_embed_dim": enc_dim,
            "dim": info_dim,
            "depth": 2,
            "num_heads": 2,
            "intermediate_layer_idx": (0, 1),
        },
        feature_head_kwargs={
            "dpt_feature": {
                "input_dims": (enc_dim, info_dim, info_dim, info_dim),
                "proj_dims": (8, 16, 24, 32),
                "feature_dim": 16,
            },
            "dpt_processor": {"input_dim": 16, "hidden_dims": (8, 8), "output_dim": 2},
        },
        adaptors_kwargs={"flow": {"class": "FlowAdaptor", "kwargs": {}}},
        has_uncertainty_head=True,
        uncertainty_head_kwargs={
            "dpt_feature": {
                "input_dims": (enc_dim, info_dim, info_dim, info_dim),
                "proj_dims": (8, 16, 24, 32),
                "feature_dim": 16,
            },
            "dpt_processor": {"input_dim": 16, "hidden_dims": (8, 8), "output_dim": 5},
        },
        uncertainty_adaptors_kwargs={
            "flow_cov": {"class": "Covariance2DAdaptor", "kwargs": {}},
            "keypoint_confidence": {"class": "ConfidenceAdaptor", "kwargs": {}},
            "non_occluded_mask": {"class": "MaskAdaptor", "kwargs": {}},
        },
        classification_head_kwargs={
            "input_feature_dim": enc_dim + info_dim,
            "hidden_dims": (32,),
            "output_dim": 8,
            "patch_size": 14,
        },
        inference_resolution=(56, 42),
        compute_dtype="float32",
    )
    return dataclasses.replace(cfg, **overrides)
