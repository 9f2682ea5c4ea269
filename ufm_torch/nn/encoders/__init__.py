"""Encoder registry (counterpart of ``ufm_tpu/nn/encoders/__init__.py``).

``feature_returner_encoder_factory`` is keyed by an ``encoder_str`` and
returns a module that maps a :class:`ViTEncoderInput` to a list of per-layer
feature maps. It accepts the same config keys as the JAX factory and fails
hard on an unknown load-bearing key.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict

from ufm_torch.nn.encoders.image_normalizations import IMAGE_NORMALIZATION_DICT, ImageNormalization
from ufm_torch.nn.encoders.vit import ViTEncoder, ViTEncoderInput, ViTEncoderOutput

__all__ = [
    "IMAGE_NORMALIZATION_DICT",
    "ImageNormalization",
    "ViTEncoder",
    "ViTEncoderInput",
    "ViTEncoderOutput",
    "feature_returner_encoder_factory",
    "module_fields",
    "register_encoder",
]

# encoders registered by name (register_encoder); the factory consults them first
_FACTORIES: Dict[str, Callable[..., Any]] = {}

_PRESETS: Dict[str, Dict[str, Any]] = {
    # DINOv2 family (patch 14). `size` presets follow the standard ViT dims;
    # the published ViT-g/14 (facebookresearch/dinov2 hubconf.py, vit_giant2)
    # has a SwiGLU FFN (a GELU ViT-g only by an explicit ffn_layer="mlp").
    "dinov2_small": dict(embed_dim=384, depth=12, num_heads=6),
    "dinov2_base": dict(embed_dim=768, depth=12, num_heads=12),
    "dinov2_large": dict(embed_dim=1024, depth=24, num_heads=16),
    "dinov2_giant": dict(embed_dim=1536, depth=40, num_heads=24, ffn_layer="swiglufused"),
}

# Bookkeeping / weight-loading keys a UniCeption-style config.json may carry
# that genuinely don't affect the built architecture — safe to ignore.
_BENIGN_CONFIG_KEYS = {
    "name",
    "size",  # consumed below as a preset selector
    "uses_torch_hub",
    "torch_hub_force_reload",
    "pretrained_checkpoint_path",
    "gradient_checkpointing",
    "device",
}

# Alternate spellings of keys this implementation supports (timm / DINOv2 /
# UniCeption conventions) -> canonical ViTEncoder field.
_CONFIG_ALIASES = {
    "init_values": "layerscale_init",
    "enc_embed_dim": "embed_dim",
    "enc_depth": "depth",
    "enc_num_heads": "num_heads",
}


def module_fields(cls) -> set:
    """The keyword arguments a module's constructor takes: its config surface."""
    return {
        name
        for name, p in inspect.signature(cls.__init__).parameters.items()
        if name != "self" and p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)
    }


def register_encoder(name: str, factory: Callable[..., Any]) -> None:
    """Make ``feature_returner_encoder_factory(name, **kwargs)`` return
    ``factory(**kwargs)``, ahead of the presets."""
    _FACTORIES[name] = factory


def feature_returner_encoder_factory(encoder_str: str, **kwargs) -> ViTEncoder:
    """Build a feature-returner encoder from a name + config kwargs.

    Accepts an explicit preset name ("dinov2_large", ...) or any name whose
    dims are fully given in kwargs. Unknown *load-bearing* keys hard-fail:
    silently ignoring an architecture option would build a wrong network that
    loads the checkpoint but predicts garbage. Purely bookkeeping keys
    (:data:`_BENIGN_CONFIG_KEYS`) are ignored. A name given to
    :func:`register_encoder` is built by its factory.
    """
    if encoder_str in _FACTORIES:
        return _FACTORIES[encoder_str](**kwargs)

    kwargs = dict(kwargs)
    for alias, canonical in _CONFIG_ALIASES.items():
        if alias in kwargs:
            kwargs.setdefault(canonical, kwargs.pop(alias))
    if "img_size" in kwargs:  # timm-style pretraining size -> pos-embed grid
        img_size = kwargs.pop("img_size")
        patch = kwargs.get("patch_size", 14)
        kwargs.setdefault("pretrain_grid_size", int(img_size) // int(patch))

    cfg: Dict[str, Any] = {}
    if encoder_str in _PRESETS:
        cfg.update(_PRESETS[encoder_str])
    elif "size" in kwargs and f"dinov2_{kwargs['size']}" in _PRESETS:
        cfg.update(_PRESETS[f"dinov2_{kwargs['size']}"])

    known = module_fields(ViTEncoder)
    unknown = set(kwargs) - known - _BENIGN_CONFIG_KEYS
    if unknown:
        raise ValueError(
            f"encoder config for '{encoder_str}' carries load-bearing options this "
            f"implementation does not support: {sorted(unknown)}. Refusing to build a "
            f"silently-wrong architecture; supported fields: {sorted(known)}."
        )
    cfg.update({k: v for k, v in kwargs.items() if k in known})
    return ViTEncoder(**cfg)
