"""Image normalization registry.

Mirrors the contract of ``uniception.models.encoders.image_normalizations``
(IMAGE_NORMALIZATION_DICT entries with ``.mean``/``.std``; reference use at
uniflowmatch/models/base.py:75,190-229): each entry maps a ``data_norm_type``
string to per-channel mean/std applied after scaling uint8 images to [0, 1].
A verbatim copy of ``ufm_tpu/nn/encoders/image_normalizations.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["ImageNormalization", "IMAGE_NORMALIZATION_DICT"]


@dataclasses.dataclass(frozen=True)
class ImageNormalization:
    mean: np.ndarray  # shape (3,)
    std: np.ndarray  # shape (3,)


def _norm(mean, std) -> ImageNormalization:
    return ImageNormalization(
        mean=np.asarray(mean, dtype=np.float32),
        std=np.asarray(std, dtype=np.float32),
    )


_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)

IMAGE_NORMALIZATION_DICT = {
    # raw [0, 1] images
    "identity": _norm((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)),
    # [-1, 1] images (DUSt3R/CroCo convention)
    "dust3r": _norm((0.5, 0.5, 0.5), (0.5, 0.5, 0.5)),
    "croco": _norm((0.5, 0.5, 0.5), (0.5, 0.5, 0.5)),
    # torchvision ImageNet statistics (DINOv2 uses these)
    "imagenet": _norm(_IMAGENET_MEAN, _IMAGENET_STD),
    "dinov2": _norm(_IMAGENET_MEAN, _IMAGENET_STD),
    "patch_embedder": _norm(_IMAGENET_MEAN, _IMAGENET_STD),
    # OpenAI CLIP statistics
    "clip": _norm((0.48145466, 0.4578275, 0.40821073), (0.26862954, 0.26130258, 0.27577711)),
}
