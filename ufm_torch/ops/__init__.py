"""Ops: attention dispatch, the Hopper flash-attention kernel, resizes.

The kernel's wrapper and launch count live in the submodule
``ufm_torch.ops.flash_attention`` (not re-exported, so the name stays the module).
"""

from ufm_torch.ops.attention import dot_product_attention
from ufm_torch.ops.resize import (
    resize_chw,
    resize_hwc,
    resize_matrix,
    resize_nearest_hwc,
)

__all__ = [
    "dot_product_attention",
    "resize_chw",
    "resize_hwc",
    "resize_matrix",
    "resize_nearest_hwc",
]
