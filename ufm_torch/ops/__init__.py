"""Ops: attention and refinement dispatch, the Hopper kernels, resizes,
``grid_sample``.

Each kernel's wrapper and launch count live in its submodule
(``ufm_torch.ops.flash_attention``, ``ufm_torch.ops.window_refinement``,
``ufm_torch.ops.gelu``, ``ufm_torch.ops.linear_gelu``,
``ufm_torch.ops.linear_swiglu``; not re-exported, so ``LAUNCHES`` stays the
module's). The kernels are dispatcher
ops (``torch.ops.ufm_torch.*``), registered by ``ufm_torch.ops.library``,
which importing this package imports.
"""

from ufm_torch.ops import library  # noqa: F401  (registers the ops)
from ufm_torch.ops.attention import dot_product_attention
from ufm_torch.ops.grid_sample import grid_sample
from ufm_torch.ops.refinement import fused_refinement_attention
from ufm_torch.ops.resize import (
    resize_chw,
    resize_hwc,
    resize_matrix,
    resize_nearest_chw,
    resize_nearest_hwc,
)

__all__ = [
    "dot_product_attention",
    "fused_refinement_attention",
    "grid_sample",
    "resize_chw",
    "resize_hwc",
    "resize_matrix",
    "resize_nearest_chw",
    "resize_nearest_hwc",
]
