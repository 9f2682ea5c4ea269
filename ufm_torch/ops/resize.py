"""Image / field resizing as separable matrix products.

Counterpart of ``ufm_tpu/ops/resize.py``: every resize is a pair of static
weight matrices built on the host in float64 numpy and applied as two
``torch.einsum``s. The builders are copied verbatim from the JAX package, so
the port keeps its exact tap/weight rules, which match ``F.interpolate``:

- ``antialias=True``: the PIL-style triangle filter of
  ``F.interpolate(mode="bilinear", antialias=True)`` (the input scaler);
- ``antialias=False``: plain bilinear, ``align_corners=False``;
- ``align_corners=True``: DPT-style upsampling, source coordinates in float32;
- nearest: torch's legacy rule ``src = floor(dst * in / out)``.

The device copies of the matrices are cached per (sizes, dtype, device), so a
forward pass never waits on a host-to-device copy of one.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from ufm_torch.ops.cache import device_constant

__all__ = [
    "resize_matrix",
    "resize_hwc",
    "resize_chw",
    "resize_nearest_hwc",
    "resize_nearest_chw",
]


def _triangle(t: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(t))


@functools.lru_cache(maxsize=256)
def _resize_matrix_np(in_size: int, out_size: int, antialias: bool, align_corners: bool = False) -> np.ndarray:
    """Row-stochastic (out_size, in_size) float64 interpolation matrix.

    Implements the exact tap/weight rule of torch's bilinear resampling with
    half-pixel centers (``align_corners=False``); with ``antialias`` the filter
    support is widened by the downscale factor and weights renormalized, which
    is the PIL-style convolution torch uses for ``antialias=True``. With
    ``align_corners=True`` (DPT-style upsampling) endpoints map to endpoints.
    """
    if in_size == out_size:
        return np.eye(in_size, dtype=np.float64)

    if align_corners:
        assert not antialias, "align_corners=True is only used without antialias"
        w = np.zeros((out_size, in_size), dtype=np.float64)
        scale32 = (np.float32(in_size) - 1) / (np.float32(out_size) - 1) if out_size > 1 else np.float32(0)
        src = (np.arange(out_size, dtype=np.float32) * scale32)
        x0 = np.floor(src).astype(np.int64)
        t = src.astype(np.float64) - x0
        for i in range(out_size):
            lo = min(max(int(x0[i]), 0), in_size - 1)
            hi = min(max(int(x0[i]) + 1, 0), in_size - 1)
            w[i, lo] += 1.0 - t[i]
            w[i, hi] += t[i]
        return w

    # torch computes source coordinates in the tensor dtype (float32 for the
    # pipeline's images); mirror that so tap choices and fractional weights
    # round identically.
    scale32 = np.float32(in_size) / np.float32(out_size)
    scale = float(scale32)
    w = np.zeros((out_size, in_size), dtype=np.float64)

    if antialias and scale > 1.0:
        support = scale  # triangle radius 1.0 * scale
        for i in range(out_size):
            center = float((np.float32(i) + np.float32(0.5)) * scale32)
            xmin = max(int(center - support + 0.5), 0)
            xmax = min(int(center + support + 0.5), in_size)
            x = np.arange(xmin, xmax)
            weights = _triangle((x + 0.5 - center) / scale)
            s = weights.sum()
            if s > 0:
                w[i, xmin:xmax] = weights / s
            else:  # degenerate: fall back to nearest tap
                w[i, min(int(center), in_size - 1)] = 1.0
    else:
        i = np.arange(out_size, dtype=np.float32)
        src = (i + np.float32(0.5)) * scale32 - np.float32(0.5)
        x0 = np.floor(src).astype(np.int64)
        t = (src.astype(np.float64) - x0)
        for i in range(out_size):
            lo = min(max(int(x0[i]), 0), in_size - 1)
            hi = min(max(int(x0[i]) + 1, 0), in_size - 1)
            w[i, lo] += 1.0 - t[i]
            w[i, hi] += t[i]

    return w


@functools.lru_cache(maxsize=256)
def _nearest_index_np(in_size: int, out_size: int) -> np.ndarray:
    """torch legacy-nearest source indices: src = floor(dst * in/out)."""
    scale = in_size / out_size
    idx = np.floor(np.arange(out_size) * scale).astype(np.int64)
    return np.minimum(idx, in_size - 1)


@device_constant
def resize_matrix(
    in_size: int,
    out_size: int,
    antialias: bool,
    dtype: torch.dtype = torch.float32,
    align_corners: bool = False,
    device: torch.device = torch.device("cpu"),
) -> torch.Tensor:
    """The (out_size, in_size) interpolation matrix as a tensor on ``device``.
    Cached, and built outside inference mode even when first asked for under
    it (the predict API), so that training may use it later."""
    w = _resize_matrix_np(in_size, out_size, antialias, align_corners)
    with torch.inference_mode(False):
        return torch.from_numpy(w).to(device=device, dtype=dtype)


@device_constant
def _nearest_index(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):  # cached: usable by training too
        return torch.from_numpy(_nearest_index_np(in_size, out_size)).to(device)


def _float_dtype(x: torch.Tensor) -> torch.dtype:
    return x.dtype if x.is_floating_point() else torch.float32


def resize_hwc(
    image: torch.Tensor,
    out_shape: Tuple[int, int],
    antialias: bool = True,
    align_corners: bool = False,
) -> torch.Tensor:
    """Bilinear-resize a (..., H, W, C) tensor to (..., H', W', C).

    ``antialias=True`` matches ``F.interpolate(..., antialias=True)``;
    ``False`` matches plain bilinear.
    """
    h_out, w_out = int(out_shape[0]), int(out_shape[1])
    h_in, w_in = image.shape[-3], image.shape[-2]
    dt = _float_dtype(image)
    wh = resize_matrix(h_in, h_out, antialias, dt, align_corners, image.device)
    ww = resize_matrix(w_in, w_out, antialias, dt, align_corners, image.device)
    x = image.to(dt)
    x = torch.einsum("oh,...hwc->...owc", wh, x)
    return torch.einsum("ow,...hwc->...hoc", ww, x)


def resize_chw(
    image: torch.Tensor,
    out_shape: Tuple[int, int],
    antialias: bool = True,
    align_corners: bool = False,
) -> torch.Tensor:
    """Bilinear-resize a (..., C, H, W) tensor to (..., C, H', W')."""
    h_out, w_out = int(out_shape[0]), int(out_shape[1])
    h_in, w_in = image.shape[-2], image.shape[-1]
    dt = _float_dtype(image)
    wh = resize_matrix(h_in, h_out, antialias, dt, align_corners, image.device)
    ww = resize_matrix(w_in, w_out, antialias, dt, align_corners, image.device)
    x = image.to(dt)
    x = torch.einsum("oh,...hw->...ow", wh, x)
    return torch.einsum("ow,...hw->...ho", ww, x)


def resize_nearest_hwc(image: torch.Tensor, out_shape: Tuple[int, int]) -> torch.Tensor:
    """Nearest-resize (..., H, W, C) with torch's legacy-nearest index rule."""
    hi = _nearest_index(image.shape[-3], int(out_shape[0]), image.device)
    wi = _nearest_index(image.shape[-2], int(out_shape[1]), image.device)
    return image.index_select(-3, hi).index_select(-2, wi)


def resize_nearest_chw(image: torch.Tensor, out_shape: Tuple[int, int]) -> torch.Tensor:
    """Nearest-resize (..., C, H, W) with torch's legacy-nearest index rule."""
    hi = _nearest_index(image.shape[-2], int(out_shape[0]), image.device)
    wi = _nearest_index(image.shape[-1], int(out_shape[1]), image.device)
    return image.index_select(-2, hi).index_select(-1, wi)

