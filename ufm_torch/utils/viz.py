"""Visualization: flow coloring and flow-based warping (counterpart of
``ufm_tpu/utils/viz.py``).

``flow_to_color`` is a Middlebury colorwheel; ``visualize_flow`` the HSV
rendering (``hsv_to_bgr``: ``cv2.cvtColor(..., COLOR_HSV2BGR)`` in numpy, bit
for bit); the warp is ``F.grid_sample``
bilinear with ``align_corners=False`` and zero padding, the semantics the JAX
package's own ``grid_sample`` reproduces.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["warp_image_with_flow", "visualize_flow", "hsv_to_bgr", "flow_to_color", "correspondence_panels"]


def warp_image_with_flow(source_image, source_mask, target_image, flow) -> np.ndarray:
    """Backward-warp ``target_image`` into the source frame along ``flow``.

    grid = clip(x + flow) + 0.5, normalized for ``align_corners=False``,
    bilinear, optional mask gating. source_image: (H, W, 3); target_image:
    (Ht, Wt, 3); flow: (H, W, 2). Runs on the host.
    """
    flow = np.asarray(flow)
    assert flow.shape[-1] == 2
    height, width = np.asarray(source_image).shape[:2]
    th, tw = np.asarray(target_image).shape[:2]

    x, y = np.meshgrid(np.arange(width), np.arange(height))
    x_new = np.clip(x + flow[..., 0], 0, tw - 1) + 0.5
    y_new = np.clip(y + flow[..., 1], 0, th - 1) + 0.5
    gx = (x_new / tw) * 2 - 1
    gy = (y_new / th) * 2 - 1
    grid = torch.from_numpy(np.stack([gx, gy], axis=-1).astype(np.float32))[None]

    tgt = torch.from_numpy(np.asarray(target_image, dtype=np.float32)).permute(2, 0, 1)[None]
    warped = F.grid_sample(tgt, grid, mode="bilinear", padding_mode="zeros", align_corners=False)
    warped = warped[0].permute(1, 2, 0).numpy()

    if source_mask is not None:
        warped = warped * (np.asarray(source_mask)[..., None] > 0.5)
    return warped


def hsv_to_bgr(hsv: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 HSV (hue 0..179) -> uint8 BGR, bit for bit
    ``cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)`` as OpenCV computes it with AVX2:
    float32 steps, six sectors of the hue scaled by 6 / 180, ``1 - s * x`` as
    one fused multiply-add; each row's pixels in blocks of 32 go through its
    vector path, which truncates each channel to an integer, and the rest of
    the row through its scalar path, which rounds half to even."""
    hsv = np.asarray(hsv, dtype=np.uint8)
    h = hsv[..., 0].astype(np.float32) * np.float32(6.0 / 180.0)
    s = hsv[..., 1].astype(np.float32) * np.float32(1.0 / 255.0)
    v = hsv[..., 2].astype(np.float32) * np.float32(1.0 / 255.0)
    sector = np.trunc(h)
    h = h - sector
    one = np.float32(1.0)

    def one_minus_s_times(x):  # fma(-s, x, 1): a single rounding of the exact value
        return (1.0 - s.astype(np.float64) * x.astype(np.float64)).astype(np.float32)

    tab = np.stack([v, v * (one - s), v * one_minus_s_times(h), v * one_minus_s_times(one - h)], axis=-1)
    # (b, g, r) = tab[...] by sector, as OpenCV's sector_data
    order = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])
    bgr = np.take_along_axis(tab, order[sector.astype(np.int64) % 6], axis=-1) * np.float32(255.0)
    width = hsv.shape[1]
    vector = (np.arange(width) < width - width % 32)[:, None]
    return np.clip(np.where(vector, np.trunc(bgr), np.rint(bgr)), 0, 255).astype(np.uint8)


def visualize_flow(flow: np.ndarray, flow_scale: float) -> np.ndarray:
    """HSV flow rendering: direction as hue, magnitude / ``flow_scale`` as
    saturation. Returns BGR uint8, as cv2 gives it."""
    magnitude = np.sqrt(np.square(flow[..., 0]) + np.square(flow[..., 1]))
    angle = np.arctan2(flow[..., 1], flow[..., 0])
    magnitude = np.clip(magnitude / flow_scale, 0, 1)
    angle_deg = np.degrees(angle) % 360

    hsv = np.zeros((flow.shape[0], flow.shape[1], 3), dtype=np.uint8)
    hsv[..., 0] = (angle_deg / 2).astype(np.uint8)
    hsv[..., 1] = (magnitude * 255).astype(np.uint8)
    hsv[..., 2] = 255
    return hsv_to_bgr(hsv)


def _make_colorwheel() -> np.ndarray:
    """Middlebury flow colorwheel (Baker et al., 55 colors)."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[0:RY, 0] = 255
    wheel[0:RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    wheel[col : col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col : col + YG, 1] = 255
    col += YG
    wheel[col : col + GC, 1] = 255
    wheel[col : col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    wheel[col : col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col : col + CB, 2] = 255
    col += CB
    wheel[col : col + BM, 2] = 255
    wheel[col : col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    wheel[col : col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col : col + MR, 0] = 255
    return wheel


_COLORWHEEL = _make_colorwheel()


def flow_to_color(flow_uv: np.ndarray, clip_flow: float | None = None) -> np.ndarray:
    """Color a (H, W, 2) flow field with the Middlebury colorwheel.

    Drop-in replacement for ``flow_vis.flow_to_color`` (RGB uint8), used by
    the CLI/demo outputs (reference cli.py:132, gradio_demo.py:109).
    """
    assert flow_uv.ndim == 3 and flow_uv.shape[2] == 2, "expected (H, W, 2) flow"
    flow = np.asarray(flow_uv, dtype=np.float64)
    if clip_flow is not None:
        flow = np.clip(flow, -clip_flow, clip_flow)

    u, v = flow[..., 0], flow[..., 1]
    rad = np.sqrt(u**2 + v**2)
    rad_max = max(rad.max(), 1e-5)
    u, v = u / rad_max, v / rad_max
    rad = rad / rad_max

    ncols = _COLORWHEEL.shape[0]
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % ncols
    f = fk - k0

    img = np.zeros((*u.shape, 3), dtype=np.uint8)
    for i in range(3):
        col0 = _COLORWHEEL[k0, i] / 255.0
        col1 = _COLORWHEEL[k1, i] / 255.0
        col = (1 - f) * col0 + f * col1
        col = 1 - rad * (1 - col)  # saturate with magnitude
        img[..., i] = np.floor(255 * col)
    return img


def correspondence_panels(source_rgb: np.ndarray, target_rgb: np.ndarray, flow: np.ndarray, covisibility: np.ndarray):
    """The three panels of ``cli infer`` and the demo, uint8 RGB in the
    source frame: the flow's colorwheel, the covisibility as gray, and the
    target backward-warped into the source frame with non-covisible pixels
    whited out (occlusions read as "no correspondence"). ``flow`` (H, W, 2),
    ``covisibility`` (H, W) in [0, 1]."""
    warped = warp_image_with_flow(source_rgb, None, target_rgb, flow).astype(np.float32)
    alpha = covisibility[..., None]
    composite = (alpha * warped + (1.0 - alpha) * 255.0).astype(np.uint8)
    covis_rgb = np.repeat((covisibility * 255).astype(np.uint8)[..., None], 3, axis=-1)
    return flow_to_color(flow), covis_rgb, composite
