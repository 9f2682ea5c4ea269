"""Resize / crop / unmap with exact region bookkeeping.

Counterpart of ``ufm_tpu/utils/flow_resizing.py``. Every manipulation tracks a
"source region" (which part of the original image the representation
covers) and a "representation region" (where that content sits in the
current tensor), as host-side numpy 4-vectors [top, bottom, left, right].
Images are channel-last tensors; every interpolation goes through the
matrix-product resizes of :mod:`ufm_torch.ops.resize` (torch-parity taps).

- ``unmap_predicted_flow`` maps a predicted flow field back to the original
  resolution: crop to the representation ROI, upsample source coordinates
  bilinearly but flow values with *nearest*, rescale per axis, re-embed into
  a zeroed full-res canvas plus a validity mask;
- ``unmap_predicted_channels`` nearest-upsamples scalar channels back;
- ``unmap_predicted_pairs`` maps sparse point pairs back.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ufm_torch.ops.cache import device_constant
from ufm_torch.ops.resize import resize_hwc, resize_nearest_hwc

__all__ = [
    "ImagePairsManipulationBase",
    "ResizeHorizontalAxisManipulation",
    "ResizeVerticalAxisManipulation",
    "ResizeToFixedManipulation",
    "CenterCropManipulation",
    "ImagePairsManipulationComposite",
    "AutomaticShapeSelection",
    "scale_axis",
    "unmap_predicted_flow",
    "unmap_predicted_channels",
    "unmap_predicted_pairs",
]

Region = np.ndarray  # shape (4,): [top, bottom, left, right]


def _identity_regions(h: int, w: int) -> Region:
    # int64, like the reference's torch.tensor([0, H, 0, W]) seeds; in-place
    # float updates then truncate, which CenterCropManipulation reproduces.
    return np.array([0, h, 0, w], dtype=np.int64)


class ImagePairsManipulationBase:
    """Strategy base: callable on (img0, img1, 4 region vectors)."""

    def __call__(self, img0, img1, img0_region_source, img1_region_source,
                 img0_region_representation, img1_region_representation):
        raise NotImplementedError

    def output_shape(self, H: int, W: int) -> Tuple[int, int]:
        raise NotImplementedError

    def output_shape_pairs(self, H1, W1, H2, W2):
        o1 = self.output_shape(H1, W1)
        o2 = self.output_shape(H2, W2)
        return o1[0], o1[1], o2[0], o2[1]

    def check_input(self, H: int, W: int) -> bool:
        raise NotImplementedError

    def check_input_pairs(self, H1, W1, H2, W2) -> bool:
        return self.check_input(H1, W1) and self.check_input(H2, W2)


class _ResizeManipulationBase(ImagePairsManipulationBase):
    """Shared resize logic; subclasses define output_shape and antialias."""

    antialias = False
    int_regions = False

    def check_input(self, H: int, W: int) -> bool:
        return True

    def __call__(self, img0, img1, img0_region_source, img1_region_source,
                 img0_region_representation, img1_region_representation):
        _, h0, w0, _ = img0.shape
        _, h1, w1, _ = img1.shape
        th0, tw0, th1, tw1 = self.output_shape_pairs(h0, w0, h1, w1)

        img0_resized = resize_hwc(img0, (th0, tw0), antialias=self.antialias)
        img1_resized = resize_hwc(img1, (th1, tw1), antialias=self.antialias)
        if img0.dtype == torch.uint8:
            img0_resized = img0_resized.to(torch.uint8)
            img1_resized = img1_resized.to(torch.uint8)

        mult0 = np.array([th0 / h0, th0 / h0, tw0 / w0, tw0 / w0])
        mult1 = np.array([th1 / h1, th1 / h1, tw1 / w1, tw1 / w1])
        rep0 = mult0 * np.asarray(img0_region_representation, dtype=np.float64)
        rep1 = mult1 * np.asarray(img1_region_representation, dtype=np.float64)
        if self.int_regions:
            rep0 = rep0.astype(np.int64)
            rep1 = rep1.astype(np.int64)

        return (img0_resized, img1_resized, img0_region_source, img1_region_source, rep0, rep1)


class ResizeHorizontalAxisManipulation(_ResizeManipulationBase):
    def __init__(self, horizontal_axis: int):
        self.horizontal_axis = horizontal_axis

    def output_shape(self, H: int, W: int) -> Tuple[int, int]:
        return (int(H * self.horizontal_axis / W), self.horizontal_axis)


class ResizeVerticalAxisManipulation(_ResizeManipulationBase):
    def __init__(self, vertical_axis: int):
        self.vertical_axis = vertical_axis

    def output_shape(self, H: int, W: int) -> Tuple[int, int]:
        return (self.vertical_axis, int(W * self.vertical_axis / H))


class ResizeToFixedManipulation(_ResizeManipulationBase):
    """Resize both images to a fixed (H, W) with PIL-style antialiasing."""

    antialias = True
    int_regions = True

    def __init__(self, target_shape: Tuple[int, int]):
        self.target_shape = (int(target_shape[0]), int(target_shape[1]))

    def output_shape(self, H: int, W: int) -> Tuple[int, int]:
        return self.target_shape


def scale_axis(source_low, source_high, reference_low, reference_high,
               reference_low_new, reference_high_new):
    """Map a sub-interval of the reference axis into source-axis coordinates."""
    reference_length = reference_high - reference_low
    rel_low = (reference_low_new - reference_low) / reference_length
    rel_high = (reference_high_new - reference_low) / reference_length
    source_length = source_high - source_low
    return source_low + rel_low * source_length, source_low + rel_high * source_length


class CenterCropManipulation(ImagePairsManipulationBase):
    def __init__(self, target_size: Tuple[int, int]):
        self.target_size = (int(target_size[0]), int(target_size[1]))

    def output_shape(self, H: int, W: int) -> Tuple[int, int]:
        return self.target_size

    def check_input(self, H: int, W: int) -> bool:
        return H >= self.target_size[0] and W >= self.target_size[1]

    def __call__(self, img0, img1, img0_region_source, img1_region_source,
                 img0_region_representation, img1_region_representation):
        _, h0, w0, _ = img0.shape
        _, h1, w1, _ = img1.shape
        th, tw = self.target_size

        def crop(img, h, w):
            top = (h - th) // 2
            left = (w - tw) // 2
            return img[:, top : top + th, left : left + tw, :], top, left

        img0_c, top0, left0 = crop(img0, h0, w0)
        img1_c, top1, left1 = crop(img1, h1, w1)

        def update(rep, src, top, left, h, w):
            src_dtype = np.asarray(src).dtype
            rep = np.asarray(rep, dtype=np.float64)
            src = np.asarray(src, dtype=np.float64).copy()
            bottom_crop = h - th - top
            right_crop = w - tw - left
            remaining = np.array(
                [
                    max(rep[0], top),
                    min(rep[1], h - bottom_crop),
                    max(rep[2], left),
                    min(rep[3], w - right_crop),
                ]
            )
            new_rep = (remaining - np.array([top, top, left, left])).astype(np.int64)
            src[0], src[1] = scale_axis(src[0], src[1], rep[0], rep[1], remaining[0], remaining[1])
            src[2], src[3] = scale_axis(src[2], src[3], rep[2], rep[3], remaining[2], remaining[3])
            if np.issubdtype(src_dtype, np.integer):
                # the reference assigns these floats into an int64 tensor,
                # truncating toward zero — reproduce exactly
                src = np.trunc(src).astype(src_dtype)
            return new_rep, src

        rep0, src0 = update(img0_region_representation, img0_region_source, top0, left0, h0, w0)
        rep1, src1 = update(img1_region_representation, img1_region_source, top1, left1, h1, w1)
        return img0_c, img1_c, src0, src1, rep0, rep1


class ImagePairsManipulationComposite(ImagePairsManipulationBase):
    def __init__(self, *manipulations: ImagePairsManipulationBase):
        self.manipulations = manipulations

    def output_shape(self, H: int, W: int) -> Tuple[int, int]:
        shape = (H, W)
        for m in self.manipulations:
            shape = m.output_shape(*shape)
        return shape

    def output_shape_pairs(self, H1, W1, H2, W2):
        shape = (H1, W1, H2, W2)
        for m in self.manipulations:
            shape = m.output_shape_pairs(*shape)
        return shape

    def check_input(self, H, W) -> bool:
        shape = (H, W)
        for m in self.manipulations:
            if not m.check_input(*shape):
                return False
            shape = m.output_shape(*shape)
        return True

    def check_input_pairs(self, H1, W1, H2, W2) -> bool:
        shape = (H1, W1, H2, W2)
        for m in self.manipulations:
            if not m.check_input_pairs(*shape):
                return False
            shape = m.output_shape_pairs(*shape)
        return True

    def __call__(self, *args):
        for m in self.manipulations:
            args = m(*args)
        return args


class AutomaticShapeSelection(ImagePairsManipulationBase):
    """Pick the candidate whose output aspect is closest to the inputs'
    (strategy="closest_aspect")."""

    def __init__(self, *manipulations: ImagePairsManipulationBase, strategy: str = "closest_aspect"):
        self.manipulations = manipulations
        if strategy != "closest_aspect":
            raise ValueError(f"Unknown strategy: {strategy}")

    def select(self, H0: int, W0: int, H1: int, W1: int):
        """Return (output_shape_pairs, chosen_manipulation) or (None, None)."""
        runnable = [
            (m.output_shape_pairs(H0, W0, H1, W1), m)
            for m in self.manipulations
            if m.check_input_pairs(H0, W0, H1, W1)
        ]
        if not runnable:
            return None, None
        return min(
            runnable,
            key=lambda x: abs(x[0][0] / x[0][1] - H0 / W0) + abs(x[0][2] / x[0][3] - H1 / W1),
        )

    def output_shape_pairs(self, H1, W1, H2, W2):
        shape, _ = self.select(H1, W1, H2, W2)
        if shape is None:
            raise ValueError("No valid shape found for the given resolution.")
        return shape

    def check_input_pairs(self, H1, W1, H2, W2) -> bool:
        return self.select(H1, W1, H2, W2)[0] is not None

    def __call__(self, img0, img1, img0_region_source=None, img1_region_source=None,
                 img0_region_representation=None, img1_region_representation=None):
        h0, w0 = img0.shape[1], img0.shape[2]
        h1, w1 = img1.shape[1], img1.shape[2]
        _, chosen = self.select(h0, w0, h1, w1)
        if chosen is None:
            raise ValueError("No valid shape found for the given resolution.")

        if img0_region_source is None:
            img0_region_source = _identity_regions(h0, w0)
            img1_region_source = _identity_regions(h1, w1)
            img0_region_representation = _identity_regions(h0, w0)
            img1_region_representation = _identity_regions(h1, w1)

        return chosen(
            img0, img1, img0_region_source, img1_region_source,
            img0_region_representation, img1_region_representation,
        )


def _as_int_region(region) -> Tuple[int, int, int, int]:
    r = np.asarray(region)
    return int(r[0]), int(r[1]), int(r[2]), int(r[3])


# Device constants of the unmap, cached on the device like the resize
# matrices: a forward pass never makes a host-to-device copy, so it can be
# captured into a CUDA graph. Unbounded, since a captured graph keeps their
# addresses: an evicted constant would be freed under it.
@device_constant
def _pixel_centers(h: int, w: int, device: torch.device) -> torch.Tensor:
    """(1, H, W, 2) xy pixel-centre coordinates."""
    xs = np.arange(w, dtype=np.float32) + 0.5
    ys = np.arange(h, dtype=np.float32) + 0.5
    with torch.inference_mode(False):
        return torch.from_numpy(np.stack(np.meshgrid(xs, ys, indexing="xy"), axis=-1))[None].to(device)


@device_constant
def _xy(x: float, y: float, device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.tensor([x, y], dtype=torch.float32, device=device)


def _valid_mask(b: int, shape: Tuple[int, int], top: int, left: int, h: int, w: int, device) -> torch.Tensor:
    valid = torch.zeros(shape, dtype=torch.bool, device=device)
    valid[top : top + h, left : left + w] = True
    return valid[None].expand(b, *shape)


def unmap_predicted_flow(
    flow: torch.Tensor,
    img0_region_representation: Region,
    img1_region_representation: Region,
    img0_region_source: Region,
    img1_region_source: Region,
    img0_source_shape: Tuple[int, int],
    img1_source_shape: Tuple[int, int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Map predicted flow (B, H, W, 2) xy back to the original image space.

    Returns (flow (B, H0, W0, 2), validity (B, H0, W0) bool).
    """
    b = flow.shape[0]
    dev = flow.device
    r0t, r0b, r0l, r0r = _as_int_region(img0_region_representation)
    s0 = np.asarray(img0_region_source, dtype=np.float64)
    s1 = np.asarray(img1_region_source, dtype=np.float64)

    flow_roi = flow[:, r0t:r0b, r0l:r0r, :]
    rh, rw = r0b - r0t, r0r - r0l

    # source-pixel-center coordinate grid over the ROI
    source_coords = _pixel_centers(rh, rw, dev)

    src_valid_h = int(round(s0[1] - s0[0]))
    src_valid_w = int(round(s0[3] - s0[2]))
    tgt_valid_h = float(s1[1] - s1[0])
    tgt_valid_w = float(s1[3] - s1[2])

    # coordinates upsample bilinearly; flow values with nearest
    source_coords_valid = resize_hwc(source_coords, (src_valid_h, src_valid_w), antialias=False)
    target_coords_valid = resize_nearest_hwc(flow_roi, (src_valid_h, src_valid_w)) + source_coords_valid

    source_coords_valid = source_coords_valid * _xy(src_valid_w / rw, src_valid_h / rh, dev)
    target_coords_valid = target_coords_valid * _xy(tgt_valid_w / rw, tgt_valid_h / rh, dev)
    source_coords_valid = source_coords_valid + _xy(float(s0[2]), float(s0[0]), dev)
    target_coords_valid = target_coords_valid + _xy(float(s1[2]), float(s1[0]), dev)

    flow_source = target_coords_valid - source_coords_valid

    h0_full, w0_full = int(img0_source_shape[0]), int(img0_source_shape[1])
    st, sl = int(round(s0[0])), int(round(s0[2]))
    flow_output = torch.zeros((b, h0_full, w0_full, 2), dtype=flow.dtype, device=dev)
    flow_output[:, st : st + src_valid_h, sl : sl + src_valid_w, :] = flow_source.to(flow.dtype)
    return flow_output, _valid_mask(b, (h0_full, w0_full), st, sl, src_valid_h, src_valid_w, dev)


def unmap_predicted_channels(
    channel: torch.Tensor,
    img0_region_representation: Region,
    img0_region_source: Region,
    img0_source_shape: Tuple[int, int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Map predicted channels (B, H, W, C) back to the original image space
    (nearest upsample). Returns (channels (B, H0, W0, C), validity (B, H0, W0))."""
    b, _, _, c = channel.shape
    r0t, r0b, r0l, r0r = _as_int_region(img0_region_representation)
    s0 = np.asarray(img0_region_source, dtype=np.float64)

    roi = channel[:, r0t:r0b, r0l:r0r, :]
    valid_h = int(round(s0[1] - s0[0]))
    valid_w = int(round(s0[3] - s0[2]))
    roi_up = resize_nearest_hwc(roi, (valid_h, valid_w))

    h0_full, w0_full = int(img0_source_shape[0]), int(img0_source_shape[1])
    st, sl = int(round(s0[0])), int(round(s0[2]))
    out = torch.zeros((b, h0_full, w0_full, c), dtype=channel.dtype, device=channel.device)
    out[:, st : st + valid_h, sl : sl + valid_w, :] = roi_up
    return out, _valid_mask(b, (h0_full, w0_full), st, sl, valid_h, valid_w, channel.device)


def unmap_predicted_pairs(
    source_points: torch.Tensor,
    target_points: torch.Tensor,
    img0_region_representation: Region,
    img1_region_representation: Region,
    img0_region_source: Region,
    img1_region_source: Region,
    img0_source_shape: Optional[Tuple[int, int]] = None,
    img1_source_shape: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Map sparse (B, N, 2) xy point pairs from the representations back to
    the source images' pixel spaces."""
    r0 = np.asarray(img0_region_representation, dtype=np.float64)
    r1 = np.asarray(img1_region_representation, dtype=np.float64)
    s0 = np.asarray(img0_region_source, dtype=np.float64)
    s1 = np.asarray(img1_region_source, dtype=np.float64)

    sx, _ = scale_axis(s0[2], s0[3], r0[2], r0[3], source_points[:, :, 0], 0.0)
    sy, _ = scale_axis(s0[0], s0[1], r0[0], r0[1], source_points[:, :, 1], 0.0)
    tx, _ = scale_axis(s1[2], s1[3], r1[2], r1[3], target_points[:, :, 0], 0.0)
    ty, _ = scale_axis(s1[0], s1[1], r1[0], r1[1], target_points[:, :, 1], 0.0)
    return torch.stack([sx, sy], dim=-1), torch.stack([tx, ty], dim=-1)
