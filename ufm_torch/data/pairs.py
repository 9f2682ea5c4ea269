"""Training data: image pairs with ground-truth flow (counterpart of
``ufm_tpu/data/pairs.py``).

Directory datasets of (img0, img1, flow) triples (the layouts of
:func:`ufm_torch.eval.find_pairs`), resized on the host to the training
resolution (images antialiased, flow values nearest-resampled and rescaled
per axis) with the port's own resize matrices, normalized for the encoder,
shuffled and stacked into fixed-shape numpy batches that
:func:`ufm_torch.training.fit` moves to the network's device. PNG files
are read by the port's codec (``ufm_torch.utils.image_io``), other image
formats by ``cv2``.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ufm_torch.eval import find_pairs
from ufm_torch.nn.encoders.image_normalizations import IMAGE_NORMALIZATION_DICT
from ufm_torch.ops.resize import _nearest_index_np, _resize_matrix_np

__all__ = ["FlowPairDataset", "train_batches"]


class FlowPairDataset:
    """List of (img0_path, img1_path, gt_path) triples from a directory."""

    def __init__(self, directory: str):
        self.directory = directory
        self.items: List[Tuple[str, str, str]] = list(find_pairs(directory))
        if not self.items:
            raise FileNotFoundError(f"no image pairs found under {directory}")

    def __len__(self) -> int:
        return len(self.items)

    def load(self, index: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Optional[np.ndarray]]:
        """Returns (img0 RGB u8, img1 RGB u8, flow (H, W, 2), valid|None)."""
        from ufm_torch.utils.image_io import read_rgb

        img0_path, img1_path, gt_path = self.items[index]
        img0, img1 = read_rgb(img0_path), read_rgb(img1_path)
        if gt_path.endswith(".npy"):
            flow, valid = np.load(gt_path), None
        elif gt_path.endswith(".flo"):
            from ufm_torch.utils.flow_io import read_flo

            flow, valid = read_flo(gt_path), None
        else:
            from ufm_torch.utils.flow_io import read_kitti_flow

            flow, valid = read_kitti_flow(gt_path)
        return img0, img1, flow, valid


def _resize_np(arr: np.ndarray, out_hw: Tuple[int, int], antialias: bool) -> np.ndarray:
    """Host-side separable resize with the matrices the device path uses;
    arr (H, W, C) float."""
    wh = _resize_matrix_np(arr.shape[0], out_hw[0], antialias)
    ww = _resize_matrix_np(arr.shape[1], out_hw[1], antialias)
    return np.einsum("ow,hwc->hoc", ww, np.einsum("oh,hwc->owc", wh, arr.astype(np.float64))).astype(
        np.float32
    )


def train_batches(
    dataset: FlowPairDataset,
    batch_size: int,
    resolution_hw: Tuple[int, int],
    data_norm_type: str = "dinov2",
    seed: int = 0,
    epochs: Optional[int] = None,
    drop_remainder: bool = True,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yield train batches: img1/img2 normalized (B, H, W, 3) float32,
    gt_flow (B, H, W, 2) in training-resolution pixels, gt_covisibility and
    valid (B, H, W) float32."""
    th, tw = int(resolution_hw[0]), int(resolution_hw[1])
    norm = IMAGE_NORMALIZATION_DICT[data_norm_type]
    rng = np.random.default_rng(seed)

    epoch = 0
    while epochs is None or epoch < epochs:
        order = rng.permutation(len(dataset))
        buf: List[Dict[str, np.ndarray]] = []
        for idx in order:
            img0, img1, flow, valid = dataset.load(int(idx))
            sh, sw = img0.shape[:2]

            img0_r = _resize_np(img0.astype(np.float32) / 255.0, (th, tw), antialias=True)
            img1_r = _resize_np(img1.astype(np.float32) / 255.0, (th, tw), antialias=True)
            img0_r = (img0_r - norm.mean) / norm.std
            img1_r = (img1_r - norm.mean) / norm.std

            # flow: nearest-resample values (like the unmap path), rescale per axis
            hi = _nearest_index_np(sh, th)
            wi = _nearest_index_np(sw, tw)
            flow_r = flow[hi][:, wi] * np.array([tw / sw, th / sh], dtype=np.float32)
            valid_r = (
                valid[hi][:, wi].astype(np.float32)
                if valid is not None
                else np.ones((th, tw), dtype=np.float32)
            )

            buf.append(
                {
                    "img1": img0_r,
                    "img2": img1_r,
                    "gt_flow": flow_r.astype(np.float32),
                    "gt_covisibility": valid_r,
                    "valid": valid_r,
                }
            )
            if len(buf) == batch_size:
                yield {k: np.stack([b[k] for b in buf]) for k in buf[0]}
                buf = []
        if buf and not drop_remainder:
            yield {k: np.stack([b[k] for b in buf]) for k in buf[0]}
        epoch += 1
