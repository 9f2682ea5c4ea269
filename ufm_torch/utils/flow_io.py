"""Optical-flow file formats: Middlebury .flo and KITTI 16-bit PNG
(counterpart of ``ufm_tpu/utils/flow_io.py``).

Pure numpy; the KITTI functions use the port's PNG codec
(``ufm_torch.utils.image_io``).
"""

from __future__ import annotations

import numpy as np

__all__ = ["read_flo", "write_flo", "read_kitti_flow", "write_kitti_flow"]

_FLO_MAGIC = 202021.25


def read_flo(path: str) -> np.ndarray:
    """Read a Middlebury .flo file -> (H, W, 2) float32."""
    with open(path, "rb") as f:
        magic = np.frombuffer(f.read(4), np.float32)[0]
        if magic != _FLO_MAGIC:
            raise ValueError(f"{path}: bad .flo magic {magic}")
        w = int(np.frombuffer(f.read(4), np.int32)[0])
        h = int(np.frombuffer(f.read(4), np.int32)[0])
        data = np.frombuffer(f.read(h * w * 2 * 4), np.float32)
    return data.reshape(h, w, 2).copy()


def write_flo(path: str, flow: np.ndarray) -> None:
    """Write (H, W, 2) float32 flow as Middlebury .flo."""
    flow = np.asarray(flow, dtype=np.float32)
    assert flow.ndim == 3 and flow.shape[2] == 2
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        f.write(np.float32(_FLO_MAGIC).tobytes())
        f.write(np.int32(w).tobytes())
        f.write(np.int32(h).tobytes())
        f.write(flow.tobytes())


def read_kitti_flow(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Read KITTI flow PNG -> ((H, W, 2) float32 flow, (H, W) bool valid)."""
    from ufm_torch.utils.image_io import read_png

    raw = read_png(path, anydepth=True)
    if raw.dtype != np.uint16:
        raise ValueError(f"{path}: not a 16-bit KITTI flow png")
    raw = raw.astype(np.float64)  # RGB: [u, v, valid]
    flow = (raw[:, :, :2] - 2**15) / 64.0
    valid = raw[:, :, 2] > 0
    return flow.astype(np.float32), valid


def write_kitti_flow(path: str, flow: np.ndarray, valid: np.ndarray | None = None) -> None:
    from ufm_torch.utils.image_io import write_png

    flow = np.asarray(flow, dtype=np.float64)
    h, w = flow.shape[:2]
    if valid is None:
        valid = np.ones((h, w), dtype=bool)
    out = np.zeros((h, w, 3), dtype=np.uint16)
    out[:, :, 0] = np.clip(flow[:, :, 0] * 64.0 + 2**15, 0, 2**16 - 1).astype(np.uint16)
    out[:, :, 1] = np.clip(flow[:, :, 1] * 64.0 + 2**15, 0, 2**16 - 1).astype(np.uint16)
    out[:, :, 2] = valid.astype(np.uint16)
    write_png(path, out)
