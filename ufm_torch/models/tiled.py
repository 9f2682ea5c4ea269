"""Tiled high-resolution inference, coarse to fine (counterpart of
``ufm_tpu/models/tiled.py``).

1. **Coarse pass**: the standard downscaled prediction gives a global flow
   field (tiles alone cannot match wide baselines).
2. **Tile pass**: overlapping tiles of the source at the model's native
   resolution; each tile's target window sits at the tile plus the median
   coarse flow over it. The (tile, window) pairs go through the model
   ``max_batch`` at a time: one batched forward on the card for each group.
3. **Stitch**: per-tile flows composed with their window offsets, blended
   with covisibility-weighted Hann feathering and gated toward the coarse
   flow where they disagree.

Only the model calls run on the card. Each call's flow and covisibility
leave the device in one copy; tile placement and stitching run in numpy on
the host, as in the JAX package, so the two agree to the model's outputs.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

__all__ = ["predict_correspondences_tiled", "last_tile_stats", "flow_and_covisibility"]

# diagnostics of the most recent call (tile counts, rejections, gate); not
# part of the stable API
last_tile_stats: dict = {}


def flow_and_covisibility(result) -> Tuple[np.ndarray, np.ndarray]:
    """A prediction's flow (B, H, W, 2) and covisibility (B, H, W) as float32
    numpy arrays, in one device-to-host copy (covisibility is ones where the
    model has none)."""
    flow = result.flow.flow_output
    covis = result.covisibility.mask if result.covisibility is not None else torch.ones_like(flow[:, 0])
    both = torch.cat([flow.float(), covis.float()[:, None]], dim=1).cpu().numpy()
    return both[:, :2].transpose(0, 2, 3, 1), both[:, 2]


def _tile_starts(full: int, tile: int, overlap: float) -> List[int]:
    if full <= tile:
        return [0]
    stride = max(1, int(tile * (1.0 - overlap)))
    starts = list(range(0, full - tile, stride))
    starts.append(full - tile)
    return starts


def _hann2d(h: int, w: int) -> np.ndarray:
    wy = np.hanning(h + 2)[1:-1]
    wx = np.hanning(w + 2)[1:-1]
    return np.clip(np.outer(wy, wx), 1e-4, None)


def predict_correspondences_tiled(
    model,
    source_image: np.ndarray,
    target_image: np.ndarray,
    overlap: float = 0.33,
    max_batch: int = 16,
    coarse_gate_px: float | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """High-res correspondence via coarse-to-fine tiling.

    source_image/target_image: (H, W, 3) uint8 RGB (may differ in size);
    ``model`` is any of the port's models (or an object with
    ``inference_resolution`` and ``predict_correspondences_batched``).
    Returns (flow (H, W, 2) float32 xy in source pixel space, covisibility
    (H, W) float32).

    ``coarse_gate_px`` bounds how far the fine result may pull away from the
    coarse global solution before it stops being trusted (robust fusion; see
    step 3 below). Default: the coarse pass's detail scale — the downscale
    factor in pixels — since genuine tile-level corrections recover detail
    the downscale blurred and are bounded by it, while larger deviations are
    tile failures (mislocated window / textureless tile).
    """
    src = np.asarray(source_image)
    tgt = np.asarray(target_image)
    sh, sw = src.shape[:2]
    th, tw = tgt.shape[:2]

    tile_w, tile_h = model.inference_resolution[0]  # model-native (W, H)

    # ---- 1. coarse global pass ---------------------------------------------
    coarse_flow, coarse_covis = flow_and_covisibility(
        model.predict_correspondences_batched(source_image=src, target_image=tgt)
    )
    coarse_flow, coarse_covis = coarse_flow[0], coarse_covis[0]  # (H, W, 2), (H, W)

    if sh <= tile_h and sw <= tile_w:
        last_tile_stats.clear()
        last_tile_stats.update(tiles=0, tiles_rejected=0, gate_px=0.0)
        return coarse_flow.astype(np.float32), coarse_covis.astype(np.float32)

    # ---- 2. tile placement + batched fine pass -----------------------------
    ys = _tile_starts(sh, tile_h, overlap)
    xs = _tile_starts(sw, tile_w, overlap)

    tiles, windows, offsets = [], [], []
    for y0 in ys:
        for x0 in xs:
            tile = src[y0 : y0 + tile_h, x0 : x0 + tile_w]
            roi_flow = coarse_flow[y0 : y0 + tile_h, x0 : x0 + tile_w]
            roi_cov = coarse_covis[y0 : y0 + tile_h, x0 : x0 + tile_w]
            good = roi_cov > 0.5
            med = (
                np.median(roi_flow[good], axis=0)
                if good.sum() > 64
                else np.median(roi_flow.reshape(-1, 2), axis=0)
            )
            # target window centered at tile + median flow, clamped in-bounds
            wy0 = int(round(np.clip(y0 + med[1], 0, max(th - tile_h, 0))))
            wx0 = int(round(np.clip(x0 + med[0], 0, max(tw - tile_w, 0))))
            win = tgt[wy0 : wy0 + tile_h, wx0 : wx0 + tile_w]
            if win.shape[:2] != (tile_h, tile_w):  # target smaller than tile
                pad = np.zeros((tile_h, tile_w, 3), dtype=tgt.dtype)
                pad[: win.shape[0], : win.shape[1]] = win
                win = pad
            tiles.append(tile)
            windows.append(win)
            offsets.append((x0, y0, wx0, wy0))

    flow_acc = np.zeros((sh, sw, 2), dtype=np.float64)
    cov_acc = np.zeros((sh, sw), dtype=np.float64)
    weight_acc = np.zeros((sh, sw), dtype=np.float64)
    feath_only = np.zeros((sh, sw))  # pure feather weight of ACCEPTED tiles
    feather = _hann2d(tile_h, tile_w)

    # ---- 3. robust fusion bounds -------------------------------------------
    # The coarse pass lost detail at the downscale factor's scale; genuine
    # fine corrections are bounded by it. Beyond that, a tile is suspect
    # (window mislocated by a bad median, textureless content, occlusion).
    scale_factor = max(sh / tile_h, sw / tile_w, 1.0)
    gate_px = float(coarse_gate_px) if coarse_gate_px is not None else max(4.0, scale_factor)
    tile_reject_px = 2.0 * gate_px
    tiles_rejected = 0

    for i in range(0, len(tiles), max_batch):
        batch_src = np.stack(tiles[i : i + max_batch])
        batch_tgt = np.stack(windows[i : i + max_batch])
        res = model.predict_correspondences_batched(source_image=batch_src, target_image=batch_tgt)
        fine_flow, fine_cov = flow_and_covisibility(res)  # (B, th, tw, 2), (B, th, tw)
        for j in range(batch_src.shape[0]):
            x0, y0, wx0, wy0 = offsets[i + j]
            # absolute flow: source pixel (x0+x) maps to (wx0 + x + fine_x)
            abs_flow = fine_flow[j] + np.array([wx0 - x0, wy0 - y0], dtype=np.float64)
            # whole-tile rejection: when even the MEDIAN pixel disagrees with
            # the global solution beyond the detail scale, the window was
            # mislocated — nothing in this tile is trustworthy
            coarse_roi = coarse_flow[y0 : y0 + tile_h, x0 : x0 + tile_w]
            disagree = np.linalg.norm(abs_flow - coarse_roi, axis=-1)
            if np.median(disagree) > tile_reject_px:
                tiles_rejected += 1
                continue
            wgt = feather * np.clip(fine_cov[j], 0.05, None)
            flow_acc[y0 : y0 + tile_h, x0 : x0 + tile_w] += abs_flow * wgt[..., None]
            cov_acc[y0 : y0 + tile_h, x0 : x0 + tile_w] += fine_cov[j] * feather
            weight_acc[y0 : y0 + tile_h, x0 : x0 + tile_w] += wgt
            feath_only[y0 : y0 + tile_h, x0 : x0 + tile_w] += feather

    feather_acc = np.where(weight_acc > 0, weight_acc, 1.0)
    flow_fine = flow_acc / feather_acc[..., None]
    cov_norm = np.zeros_like(cov_acc)
    covered = weight_acc > 0
    # covisibility normalized by the pure feather weight (not cov-gated) of
    # the tiles that actually contributed — a rejected tile's feather must
    # not dilute an accepted neighbor's covisibility where they overlap
    cov_norm[covered] = (cov_acc / np.where(feath_only > 0, feath_only, 1.0))[covered]

    # per-pixel soft gate: pull the fused result toward coarse as the
    # disagreement leaves the plausible-correction band (Gaussian falloff at
    # gate_px), so single-pixel tile outliers cannot dominate the EPE tail
    d = np.linalg.norm(flow_fine - coarse_flow, axis=-1)
    w_fine = np.exp(-((d / gate_px) ** 2)) * covered
    flow_out = coarse_flow + w_fine[..., None] * (flow_fine - coarse_flow)
    cov_out = np.where(covered, cov_norm, coarse_covis)
    last_tile_stats.clear()
    last_tile_stats.update(
        tiles=len(tiles), tiles_rejected=tiles_rejected, gate_px=round(gate_px, 2)
    )
    return flow_out.astype(np.float32), cov_out.astype(np.float32)
