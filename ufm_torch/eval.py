"""Evaluation: EPE / outlier metrics over image-pair datasets (counterpart
of ``ufm_tpu/eval.py``).

- per-pair and aggregate metrics in numpy: EPE (mean / median), accuracy
  under 1, 3 and 5 px, the KITTI Fl outlier rate, covisibility precision /
  recall / IoU at 0.5, and forward-backward cycle consistency for pairs
  without ground truth;
- dataset walkers for directories of ``name_0.png`` / ``name_1.png`` pairs
  with ``.npy``, ``.flo`` or KITTI PNG ground truth
  (:mod:`ufm_torch.utils.flow_io`), such as the bundled synthetic pairs.

The model runs on its device; each prediction's flow and covisibility leave
it in one copy (:func:`ufm_torch.models.tiled.flow_and_covisibility`).
PNG files are read by the port's own codec (``ufm_torch.utils.image_io``);
other image formats need ``cv2``.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

__all__ = [
    "flow_metrics",
    "covisibility_metrics",
    "cycle_consistency_metrics",
    "evaluate_pairs",
    "find_pairs",
]


def flow_metrics(
    pred: np.ndarray, gt: np.ndarray, valid: Optional[np.ndarray] = None
) -> Dict[str, float]:
    """pred/gt: (H, W, 2); valid: (H, W) bool. Standard flow metrics."""
    err = np.linalg.norm(pred - gt, axis=-1)
    mag = np.linalg.norm(gt, axis=-1)
    if valid is not None:
        err = err[valid]
        mag = mag[valid]
    if err.size == 0:
        return {"epe": float("nan")}
    # KITTI Fl: error > 3px AND > 5% of GT magnitude
    fl = (err > 3.0) & (err > 0.05 * np.maximum(mag, 1e-6))
    return {
        "epe": float(err.mean()),
        "epe_median": float(np.median(err)),
        "acc_1px": float((err < 1.0).mean()),
        "acc_3px": float((err < 3.0).mean()),
        "acc_5px": float((err < 5.0).mean()),
        "fl_outlier": float(fl.mean()),
    }


def covisibility_metrics(pred_mask: np.ndarray, gt_mask: np.ndarray, threshold: float = 0.5) -> Dict[str, float]:
    p = pred_mask > threshold
    g = gt_mask > threshold
    tp = float((p & g).sum())
    return {
        "covis_precision": tp / max(float(p.sum()), 1.0),
        "covis_recall": tp / max(float(g.sum()), 1.0),
        "covis_iou": tp / max(float((p | g).sum()), 1.0),
    }


def cycle_consistency_metrics(
    fwd_flow: np.ndarray,
    bwd_flow: np.ndarray,
    covis: Optional[np.ndarray] = None,
    covis_threshold: float = 0.5,
    return_map: bool = False,
):
    """Forward-backward consistency for pairs with no ground truth.

    ``fwd_flow``: (H, W, 2) flow mapping source pixel p to target coordinates
    p + fwd(p) (target image may have a different resolution H'×W').
    ``bwd_flow``: (H', W', 2) flow from the swapped-order prediction.
    ``covis``: optional (H, W) covisibility in [0, 1]; only pixels the model
    itself claims are covisible are scored (occluded pixels have no
    round trip to close).

    cycle(p) = fwd(p) + bwd(p + fwd(p)) ≈ 0 for true correspondences; the
    backward flow is sampled bilinearly at the forward target coordinates.
    Returns cycle-EPE statistics over the scored pixels plus coverage; with
    ``return_map=True`` returns ``(stats, err_map)`` where ``err_map`` is the
    per-pixel cycle error ((H, W), zero at unscored pixels) — one
    interpolator for both the printed stats and any rendered heatmap.
    """
    h, w = fwd_flow.shape[:2]
    th, tw = bwd_flow.shape[:2]
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    tx = xs + fwd_flow[..., 0]
    ty = ys + fwd_flow[..., 1]

    inside = (tx >= 0) & (tx <= tw - 1) & (ty >= 0) & (ty <= th - 1)
    x0 = np.clip(np.floor(tx), 0, tw - 2).astype(int)
    y0 = np.clip(np.floor(ty), 0, th - 2).astype(int)
    fx = np.clip(tx - x0, 0.0, 1.0)[..., None]
    fy = np.clip(ty - y0, 0.0, 1.0)[..., None]
    b = bwd_flow.astype(np.float64)
    bwd_at_fwd = (
        b[y0, x0] * (1 - fx) * (1 - fy)
        + b[y0, x0 + 1] * fx * (1 - fy)
        + b[y0 + 1, x0] * (1 - fx) * fy
        + b[y0 + 1, x0 + 1] * fx * fy
    )
    cycle_err = np.linalg.norm(fwd_flow + bwd_at_fwd, axis=-1)

    scored = inside if covis is None else inside & (covis > covis_threshold)
    out = {"cycle_coverage": float(scored.mean())}
    if not scored.any():
        out["cycle_epe"] = float("nan")
        return (out, np.zeros((h, w))) if return_map else out
    err = cycle_err[scored]
    out.update(
        {
            "cycle_epe": float(err.mean()),
            "cycle_epe_median": float(np.median(err)),
            "cycle_acc_1px": float((err < 1.0).mean()),
            "cycle_acc_3px": float((err < 3.0).mean()),
        }
    )
    return (out, cycle_err * scored) if return_map else out


def find_pairs(directory: str, require_gt: bool = True) -> Iterable[Tuple[str, str, Optional[str]]]:
    """Yield (img0, img1, gt) triples for supported layouts:
    ``name_0.png / name_1.png / name_flow.npy`` (synthetic), ``name.flo``,
    or KITTI ``name_10.png / name_11.png / flow_occ/name_10.png``.
    With ``require_gt=False``, pairs without any ground-truth file are also
    yielded with ``gt=None`` (e.g. the reference's real photo pairs,
    reference examples/image_pairs/) for cycle-consistency evaluation."""
    for img0 in sorted(glob.glob(os.path.join(directory, "*_0.png"))):
        stem = img0[: -len("_0.png")]
        img1 = stem + "_1.png"
        if not os.path.exists(img1):
            continue
        gt_found = None
        for gt in (stem + "_flow.npy", stem + ".flo", stem + "_flow.png"):
            if os.path.exists(gt):
                gt_found = gt
                break
        if gt_found is not None:
            yield img0, img1, gt_found
        elif not require_gt:
            yield img0, img1, None


def _load_gt(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    if path.endswith(".npy"):
        return np.load(path), None
    if path.endswith(".flo"):
        from ufm_torch.utils.flow_io import read_flo

        return read_flo(path), None
    from ufm_torch.utils.flow_io import read_kitti_flow

    return read_kitti_flow(path)


def evaluate_pairs(
    model,
    directory: str,
    tiled: bool = False,
    out_json: Optional[str] = None,
    require_gt: bool = True,
) -> Dict[str, float]:
    """Run the model over all pairs in ``directory`` and aggregate metrics.

    Pairs with ground truth get EPE/accuracy/Fl metrics. With
    ``require_gt=False``, pairs without ground truth (the reference's real
    photo pairs) are scored by forward-backward cycle consistency over the
    model's own covisibility mask, plus covisibility coverage — the same
    quantitative signal available to any user without labeled flow."""
    from ufm_torch.models.tiled import flow_and_covisibility, predict_correspondences_tiled
    from ufm_torch.utils.image_io import read_rgb

    def _predict(src, tgt):
        if tiled:
            return predict_correspondences_tiled(model, src, tgt)
        result = model.predict_correspondences_batched(source_image=src, target_image=tgt)
        flow, covis = flow_and_covisibility(result)
        return flow[0], (covis[0] if result.covisibility is not None else None)

    rows = []
    for img0_path, img1_path, gt_path in find_pairs(directory, require_gt=require_gt):
        img0, img1 = read_rgb(img0_path), read_rgb(img1_path)

        flow, covis = _predict(img0, img1)
        m: Dict[str, float] = {"flow_finite": bool(np.isfinite(flow).all())}
        if covis is not None:
            m["covis_mean"] = float(np.mean(covis))
        if gt_path is not None:
            gt_flow, gt_valid = _load_gt(gt_path)
            m.update(flow_metrics(flow, gt_flow, gt_valid))
        else:
            bwd_flow, _ = _predict(img1, img0)
            m.update(cycle_consistency_metrics(flow, bwd_flow, covis))
        m["pair"] = os.path.basename(img0_path)
        rows.append(m)

    agg: Dict[str, float] = {}
    if rows:
        keys = sorted({k for r in rows for k in r if k not in ("pair", "flow_finite")})
        for k in keys:
            vals = [r[k] for r in rows if k in r and np.isfinite(r[k])]
            if vals:
                agg[k] = float(np.mean(vals))
        agg["all_flows_finite"] = all(r["flow_finite"] for r in rows)
        agg["num_pairs"] = len(rows)
    if out_json:
        with open(out_json, "w") as f:
            json.dump({"aggregate": agg, "per_pair": rows}, f, indent=2)
    return agg
