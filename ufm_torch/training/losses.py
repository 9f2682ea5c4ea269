"""Training losses for the UFM family (counterpart of ``ufm_tpu/training/losses.py``).

The reference release is inference-only, but its architecture carries the
training-era contracts: per-group optimizer learning rates, a covariance head
for Gaussian NLL supervision, a covisibility head with logits for BCE, and
the refinement stage returning ``log_softmax`` for a classification loss
that supervises the refinement apart from the regression flow. The same
functions as the JAX package's, on torch tensors: ``stop_gradient`` is
``.detach()``, and ``torch.round`` rounds half to even like ``jnp.round``.

All maps channel-last; masks broadcast (B, H, W).

Under data parallelism (``group``: the process group of the ranks that hold
the other shards of the batch) every masked mean is the mean over the
*global* batch, as in the JAX package's sharded step: a rank divides its
local masked sum by the masked count summed over the group, so the ranks'
values sum to the global mean (shards differ in their mask counts, and a
mean of local means would not). ``ufm_total_loss`` returns this rank's share
of the global loss and the global metrics. Without a group the arithmetic is
the single-device one, unchanged.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

__all__ = [
    "epe",
    "flow_regression_loss",
    "covariance_nll_loss",
    "covisibility_bce_loss",
    "refinement_classification_loss",
    "ufm_total_loss",
]


def _masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor], group=None) -> torch.Tensor:
    if group is None:
        if mask is None:
            return x.mean()
        m = mask.to(x.dtype)
        return (x * m).sum() / m.sum().clamp(min=1.0)
    if mask is None:
        num, den = x.sum(), torch.full((), x.numel(), dtype=x.dtype, device=x.device)
    else:
        m = mask.to(x.dtype)
        num, den = (x * m).sum(), m.sum().detach()
    dist.all_reduce(den, group=group)
    return num / den.clamp(min=1.0)


def epe(
    pred_flow: torch.Tensor, gt_flow: torch.Tensor, mask: Optional[torch.Tensor] = None, group=None
) -> torch.Tensor:
    """Average end-point error; flows (B, H, W, 2)."""
    err = torch.linalg.vector_norm(pred_flow - gt_flow, dim=-1)
    return _masked_mean(err, mask, group)


def flow_regression_loss(
    pred_flow: torch.Tensor,
    gt_flow: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    charbonnier_eps: float = 1e-3,
    group=None,
) -> torch.Tensor:
    """Robust (Charbonnier) flow regression loss."""
    sq = ((pred_flow - gt_flow) ** 2).sum(dim=-1)
    err = torch.sqrt(sq + charbonnier_eps**2)
    return _masked_mean(err, mask, group)


def covariance_nll_loss(
    pred_flow: torch.Tensor,
    gt_flow: torch.Tensor,
    cov_inv: torch.Tensor,
    cov_log_det: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    group=None,
) -> torch.Tensor:
    """Bivariate Gaussian negative log-likelihood of the flow error under the
    predicted covariance ([inv_xx, inv_yy, inv_xy] channel layout of
    Covariance2DAdaptor). The flow error is detached: this loss supervises
    only the covariance branch."""
    e = (pred_flow - gt_flow).detach()
    ex, ey = e[..., 0], e[..., 1]
    quad = cov_inv[..., 0] * ex * ex + cov_inv[..., 1] * ey * ey + 2.0 * cov_inv[..., 2] * ex * ey
    nll = 0.5 * (quad + cov_log_det)
    return _masked_mean(nll, mask, group)


def covisibility_bce_loss(
    logits: torch.Tensor, gt_mask: torch.Tensor, valid: Optional[torch.Tensor] = None, group=None
) -> torch.Tensor:
    """Binary cross-entropy on covisibility logits (B, H, W)."""
    gt = gt_mask.to(logits.dtype)
    bce = logits.clamp(min=0) - logits * gt + torch.log1p(torch.exp(-logits.abs()))
    return _masked_mean(bce, valid, group)


def refinement_classification_loss(
    log_softmax: torch.Tensor,
    regression_flow: torch.Tensor,
    gt_flow: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    group=None,
) -> torch.Tensor:
    """Cross-entropy over the P x P neighborhood: the correct class is the
    offset that moves the regressed flow toward the ground truth. Only pixels
    whose true offset lies inside the window are supervised."""
    b, h, w, p, _ = log_softmax.shape
    r = (p - 1) // 2
    target_off = gt_flow - regression_flow.detach()  # (B, H, W, 2) xy
    jx = (torch.round(target_off[..., 0]) + r).clamp(0, p - 1).long()
    iy = (torch.round(target_off[..., 1]) + r).clamp(0, p - 1).long()
    flat = log_softmax.reshape(b, h, w, p * p)
    idx = iy * p + jx
    nll = -torch.gather(flat, -1, idx[..., None])[..., 0]
    inside = (target_off[..., 0].abs() <= r + 0.5) & (target_off[..., 1].abs() <= r + 0.5)
    m = inside if mask is None else (inside & (mask > 0))
    return _masked_mean(nll, m, group)


def ufm_total_loss(
    outputs: Dict[str, torch.Tensor],
    batch: Dict[str, torch.Tensor],
    weights: Optional[Dict[str, float]] = None,
    group=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Combined training loss from the raw network output dict
    (:class:`ufm_torch.models.UFMNet`) and a batch with ``gt_flow``
    (B, H, W, 2), ``gt_covisibility`` (B, H, W), optional ``valid`` mask.
    Returns (loss, metrics); the metrics are the loss terms, ``epe`` and
    ``total_loss``. With ``group`` (this rank's batch is one shard of a
    global batch split over the group's ranks), ``loss`` is this rank's
    share of the global loss (the shares sum to it) and the metrics are the
    global values, the same on every rank."""
    w = {"flow": 1.0, "covariance": 0.1, "covisibility": 1.0, "refinement": 1.0}
    if weights:
        w.update(weights)

    gt_flow = batch["gt_flow"]
    valid = batch.get("valid")
    metrics: Dict[str, torch.Tensor] = {}

    reg_flow = outputs.get("regression_flow", outputs["flow"])
    loss = w["flow"] * flow_regression_loss(reg_flow, gt_flow, valid, group=group)
    metrics["flow_loss"] = loss
    metrics["epe"] = epe(outputs["flow"], gt_flow, valid, group=group)

    if "flow_cov_inv" in outputs:
        cov = w["covariance"] * covariance_nll_loss(
            reg_flow, gt_flow, outputs["flow_cov_inv"], outputs["flow_cov_log_det"], valid, group=group
        )
        metrics["covariance_loss"] = cov
        loss = loss + cov

    if "covis_logits" in outputs and "gt_covisibility" in batch:
        cv = w["covisibility"] * covisibility_bce_loss(
            outputs["covis_logits"], batch["gt_covisibility"], valid, group=group
        )
        metrics["covisibility_loss"] = cv
        loss = loss + cv

    if "refinement_log_softmax" in outputs:
        rf = w["refinement"] * refinement_classification_loss(
            outputs["refinement_log_softmax"], outputs.get("regression_flow", reg_flow), gt_flow, valid, group=group
        )
        metrics["refinement_loss"] = rf
        loss = loss + rf

    metrics["total_loss"] = loss
    if group is not None:  # the shares' sums: one all-reduce for every metric
        names = list(metrics)
        total = torch.stack([metrics[k].detach() for k in names])
        dist.all_reduce(total, group=group)
        metrics = dict(zip(names, total.unbind()))
    return loss, metrics
