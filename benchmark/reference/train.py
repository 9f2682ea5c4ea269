"""UFM training in plain PyTorch: the benchmark's frozen reference of a train
step.

The loss of the published training contracts (a Charbonnier flow
regression, the bivariate Gaussian NLL of the flow error under the predicted
covariance with the error detached, weighted 0.1, and a binary cross-entropy
on the covisibility logits; every term a mean over the batch's pixels) and
AdamW with fp32 master weights: per parameter group, the gradient clipped at
global norm 1.0, then decoupled weight decay, Adam's moments with bias
correction, and the learning rate on a linear-warmup cosine schedule scaled
per group. The gradient of a batch is taken pair by pair and summed, so a
step fits beside whatever else is on the device.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from benchmark.reference import module_of

__all__ = ["GROUP_LR_SCALE", "group_of", "loss_terms", "Trainer"]

# learning-rate scale of each parameter group, by the parameter's top-level module
GROUP_LR_SCALE = {"encoder": 0.1, "info_sharing": 1.0, "output_head": 1.0, "uncertainty_head": 1.0,
                  "classification_head": 1.0, "unet_feature": 1.0}
_GROUP = {"encoder": "encoder", "info_sharing": "info_sharing", "head1": "output_head",
          "uncertainty_head": "uncertainty_head", "classification_head": "classification_head",
          "classification_bias": "classification_head", "unet_feature": "unet_feature", "conv1": "unet_feature",
          "conv2": "unet_feature"}
BETAS, EPS, MAX_NORM = (0.9, 0.999), 1e-8, 1.0


def group_of(name: str) -> str:
    return _GROUP.get(name.split(".")[0], "output_head")


def loss_terms(out: Dict[str, torch.Tensor], gt_flow: torch.Tensor, gt_covis: torch.Tensor) -> torch.Tensor:
    """The training loss of one batch from the network's outputs: a mean over
    its pixels of each term."""
    flow = out.get("regression_flow", out["flow"])
    loss = torch.sqrt(((flow - gt_flow) ** 2).sum(-1) + 1e-6).mean()
    if "flow_cov_inv" in out:
        e = (flow - gt_flow).detach()
        inv = out["flow_cov_inv"]
        quad = inv[..., 0] * e[..., 0] ** 2 + inv[..., 1] * e[..., 1] ** 2 + 2 * inv[..., 2] * e[..., 0] * e[..., 1]
        loss = loss + 0.1 * (0.5 * (quad + out["flow_cov_log_det"])).mean()
    if "covis_logits" in out:
        x, y = out["covis_logits"], gt_covis
        loss = loss + (torch.clamp(x, min=0) - x * y + torch.log1p(torch.exp(-x.abs()))).mean()
    if "refinement_log_softmax" in out:
        raise NotImplementedError("the refinement's classification loss is not written here")
    return loss


def warmup_cosine(step: int, peak: float, warmup: int, total: int) -> float:
    if step < warmup:
        return peak * step / warmup
    t = min(step - warmup, total - warmup)
    return peak * 0.5 * (1 + math.cos(math.pi * t / (total - warmup)))


class Trainer:
    """fp32 parameters (the masters) and AdamW's state over them; ``step``
    takes one batch and returns its loss. The network is ``arch``'s
    reference module's ``forward``, under ``numerics`` (default: the
    module's ``FP32``)."""

    def __init__(self, params: Dict[str, torch.Tensor], arch, lr: float = 1e-4, weight_decay: float = 0.05,
                 warmup: int = 100, total: int = 10000, numerics=None):
        self.ref = module_of(arch)
        self.arch, self.numerics = arch, numerics or self.ref.FP32
        self.params = {k: v.detach().float().clone().requires_grad_(True) for k, v in params.items()}
        self.m = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.lr, self.wd, self.warmup, self.total = lr, weight_decay, warmup, total
        self.t = 0
        self.last_grads: Dict[str, torch.Tensor] = {}

    def gradient(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Sum over the batch's pairs of each pair's share of the mean loss."""
        for p in self.params.values():
            p.grad = None
        b = batch["img1"].shape[0]
        total = 0.0
        for i in range(b):
            out = self.ref.forward(self.params, self.arch, batch["img1"][i:i + 1], batch["img2"][i:i + 1],
                                   self.numerics)
            loss = loss_terms(out, batch["gt_flow"][i:i + 1], batch["gt_covisibility"][i:i + 1]) / b
            loss.backward()
            total += float(loss.detach())
        return torch.tensor(total)

    @torch.no_grad()
    def apply(self) -> None:
        """Clip each group at global norm 1, then one AdamW update."""
        groups: Dict[str, List[str]] = {}
        for k in self.params:
            groups.setdefault(group_of(k), []).append(k)
        grads = {}
        for g, names in groups.items():
            gs = [self.params[k].grad if self.params[k].grad is not None else torch.zeros_like(self.params[k])
                  for k in names]
            norm = torch.sqrt(sum((x.double() ** 2).sum() for x in gs)).float()
            c = torch.where(norm < MAX_NORM, torch.ones_like(norm), MAX_NORM / norm)
            for k, x in zip(names, gs):
                grads[k] = x * c
        self.last_grads = grads
        b1, b2 = BETAS
        self.t += 1
        base = warmup_cosine(self.t - 1, self.lr, self.warmup, self.total)
        for k, p in self.params.items():
            lr = base * GROUP_LR_SCALE[group_of(k)]
            g = grads[k]
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            p.mul_(1 - lr * self.wd)
            m_hat = self.m[k] / (1 - b1 ** self.t)
            v_hat = self.v[k] / (1 - b2 ** self.t)
            p.sub_(lr * m_hat / (v_hat.sqrt() + EPS))

    def step(self, batch: Dict[str, torch.Tensor]) -> float:
        loss = self.gradient(batch)
        self.apply()
        return float(loss)
