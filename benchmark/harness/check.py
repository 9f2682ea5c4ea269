"""The comparison that decides ``correct``: the numbers each cell compares
with the reference, and their limits (``benchmark/limits/<cell>.json``).

A predict cell compares each output field of the sampled calls (a uniform
sample of the window's calls, drawn from the seed: :class:`Reservoir`) with
the reference's answer on the same pair. The flow: two quantiles over a
pair's pixels of its end-point error, the 90th percentile (the bulk of the
image) and the 99.9th (its tail: the border pixels, where the window's taps
leave the image and the unmap works, are 0.7% of a 480x640 pair), each as a
share of the same quantile of the control's error on that pair (the
reference one precision step below, its module's ``CONTROL``): how far a
rounding moves the flow depends on the weights (UFM-Refine's window softmax
is more or less peaked from seed to seed: at the 90th percentile the program
read 0.024-0.127 px over 12 seeds and the control 0.29-1.32, a steady
7-10% of it on each seed), so a share of the control's error is steady where
the pixels are not. The covariance, the covisibility and the keypoint
confidence: the relative L2 gap ||got - want|| / ||want||. Each number is
the largest over the sampled calls and pairs. A training cell compares the loss of each step that runs at
the initial weights (the schedule's first rate is 0: steps 1 and 2; the
relative gap, the largest), the
norm of each parameter's first gradient as the optimizer received it, and
the norm of each parameter's change over the three steps: for a norm, the
gap between the system's and the reference's, over the reference's norm of
that parameter or the median parameter's, whichever is larger; for the
gradient the worst parameter's gap, for the change the median parameter's.
Elements whose reference gradient is under a thousandth of the median
parameter's RMS gradient element move by round-off alone and are left out
of the change (:func:`change_norms`).
"""

from __future__ import annotations

import json
import math
import os
import statistics
from typing import Dict, List, Mapping, Optional

import torch

__all__ = ["PREDICT_FIELDS", "FLOW_QUANTILES", "Reservoir", "predict_gaps", "predict_numbers", "norm_gaps",
           "change_norms", "train_gaps", "load_limits", "judge"]

# output field of the predict API -> the short name of its number
PREDICT_FIELDS = {"flow": "flow", "flow_covariance": "covariance", "covisibility": "covisibility",
                  "keypoint_confidence": "confidence"}
# the flow's numbers: name -> quantile of a pair's end-point errors
FLOW_QUANTILES = {"flow": 0.9, "flow_tail": 0.999}
ZERO_GRADIENT_SHARE = 1e-3
# steps whose loss is compared: the warmup's first rate is 0, so steps 1 and 2
# both run at the initial weights; from step 3 on the backbone's bf16 weights
# hold the masters' updates of ~1e-6 rounded away, and the loss reads that
INITIAL_STEPS = 2


def _rel_l2(got: Optional[torch.Tensor], want: torch.Tensor) -> float:
    if got is None or got.shape != want.shape:
        return math.inf
    got, want = got.double(), want.double().to(got.device)
    if not bool(torch.isfinite(got).all()):
        return math.inf
    return float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want).clamp(min=1e-30))


def _epe_quantiles(got: Optional[torch.Tensor], want: torch.Tensor) -> Optional[torch.Tensor]:
    """Of two (B, 2, H, W) flows, each pair's quantiles (:data:`FLOW_QUANTILES`)
    over its pixels of the end-point error in px, (B, quantiles); None where
    ``got`` is no finite flow of ``want``'s shape."""
    if got is None or got.shape != want.shape or not bool(torch.isfinite(got).all()):
        return None
    epe = torch.linalg.vector_norm(got.double() - want.double().to(got.device), dim=1).flatten(1)
    n = epe.shape[1]
    return torch.stack([torch.kthvalue(epe, max(1, math.ceil(q * n)), dim=1).values
                        for q in FLOW_QUANTILES.values()], dim=1)


def predict_gaps(got: Mapping[str, torch.Tensor], want: Mapping[str, torch.Tensor],
                 control: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    """One call's numbers (see the module's docstring): each flow quantile
    of ``got``'s error over ``control``'s on the same pair (the largest over
    the pairs; the same in px under ``<name>_px``, a reading), and for each
    other field the reference answers the relative L2 gap."""
    mine = _epe_quantiles(got.get("flow"), want["flow"])
    theirs = _epe_quantiles(control["flow"], want["flow"])
    gaps: Dict[str, float] = {}
    for j, k in enumerate(FLOW_QUANTILES):
        if mine is None:
            gaps[k] = gaps[f"{k}_px"] = math.inf
        else:
            gaps[k] = float((mine[:, j].to(theirs.device) / theirs[:, j].clamp(min=1e-12)).max())
            gaps[f"{k}_px"] = float(mine[:, j].max())
    gaps.update({short: _rel_l2(got.get(field), want[field])
                 for field, short in PREDICT_FIELDS.items() if field != "flow" and field in want})
    return gaps


def predict_numbers() -> List[str]:
    """The names of a predict cell's numbers."""
    return [*FLOW_QUANTILES, *(f"{k}_px" for k in FLOW_QUANTILES),
            *(v for k, v in PREDICT_FIELDS.items() if k != "flow")]


def norm_gaps(got: Mapping[str, float], want: Mapping[str, float]) -> Dict[str, float]:
    """Each parameter's gap between the two norms, over the reference's norm
    of it or of the median parameter, whichever is larger."""
    median = statistics.median(want.values())
    gaps = {}
    for k in want:
        gap = abs(got.get(k, math.nan) - want[k]) / max(want[k], median, 1e-30)
        gaps[k] = gap if math.isfinite(gap) else math.inf
    return gaps


def change_norms(got_delta: Mapping[str, torch.Tensor], want_delta: Mapping[str, torch.Tensor],
                 want_grad: Mapping[str, torch.Tensor]):
    """Each parameter's change norm on both sides over the elements that the
    reference's first gradient moves: elements whose reference gradient is
    under a thousandth of the median parameter's RMS gradient element (a key
    bias under softmax, say) move under Adam by round-off alone and are left
    out, on both sides; a parameter left with no element is left out.
    Returns (system's norms, reference's norms, elements left out)."""
    rms = {k: float(torch.linalg.vector_norm(g.double()) / math.sqrt(g.numel())) for k, g in want_grad.items()}
    floor = ZERO_GRADIENT_SHARE * statistics.median(rms.values())
    got, want, left_out = {}, {}, 0
    for k, g in want_grad.items():
        keep = g.abs() >= floor
        n = int(keep.sum())
        left_out += g.numel() - n
        if n:
            got[k] = float(torch.linalg.vector_norm(got_delta[k].to(g.device).double()[keep]))
            want[k] = float(torch.linalg.vector_norm(want_delta[k].double()[keep]))
    return got, want, left_out


def train_gaps(got_losses: List[float], want_losses: List[float], got_grad: Mapping[str, float],
               want_grad: Mapping[str, float], got_change: Mapping[str, float],
               want_change: Mapping[str, float]) -> Dict[str, float]:
    """The three numbers of a training cell (see the module's docstring);
    the change norms over the elements :func:`change_norms` keeps."""
    loss = 0.0
    for g, w in zip(got_losses[:INITIAL_STEPS], want_losses[:INITIAL_STEPS]):
        gap = abs(g - w) / max(abs(w), 1e-30)
        loss = max(loss, gap) if math.isfinite(gap) else math.inf
    if len(got_losses) != len(want_losses):
        loss = math.inf
    return {
        "loss": loss,
        "gradient": max(norm_gaps(got_grad, want_grad).values()),
        "change": statistics.median(norm_gaps(got_change, want_change).values()),
    }


class Reservoir:
    """A uniform sample of ``k`` of a stream of items whose length is not
    known ahead (Vitter's algorithm R), drawn from ``rng`` (a
    ``random.Random``): after n offers each has stayed with probability k / n.
    ``make`` is called only for an item that goes in."""

    def __init__(self, k: int, rng):
        self.k, self.rng, self.seen = k, rng, 0
        self.items: List[object] = []

    def offer(self, make) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(make())
            return
        slot = self.rng.randrange(self.seen)
        if slot < self.k:
            self.items[slot] = make()


def load_limits(root: str, cell: str) -> Dict[str, float]:
    """The cell's limits: number name -> limit."""
    with open(os.path.join(root, "benchmark", "limits", f"{cell}.json")) as f:
        spec = json.load(f)
    return {k: float(v["limit"]) for k, v in spec["numbers"].items()}


def judge(values: Mapping[str, float], limits: Mapping[str, float]) -> Dict[str, object]:
    """``correct`` (every limited number present, finite and within its
    limit) and each number beside its limit."""
    compared = {k: {"value": values.get(k, math.inf), "limit": lim} for k, lim in limits.items()}
    ok = all(math.isfinite(v["value"]) and v["value"] <= v["limit"] for v in compared.values())
    return {"correct": ok, "compared": compared}
