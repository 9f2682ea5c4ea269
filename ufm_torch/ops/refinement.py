"""Classification-refinement ops (counterpart of ``ufm_tpu/ops/refinement.py``).

Around each pixel's predicted target location, a P x P window of target-view
features is sampled bicubically (zeros padding, ``align_corners=False``) and
correlated with the source-view feature (1 x P^2 attention with temperature
and a learned bias); the outputs are the attention-weighted integer-offset
flow residual and the log-softmax.

- :func:`obtain_neighborhood_features` + :func:`refinement_attention` are the
  materializing reference semantics: they build the (B, H, W, P, P, C)
  window. Tests hold the fused path to them.
- :func:`fused_refinement_attention` is what the network calls. It never
  builds the window: the score of each window position is bilinear in the
  (P+3)^2 integer taps, so each tap is reduced against q once and the scores
  are a separable cubic combination of those scalars. By default it calls the
  dispatcher op ``ufm_torch::window_refinement`` (:mod:`ufm_torch.ops.library`):
  a CUDA tensor takes the Hopper kernel
  (:mod:`ufm_torch.ops.window_refinement`), a CPU tensor its plain version.

All maps are channel-last; positions are in pixel-index space.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ufm_torch.ops import library
from ufm_torch.ops.grid_sample import grid_sample
from ufm_torch.ops.window_refinement import (
    base_grid,
    neighborhood_offsets_xy,
    window_refinement,
    window_refinement_reference,
)

__all__ = [
    "IMPLS",
    "base_grid",
    "neighborhood_offsets_xy",
    "obtain_neighborhood_features",
    "refinement_attention",
    "fused_refinement_attention",
]

IMPLS = ("cuda", "torch")


def obtain_neighborhood_features(
    flow: torch.Tensor, other_features: torch.Tensor, local_patch: int = 5
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Materializing neighborhood sampler. flow (B, H, W, 2) xy,
    other_features (B, H, W, C) -> (features (B, H, W, P, P, C),
    offsets_xy (1, 1, 1, P, P, 2))."""
    if local_patch % 2 != 1:
        raise ValueError(f"local_patch must be odd, got {local_patch}")
    p = local_patch
    _, h, w, _ = other_features.shape
    dev = other_features.device
    pos = flow + base_grid(h, w, dev)[None]
    offs = neighborhood_offsets_xy(p, dev)
    coords = pos[:, :, :, None, None, :] + offs[None, None, None]  # (B, H, W, P, P, 2)
    # normalize to the grid convention where index c samples position c
    norm = torch.tensor([w, h], dtype=torch.float32, device=dev)
    grid = (coords + 0.5) / norm * 2.0 - 1.0
    return grid_sample(other_features, grid, mode="bicubic"), offs[None, None, None]


def refinement_attention(
    query_features: torch.Tensor,
    neighborhood_features: torch.Tensor,
    neighborhood_residual: torch.Tensor,
    classification_bias: torch.Tensor,
    temperature: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention over materialized windows: query (B, H, W, C), windows
    (B, H, W, P, P, C), offsets broadcastable to (..., P, P, 2), bias (P*P,)
    -> (residual (B, H, W, 2), log_softmax (B, H, W, P, P))."""
    b, h, w, p, _, _ = neighborhood_features.shape
    scores = torch.einsum("bhwc,bhwijc->bhwij", query_features, neighborhood_features)
    flat = (scores / temperature + classification_bias.reshape(p, p)).reshape(b, h, w, p * p)
    attn = torch.softmax(flat, dim=-1)
    log_softmax = torch.log_softmax(flat, dim=-1).reshape(b, h, w, p, p)
    offs = torch.broadcast_to(neighborhood_residual, (1, 1, 1, p, p, 2)).reshape(p * p, 2)
    return attn @ offs, log_softmax


def fused_refinement_attention(
    query_features: torch.Tensor,
    target_features: torch.Tensor,
    flow: torch.Tensor,
    classification_bias: torch.Tensor,
    temperature: float,
    local_patch: int = 5,
    impl: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused sampler + attention: query / target features (B, H, W, C), flow
    (B, H, W, 2) xy, bias (P*P,) -> (residual (B, H, W, 2), log_softmax
    (B, H, W, P, P)), equal to the materializing composition.

    ``impl``: ``None`` calls the op, whose implementation the tensors' device
    picks (CUDA: the kernel, CPU: the plain version); ``"cuda"`` asks for the
    kernel, which raises on what it does not take; ``"torch"`` asks for the
    plain version, decomposed, on any device.
    """
    if impl in (None, "cuda"):
        # the kernel's operands: fp32, contiguous (the flow head's output is
        # a permuted view)
        q, f, fl, bias = (t.float().contiguous() for t in (query_features, target_features, flow, classification_bias))
        if impl is None:
            return library.window_refinement(q, f, fl, bias, float(temperature), int(local_patch))
        return window_refinement(q, f, fl, bias, temperature, local_patch)
    if impl == "torch":
        return window_refinement_reference(
            query_features, target_features, flow, classification_bias, temperature, local_patch
        )
    raise ValueError(f"unknown refinement impl: {impl!r} (expected one of {IMPLS} or None)")
