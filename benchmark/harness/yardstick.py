"""The yardstick: the card's peaks, the least time each kernel's work needs,
the model's operations, and the statistics of a run.

The peaks are NVIDIA's data sheet for the H100 SXM (dense, no sparsity) at
its full 700 W; a card set to a lower power limit runs below them, so a
result carries the card's limit beside it. A bound is the larger of the
operations over the peak rate and the bytes over the peak bandwidth, each
input read once and each output written once; a kernel's roofline share is
the summed bound of its calls over their summed device time.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch

__all__ = [
    "PEAK_BF16_FLOPS", "PEAK_FP32_FLOPS", "PEAK_BYTES",
    "attention_bound_ms", "attention_bwd_bound_ms", "linear_gelu_bound_ms", "linear_gelu_bwd_bound_ms",
    "window_bound_ms", "window_taps", "percentile", "model_flops_per_pair", "per_forward_bounds",
]

PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12  # without the tensor cores
PEAK_BYTES = 3.35e12


def _bound(flops: float, nbytes: float, peak: float) -> Tuple[float, str]:
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def attention_bound_ms(b, s, h, d):
    """Attention forward on bf16 (B, S, H, D): 4 B H S^2 D operations; q, k,
    v read once and the output written once."""
    return _bound(4 * b * h * s * s * d, 4 * b * s * h * d * 2, PEAK_BF16_FLOPS)


def attention_bwd_bound_ms(b, s, h, d):
    """Attention backward: 10 B H S^2 D operations (five S x S x D
    products); q, k, v, o, g read once, dq, dk, dv written once (bf16), the
    row log-sum-exp read and the row delta written once (fp32)."""
    return _bound(10 * b * h * s * s * d, 8 * b * s * h * d * 2 + 2 * b * h * s * 4, PEAK_BF16_FLOPS)


def linear_gelu_bound_ms(m, k, n):
    """fc1 + GELU, (M, K) x (K, N) in bf16: 2 M N K operations; x, W and the
    bias read once, y written once."""
    return _bound(2 * m * n * k, 2 * (m * k + n * k + n + m * n), PEAK_BF16_FLOPS)


def linear_gelu_bwd_bound_ms(m, n2, n):
    """fc2's input gradient with the GELU gradient, g (M, N2) x w2 (N2, N) in
    bf16: 2 M N N2 operations; g, w2 and h read once, dh written once."""
    return _bound(2 * m * n * n2, 2 * (m * n2 + n2 * n + 2 * m * n), PEAK_BF16_FLOPS)


def window_bound_ms(shape, p, in_image_taps):
    """The window refinement forward in fp32 on q (B, H, W, C): 2C operations
    for each tap inside the image (those outside are zeros never read), the
    cubic x pass (K rows x P x 4 FMA) and y pass (P x P x 4 FMA), ~10 per
    score for temperature, bias, softmax, log_softmax and the residual; q, f,
    flow read once, the residual and log_softmax written once."""
    b, h, w, c = shape
    n, k = b * h * w, p + 3
    nbytes = 4 * (n * (2 * c + 2 + 2 + p * p) + p * p)
    flops = 2 * c * in_image_taps + n * (8 * k * p + 8 * p * p + 10 * p * p)
    return _bound(flops, nbytes, PEAK_FP32_FLOPS)


def window_taps(flow: torch.Tensor, p: int) -> float:
    """Taps inside the image of every pixel's (P+3)^2 tap window around
    floor(flow + its position) (B, H, W, 2 xy): what these inputs need read."""
    _, h, w, _ = flow.shape
    r = (p - 1) // 2
    ys, xs = torch.meshgrid(torch.arange(h, device=flow.device, dtype=torch.float32),
                            torch.arange(w, device=flow.device, dtype=torch.float32), indexing="ij")
    x0 = torch.floor(flow[..., 0].float() + xs)
    y0 = torch.floor(flow[..., 1].float() + ys)
    nx = ((x0 + r + 2).clamp(max=w - 1) - (x0 - r - 1).clamp(min=0) + 1).clamp(min=0)
    ny = ((y0 + r + 2).clamp(max=h - 1) - (y0 - r - 1).clamp(min=0) + 1).clamp(min=0)
    return float((nx * ny).double().sum())


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0-100) by linear interpolation between the
    closest ranks, over all values."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def model_flops_per_pair(arch, train: bool) -> float:
    """The operations of ``arch``'s reference network on one pair at the
    model resolution, counted by ``torch.utils.flop_counter.FlopCounterMode``
    on the meta device (matrix products and convolutions): the forward, or
    with ``train`` the forward, the loss and the backward."""
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.reference import module_of
    from benchmark.reference.train import loss_terms

    ref = module_of(arch)
    h, w = arch.model_hw
    params = {k: torch.empty(shape, device="meta", requires_grad=train)
              for k, (shape, _) in ref.param_specs(arch).items()}
    img = torch.empty((1, h, w, 3), device="meta")
    counter = FlopCounterMode(display=False)
    with counter, torch.set_grad_enabled(train):
        out = ref.forward(params, arch, img, img)
        if train:
            loss_terms(out, torch.empty((1, h, w, 2), device="meta"), torch.empty((1, h, w), device="meta")).backward()
    return float(counter.get_total_flops())


def per_forward_bounds(arch, batch: int) -> Dict[str, float]:
    """The bounds (ms) of one forward's (or one step's) kernel calls of each
    kind at ``batch`` pairs, from the configuration's sizes: the attention
    forward and backward (the encoder over 2B images, the info sharing over B
    joint sequences), fc1 + GELU and fc2's input gradient with the GELU's."""
    e, i = arch.enc, arch.info
    h, w = arch.model_hw
    s_enc = arch.encoder_tokens(h // e["patch_size"], w // e["patch_size"])
    s_info = 2 * (h // e["patch_size"]) * (w // e["patch_size"])
    d_enc, d_info = e["embed_dim"] // e["num_heads"], i["dim"] // i["num_heads"]
    attn = e["depth"] * attention_bound_ms(2 * batch, s_enc, e["num_heads"], d_enc)[0] \
        + i["depth"] * attention_bound_ms(batch, s_info, i["num_heads"], d_info)[0]
    attn_bwd = e["depth"] * attention_bwd_bound_ms(2 * batch, s_enc, e["num_heads"], d_enc)[0] \
        + i["depth"] * attention_bwd_bound_ms(batch, s_info, i["num_heads"], d_info)[0]
    hid_e, hid_i = int(e["embed_dim"] * e["mlp_ratio"]), int(i["dim"] * i["mlp_ratio"])
    mlp = e["depth"] * linear_gelu_bound_ms(2 * batch * s_enc, e["embed_dim"], hid_e)[0] \
        + i["depth"] * linear_gelu_bound_ms(batch * s_info, i["dim"], hid_i)[0]
    mlp_bwd = e["depth"] * linear_gelu_bwd_bound_ms(2 * batch * s_enc, e["embed_dim"], hid_e)[0] \
        + i["depth"] * linear_gelu_bwd_bound_ms(batch * s_info, i["dim"], hid_i)[0]
    return {"attn_fwd": attn, "attn_bwd": attn_bwd, "mlp_fwd": mlp, "mlp_bwd": mlp_bwd}
