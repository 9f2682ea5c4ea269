"""The least time the SwiGLU FFN's fused ``w12`` + gate calls need on the
card (``ufm_torch::linear_swiglu_bf16``), from a configuration's sizes.

One call is the (M, K) x (K, 2H) product of ``w12`` with the gate in its
epilogue, bf16: 2 M K (2H) operations; x, ``w12`` and its bias read once,
the gated (M, H) output written once. The bound is the larger of the
operations over the bf16 peak and the bytes over the bandwidth
(:mod:`benchmark.harness.yardstick`'s peaks).
"""

from __future__ import annotations

from typing import Optional, Tuple

from benchmark.harness.yardstick import PEAK_BF16_FLOPS, PEAK_BYTES

__all__ = ["linear_swiglu_bound_ms", "swiglu_fwd_bound_ms"]


def linear_swiglu_bound_ms(m: int, k: int, hidden: int) -> Tuple[float, str]:
    """One call at M rows, K inputs and H gated outputs (``w12`` is 2H x K):
    (ms, "operations" or "bytes")."""
    t_ops = 2 * m * k * 2 * hidden / PEAK_BF16_FLOPS * 1e3
    t_bytes = 2 * (m * k + 2 * hidden * k + 2 * hidden + m * hidden) / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def swiglu_fwd_bound_ms(arch, batch: int) -> Optional[float]:
    """The bound (ms) of one forward's calls at ``batch`` pairs: one call a
    encoder block at M = 2 x batch x the encoder's tokens, K = its width, H =
    its SwiGLU width (``arch.enc["ffn_hidden"]``); None for an arch whose
    encoder has no SwiGLU FFN."""
    e = arch.enc
    hidden = e.get("ffn_hidden")
    if not hidden:
        return None
    h, w = arch.model_hw
    m = 2 * batch * arch.encoder_tokens(h // e["patch_size"], w // e["patch_size"])
    return e["depth"] * linear_swiglu_bound_ms(m, e["embed_dim"], hidden)[0]
