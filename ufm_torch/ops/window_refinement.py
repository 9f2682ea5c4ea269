"""Window refinement: the Hopper kernel and its plain PyTorch version.

One function of (q, f, flow, bias, temperature, P), the forward of
``ufm_tpu/ops/refinement.py::_fused_refinement_pallas``: for each pixel, the
dot products of its source feature q(p) with the (P+3)^2 integer taps of the
zero-padded target map F around floor(flow + grid) - r - 1, combined
bicubically (torch's A = -0.75) into P x P window scores, then
``scores / temperature + bias``, softmax, log_softmax and the
offset-weighted flow residual.

- :func:`window_refinement_reference` is the plain version (the math of
  ``_window_dots`` + ``_fused_refinement_xla`` + ``_scores_tail``): the CPU
  implementation of the dispatcher op ``ufm_torch::window_refinement``
  (:mod:`ufm_torch.ops.library`), what the checks use, and the op's backward.
- :func:`launch` is the op's CUDA implementation: it launches
  ``ufm_torch/csrc/window_refinement_fwd.cu`` (which replaces the Pallas
  window-dots kernels ``_dots16`` and ``_dots8`` and the XLA epilogue around
  them) and raises on anything the kernel does not take; it never falls back
  to the plain version. The op's gradient is autograd over the plain
  version, as in the JAX package (a Pallas forward with the XLA VJP).
  :func:`window_refinement` calls the op on CUDA tensors and refuses any
  other.
- :func:`staged_tiles` counts, in plain PyTorch, the tiles of
  ``TILE`` pixels whose taps the kernel stages in shared memory: those whose
  taps all fit one ``BOX`` of the target map. The kernel reads the other
  tiles' taps from global memory; given a counter it adds the number it
  staged, which equals this count.

Both clamp the sample position to [-(r+4), W+r+4] x [-(r+4), H+r+4] before
the integer conversion, as the Pallas path does: a window wholly outside the
image stays all zero, so no score changes, and a huge flow (seeded random
weights can give one) never reaches an undefined float -> int conversion.

Shapes are channel-last like the JAX package: q, f (B, H, W, C); flow
(B, H, W, 2) xy; bias (P*P,). Outputs: residual (B, H, W, 2) and log_softmax
(B, H, W, P, P), indexed [i, j] = (row offset i - R, column offset j - R).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ufm_torch.ops import _build
from ufm_torch.ops.grid_sample import cubic_weights

__all__ = [
    "window_refinement",
    "window_refinement_reference",
    "launch",
    "plain",
    "base_grid",
    "neighborhood_offsets_xy",
    "supports_kernel",
    "staged_tiles",
    "tile_count",
    "LAUNCHES",
    "CHANNELS",
    "PATCHES",
]

# the kernel's domain: the Pallas kernel's (window_dots.py::supports_pallas_window)
CHANNELS = (4, 8, 16)
PATCHES = (1, 3, 5)

# kernel launches since the count was last reset (``LAUNCHES = 0``)
LAUNCHES = 0

# the kernel's tiles of pixels and the box of the target map it stages for a
# tile, (x, y) in pixels (kTileW, kTileH, kBoxW, kBoxH of the CUDA source)
TILE = (32, 8)
BOX = (64, 22)

_fn = None


def supports_kernel(c: int, p: int) -> bool:
    """Whether the kernel takes feature width ``c`` and window ``p``."""
    return c in CHANNELS and p in PATCHES


def base_grid(h: int, w: int, device=None) -> torch.Tensor:
    """(H, W, 2) xy integer pixel grid."""
    xs = torch.arange(w, dtype=torch.float32, device=device)
    ys = torch.arange(h, dtype=torch.float32, device=device)
    gx, gy = torch.meshgrid(xs, ys, indexing="xy")
    return torch.stack([gx, gy], dim=-1)


def neighborhood_offsets_xy(p: int, device=None) -> torch.Tensor:
    """(P, P, 2) xy offsets in row-major (i, j) order: entry [i, j] is
    (j - R, i - R), the values the attention weights."""
    r = (p - 1) // 2
    ar = torch.arange(p, device=device) - r
    i, j = torch.meshgrid(ar, ar, indexing="ij")
    return torch.stack([j, i], dim=-1).float()


def _window_dots(q: torch.Tensor, f: torch.Tensor, x_base: torch.Tensor, y_base: torch.Tensor, k: int) -> torch.Tensor:
    """q . F[tap] for each pixel's K x K integer tap window, zeros outside the
    image: one gather and one reduction per tap, never the K^2 x C window.
    Returns (B, H, W, Ky, Kx)."""
    b, h, w, c = f.shape
    flat = f.reshape(b, h * w, c)
    ix_valid, ix_lin = [], []
    for u in range(k):
        ix = x_base + u
        ix_valid.append((ix >= 0) & (ix < w))
        ix_lin.append(ix.clamp(0, w - 1))
    rows = []
    for v in range(k):
        iy = y_base + v
        y_ok = (iy >= 0) & (iy < h)
        y_lin = iy.clamp(0, h - 1) * w
        row = []
        for u in range(k):
            idx = (y_lin + ix_lin[u]).reshape(b, h * w, 1).expand(-1, -1, c)
            tap = torch.gather(flat, 1, idx).reshape(b, h, w, c)
            d = (q * tap).sum(-1)
            row.append(torch.where(y_ok & ix_valid[u], d, 0.0))
        rows.append(torch.stack(row, dim=-1))
    return torch.stack(rows, dim=-2)


def _scores_tail(scores: torch.Tensor, bias: torch.Tensor, temperature: float, p: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw window scores -> (residual, log_softmax)."""
    b, h, w = scores.shape[:3]
    flat = (scores / temperature + bias.reshape(p, p)).reshape(b, h, w, p * p)
    attn = torch.softmax(flat, dim=-1)
    log_softmax = torch.log_softmax(flat, dim=-1).reshape(b, h, w, p, p)
    residual = attn @ neighborhood_offsets_xy(p, flat.device).reshape(p * p, 2)
    return residual, log_softmax


def _sample_positions(flow: torch.Tensor, p: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """flow + grid, clamped to [-(r+4), W+r+4] x [-(r+4), H+r+4]: (x, y),
    each (B, H, W) fp32."""
    _, h, w, _ = flow.shape
    m = float((p - 1) // 2 + 4)
    pos = flow.float() + base_grid(h, w, flow.device)[None]
    return pos[..., 0].clamp(-m, w + m), pos[..., 1].clamp(-m, h + m)


def tile_count(b: int, h: int, w: int) -> int:
    """The kernel's tiles of an (B, H, W) map: each image in row-major tiles
    of ``TILE`` pixels, the last row and column cut by the border."""
    return b * -(-h // TILE[1]) * -(-w // TILE[0])


def staged_tiles(flow: torch.Tensor, p: int) -> int:
    """How many of the kernel's tiles (:func:`tile_count`) stage their taps:
    those where the span of the pixels' leftmost taps plus P + 3 is at most
    ``BOX[0]`` and that of their topmost taps plus P + 3 at most ``BOX[1]``
    (the kernel's fit rule; pixels past the border take no part)."""
    b, h, w, _ = flow.shape
    r, k = (p - 1) // 2, p + 3
    pos_x, pos_y = _sample_positions(flow, p)
    ty, tx = -(-h // TILE[1]), -(-w // TILE[0])
    spans = []
    for pos in (pos_x, pos_y):
        base = torch.floor(pos).long() - r - 1
        lo = torch.full((b, ty * TILE[1], tx * TILE[0]), torch.iinfo(torch.int64).max, device=flow.device)
        hi = torch.full_like(lo, torch.iinfo(torch.int64).min)
        lo[:, :h, :w] = base
        hi[:, :h, :w] = base
        lo = lo.view(b, ty, TILE[1], tx, TILE[0]).amin(dim=(2, 4))
        hi = hi.view(b, ty, TILE[1], tx, TILE[0]).amax(dim=(2, 4))
        spans.append(hi - lo + k)
    return int(((spans[0] <= BOX[0]) & (spans[1] <= BOX[1])).sum())


def window_refinement_reference(
    q: torch.Tensor, f: torch.Tensor, flow: torch.Tensor, bias: torch.Tensor, temperature: float, p: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: (residual (B, H, W, 2), log_softmax (B, H, W, P, P)),
    fp32, on any device, differentiable."""
    if p % 2 != 1:
        raise ValueError(f"the window size must be odd, got {p}")
    r = (p - 1) // 2
    q, f = q.float(), f.float()
    pos_x, pos_y = _sample_positions(flow, p)
    x0, y0 = torch.floor(pos_x), torch.floor(pos_y)
    wx = torch.stack(cubic_weights(pos_x - x0), dim=-1)  # (B, H, W, 4)
    wy = torch.stack(cubic_weights(pos_y - y0), dim=-1)
    dots = _window_dots(q, f, x0.long() - r - 1, y0.long() - r - 1, p + 3)  # (B, H, W, Ky, Kx)
    # separable cubic combination: scores[i, j] = sum_l sum_m wy[l] wx[m] dots[i + l, j + m]
    sx = sum(wx[..., None, mm, None] * dots[..., mm : mm + p] for mm in range(4))  # (B, H, W, Ky, P)
    scores = sum(wy[..., ll, None, None] * sx[..., ll : ll + p, :] for ll in range(4))  # (B, H, W, P, P)
    return _scores_tail(scores, bias.float(), temperature, p)


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load_library("window_refinement_fwd").ufm_window_refinement_fwd_f32
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


_PLAIN = "the plain version is fused_refinement_attention(..., impl='torch')"


def _check(q: torch.Tensor, f: torch.Tensor, flow: torch.Tensor, bias: torch.Tensor, p: int,
           staged_count: Optional[torch.Tensor]) -> None:
    for name, t in (("q", q), ("f", f), ("flow", flow), ("bias", bias)):
        if not t.is_cuda:
            raise ValueError(f"window_refinement runs only on CUDA tensors ({name} is on {t.device}); {_PLAIN}")
        if t.dtype != torch.float32:
            raise ValueError(f"window_refinement takes float32, got {name}.dtype={t.dtype}; {_PLAIN}")
        if not t.is_contiguous():
            raise ValueError(f"window_refinement needs contiguous tensors, got {name}.stride()={t.stride()}; {_PLAIN}")
    if not (q.device == f.device == flow.device == bias.device):
        raise ValueError("q, f, flow and bias must be on one device")
    if q.dim() != 4 or q.shape != f.shape or not supports_kernel(q.shape[-1], p):
        raise ValueError(
            f"window_refinement takes q, f (B, H, W, C) with C in {CHANNELS} and P in {PATCHES}, "
            f"got q {tuple(q.shape)}, f {tuple(f.shape)}, P={p}; {_PLAIN}"
        )
    if flow.shape != (*q.shape[:3], 2) or bias.shape != (p * p,):
        raise ValueError(f"flow must be {(*q.shape[:3], 2)} and bias {(p * p,)}, got {tuple(flow.shape)}, {tuple(bias.shape)}")
    # taps are read as 16-byte vectors (and f through a TMA map), the flow as 8-byte pairs
    if q.data_ptr() % 16 or f.data_ptr() % 16 or flow.data_ptr() % 8:
        raise ValueError(f"window_refinement needs 16-byte aligned q and f; {_PLAIN}")
    if staged_count is not None and (
        staged_count.device != q.device or staged_count.dtype != torch.int32 or staged_count.numel() != 1
    ):
        raise ValueError(f"staged_count must be one int32 element on {q.device}, got {staged_count.dtype} "
                         f"{tuple(staged_count.shape)} on {staged_count.device}")


def launch(q, f, flow, bias, temperature: float, p: int, staged_count: Optional[torch.Tensor] = None):
    """The op's CUDA implementation, one kernel launch: fp32 contiguous CUDA
    tensors -> (residual (B, H, W, 2), log_softmax (B, H, W, P, P)), fresh
    tensors. ``staged_count``, one int32 element on the same card, receives
    the number of tiles whose taps the kernel staged in shared memory (added
    to it)."""
    global LAUNCHES
    _check(q, f, flow, bias, p, staged_count)
    b, h, w, c = q.shape
    residual = torch.empty((b, h, w, 2), dtype=torch.float32, device=q.device)
    log_softmax = torch.empty((b, h, w, p, p), dtype=torch.float32, device=q.device)
    if residual.numel() == 0:
        return residual, log_softmax
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), f.data_ptr(), flow.data_ptr(), bias.data_ptr(), residual.data_ptr(), log_softmax.data_ptr(),
            None if staged_count is None else staged_count.data_ptr(), b, h, w, c, p, float(temperature), stream,
        )
        LAUNCHES += 1
    if err != 0:
        raise RuntimeError(
            f"window_refinement kernel launch failed: {_build.launch_error_cause(err)} at q {tuple(q.shape)}, P={p}"
        )
    return residual, log_softmax


def plain(q, f, flow, bias, temperature: float, p: int, staged_count: Optional[torch.Tensor] = None):
    """The op's CPU implementation: :func:`window_refinement_reference`;
    ``staged_count`` receives :func:`staged_tiles`, the kernel's count of the
    same rule."""
    out = window_refinement_reference(q, f, flow, bias, temperature, p)
    if staged_count is not None:
        staged_count.add_(staged_tiles(flow, p))
    return out


def window_refinement(
    q: torch.Tensor,
    f: torch.Tensor,
    flow: torch.Tensor,
    bias: torch.Tensor,
    temperature: float,
    p: int,
    staged_count: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The window refinement on the card (the op on CUDA tensors; see
    :func:`launch`). The model passes no ``staged_count``."""
    for name, t in (("q", q), ("f", f), ("flow", flow), ("bias", bias)):
        if not t.is_cuda:
            raise ValueError(f"window_refinement runs only on CUDA tensors ({name} is on {t.device}); {_PLAIN}")
    return torch.ops.ufm_torch.window_refinement(q, f, flow, bias, float(temperature), int(p), staged_count)
