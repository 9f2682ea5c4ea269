"""Window refinement: the Hopper kernels and their plain PyTorch versions.

One function of (q, f, flow, bias, temperature, P), the forward of
``ufm_tpu/ops/refinement.py::_fused_refinement_pallas``: for each pixel, the
dot products of its source feature q(p) with the (P+3)^2 integer taps of the
zero-padded target map F around floor(flow + grid) - r - 1, combined
bicubically (torch's A = -0.75) into P x P window scores, then
``scores / temperature + bias``, softmax, log_softmax and the
offset-weighted flow residual; and its backward, the JAX package's
``_fused_refinement_pallas_bwd`` (the XLA VJP of ``_fused_refinement_xla``).

- :func:`window_refinement_reference` is the plain forward (the math of
  ``_window_dots`` + ``_fused_refinement_xla`` + ``_scores_tail``): the CPU
  implementation of the dispatcher op ``ufm_torch::window_refinement``
  (:mod:`ufm_torch.ops.library`) and what the checks use.
- :func:`window_refinement_backward_reference` is the plain backward, in
  closed form (the formulas the backward kernel follows term by term): the
  CPU implementation of the op ``ufm_torch::window_refinement_bwd``, which
  is the forward op's gradient.
- :func:`launch` and :func:`launch_backward` are the ops' CUDA
  implementations: they launch ``ufm_torch/csrc/window_refinement_fwd.cu``
  (which replaces the Pallas window-dots kernels ``_dots16`` and ``_dots8``
  and the XLA epilogue around them) and ``ufm_torch/csrc/
  window_refinement_bwd.cu`` (which replaces the XLA VJP), and raise on
  anything the kernels do not take; they never fall back to a plain version.
  :func:`window_refinement` calls the forward op on CUDA tensors and refuses
  any other.
- The kernels take 1 <= C <= ``MAX_CHANNELS`` and odd 1 <= P <=
  ``MAX_PATCH`` (:func:`check_domain`), the shapes the JAX package answers
  through its XLA path; the Pallas kernel itself took C in {4, 8, 16} and
  P <= 5.
- :func:`staged_tiles` counts, in plain PyTorch, the tiles of
  ``TILE`` pixels whose taps the kernels stage in shared memory: those
  whose taps all fit one ``BOX`` of the target map, at a feature width they
  stage (C <= 16 and a multiple of 4). The kernels read the other tiles'
  taps from global memory; given a counter each adds the number it staged,
  which equals this count. At P <= 5 the backward sums a staged tile's df
  over a box of the same extent and adds each box pixel to df once.

All clamp the sample position to [-(r+4), W+r+4] x [-(r+4), H+r+4] before
the integer conversion, as the Pallas path does: a window wholly outside the
image stays all zero, so no score changes (and no flow gradient arises), and
a huge flow (seeded random weights can give one) never reaches an undefined
float -> int conversion.

Shapes are channel-last like the JAX package: q, f (B, H, W, C); flow
(B, H, W, 2) xy; bias (P*P,). Outputs: residual (B, H, W, 2) and log_softmax
(B, H, W, P, P), indexed [i, j] = (row offset i - R, column offset j - R).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ufm_torch.ops import _build
from ufm_torch.ops.grid_sample import cubic_weights, cubic_weights_derivative

__all__ = [
    "window_refinement",
    "window_refinement_reference",
    "window_refinement_backward_reference",
    "launch",
    "launch_backward",
    "plain",
    "plain_backward",
    "base_grid",
    "neighborhood_offsets_xy",
    "supports_kernel",
    "check_domain",
    "staged_tiles",
    "tile_count",
    "LAUNCHES",
    "BWD_LAUNCHES",
    "MAX_CHANNELS",
    "MAX_PATCH",
]

# the kernels' domain: any feature width up to MAX_CHANNELS and any odd window
# up to MAX_PATCH (the JAX package answers every shape through its XLA path)
MAX_CHANNELS = 64
MAX_PATCH = 9

# kernel launches since the count was last reset (``LAUNCHES = 0``): the
# forward's, and the backward's (one a call: the kernel and its bias reduction)
LAUNCHES = 0
BWD_LAUNCHES = 0

# the kernels' tiles of pixels and the box of the target map they stage for a
# tile, (x, y) in pixels (kTileW, kTileH, kBoxW, kBoxH of csrc/window_refinement.cuh)
TILE = (32, 8)
BOX = (64, 22)

_fn = None
_bwd_fn = None


def supports_kernel(c: int, p: int) -> bool:
    """Whether the kernels take feature width ``c`` and window ``p``."""
    return 1 <= c <= MAX_CHANNELS and 1 <= p <= MAX_PATCH and p % 2 == 1


def check_domain(c: int, p: int) -> None:
    """Raise a ValueError naming C or P and its limit where the kernels do
    not take feature width ``c`` or window ``p``."""
    if not 1 <= c <= MAX_CHANNELS:
        raise ValueError(f"the window kernels take feature widths 1 <= C <= {MAX_CHANNELS}, got C = {c}; {_PLAIN}")
    if not (1 <= p <= MAX_PATCH and p % 2 == 1):
        raise ValueError(f"the window kernels take odd windows 1 <= P <= {MAX_PATCH}, got P = {p}; {_PLAIN}")


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


def staged_tiles(flow: torch.Tensor, p: int, c: int = 16) -> int:
    """How many of the kernels' tiles (:func:`tile_count`) stage their taps
    (the forward and the backward stage the same ones): none at a feature
    width ``c`` over 16 (two boxes would outgrow shared memory) or not a
    multiple of 4 (TMA maps only rows of a multiple of 16 bytes), else those
    where the span of the pixels' leftmost taps plus P + 3 is at most
    ``BOX[0]`` and that of their topmost taps plus P + 3 at most ``BOX[1]``
    (the kernels' fit rule; pixels past the border take no part)."""
    if c > 16 or c % 4:
        return 0
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


def _spread(d: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor, k: int) -> torch.Tensor:
    """The transpose of the separable cubic combination: (B, H, W, P, P)
    score gradients -> (B, H, W, K, K) tap gradients,
    out[v, u] = sum_l sum_m wy[l] wx[m] d[v - l, u - m]."""
    p = d.shape[-1]
    ry = d.new_zeros((*d.shape[:3], k, p))
    for ll in range(4):
        ry[..., ll : ll + p, :] += wy[..., ll, None, None] * d
    out = d.new_zeros((*d.shape[:3], k, k))
    for mm in range(4):
        out[..., :, mm : mm + p] += wx[..., mm, None, None] * ry
    return out


def window_refinement_backward_reference(
    q: torch.Tensor,
    f: torch.Tensor,
    flow: torch.Tensor,
    bias: torch.Tensor,
    log_softmax: torch.Tensor,
    g_residual: torch.Tensor,
    g_log_softmax: torch.Tensor,
    temperature: float,
    p: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain backward: the cotangents (``g_residual`` (B, H, W, 2),
    ``g_log_softmax`` (B, H, W, P, P)) of the forward's outputs -> (dq, df,
    dflow, dbias), in closed form (the backward kernel's formulas, term by
    term), in fp32, or in fp64 where the inputs are (the sample positions
    are fp32 in both, as in the forward). Per pixel:

    - a = exp(log_softmax); the residual, sum a * offs, is recomputed from a;
    - g_s = a * ((offs - residual) . g_residual) + g_log_softmax
      - a * sum g_log_softmax; dbias = the sum of g_s over pixels;
      dscores = g_s / T;
    - ddots[v, u] = sum_{l, m} wy[l] wx[m] dscores[v - l, u - m]; ddots_x
      the same with wx' (the cubic weights' derivative in the fractional
      position) for wx, ddots_y with wy' for wy;
    - over the (P+3)^2 taps inside the image: dq += ddots F[tap],
      df[tap] += ddots q, dflow += (q . F[tap]) (ddots_x, ddots_y).

    Where the position is clamped every tap lies outside the image, so dflow
    is 0 there, as the JAX package's VJP (which has no clamp) also gives."""
    if p % 2 != 1:
        raise ValueError(f"the window size must be odd, got {p}")
    dt = torch.promote_types(q.dtype, torch.float32)
    r, k = (p - 1) // 2, p + 3
    b, h, w, c = f.shape
    q, f = q.to(dt), f.to(dt)
    pos_x, pos_y = _sample_positions(flow, p)
    x0, y0 = torch.floor(pos_x), torch.floor(pos_y)
    tx, ty = (pos_x - x0).to(dt), (pos_y - y0).to(dt)
    wx, wy = torch.stack(cubic_weights(tx), dim=-1), torch.stack(cubic_weights(ty), dim=-1)  # (B, H, W, 4)
    dwx = torch.stack(cubic_weights_derivative(tx), dim=-1)
    dwy = torch.stack(cubic_weights_derivative(ty), dim=-1)

    a = torch.exp(log_softmax.to(dt)).reshape(b, h, w, p * p)
    offs = neighborhood_offsets_xy(p, q.device).to(dt).reshape(p * p, 2)
    residual = a @ offs  # (B, H, W, 2)
    g_ls = g_log_softmax.to(dt).reshape(b, h, w, p * p)
    g_s = (a * ((offs - residual[..., None, :]) * g_residual.to(dt)[..., None, :]).sum(-1)
           + g_ls - a * g_ls.sum(-1, keepdim=True))
    dbias = g_s.sum(dim=(0, 1, 2)).to(torch.promote_types(bias.dtype, dt))
    dscores = (g_s / temperature).reshape(b, h, w, p, p)
    ddots = _spread(dscores, wy, wx, k)
    ddots_x = _spread(dscores, wy, dwx, k)
    ddots_y = _spread(dscores, dwy, wx, k)

    flat = f.reshape(b, h * w, c)
    xb, yb = x0.long() - r - 1, y0.long() - r - 1
    dq = torch.zeros_like(q)
    df = torch.zeros_like(flat)
    dflow_x, dflow_y = q.new_zeros((b, h, w)), q.new_zeros((b, h, w))
    for v in range(k):
        iy = yb + v
        y_ok = (iy >= 0) & (iy < h)
        for u in range(k):
            ix = xb + u
            ok = (y_ok & (ix >= 0) & (ix < w))[..., None]
            lin = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).reshape(b, h * w, 1).expand(-1, -1, c)
            tap = torch.where(ok, torch.gather(flat, 1, lin).reshape(b, h, w, c), 0.0)
            g = ddots[..., v, u, None]
            dq += g * tap
            df.scatter_add_(1, lin, torch.where(ok, g * q, 0.0).reshape(b, h * w, c))
            dot = (q * tap).sum(-1)
            dflow_x += dot * ddots_x[..., v, u]
            dflow_y += dot * ddots_y[..., v, u]
    dflow = torch.stack([dflow_x, dflow_y], dim=-1)
    return dq, df.reshape(b, h, w, c), dflow, dbias


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load_library("window_refinement_fwd").ufm_window_refinement_fwd_f32
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _bwd_kernel():
    global _bwd_fn
    if _bwd_fn is None:
        fn = _build.load_library("window_refinement_bwd").ufm_window_refinement_bwd_f32
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bwd_fn = fn
    return _bwd_fn


_PLAIN = "the plain version is fused_refinement_attention(..., impl='torch')"


def _check_tensors(op: str, named) -> None:
    """Every tensor of ``named`` ((name, tensor) pairs) a contiguous fp32
    CUDA tensor on the first one's device."""
    device = named[0][1].device
    for name, t in named:
        if not t.is_cuda:
            raise ValueError(f"{op} runs only on CUDA tensors ({name} is on {t.device}); {_PLAIN}")
        if t.dtype != torch.float32:
            raise ValueError(f"{op} takes float32, got {name}.dtype={t.dtype}; {_PLAIN}")
        if not t.is_contiguous():
            raise ValueError(f"{op} needs contiguous tensors, got {name}.stride()={t.stride()}; {_PLAIN}")
        if t.device != device:
            raise ValueError(f"{op}: {', '.join(n for n, _ in named)} must be on one device")


def _check(q: torch.Tensor, f: torch.Tensor, flow: torch.Tensor, bias: torch.Tensor, p: int,
           staged_count: Optional[torch.Tensor], op: str = "window_refinement") -> None:
    _check_tensors(op, (("q", q), ("f", f), ("flow", flow), ("bias", bias)))
    if q.dim() != 4 or q.shape != f.shape:
        raise ValueError(f"{op} takes q, f (B, H, W, C), got q {tuple(q.shape)}, f {tuple(f.shape)}; {_PLAIN}")
    check_domain(q.shape[-1], p)
    if flow.shape != (*q.shape[:3], 2) or bias.shape != (p * p,):
        raise ValueError(f"flow must be {(*q.shape[:3], 2)} and bias {(p * p,)}, got {tuple(flow.shape)}, {tuple(bias.shape)}")
    # taps are read as 16-byte vectors where C is a multiple of 4 (and f
    # through a TMA map), else element by element; the flow as 8-byte pairs
    if q.data_ptr() % 16 or f.data_ptr() % 16 or flow.data_ptr() % 8:
        raise ValueError(f"{op} needs 16-byte aligned q and f; {_PLAIN}")
    if staged_count is not None and (
        staged_count.device != q.device or staged_count.dtype != torch.int32 or staged_count.numel() != 1
    ):
        raise ValueError(f"staged_count must be one int32 element on {q.device}, got {staged_count.dtype} "
                         f"{tuple(staged_count.shape)} on {staged_count.device}")


def launch(q, f, flow, bias, temperature: float, p: int, staged_count: Optional[torch.Tensor] = None,
           any_kernel: bool = False):
    """The op's CUDA implementation, one kernel launch: fp32 contiguous CUDA
    tensors -> (residual (B, H, W, 2), log_softmax (B, H, W, P, P)), fresh
    tensors. ``staged_count``, one int32 element on the same card, receives
    the number of tiles whose taps the kernel staged in shared memory (added
    to it). ``any_kernel`` sends C in {4, 8, 16} at P <= 5 to the kernel
    that takes the rest of C <= 16 as well (the op never does: it is there
    to compare the two on the same shapes)."""
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
            None if staged_count is None else staged_count.data_ptr(), b, h, w, c, p, float(temperature),
            int(any_kernel), stream,
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
        staged_count.add_(staged_tiles(flow, p, q.shape[-1]))
    return out


def launch_backward(q, f, flow, bias, log_softmax, g_residual, g_log_softmax, temperature: float, p: int,
                    staged_count: Optional[torch.Tensor] = None):
    """The backward op's CUDA implementation, one call (the gradients, with
    per-tile partial sums of dbias, in a kernel for the tiles read from
    global memory and, at a width that stages, one for the staged tiles; then
    the sum of the partials in a fixed order): fp32 contiguous CUDA tensors
    -> (dq, df, dflow, dbias), fresh tensors. dq, dflow and dbias are the
    same bits on every call; df is summed with atomics, in an order that
    varies.
    ``staged_count``, one int32 element on the same card, receives the
    number of tiles whose taps the kernel staged in shared memory (added to
    it; the same tiles as the forward's, :func:`staged_tiles`)."""
    global BWD_LAUNCHES
    _check(q, f, flow, bias, p, staged_count, op="window_refinement_bwd")
    _check_tensors("window_refinement_bwd", (("q", q), ("log_softmax", log_softmax), ("g_residual", g_residual),
                                             ("g_log_softmax", g_log_softmax)))
    b, h, w, c = q.shape
    for name, t, want in (("log_softmax", log_softmax, (b, h, w, p, p)), ("g_residual", g_residual, (b, h, w, 2)),
                          ("g_log_softmax", g_log_softmax, (b, h, w, p, p))):
        if t.shape != want:
            raise ValueError(f"window_refinement_bwd: {name} must be {want}, got {tuple(t.shape)}")
    dq = torch.empty_like(q)
    df = torch.zeros_like(f)  # the kernel adds into it
    dflow = torch.empty_like(flow)
    dbias = torch.empty_like(bias)
    if dq.numel() == 0:
        return dq, df, torch.zeros_like(flow), torch.zeros_like(bias)
    partials = torch.empty((tile_count(b, h, w), p * p), dtype=torch.float32, device=q.device)
    plans = torch.empty((tile_count(b, h, w), 4), dtype=torch.int32, device=q.device)
    fn = _bwd_kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), f.data_ptr(), flow.data_ptr(), log_softmax.data_ptr(), g_residual.data_ptr(),
            g_log_softmax.data_ptr(), dq.data_ptr(), df.data_ptr(), dflow.data_ptr(), dbias.data_ptr(),
            partials.data_ptr(), plans.data_ptr(), None if staged_count is None else staged_count.data_ptr(), b, h, w,
            c, p,
            float(temperature), stream,
        )
        BWD_LAUNCHES += 1
    if err != 0:
        raise RuntimeError(
            f"window_refinement_bwd kernel launch failed: {_build.launch_error_cause(err)} at q {tuple(q.shape)}, P={p}"
        )
    return dq, df, dflow, dbias


def plain_backward(q, f, flow, bias, log_softmax, g_residual, g_log_softmax, temperature: float, p: int):
    """The backward op's CPU implementation:
    :func:`window_refinement_backward_reference`, each gradient in its
    input's dtype."""
    grads = window_refinement_backward_reference(q, f, flow, bias, log_softmax, g_residual, g_log_softmax,
                                                 temperature, p)
    return tuple(g.to(t.dtype) for g, t in zip(grads, (q, f, flow, bias)))


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
