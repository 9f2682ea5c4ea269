"""The MLP's ``fc1`` product with the bf16 exact GELU as its epilogue: the
Hopper kernel and its plain PyTorch version.

The backbone MLP is ``fc1 -> GELU -> fc2`` (``ufm_tpu/nn/layers.py::Mlp``,
with ``ufm_tpu/ops/gelu.py::fast_exact_gelu`` as the activation). On the card
the GELU runs in the epilogue of ``fc1``'s product, so the hidden activation
is written once, already activated:

    h = bf16(x @ W.T + b)     (fp32 accumulation, rounded once)
    y = gelu_bf16(h)          (the JAX package's bits for every finite h)

- :func:`linear_gelu_reference` is the plain version,
  ``fast_exact_gelu_reference(F.linear(x, w, b))`` on any device: the CPU
  implementation of the dispatcher op ``ufm_torch::linear_gelu_bf16``
  (:mod:`ufm_torch.ops.library`), bit for bit what the port's MLP computed
  with the two ops, and what the checks use.
- :func:`launch` is the op's CUDA implementation: one launch of
  ``ufm_torch/csrc/linear_gelu_bf16_fwd.cu``. It raises on anything the
  kernel does not take and never falls back to the plain version.
- :func:`linear_gelu_bf16` calls the op; the device of the tensors picks the
  implementation.

Training runs the same launch with ``h`` written beside ``y``
(:func:`launch_preact`, the op ``ufm_torch::linear_gelu_bf16_preact``, plain
version :func:`linear_gelu_preact_reference`): the op's gradient reads ``h``
(:mod:`ufm_torch.ops.library`).

The MLP's backward runs the GELU's gradient in the epilogue of ``fc2``'s
input-gradient product: for ``fc2``'s cotangent ``g`` (..., N2), its weight
``w2`` (N2, N) and the saved ``h`` (..., N),

    dy = bf16(g @ w2)                 (fp32 accumulation, rounded once)
    dh = gelu_bf16_bwd(dy, h)         (the JAX package's VJP bits)

- :func:`linear_gelu_bwd_reference` is the plain version,
  ``fast_exact_gelu_vjp_reference(h, g.reshape(-1, N2).mm(w2))``: the CPU
  implementation of the op ``ufm_torch::linear_gelu_bf16_bwd``, bit for bit
  the two-op route's ``dh`` on the CPU, and what the checks use.
- :func:`launch_backward` is its CUDA implementation: one launch of
  ``ufm_torch/csrc/linear_gelu_bf16_bwd.cu`` (``BWD_LAUNCHES`` counts them).
  It raises on anything the kernel does not take and never falls back.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from ufm_torch.ops import _build
from ufm_torch.ops.gelu import fast_exact_gelu_reference, fast_exact_gelu_vjp_reference

__all__ = [
    "linear_gelu_reference", "linear_gelu_preact_reference", "launch", "launch_preact", "linear_gelu_bf16",
    "linear_gelu_bwd_reference", "launch_backward", "linear_gelu_bf16_bwd", "SCHEDULES", "BWD_SCHEDULES",
    "LAUNCHES", "BWD_LAUNCHES",
]

# kernel launches since the count was last reset (``LAUNCHES = 0``): the
# forward (csrc/linear_gelu_bf16_fwd.cu) and the backward
# (csrc/linear_gelu_bf16_bwd.cu)
LAUNCHES = 0
BWD_LAUNCHES = 0

# the kernel's schedules (csrc/linear_gelu_bf16_fwd.cu): "pingpong" is the
# op's; the others exist to be timed beside it
SCHEDULES = {"pingpong": 0, "serial": 1, "cooperative": 2}
# the backward kernel's (csrc/linear_gelu_bf16_bwd.cu): "pingpong" is the
# op's; "serial" (no overlap) and "rr3" (three consumers, 128 x 64 tiles)
# exist to be timed beside it
BWD_SCHEDULES = {"pingpong": 0, "serial": 1, "rr3": 2}

_fn = None
_bwd_fn = None


def linear_gelu_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version: ``F.linear`` then the bf16 GELU's plain chain, on
    bf16 ``x`` (..., K), ``w`` (N, K) and ``b`` (N,) on any device."""
    _check(x, w, b)
    return fast_exact_gelu_reference(F.linear(x, w, b))


def linear_gelu_preact_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """The plain version of the training launch: ``(y, h)`` with ``h =
    F.linear(x, w, b)`` (bf16) and ``y`` the bf16 GELU's plain chain of it."""
    _check(x, w, b)
    h = F.linear(x, w, b)
    return fast_exact_gelu_reference(h), h


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> None:
    for name, t in (("x", x), ("w", w), ("b", b)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"linear_gelu_bf16 takes bfloat16, got {name} {t.dtype}")
    if x.dim() < 1 or w.dim() != 2 or b.dim() != 1 or x.shape[-1] != w.shape[1] or b.shape[0] != w.shape[0]:
        raise ValueError(
            f"linear_gelu_bf16 takes x (..., K), w (N, K) and b (N,), got x {tuple(x.shape)}, "
            f"w {tuple(w.shape)}, b {tuple(b.shape)}"
        )


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load_library("linear_gelu_bf16_fwd").ufm_linear_gelu_bf16_fwd
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def launch(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, preact_out: Optional[torch.Tensor] = None,
           schedule: str = "pingpong") -> torch.Tensor:
    """The op's CUDA implementation, one kernel launch: bf16 CUDA ``x``
    (..., K), ``w`` (N, K) and ``b`` (N,) -> a fresh contiguous (..., N)
    tensor. ``w`` and ``b`` must be contiguous (a parameter is); a
    non-contiguous ``x`` is read through a contiguous copy. K and N must be
    multiples of 8 and every base address 16-byte aligned (TMA's
    conditions). ``preact_out``, a contiguous bf16 tensor of the output's
    shape, also receives the rounded pre-activation ``h`` (the training
    launch, :func:`launch_preact`). An empty ``x`` launches nothing."""
    global LAUNCHES
    for name, t in (("x", x), ("w", w), ("b", b)):
        if not t.is_cuda:
            raise ValueError(
                f"the linear + GELU kernel runs only on CUDA tensors ({name} is on {t.device}); "
                "the plain version is linear_gelu_reference"
            )
    _check(x, w, b)
    if w.device != x.device or b.device != x.device:
        raise ValueError(f"x, w and b must share a device, got {x.device}, {w.device}, {b.device}")
    n, k = w.shape
    if k % 8 or n % 8:
        raise ValueError(f"the linear + GELU kernel takes K and N multiples of 8, got K={k}, N={n}")
    if not (w.is_contiguous() and b.is_contiguous()):
        raise ValueError("the linear + GELU kernel takes a contiguous w and b")
    x2 = x.reshape(-1, k).contiguous()
    m = x2.shape[0]
    out = torch.empty((*x.shape[:-1], n), dtype=torch.bfloat16, device=x.device)
    pre_ptr = None
    if preact_out is not None:
        if preact_out.dtype != torch.bfloat16 or preact_out.shape != out.shape or not preact_out.is_contiguous() \
                or preact_out.device != x.device:
            raise ValueError(f"preact_out must be a contiguous bf16 {tuple(out.shape)} tensor on {x.device}")
        pre_ptr = preact_out.data_ptr()
    if m >= 2**31:
        raise ValueError(f"the linear + GELU kernel takes fewer than 2^31 rows, got {m}")
    for name, t in (("x", x2), ("w", w), ("b", b), ("preact_out", preact_out)):
        if t is not None and t.numel() and t.data_ptr() % 16:
            raise ValueError(f"the linear + GELU kernel needs 16-byte aligned operands ({name} is not)")
    if m == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(x.device):
        err = fn(x2.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), pre_ptr, m, n, k, SCHEDULES[schedule],
                 torch.cuda.current_stream(x.device).cuda_stream)
        LAUNCHES += 1
    if err != 0:
        raise RuntimeError(f"linear + GELU kernel launch failed: {_build.launch_error_cause(err)} at "
                           f"M={m}, N={n}, K={k}")
    return out


def launch_preact(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """The training launch: :func:`launch` with a fresh ``h`` as its
    ``preact_out``; returns ``(y, h)``."""
    h = torch.empty((*x.shape[:-1], w.shape[0]), dtype=torch.bfloat16, device=x.device)
    return launch(x, w, b, preact_out=h), h


def linear_gelu_bf16(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``gelu_bf16(F.linear(x, w, b))`` through the op
    ``ufm_torch::linear_gelu_bf16``: the fused kernel for CUDA tensors, the
    plain version for CPU tensors. Refuses any dtype but bfloat16."""
    _check(x, w, b)
    return torch.ops.ufm_torch.linear_gelu_bf16.default(x, w, b)


# ---- the backward: fc2's input gradient with the GELU's gradient as its epilogue
def _check_bwd(g: torch.Tensor, w2: torch.Tensor, h: torch.Tensor) -> None:
    for name, t in (("g", g), ("w2", w2), ("h", h)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"linear_gelu_bf16_bwd takes bfloat16, got {name} {t.dtype}")
    if g.dim() < 1 or w2.dim() != 2 or h.dim() < 1 or g.shape[-1] != w2.shape[0] or h.shape[-1] != w2.shape[1] \
            or g.shape[:-1].numel() != h.shape[:-1].numel():
        raise ValueError(
            f"linear_gelu_bf16_bwd takes g (..., N2), w2 (N2, N) and h (..., N) with as many rows as g, got "
            f"g {tuple(g.shape)}, w2 {tuple(w2.shape)}, h {tuple(h.shape)}"
        )


def linear_gelu_bwd_reference(g: torch.Tensor, w2: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """The plain version: the GELU's gradient at ``h`` under ``g @ w2``
    (``fast_exact_gelu_vjp_reference(h, g.reshape(-1, N2).mm(w2))``), bf16
    ``g`` (..., N2), ``w2`` (N2, N) and ``h`` (..., N) on any device; ``dh``
    has ``h``'s shape."""
    _check_bwd(g, w2, h)
    dy = g.reshape(-1, w2.shape[0]).mm(w2)
    return fast_exact_gelu_vjp_reference(h.reshape(dy.shape), dy).view(h.shape)


def _bwd_kernel():
    global _bwd_fn
    if _bwd_fn is None:
        fn = _build.load_library("linear_gelu_bf16_bwd").ufm_linear_gelu_bf16_bwd
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bwd_fn = fn
    return _bwd_fn


def launch_backward(g: torch.Tensor, w2: torch.Tensor, h: torch.Tensor, dy_out: Optional[torch.Tensor] = None,
                    schedule: str = "pingpong") -> torch.Tensor:
    """The backward op's CUDA implementation, one kernel launch: bf16 CUDA
    ``g`` (..., N2), ``w2`` (N2, N) and ``h`` (..., N) -> a fresh contiguous
    ``dh`` of ``h``'s shape. ``w2`` must be contiguous (a parameter is);
    ``g`` and ``h`` are read through contiguous copies where they are not.
    N2 and N must be multiples of 8 and every base address 16-byte aligned
    (TMA's conditions), fewer than 2^31 rows. ``dy_out``, a contiguous bf16
    (rows, N) tensor, also receives the rounded product (the checks'
    instance). No rows launch nothing."""
    global BWD_LAUNCHES
    for name, t in (("g", g), ("w2", w2), ("h", h)):
        if not t.is_cuda:
            raise ValueError(
                f"the linear + GELU gradient kernel runs only on CUDA tensors ({name} is on {t.device}); "
                "the plain version is linear_gelu_bwd_reference"
            )
    _check_bwd(g, w2, h)
    if w2.device != g.device or h.device != g.device:
        raise ValueError(f"g, w2 and h must share a device, got {g.device}, {w2.device}, {h.device}")
    n2, n = w2.shape
    if n2 % 8 or n % 8:
        raise ValueError(f"the linear + GELU gradient kernel takes N2 and N multiples of 8, got N2={n2}, N={n}")
    if not w2.is_contiguous():
        raise ValueError("the linear + GELU gradient kernel takes a contiguous w2")
    g2 = g.reshape(-1, n2).contiguous()
    h2 = h.reshape(-1, n).contiguous()
    m = g2.shape[0]
    if m >= 2**31:
        raise ValueError(f"the linear + GELU gradient kernel takes fewer than 2^31 rows, got {m}")
    dy_ptr = None
    if dy_out is not None:
        if dy_out.dtype != torch.bfloat16 or tuple(dy_out.shape) != (m, n) or not dy_out.is_contiguous() \
                or dy_out.device != g.device:
            raise ValueError(f"dy_out must be a contiguous bf16 {(m, n)} tensor on {g.device}")
        dy_ptr = dy_out.data_ptr()
    out = torch.empty(h.shape, dtype=torch.bfloat16, device=h.device)
    for name, t in (("g", g2), ("w2", w2), ("h", h2), ("dh", out), ("dy_out", dy_out)):
        if t is not None and t.numel() and t.data_ptr() % 16:
            raise ValueError(f"the linear + GELU gradient kernel needs 16-byte aligned operands ({name} is not)")
    if m == 0:
        return out
    fn = _bwd_kernel()
    with torch.cuda.device(g.device):
        err = fn(g2.data_ptr(), w2.data_ptr(), h2.data_ptr(), out.data_ptr(), dy_ptr, m, n, n2,
                 BWD_SCHEDULES[schedule], torch.cuda.current_stream(g.device).cuda_stream)
        BWD_LAUNCHES += 1
    if err != 0:
        raise RuntimeError(f"linear + GELU gradient kernel launch failed: {_build.launch_error_cause(err)} at "
                           f"M={m}, N={n}, N2={n2}")
    return out


def linear_gelu_bf16_bwd(g: torch.Tensor, w2: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """``gelu_bf16_bwd(g @ w2, h)`` through the op
    ``ufm_torch::linear_gelu_bf16_bwd``: the fused kernel for CUDA tensors,
    the plain version for CPU tensors. Refuses any dtype but bfloat16."""
    _check_bwd(g, w2, h)
    return torch.ops.ufm_torch.linear_gelu_bf16_bwd.default(g, w2, h)
