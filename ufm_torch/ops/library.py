"""The port's Hopper kernels as dispatcher ops (``torch.library``).

Five ops in the ``ufm_torch`` namespace:

- ``flash_attention_fwd(q, k, v, scale, with_lse) -> (out, lse)``: softmax
  attention over (B, S, H, D); ``lse`` (B, H, Sq) fp32 is each row's
  log-sum-exp when ``with_lse``, else an empty tensor;
- ``flash_attention_bwd(q, k, v, out, lse, g, scale) -> (dq, dk, dv)``;
- ``window_refinement(q, f, flow, bias, temperature, p, staged_count?) ->
  (residual, log_softmax)``; ``staged_count`` (optional, mutated) receives
  the number of tiles whose taps the kernel staged;
- ``gelu_bf16(x) -> y``: the JAX package's exact GELU of a bf16 tensor, bit
  for bit (``ufm_torch/ops/gelu.py``);
- ``linear_gelu_bf16(x, w, b) -> y``: ``gelu_bf16(F.linear(x, w, b))`` on
  bf16, the MLP's ``fc1`` with the GELU as its epilogue
  (``ufm_torch/ops/linear_gelu.py``).

The tensors' device picks the implementation inside the op: CUDA runs the
hand-written kernel (``flash_attention.launch_forward`` /
``launch_backward``, which pick the wgmma or the mma kernel by dtype
and head dim, ``window_refinement.launch``, ``gelu.launch``,
``linear_gelu.launch``: every pointer, stride and alignment check and the
launch counters live there, and they raise on what the kernels do not
take), CPU runs the plain version. A fake implementation gives each output's
shape and dtype from the inputs' (with the shape checks, and on a CUDA
tensor the kernels' dtype and head-dim domain: fp32, bf16 or fp16 at 1 <= D
<= 256, as ``forward_kernel`` / ``backward_kernel`` route it), so
``torch.export`` and ``torch.compile`` trace the model with the ops as graph
nodes and an exported program launches the kernels wherever it is moved to.

Gradients: the forward attention op's backward is the backward op (its
forward then writes ``lse``, which the backward kernel reads); the window
op's backward is autograd over its plain version, as in the JAX package
(the TPU kernel had no backward); the GELU op's backward is one
``aten.gelu_backward`` on the saved input. Each is an ``Autograd`` kernel
around an ``autograd.Function``, which is what
``torch.library.register_autograd`` registers, written out:
``register_autograd`` refuses an op with a mutated argument (the window op's
``staged_count``), and its generic kernel does more host work a call. The
backward op has no gradient of its own, and the fused ``linear_gelu_bf16``
none: its ``Autograd`` kernel refuses inputs that require grad under grad
mode (the MLP takes the two ops there).

Registration runs when the module is imported (``ufm_torch.ops`` imports
it); it builds nothing: a kernel is compiled at its first CUDA launch.
"""

from __future__ import annotations

import torch

from ufm_torch.ops import flash_attention as _fa
from ufm_torch.ops import gelu as _gelu
from ufm_torch.ops import linear_gelu as _lg
from ufm_torch.ops import window_refinement as _wr

__all__ = [
    "NAMESPACE", "flash_attention_fwd", "flash_attention_bwd", "window_refinement", "gelu_bf16", "linear_gelu_bf16",
    "OPS", "attention",
]

NAMESPACE = "ufm_torch"

_LIB = torch.library.Library(NAMESPACE, "DEF")
_LIB.define("flash_attention_fwd(Tensor q, Tensor k, Tensor v, float scale, bool with_lse) -> (Tensor, Tensor)")
_LIB.define(
    "flash_attention_bwd(Tensor q, Tensor k, Tensor v, Tensor out, Tensor lse, Tensor g, float scale)"
    " -> (Tensor, Tensor, Tensor)"
)
_LIB.define(
    "window_refinement(Tensor q, Tensor f, Tensor flow, Tensor bias, float temperature, int p,"
    " Tensor(a!)? staged_count=None) -> (Tensor, Tensor)"
)
_LIB.define("gelu_bf16(Tensor x) -> Tensor")
_LIB.define("linear_gelu_bf16(Tensor x, Tensor w, Tensor b) -> Tensor")

flash_attention_fwd = torch.ops.ufm_torch.flash_attention_fwd.default
flash_attention_bwd = torch.ops.ufm_torch.flash_attention_bwd.default
window_refinement = torch.ops.ufm_torch.window_refinement.default
gelu_bf16 = torch.ops.ufm_torch.gelu_bf16.default
linear_gelu_bf16 = torch.ops.ufm_torch.linear_gelu_bf16.default
OPS = (flash_attention_fwd, flash_attention_bwd, window_refinement, gelu_bf16, linear_gelu_bf16)

_LIB.impl("flash_attention_fwd", _fa.launch_forward, "CUDA")
_LIB.impl("flash_attention_fwd", _fa.plain_forward, "CPU")
_LIB.impl("flash_attention_bwd", _fa.launch_backward, "CUDA")
_LIB.impl("flash_attention_bwd", _fa.plain_backward, "CPU")
_LIB.impl("window_refinement", _wr.launch, "CUDA")
_LIB.impl("window_refinement", _wr.plain, "CPU")
_LIB.impl("gelu_bf16", _gelu.launch, "CUDA")
_LIB.impl("gelu_bf16", _gelu.fast_exact_gelu_reference, "CPU")
_LIB.impl("linear_gelu_bf16", _lg.launch, "CUDA")
_LIB.impl("linear_gelu_bf16", _lg.linear_gelu_reference, "CPU")


# ---- fake implementations: shapes and dtypes --------------------------------
def _check_attention(op: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{op} takes (B, S, H, D) tensors, got q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if k.shape != v.shape or q.shape[0] != k.shape[0] or q.shape[2:] != k.shape[2:]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.device.type == "cuda":  # the kernels' domain
        for name, t in (("k", k), ("v", v)):
            if t.dtype != q.dtype:
                raise ValueError(f"{op}: q, k and v must share a dtype, got q {q.dtype}, {name} {t.dtype}")
        route = _fa.forward_kernel if op == "flash_attention_fwd" else _fa.backward_kernel
        route(q.dtype, q.shape[-1])


@torch.library.register_fake(f"{NAMESPACE}::flash_attention_fwd", lib=_LIB)
def _fwd_fake(q, k, v, scale, with_lse):
    _check_attention("flash_attention_fwd", q, k, v)
    b, sq, h, _ = q.shape
    lse_shape = (b, h, sq) if with_lse else (0,)
    return q.new_empty(q.shape), q.new_empty(lse_shape, dtype=torch.float32)


@torch.library.register_fake(f"{NAMESPACE}::flash_attention_bwd", lib=_LIB)
def _bwd_fake(q, k, v, out, lse, g, scale):
    _check_attention("flash_attention_bwd", q, k, v)
    if out.shape != q.shape or g.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and g {tuple(g.shape)} must be q's shape {tuple(q.shape)}")
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


@torch.library.register_fake(f"{NAMESPACE}::window_refinement", lib=_LIB)
def _window_fake(q, f, flow, bias, temperature, p, staged_count=None):
    if q.dim() != 4 or q.shape != f.shape or flow.shape != (*q.shape[:3], 2) or bias.shape != (p * p,):
        raise ValueError(
            f"window_refinement takes q, f (B, H, W, C), flow (B, H, W, 2) and bias (P*P,), got q {tuple(q.shape)}, "
            f"f {tuple(f.shape)}, flow {tuple(flow.shape)}, bias {tuple(bias.shape)}, P={p}"
        )
    b, h, w, _ = q.shape
    return q.new_empty((b, h, w, 2), dtype=torch.float32), q.new_empty((b, h, w, p, p), dtype=torch.float32)


@torch.library.register_fake(f"{NAMESPACE}::gelu_bf16", lib=_LIB)
def _gelu_fake(x):
    if x.dtype != torch.bfloat16:
        raise ValueError(f"gelu_bf16 takes bfloat16, got {x.dtype}")
    return x.new_empty(x.shape)


@torch.library.register_fake(f"{NAMESPACE}::linear_gelu_bf16", lib=_LIB)
def _linear_gelu_fake(x, w, b):
    _lg._check(x, w, b)
    return x.new_empty((*x.shape[:-1], w.shape[0]))


# ---- autograd --------------------------------------------------------------
class _FlashAttention(torch.autograd.Function):
    """The forward op below autograd; the backward is the backward op on the
    saved q, k, v, output and row log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, scale, with_lse):
        with torch._C._AutoDispatchBelowAutograd():
            out, lse = flash_attention_fwd(q, k, v, scale, with_lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        if lse.numel() == 0 and q.is_cuda:
            raise RuntimeError("the attention backward needs the forward's row log-sum-exp: call it with_lse=True")
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, g, ctx.scale)
        return dq, dk, dv, None, None


def _fwd_autograd(q, k, v, scale, with_lse):
    if _fa.needs_lse(q, k, v):
        return _FlashAttention.apply(q, k, v, scale, with_lse)
    with torch._C._AutoDispatchBelowAutograd():
        return flash_attention_fwd(q, k, v, scale, with_lse)


class _WindowRefinement(torch.autograd.Function):
    """The window op below autograd; the backward is autograd over the plain
    version on the saved inputs."""

    @staticmethod
    def forward(ctx, q, f, flow, bias, temperature, p, staged_count):
        with torch._C._AutoDispatchBelowAutograd():
            out = window_refinement(q, f, flow, bias, temperature, p, staged_count)
        ctx.save_for_backward(q, f, flow, bias)
        ctx.temperature, ctx.p = temperature, p
        return out

    @staticmethod
    def backward(ctx, g_residual, g_log_softmax):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(need) for t, need in zip(saved, ctx.needs_input_grad[:4])]
            outs = _wr.window_refinement_reference(*ins, ctx.temperature, ctx.p)
            wanted = [t for t in ins if t.requires_grad]
            grads = iter(torch.autograd.grad(outs, wanted, (g_residual, g_log_softmax)))
        return (*[next(grads) if t.requires_grad else None for t in ins], None, None, None)


def _window_autograd(q, f, flow, bias, temperature, p, staged_count=None):
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, f, flow, bias)):
        return _WindowRefinement.apply(q, f, flow, bias, temperature, p, staged_count)
    with torch._C._AutoDispatchBelowAutograd():
        return window_refinement(q, f, flow, bias, temperature, p, staged_count)


class _GeluBf16(torch.autograd.Function):
    """The GELU op below autograd; the backward is ``F.gelu``'s exact
    derivative (``aten.gelu_backward``) on the saved input: one op, where
    autograd through the plain chain would keep three intermediates."""

    @staticmethod
    def forward(ctx, x):
        with torch._C._AutoDispatchBelowAutograd():
            y = gelu_bf16(x)
        ctx.save_for_backward(x)
        return y

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return torch.ops.aten.gelu_backward(grad, x, approximate="none")


def _gelu_autograd(x):
    if torch.is_grad_enabled() and x.requires_grad:
        return _GeluBf16.apply(x)
    with torch._C._AutoDispatchBelowAutograd():
        return gelu_bf16(x)


_LIB.impl("flash_attention_fwd", _fwd_autograd, "Autograd")
_LIB.impl("window_refinement", _window_autograd, "Autograd")
_LIB.impl("gelu_bf16", _gelu_autograd, "Autograd")


def _linear_gelu_autograd(x, w, b):
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w, b)):
        raise RuntimeError(
            "ufm_torch::linear_gelu_bf16 has no gradient: under grad mode take fc1 and "
            "ufm_torch::gelu_bf16 (nn.layers.Mlp does)"
        )
    with torch._C._AutoDispatchBelowAutograd():
        return linear_gelu_bf16(x, w, b)


_LIB.impl("linear_gelu_bf16", _linear_gelu_autograd, "Autograd")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """The forward op's output on any device (writing the row log-sum-exp
    only when the output will be differentiated)."""
    return flash_attention_fwd(q, k, v, scale, _fa.needs_lse(q, k, v))[0]

