"""Flash attention: the Hopper kernels and their plain PyTorch versions.

The kernels are reached through the dispatcher ops
``ufm_torch::flash_attention_fwd`` and ``ufm_torch::flash_attention_bwd``
(:mod:`ufm_torch.ops.library`). :func:`launch_forward` launches one of two
hand-written CUDA forwards (the port of ``ufm_tpu/ops/flash_attention.py``'s
Pallas forward), chosen by :func:`forward_kernel` from the dtype and head dim
alone: bf16 at D = 64, the flagship's attention, takes the wgmma kernel
(``ufm_torch/csrc/flash_attention_fwd.cu``); every other call in the TPU
kernel's domain (fp32, bf16 or fp16, 1 <= D <= 256) takes the mma kernel
(``ufm_torch/csrc/flash_attention_fwd_any.cu``: TF32 ``mma.sync`` on the
tensor cores, 3xTF32 for fp32 operands). Both also write each row's
log-sum-exp when asked. :func:`launch_backward` launches one of two
hand-written CUDA backwards (the port of the Pallas
``_flash_attention_bwd_impl``), chosen by :func:`backward_kernel` the same
way: bf16 at D = 64 takes the wgmma kernel
(``ufm_torch/csrc/flash_attention_bwd.cu``), the rest of the domain the
mma kernel (``ufm_torch/csrc/flash_attention_bwd_any.cu``). They are
the ops' CUDA implementations, and raise on anything the kernels do not
take; they never fall back to :func:`attention_reference` /
:func:`attention_backward_reference`, the plain versions of the same
functions, which are the ops' CPU implementations and what the kernel
checks use. :func:`flash_attention`,
:func:`flash_attention_forward` and :func:`flash_attention_backward` call the
ops on CUDA tensors and refuse any other.

Inputs are (B, S, H, D) like the JAX package. q, k and v may be strided views
(the fused qkv projection, reshaped (B, S, 3, H, D)): the wgmma kernels read
them in place through TMA tensor maps, which need D contiguous, a 16-byte
aligned base and the other strides multiples of 16 bytes
(:func:`tma_layout_error`); the mma kernels read any strides.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from ufm_torch.ops import _build

__all__ = [
    "flash_attention",
    "flash_attention_forward",
    "flash_attention_backward",
    "launch_forward",
    "launch_backward",
    "plain_forward",
    "plain_backward",
    "needs_lse",
    "attention_reference",
    "attention_backward_reference",
    "LAUNCHES",
    "ANY_LAUNCHES",
    "BWD_LAUNCHES",
    "ANY_BWD_LAUNCHES",
    "HEAD_DIM",
    "MAX_HEAD_DIM",
    "forward_kernel",
    "backward_kernel",
    "tma_layout_error",
]

HEAD_DIM = 64  # the wgmma kernels' only head_dim (the flagship's)
MAX_HEAD_DIM = 256  # the mma kernels' largest head_dim
# the mma kernels' element types, by their C entry points' dtype code
_ANY_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_GRID_Y = 65535  # the mma forward's grid: (Sq blocks, B * H)

# wgmma forward kernel launches since the count was last reset (``LAUNCHES = 0``)
LAUNCHES = 0
# mma forward kernel launches since the count was last reset
ANY_LAUNCHES = 0
# backward calls since the count was last reset (``BWD_LAUNCHES = 0``); each
# call runs two CUDA kernels in order: delta, then one grid of dK/dV and dQ
# blocks
BWD_LAUNCHES = 0
# mma backward calls since the count was last reset; each call runs two
# CUDA kernels in order: delta, then one grid of dK/dV and dQ blocks
ANY_BWD_LAUNCHES = 0

_fwd_fn = None
_fwd_any_fn = None
_bwd_fn = None
_bwd_any_fn = None


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, with_lse: bool = False):
    """Plain softmax attention over (B, S, H, D): logits in the input dtype
    times ``scale``, softmax in fp32, weights cast back, then times v (the math
    of ``ufm_tpu/ops/attention.py::_xla_attention``). With ``with_lse`` it
    returns (out, lse): ``lse`` (B, H, Sq) fp32 is each row's natural-log
    log-sum-exp of the scaled logits, as the forward kernel writes it."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    weights = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", weights, v)
    if with_lse:
        return out, torch.logsumexp(logits.float(), dim=-1)
    return out


def attention_backward_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor, scale: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain attention gradient (dq, dk, dv) for the output gradient ``g``:
    the math of ``ufm_tpu/ops/flash_attention.py::_xla_attention_bwd`` (logits
    in the input dtype, then fp32 einsums throughout, each gradient cast back
    to its input's dtype)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    p = torch.softmax(logits, dim=-1)
    g32, v32 = g.float(), v.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p, g32)
    dp = torch.einsum("bqhd,bkhd->bhqk", g32, v32)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _fwd_kernel():
    global _fwd_fn
    if _fwd_fn is None:
        fn = _build.load_library("flash_attention_fwd").ufm_flash_attention_fwd_bf16
        fn.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 12
            + [ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _fwd_fn = fn
    return _fwd_fn


def _fwd_any_kernel():
    global _fwd_any_fn
    if _fwd_any_fn is None:
        fn = _build.load_library("flash_attention_fwd_any").ufm_flash_attention_fwd_any
        fn.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 15
            + [ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _fwd_any_fn = fn
    return _fwd_any_fn


def _route(what: str, dtype: torch.dtype, head_dim: int) -> str:
    if dtype == torch.bfloat16 and head_dim == HEAD_DIM:
        return "wgmma"
    if dtype in _ANY_DTYPES and 1 <= head_dim <= MAX_HEAD_DIM:
        return "mma"
    raise ValueError(
        f"{what} on the card takes float32, bfloat16 or float16 with 1 <= D <= {MAX_HEAD_DIM}, "
        f"got {dtype} with D = {head_dim}"
    )


def forward_kernel(dtype: torch.dtype, head_dim: int) -> str:
    """Which forward kernel takes a CUDA call of this dtype and head dim:
    ``"wgmma"`` (bf16 at D = 64, ``csrc/flash_attention_fwd.cu``) or
    ``"mma"`` (fp32, bf16 or fp16 at any other 1 <= D <= 256,
    ``csrc/flash_attention_fwd_any.cu``: TF32 mma.sync, 3xTF32 for fp32). Raises ValueError, naming the
    dtype and D, outside that domain (float64, D > 256)."""
    return _route("flash_attention", dtype, head_dim)


def backward_kernel(dtype: torch.dtype, head_dim: int) -> str:
    """Which backward kernel takes a CUDA call of this dtype and head dim:
    ``"wgmma"`` (bf16 at D = 64, ``csrc/flash_attention_bwd.cu``) or
    ``"mma"`` (fp32, bf16 or fp16 at any other 1 <= D <= 256,
    ``csrc/flash_attention_bwd_any.cu``); the forward's routing, so a
    backward reads the lse of the forward it follows. Raises ValueError,
    naming the dtype and D, outside that domain."""
    return _route("the attention backward", dtype, head_dim)


def _bwd_any_kernel():
    global _bwd_any_fn
    if _bwd_any_fn is None:
        fn = _build.load_library("flash_attention_bwd_any").ufm_flash_attention_bwd_any
        fn.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 29
            + [ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _bwd_any_fn = fn
    return _bwd_any_fn


def _bwd_kernel():
    global _bwd_fn
    if _bwd_fn is None:
        fn = _build.load_library("flash_attention_bwd").ufm_flash_attention_bwd_bf16
        fn.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 24
            + [ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _bwd_fn = fn
    return _bwd_fn


def _check_tensor(name: str, t: torch.Tensor) -> None:
    if not t.is_cuda:
        raise ValueError(
            f"flash_attention runs only on CUDA tensors ({name} is on {t.device}); "
            "the plain version is dot_product_attention(..., impl='torch')"
        )
    if t.dtype != torch.bfloat16 or t.dim() != 4 or t.shape[-1] != HEAD_DIM:
        d = t.shape[-1] if t.dim() else None
        raise ValueError(
            f"the wgmma attention kernels take bfloat16 (B, S, H, {HEAD_DIM}) tensors, got {name} {t.dtype} "
            f"{tuple(t.shape)} (D = {d})"
        )
    why = _layout_error(t)
    if why is not None:
        raise ValueError(f"flash_attention cannot read {name} in place: {why}")


# TMA's limits on a tensor map: global strides below 2^40 bytes, coordinates
# (int32) below 2^31
_TMA_MAX_STRIDE_BYTES = 1 << 40
_TMA_MAX_DIM = 1 << 31


def tma_layout_error(
    shape: Sequence[int], strides: Sequence[int], data_ptr: int, itemsize: int
) -> Optional[str]:
    """Why the kernels' rank-4 TMA tensor map cannot cover a (B, S, H, D)
    view with these element strides, base address and item size, or None
    when it can: D contiguous, the base 16-byte aligned, and the B, S and H
    strides positive multiples of 16 bytes below 2^40 (a dimension of size 1
    is never stepped, so its stride is free; the C side replaces it)."""
    if len(shape) != 4 or len(strides) != 4:
        return f"expected a rank-4 (B, S, H, D) view, got shape {tuple(shape)}"
    if strides[-1] != 1:
        return f"the head dim is not contiguous (strides {tuple(strides)})"
    if data_ptr % 16:
        return f"the base address is not 16-byte aligned (offset {data_ptr % 16})"
    for dim, (n, st) in zip("BSH", zip(shape[:3], strides[:3])):
        if n >= _TMA_MAX_DIM:
            return f"{dim} = {n} exceeds TMA's coordinate range"
        nbytes = st * itemsize
        if n > 1 and (nbytes <= 0 or nbytes % 16 or nbytes >= _TMA_MAX_STRIDE_BYTES):
            return f"the {dim} stride is {nbytes} bytes, not a positive multiple of 16 below 2^40"
    return None


def _layout_error(t: torch.Tensor) -> Optional[str]:
    return tma_layout_error(tuple(t.shape), t.stride(), t.data_ptr(), t.element_size())


def _launch_error(what: str, err: int, q: torch.Tensor, k: torch.Tensor) -> RuntimeError:
    return RuntimeError(f"{what} failed: {_build.launch_error_cause(err)} at q {tuple(q.shape)}, k {tuple(k.shape)}")


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if k.shape != v.shape or q.shape[0] != k.shape[0] or q.shape[2:] != k.shape[2:]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if k.shape[1] == 0:
        raise ValueError("flash_attention needs at least one key")


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_tensor(name, t)
    _check_shapes(q, k, v)


def _check_any(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """The mma forward's conditions beyond q's dtype and D (which
    :func:`forward_kernel` checked): CUDA tensors of q's dtype, rank 4,
    matching shapes, B * H within its grid."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention runs only on CUDA tensors ({name} is on {t.device})")
        if t.dim() != 4:
            raise ValueError(f"flash_attention takes (B, S, H, D) tensors, got {name}.shape={tuple(t.shape)}")
        if t.dtype != q.dtype:
            raise ValueError(f"q, k and v must share a dtype, got q {q.dtype}, {name} {t.dtype}")
    _check_shapes(q, k, v)
    if q.shape[0] * q.shape[2] > _MAX_GRID_Y:
        raise ValueError(f"flash_attention takes B * H <= {_MAX_GRID_Y}, got q {tuple(q.shape)}")


def _empty_lse(q: torch.Tensor) -> torch.Tensor:
    """The forward op's ``lse`` output when it was not asked for."""
    return torch.empty((0,), dtype=torch.float32, device=q.device)


def launch_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, with_lse: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward op's CUDA implementation, one kernel launch: (out
    (B, Sq, H, D) in q's dtype, lse (B, H, Sq) fp32, or an empty tensor when
    not ``with_lse``). ``lse`` is each row's natural-log log-sum-exp of the
    scaled scores, written only when ``with_lse`` (the training forward);
    inference passes a null pointer. :func:`forward_kernel` picks the kernel
    from q's dtype and D before anything is launched."""
    global LAUNCHES
    if q.dim() == 4 and forward_kernel(q.dtype, q.shape[-1]) == "mma":
        return _launch_forward_any(q, k, v, scale, with_lse)
    _check(q, k, v)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) if with_lse else _empty_lse(q)
    if sq == 0:
        return out, lse
    fn = _fwd_kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr() if with_lse else None,
            b, h, sq, sk,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            float(scale), stream,
        )
        LAUNCHES += 1
    if err != 0:
        raise _launch_error("flash_attention kernel launch", err, q, k)
    return out, lse


def _launch_forward_any(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, with_lse: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`launch_forward` on the mma kernel: q, k, v read through
    their strides, a fresh contiguous output."""
    global ANY_LAUNCHES
    _check_any(q, k, v)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) if with_lse else _empty_lse(q)
    if out.numel() == 0:
        return out, lse
    fn = _fwd_any_kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr() if with_lse else None,
            _ANY_DTYPES[q.dtype], b, h, sq, sk, d,
            *q.stride(), *k.stride(), *v.stride(), *out.stride()[:3],
            float(scale), stream,
        )
        ANY_LAUNCHES += 1
    if err != 0:
        raise _launch_error("flash_attention (mma) kernel launch", err, q, k)
    return out, lse


def launch_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    g: torch.Tensor,
    scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward op's CUDA implementation, one backward call (two CUDA
    kernels: delta, then dK/dV and dQ): (dq, dk, dv), fresh contiguous
    tensors in the inputs' dtype, from the forward's inputs, output and
    ``lse`` and the output gradient ``g``. :func:`backward_kernel` picks the
    kernel from q's dtype and D before anything is launched: bf16 at D = 64
    takes the wgmma kernel, which reads ``g`` through its strides (one whose
    rows it cannot read in place, a non-contiguous head dim or unaligned
    rows, is copied to a contiguous tensor first); the rest of the domain
    takes the mma kernel (:func:`_launch_backward_any`). Outside the
    domain it raises, naming the dtype and D."""
    global BWD_LAUNCHES
    if q.dim() == 4 and backward_kernel(q.dtype, q.shape[-1]) == "mma":
        return _launch_backward_any(q, k, v, out, lse, g, scale)
    _check(q, k, v)
    if _layout_error(g) is not None:
        g = g.contiguous()
    for name, t in (("out", out), ("g", g)):
        _check_tensor(name, t)
        if t.shape != q.shape:
            raise ValueError(f"{name}.shape={tuple(t.shape)} != q.shape={tuple(q.shape)}")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if lse.dtype != torch.float32 or lse.shape != (b, h, sq) or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous float32 {(b, h, sq)} tensor, got {lse.dtype} {tuple(lse.shape)}")
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, sk, h, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, sk, h, d), dtype=v.dtype, device=q.device)
    if sq == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)  # scratch
    fn = _bwd_kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), g.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, h, sq, sk,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3], *g.stride()[:3],
            *dq.stride()[:3], *dk.stride()[:3], *dv.stride()[:3],
            float(scale), stream,
        )
        BWD_LAUNCHES += 1
    if err != 0:
        raise _launch_error("flash_attention backward launch", err, q, k)
    return dq, dk, dv


def _launch_backward_any(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    g: torch.Tensor,
    scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`launch_backward` on the mma kernel: q, k, v, ``out`` and
    ``g`` read through their strides, fresh contiguous gradients."""
    global ANY_BWD_LAUNCHES
    _check_any(q, k, v)
    for name, t in (("out", out), ("g", g)):
        if not t.is_cuda or t.dtype != q.dtype or t.shape != q.shape:
            raise ValueError(
                f"{name} must be a CUDA tensor of q's dtype and shape, got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if lse.dtype != torch.float32 or lse.shape != (b, h, sq) or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous float32 {(b, h, sq)} tensor, got {lse.dtype} {tuple(lse.shape)}")
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, sk, h, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, sk, h, d), dtype=v.dtype, device=q.device)
    if dq.numel() == 0:  # no query: dk and dv are zero
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)  # scratch
    fn = _bwd_any_kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), g.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _ANY_DTYPES[q.dtype], b, h, sq, sk, d,
            *q.stride(), *k.stride(), *v.stride(), *out.stride(), *g.stride(),
            *dq.stride()[:3], *dk.stride()[:3], *dv.stride()[:3],
            float(scale), stream,
        )
        ANY_BWD_LAUNCHES += 1
    if err != 0:
        raise _launch_error("flash_attention backward (mma) launch", err, q, k)
    return dq, dk, dv


def plain_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, with_lse: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward op's CPU implementation: :func:`attention_reference`,
    returned in the kernel's layout (contiguous, an empty ``lse`` when not
    ``with_lse``)."""
    if with_lse:
        out, lse = attention_reference(q, k, v, scale, with_lse=True)
        return out.contiguous(), lse.contiguous()
    return attention_reference(q, k, v, scale).contiguous(), _empty_lse(q)


def plain_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    g: torch.Tensor,
    scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward op's CPU implementation: :func:`attention_backward_reference`
    (which recomputes P and so needs neither ``out`` nor ``lse``)."""
    return tuple(t.contiguous() for t in attention_backward_reference(q, k, v, g, scale))


def _require_cuda(*tensors: torch.Tensor) -> None:
    for name, t in zip("qkv", tensors):
        if not t.is_cuda:
            raise ValueError(
                f"flash_attention runs only on CUDA tensors ({name} is on {t.device}); "
                "the plain version is dot_product_attention(..., impl='torch')"
            )


def needs_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether a forward's output will be differentiated: then the forward
    writes the row log-sum-exp, which the backward kernel reads."""
    return torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)


def flash_attention_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, with_lse: bool = False
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One forward op call on the card: (out (B, Sq, H, D) in q's dtype, lse
    (B, H, Sq) fp32 or None); see :func:`launch_forward`."""
    _require_cuda(q, k, v)
    out, lse = torch.ops.ufm_torch.flash_attention_fwd(q, k, v, float(scale), with_lse)
    return out, (lse if with_lse else None)


def flash_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    g: torch.Tensor,
    scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One backward op call on the card; see :func:`launch_backward`."""
    _require_cuda(q, k, v)
    return torch.ops.ufm_torch.flash_attention_bwd(q, k, v, out, lse, g, float(scale))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: Optional[float] = None) -> torch.Tensor:
    """Softmax attention on the card: q (B, Sq, H, D), k/v (B, Sk, H, D)
    fp32, bf16 or fp16, 1 <= D <= 256 -> (B, Sq, H, D) in their dtype, a fresh
    contiguous tensor, from the kernel :func:`forward_kernel` picks. With grad enabled
    and an input that requires grad, the forward also writes the row
    log-sum-exp and the output's gradient is the backward kernel
    :func:`backward_kernel` picks (the op's autograd formula); otherwise it
    is one plain forward launch."""
    _require_cuda(q, k, v)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return torch.ops.ufm_torch.flash_attention_fwd(q, k, v, float(scale), needs_lse(q, k, v))[0]
