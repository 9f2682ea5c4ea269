"""The attention backward over the TPU kernel's whole domain, on the CPU.

- **The plain backward** (``attention_backward_reference``, the backward
  op's CPU implementation and the reference the card's mma backward
  kernel ``csrc/flash_attention_bwd_any.cu`` is held to) against
  ``jax.vjp`` through the JAX package's ``flash_attention`` in interpret mode,
  whose backward is the Pallas ``_flash_attention_bwd_impl``
  (``ufm_tpu/ops/flash_attention.py:452``; its XLA fallback is made to raise
  here, so the Pallas kernel is what ran): fp32, bf16 and fp16 at head dims
  1, 24, 40, 128 and 256, with equal ragged lengths and Sq != Sk.
- **The op's gradient on the CPU** (autograd through
  ``ufm_torch::flash_attention_fwd``, whose backward is
  ``ufm_torch::flash_attention_bwd``) against the same JAX gradient.
- **The routing** of a CUDA backward call (``backward_kernel``), its
  refusals, and the backward op's fake domain on fake CUDA tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ufm_tpu.ops import flash_attention as jfa
from ufm_torch.ops import flash_attention as fa
from ufm_torch.ops import _build, launches, library

DTYPES = ("float32", "bfloat16", "float16")
HEAD_DIMS = (1, 24, 40, 128, 256)
LENGTHS = ((77, 77), (65, 130))  # (Sq, Sk): ragged against the 64-row tiles, equal and not
# plain backward against the Pallas backward: fp32 sums in another order; in
# bf16 and fp16 the plain version rounds its logits to the input dtype where
# the Pallas kernel keeps them fp32 and rounds P and dS instead: two ulps of
# the type at |x| in [2, 4) (the gradients reach ~2 here)
ATOL = {"float32": 1e-5, "bfloat16": 2.0**-5, "float16": 2.0**-8}


def _inputs(sq, sk, d, seed):
    """q, g (1, Sq, 2, D) and k, v (1, Sk, 2, D), fp32 numpy."""
    rng = np.random.default_rng(seed)
    q, g = (rng.standard_normal((1, sq, 2, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((1, sk, 2, d)).astype(np.float32) for _ in range(2))
    return q, k, v, g


@pytest.fixture
def pallas_backward_only(monkeypatch):
    """The JAX package's attention VJP with its XLA fallback made to raise:
    a gradient then comes from the Pallas backward kernel."""

    def refuse(*args, **kwargs):
        raise AssertionError("the JAX VJP took its XLA backward, not the Pallas kernel")

    monkeypatch.setattr(jfa, "_xla_attention_bwd", refuse)


def _jax_grads(q, k, v, g, dtype):
    """(dq, dk, dv) of the JAX package's flash_attention (interpret mode) as
    fp32 numpy arrays."""
    jq, jk, jv, jg = (jnp.asarray(x, dtype=dtype) for x in (q, k, v, g))
    _, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(a, b, c, interpret=True), jq, jk, jv)
    grads = vjp(jg)
    assert all(t.dtype == jnp.dtype(dtype) for t in grads)
    return [np.asarray(t.astype(jnp.float32)) for t in grads]


@pytest.mark.parametrize("sq, sk", LENGTHS)
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_backward_matches_the_pallas_backward(pallas_backward_only, dtype, d, sq, sk):
    q, k, v, g = _inputs(sq, sk, d, seed=d * 1000 + sq + sk)
    want = _jax_grads(q, k, v, g, dtype)
    tt = getattr(torch, dtype)
    got = fa.attention_backward_reference(*(torch.from_numpy(x).to(tt) for x in (q, k, v, g)), d**-0.5)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == tt and a.shape == w.shape, name
        np.testing.assert_allclose(a.float().numpy(), w, atol=ATOL[dtype], rtol=0, err_msg=name)


@pytest.mark.parametrize("dtype", DTYPES)
def test_op_gradient_on_the_cpu_matches_the_pallas_backward(pallas_backward_only, dtype):
    """Autograd through the forward op on CPU tensors (the op's CPU
    implementations: the plain forward with lse, then the backward op) gives
    the JAX package's gradient, at D = 40 with Sq != Sk."""
    q, k, v, g = _inputs(65, 130, 40, seed=3)
    want = _jax_grads(q, k, v, g, dtype)
    tt = getattr(torch, dtype)
    leaves = [torch.from_numpy(x).to(tt).requires_grad_(True) for x in (q, k, v)]
    before = launches.snapshot()
    out = library.attention(*leaves, 40**-0.5)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g).to(tt))
    assert launches.since(before) == dict.fromkeys(before, 0)  # the CPU launches no kernel
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == tt, name
        np.testing.assert_allclose(a.float().numpy(), w, atol=ATOL[dtype], rtol=0, err_msg=name)


@pytest.mark.parametrize("dtype, d, kernel", [
    (torch.bfloat16, 64, "wgmma"), (torch.float32, 64, "mma"), (torch.float16, 64, "mma"),
    (torch.bfloat16, 32, "mma"), (torch.float32, 24, "mma"), (torch.float32, 1, "mma"),
    (torch.float16, 256, "mma"), (torch.bfloat16, 256, "mma"),
])
def test_backward_kernel_by_dtype_and_head_dim(dtype, d, kernel):
    assert fa.backward_kernel(dtype, d) == kernel
    assert fa.forward_kernel(dtype, d) == kernel  # a backward reads the lse of the forward it follows


@pytest.mark.parametrize("dtype, d", [(torch.float64, 64), (torch.float64, 24), (torch.float32, 0),
                                      (torch.float32, 257), (torch.bfloat16, 257), (torch.float16, 0)])
def test_backward_kernel_refuses_outside_the_domain(dtype, d):
    with pytest.raises(ValueError, match=f"attention backward on the card .* got {dtype} with D = {d}"):
        fa.backward_kernel(dtype, d)


@pytest.mark.parametrize("dtype, d", [(torch.float32, 24), (torch.float32, 64), (torch.float16, 64),
                                      (torch.float16, 40), (torch.bfloat16, 32), (torch.bfloat16, 256)])
def test_fake_backward_on_the_card_takes_the_domain(dtype, d):
    with FakeTensorMode():
        q = torch.empty(2, 13, 3, d, device="cuda", dtype=dtype)
        k = torch.empty(2, 40, 3, d, device="cuda", dtype=dtype)
        lse = torch.empty(2, 3, 13, device="cuda")
        dq, dk, dv = library.flash_attention_bwd(q, k, k, q, lse, q, 0.125)
        assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, k.shape)
        assert {t.dtype for t in (dq, dk, dv)} == {dtype}
        assert {t.device.type for t in (dq, dk, dv)} == {"cuda"}


def test_fma_backward_refuses_cpu_tensors_and_counts_nothing():
    """The mma backward's CUDA implementation refuses CPU tensors (the
    CPU takes the op's plain version), and a refused call counts no launch."""
    x = torch.zeros(1, 8, 2, 24)
    lse = torch.zeros(1, 2, 8)
    before = launches.snapshot()
    with pytest.raises(ValueError, match="CUDA"):
        fa.launch_backward(x, x, x, x, lse, x, 0.2)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_backward(x.half(), x.half(), x.half(), x.half(), lse, x.half(), 0.2)
    assert launches.since(before) == dict.fromkeys(before, 0)


def test_launch_counters_hold_the_fma_backward_last_and_reset_together():
    """The mma backward's counter is ``launches``' entry named after its
    kernel, among one entry per kernel source, and ``reset`` zeroes them
    all."""
    fa.ANY_BWD_LAUNCHES += 3
    assert launches.snapshot()["flash_attention_bwd_any"] == fa.ANY_BWD_LAUNCHES >= 3
    assert set(launches.snapshot()) == set(_build.KERNEL_SOURCES)
    launches.reset()
    assert launches.snapshot() == dict.fromkeys(_build.KERNEL_SOURCES, 0) and fa.ANY_BWD_LAUNCHES == 0
