"""ufm_torch attention backward: the plain version against the JAX package.

``attention_backward_reference`` (the plain version the card's backward
kernel is held to) against ``_xla_attention_bwd`` (the same math, fp32: only
the summation order differs, rtol / atol 2e-5), against the Pallas backward
``_flash_attention_bwd_impl`` in interpret mode (JAX's own bar between its
kernel and its XLA VJP: 2e-4 in fp32, 5e-2 in bf16), and against torch
autograd through ``attention_reference`` (fp32, 2e-5). Inputs are made with
numpy from a seed and fed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ufm_tpu.ops import flash_attention as jfa
from ufm_torch.ops import flash_attention as fa
from ufm_torch.ops.attention import dot_product_attention


def _inputs(b, s, h, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(4)]


def _assert_close(got, want, tol, name):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("b,s,h,d", [(1, 72, 2, 16), (2, 130, 3, 32), (1, 77, 2, 64)])
def test_backward_reference_matches_xla_vjp(b, s, h, d):
    q, k, v, g = _inputs(b, s, h, d, seed=s + d)
    scale = d**-0.5
    got = fa.attention_backward_reference(*(torch.from_numpy(x) for x in (q, k, v, g)), scale)
    want = jfa._xla_attention_bwd(scale, tuple(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(g))
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        _assert_close(a.numpy(), np.asarray(w), 2e-5, name)


@pytest.mark.parametrize("b,s,h,d", [(1, 72, 2, 16), (1, 300, 2, 64), (2, 130, 3, 32)])
def test_backward_reference_matches_pallas_backward(b, s, h, d, monkeypatch):
    """The shapes of tests/test_attention.py's Pallas-vs-XLA backward test,
    with its forced 128-row Q blocks (dk / dv accumulate across blocks)."""
    q, k, v, g = _inputs(b, s, h, d, seed=11)
    scale = d**-0.5
    monkeypatch.setattr(jfa, "_bwd_block_q", lambda *a: 128)
    want = jfa._flash_attention_bwd_impl(*(jnp.asarray(x) for x in (q, k, v, g)), scale=scale, interpret=True)
    got = fa.attention_backward_reference(*(torch.from_numpy(x) for x in (q, k, v, g)), scale)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        _assert_close(a.numpy(), np.asarray(w), 2e-4, name)


def test_backward_reference_bf16_matches_pallas_backward():
    q, k, v, g = _inputs(1, 200, 2, 64, seed=13)
    scale = 64**-0.5
    want = jfa._flash_attention_bwd_impl(
        *(jnp.asarray(x, dtype=jnp.bfloat16) for x in (q, k, v, g)), scale=scale, interpret=True
    )
    got = fa.attention_backward_reference(*(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, g)), scale)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16
        _assert_close(a.float().numpy(), np.asarray(w, dtype=np.float32), 5e-2, name)


@pytest.mark.parametrize("s", [7, 130])
def test_backward_reference_matches_autograd(s):
    """The closed form against autograd through the plain forward, which is
    the gradient the CPU path takes."""
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(2, s, 2, 32, seed=s))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = dot_product_attention(*leaves)
    got = torch.autograd.grad(out, leaves, g)
    want = fa.attention_backward_reference(q, k, v, g, 32**-0.5)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        _assert_close(a.numpy(), w.numpy(), 2e-5, name)


def test_kernel_pair_refuses_cpu_tensors():
    """With grad enabled the kernel path (the autograd Function) still takes
    CUDA tensors only, and the backward wrapper refuses CPU tensors too; no
    kernel call is counted."""
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(1, 16, 2, 64, seed=1))
    fwd, bwd = fa.LAUNCHES, fa.BWD_LAUNCHES
    leaf = q.clone().requires_grad_(True)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(leaf, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_backward(q, k, v, q, torch.zeros(1, 2, 16), g, 0.125)
    assert (fa.LAUNCHES, fa.BWD_LAUNCHES) == (fwd, bwd)
