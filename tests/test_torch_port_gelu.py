"""The port's exact GELU against ``jax.nn.gelu(approximate=False)``.

On bf16 the JAX package's MLP activation is bitwise ``jax.nn.gelu``: an
op-for-op chain that rounds to bf16 after every op. The port's
``gelu_exact`` computes the same chain, and these tests check it over every
finite bf16 input (65,280 values): bit for bit, except where XLA's CPU
flushed a subnormal to zero. XLA flushes subnormal results of every op of
the chain, PyTorch keeps them; so where the two differ, JAX's result is
zero and PyTorch's chain went through a subnormal: its result, its 0.5 x,
or its erfc (in 4 inputs that last gives a tiny normal result, e.g. 6.5 *
erfc(9.25) = 2.8e-38, where XLA's erfc is 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ufm_torch.nn.layers import gelu_exact

SMALLEST_NORMAL = 2.0**-126


def _all_finite_bf16():
    bits = np.arange(65536, dtype=np.uint16)
    x = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    finite = torch.isfinite(x)
    return x[finite], bits[finite.numpy()]


def _jax_gelu_bits(bits: np.ndarray) -> np.ndarray:
    x = jax.lax.bitcast_convert_type(jnp.asarray(bits), jnp.bfloat16)
    y = jax.nn.gelu(x, approximate=False)
    return np.asarray(jax.lax.bitcast_convert_type(y, jnp.uint16))


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16)


def _subnormal(t: torch.Tensor) -> torch.Tensor:
    a = t.float().abs()
    return (a > 0) & (a < SMALLEST_NORMAL)


def test_gelu_exact_bf16_matches_jax_over_every_finite_input():
    x, bits = _all_finite_bf16()
    assert x.numel() == 65280
    got = gelu_exact(x)
    assert got.dtype == torch.bfloat16
    want_bits = _jax_gelu_bits(bits)
    want = torch.from_numpy(want_bits.view(np.int16).copy()).view(torch.bfloat16).float()
    differ = torch.from_numpy(_bits(got) != want_bits)
    normal = (got.float().abs() >= SMALLEST_NORMAL) | (want.abs() >= SMALLEST_NORMAL)
    # the chain's intermediates 0.5 x and erfc(-x c), before their bf16 rounding
    half = x.float() * 0.5
    erfc = torch.special.erfc((x.float() * -0.70703125).to(torch.bfloat16).float())
    intermediate_flushed = _subnormal(half) | _subnormal(erfc)
    # the rule: bits equal wherever either result is normal, both results
    # below the smallest normal elsewhere; it holds at every input whose
    # intermediates are normal
    assert not (differ & normal & ~intermediate_flushed).any()
    assert (want[differ] == 0).all(), "a non-zero JAX result differs"
    # the exceptions: XLA flushed an intermediate to 0 where PyTorch kept it
    # and rounded a normal result from it: x = +-2^-126 * 255/128 (0.5 x
    # rounds up to 2^-126) and the two x whose erfc argument is 9.25
    exceptions = x[differ & normal].float()
    assert exceptions.numel() == 4
    assert sorted(exceptions.abs().tolist())[:2] == [2.0**-126 * 255 / 128] * 2
    assert ((exceptions > -13.2) & (exceptions < -13.0)).sum() == 2
    assert (got.float().abs()[differ] < 2**-124).all()
    assert int(differ.sum()) == 514


def test_f_gelu_on_bf16_is_not_the_jax_chain():
    """Why gelu_exact does not call F.gelu on bf16: F.gelu rounds once, and
    differs from jax.nn.gelu on normal results."""
    x, bits = _all_finite_bf16()
    want = torch.from_numpy(_jax_gelu_bits(bits).view(np.int16).copy()).view(torch.bfloat16).float()
    plain = F.gelu(x, approximate="none").float()
    normal = (plain.abs() >= SMALLEST_NORMAL) | (want.abs() >= SMALLEST_NORMAL)
    assert ((plain != want) & normal).sum() > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gelu_exact_other_dtypes_is_f_gelu(dtype):
    x = torch.linspace(-6, 6, 4097, dtype=dtype)
    torch.testing.assert_close(gelu_exact(x), F.gelu(x, approximate="none"), rtol=0, atol=0)
    np.testing.assert_allclose(
        gelu_exact(x.float()).numpy(), np.asarray(jax.nn.gelu(x.float().numpy(), approximate=False)),
        rtol=0, atol=1e-6,
    )


def test_gelu_exact_bf16_gradient_is_finite_and_close_to_fp32():
    """The chain is differentiable through autograd (bf16 training on the
    card): its gradient stays within bf16 rounding of the fp32 GELU's."""
    x32 = torch.linspace(-6, 6, 4097, dtype=torch.float32)
    x = x32.to(torch.bfloat16).requires_grad_(True)
    gelu_exact(x).float().sum().backward()
    ref = x32.to(torch.bfloat16).float().requires_grad_(True)
    F.gelu(ref, approximate="none").sum().backward()
    assert torch.isfinite(x.grad).all()
    torch.testing.assert_close(x.grad.float(), ref.grad, rtol=0, atol=2e-2)


def test_gelu_exact_bf16_backward_is_f_gelu_backward_on_the_saved_input():
    """The chain's backward is one gelu_backward: the same bf16 gradient as
    F.gelu's, and the input the only tensor kept for it (autograd through
    the chain would keep three intermediates of the hidden activation)."""
    x, _ = _all_finite_bf16()
    x = x[x.float().abs() < 1e4].clone().requires_grad_(True)
    y = gelu_exact(x)
    (saved,) = y.grad_fn.saved_tensors
    assert torch.equal(saved, x)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    (got,) = torch.autograd.grad(y, x, g)
    x2 = x.detach().clone().requires_grad_(True)
    (want,) = torch.autograd.grad(F.gelu(x2, approximate="none"), x2, g)
    assert torch.equal(got, want)


def test_gelu_exact_bf16_without_grad_is_the_same_chain():
    x, _ = _all_finite_bf16()
    with torch.no_grad():
        plain = gelu_exact(x)
    tracked = gelu_exact(x.clone().requires_grad_(True)).detach()
    assert torch.equal(plain.view(torch.int16), tracked.view(torch.int16))
