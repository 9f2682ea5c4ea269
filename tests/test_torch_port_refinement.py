"""ufm_torch refinement ops against the JAX package, on the CPU in fp32.

- The plain window refinement (the kernel's plain version) against JAX's
  ``_fused_refinement_xla`` and the Pallas window-dots path (interpret mode:
  the TPU kernel's own math), at the bars of ``tests/test_window_dots.py``
  (residual 2e-5, log_softmax 2e-4), with windows across every border and
  wholly outside the image.
- The port's materializing path against its fused path, and ``grid_sample``
  against JAX's (1e-5: fp32 on both sides, only summation order differs).
- The dispatch: a CPU tensor takes the plain version; the kernel refuses it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ufm_tpu.ops.grid_sample import grid_sample as jax_grid_sample
from ufm_tpu.ops.refinement import _fused_refinement_xla
from ufm_tpu.ops.refinement import fused_refinement_attention as jax_fused_refinement_attention
from ufm_torch.ops import window_refinement as wr
from ufm_torch.ops.grid_sample import grid_sample
from ufm_torch.ops.refinement import (
    fused_refinement_attention,
    obtain_neighborhood_features,
    refinement_attention,
)

RES_ATOL, LS_ATOL = 2e-5, 2e-4
TEMPERATURE = 4.0


def _inputs(b, h, w, c, p, scale, seed=0, far=True):
    """Seeded numpy inputs; with ``far``, one window of each image lies far
    outside it on each side (as in tests/test_window_dots.py)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, w, c)).astype(np.float32)
    f = rng.standard_normal((b, h, w, c)).astype(np.float32)
    flow = (rng.standard_normal((b, h, w, 2)) * scale).astype(np.float32)
    if far:
        flow[:, 0, 0] = -500.0
        flow[:, -1, -1] = 1e6
    bias = rng.standard_normal((p * p,)).astype(np.float32)
    return q, f, flow, bias


def _close(got: torch.Tensor, want, atol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=0)


@pytest.mark.parametrize("w", [13, 44])
@pytest.mark.parametrize("c,p", [(16, 5), (8, 5), (4, 3)])
def test_plain_matches_jax_xla(c, p, w):
    q, f, flow, bias = _inputs(2, 16, w, c, p, scale=40.0)
    want_res, want_ls = _fused_refinement_xla(*map(jnp.asarray, (q, f, flow, bias)), TEMPERATURE, p)
    res, ls = wr.window_refinement_reference(*map(torch.from_numpy, (q, f, flow, bias)), TEMPERATURE, p)
    _close(res, want_res, RES_ATOL)
    _close(ls, want_ls, LS_ATOL)


def test_plain_matches_jax_pallas_interpret():
    """The TPU kernel's math (interpret mode off the TPU) on the same inputs."""
    q, f, flow, bias = _inputs(1, 16, 24, 16, 5, scale=40.0, seed=3)
    want_res, want_ls = jax_fused_refinement_attention(*map(jnp.asarray, (q, f, flow, bias)), TEMPERATURE, 5, impl="pallas")
    res, ls = wr.window_refinement_reference(*map(torch.from_numpy, (q, f, flow, bias)), TEMPERATURE, 5)
    _close(res, want_res, RES_ATOL)
    _close(ls, want_ls, LS_ATOL)


def test_plain_gradients_match_jax():
    """The kernel's backward is autograd over the plain version: its
    gradients must be JAX's (the VJP of ``_fused_refinement_xla``)."""
    q, f, flow, bias = _inputs(1, 8, 8, 16, 5, scale=6.0, far=False)

    def jax_loss(*args):
        res, ls = _fused_refinement_xla(*args, TEMPERATURE, 5)
        return jnp.sum(res**2) + jnp.mean(ls)

    want = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (q, f, flow, bias)))
    ins = [torch.from_numpy(x).requires_grad_(True) for x in (q, f, flow, bias)]
    res, ls = wr.window_refinement_reference(*ins, TEMPERATURE, 5)
    (res.pow(2).sum() + ls.mean()).backward()
    for t, g in zip(ins, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("c,p", [(8, 5), (4, 3)])
def test_materializing_matches_fused(c, p):
    """The (B, H, W, P, P, C) bicubic window path against the fused path."""
    q, f, flow, bias = map(torch.from_numpy, _inputs(2, 11, 13, c, p, scale=3.0, far=False))
    feats, offs = obtain_neighborhood_features(flow, f, p)
    assert feats.shape == (2, 11, 13, p, p, c) and offs.shape == (1, 1, 1, p, p, 2)
    want_res, want_ls = refinement_attention(q, feats, offs, bias, TEMPERATURE)
    res, ls = fused_refinement_attention(q, f, flow, bias, TEMPERATURE, p)
    _close(res, want_res.numpy(), 1e-5)
    _close(ls, want_ls.numpy(), 1e-5)


@pytest.mark.parametrize("mode", ["bilinear", "bicubic", "nearest"])
def test_grid_sample_matches_jax(mode):
    """Samples inside, across the border and outside (|grid| up to 1.3)."""
    rng = np.random.default_rng(4)
    feats = rng.standard_normal((2, 9, 11, 3)).astype(np.float32)
    grid = (rng.random((2, 5, 7, 2)) * 2.6 - 1.3).astype(np.float32)
    want = jax_grid_sample(jnp.asarray(feats), jnp.asarray(grid), mode=mode)
    _close(grid_sample(torch.from_numpy(feats), torch.from_numpy(grid), mode=mode), want, 1e-5)


def test_dispatch():
    """CPU tensors take the plain version (no launch); the kernel, asked for
    explicitly, refuses them; an unknown impl raises."""
    q, f, flow, bias = map(torch.from_numpy, _inputs(1, 6, 7, 8, 5, scale=3.0))
    before = wr.LAUNCHES
    res, ls = fused_refinement_attention(q, f, flow, bias, TEMPERATURE, 5)
    ref_res, ref_ls = wr.window_refinement_reference(q, f, flow, bias, TEMPERATURE, 5)
    assert wr.LAUNCHES == before
    assert torch.equal(res, ref_res) and torch.equal(ls, ref_ls)
    with pytest.raises(ValueError, match="CUDA"):
        fused_refinement_attention(q, f, flow, bias, TEMPERATURE, 5, impl="cuda")
    with pytest.raises(ValueError, match="unknown refinement impl"):
        fused_refinement_attention(q, f, flow, bias, TEMPERATURE, 5, impl="pallas")
    assert wr.supports_kernel(16, 5) and wr.supports_kernel(4, 3)
    # the kernels' domain: 1 <= C <= 64, odd 1 <= P <= 9 (the shapes JAX's XLA path answers)
    assert wr.supports_kernel(5, 5) and wr.supports_kernel(16, 7) and wr.supports_kernel(1, 1) and wr.supports_kernel(64, 9)
    assert not wr.supports_kernel(65, 5) and not wr.supports_kernel(16, 11) and not wr.supports_kernel(16, 4)
    assert not wr.supports_kernel(0, 5)
