"""ufm_torch attention: the plain version against the JAX package's Pallas
kernel (interpret mode) and XLA reference, and the CUDA-only path's refusals.

Inputs are made with numpy from a seed and fed to both packages. Tolerance:
fp32 on both sides, only the summation order differs (atol 1e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ufm_tpu.ops.attention import _xla_attention
from ufm_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from ufm_torch.ops import flash_attention as fa
from ufm_torch.ops.attention import dot_product_attention

ATOL = 1e-5


def _qkv(b, s, h, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("s", [7, 130, 257])
@pytest.mark.parametrize("d", [32, 64])
def test_plain_attention_matches_jax(s, d):
    q, k, v = _qkv(2, s, 2, d, seed=s + d)
    scale = d**-0.5
    got = fa.attention_reference(*(torch.from_numpy(x) for x in (q, k, v)), scale).numpy()
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    xla = np.asarray(_xla_attention(jq, jk, jv, scale))
    pallas = np.asarray(jax_flash_attention(jq, jk, jv, scale=scale, interpret=True))
    np.testing.assert_allclose(got, xla, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=0)


def test_dispatch_cpu_takes_plain_version():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 33, 2, 64, seed=1))
    before = fa.LAUNCHES
    ref = fa.attention_reference(q, k, v, 64**-0.5)
    # impl=None: a CPU tensor takes the plain version; "torch" asks for it
    assert torch.equal(dot_product_attention(q, k, v), ref)
    assert torch.equal(dot_product_attention(q, k, v, impl="torch"), ref)
    assert fa.LAUNCHES == before


def test_cuda_path_refuses_cpu_tensors():
    """The kernel's path raises on a CPU tensor instead of falling back."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 16, 2, 64))
    before = fa.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        dot_product_attention(q, k, v, impl="cuda")
    with pytest.raises(ValueError, match="unknown attention impl"):
        dot_product_attention(q, k, v, impl="xla")
    assert fa.LAUNCHES == before
