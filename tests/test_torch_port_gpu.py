"""ufm_torch on the card: the Hopper kernel and the model's kernel path.

These tests need an NVIDIA GPU and nvcc and skip elsewhere. This file imports
neither JAX nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_port_gpu.py -m cuda --noconftest -q
"""

import pytest
import torch

from ufm_torch.models import UniFlowMatchConfidence, ufm_tiny_config
from ufm_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the GPU machine)")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(2, 1201, 16, 64), (1, 2400, 12, 64), (1, 77, 2, 64), (3, 1, 1, 64)])
def test_kernel_matches_fp32_reference(cuda, shape):
    """The kernel on bf16 views of a fused qkv tensor, held to an fp32
    reference on the same inputs: at most twice as far as the plain bf16
    version (which rounds its logits to bf16), and 4e-3 at the tightest."""
    b, s, h, d = shape
    g = torch.Generator(device=cuda).manual_seed(0)
    qkv = torch.randn(b, s, 3, h, d, generator=g, device=cuda).to(torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    before = fa.LAUNCHES
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    ref = fa.attention_reference(q.float(), k.float(), v.float(), d**-0.5)
    plain = fa.attention_reference(q, k, v, d**-0.5)
    err = (out.float() - ref).abs().max().item()
    plain_err = (plain.float() - ref).abs().max().item()
    assert err <= max(2 * plain_err, 4e-3)


def test_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.zeros(1, 8, 2, 64, device=cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        fa.flash_attention(x, x, x)
    y = torch.zeros(1, 8, 2, 32, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="64"):
        fa.flash_attention(y, y, y)


def test_small_model_kernel_path(cuda):
    """A small bf16 UFM-Base (head_dim 64) on the card: every attention call
    of a forward goes through the kernel, and the outputs stay close to the
    plain-attention path (bf16 rounding over 4 layers)."""
    cfg = ufm_tiny_config(compute_dtype="bfloat16")
    cfg.encoder_kwargs = dict(cfg.encoder_kwargs, embed_dim=128, num_heads=2)
    cfg.info_sharing_kwargs = dict(cfg.info_sharing_kwargs, input_embed_dim=128, dim=128, num_heads=2)
    for head in (cfg.feature_head_kwargs, cfg.uncertainty_head_kwargs):
        head["dpt_feature"] = dict(head["dpt_feature"], input_dims=(128, 128, 128, 128))
    model = UniFlowMatchConfidence.from_config(cfg, seed=0)
    g = torch.Generator().manual_seed(1)
    src = torch.randint(0, 256, (2, 60, 80, 3), generator=g, dtype=torch.uint8)
    tgt = torch.randint(0, 256, (2, 60, 80, 3), generator=g, dtype=torch.uint8)
    before = fa.LAUNCHES
    res = model.predict_correspondences_batched(src, tgt)
    torch.cuda.synchronize()
    assert fa.LAUNCHES - before == 4
    model.attention_impl = "torch"
    plain = model.predict_correspondences_batched(src, tgt)
    assert fa.LAUNCHES - before == 4
    f, p = res.flow.flow_output.float(), plain.flow.flow_output.float()
    assert torch.isfinite(f).all()
    assert ((f - p).norm() / p.norm()).item() < 2e-2
