"""ufm_torch UFM-Base end to end on the CPU, against the JAX package.

- The port's ``UFMNet`` on ``ufm_tiny_config()`` (fp32), with the parameters
  of ``UFMNet.init(PRNGKey(7))`` carried over, must reproduce the committed
  golden ``tests/golden/ufm_base_tiny.npz`` on every key (atol 1e-4): the
  end-to-end anchor, no JAX forward needed.
- The port's ``predict_correspondences_batched`` and ``forward`` must match
  the JAX model's on the same (perturbed) weights (atol 1e-4; the
  covariance, exp() of head outputs, relatively at 1e-5).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ufm_tpu.checkpoint.convert import flatten_params, unflatten_params
from ufm_tpu.models import UFMNet as JNet
from ufm_tpu.models import UniFlowMatchConfidence as JModel
from ufm_tpu.models import ufm_tiny_config as jax_tiny_config
from ufm_tpu.utils.anchor import seeded_inputs
from ufm_torch.checkpoint import load_jax_params
from ufm_torch.models import UFMNet, UniFlowMatch, UniFlowMatchConfidence, ufm_base_config, ufm_tiny_config
from ufm_torch.nn.layers import Attention

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "ufm_base_tiny.npz")
ATOL = 1e-4
# two trained resolutions of opposite aspect: closest-aspect selection matters
RESOLUTIONS = [(56, 42), (42, 56)]


def test_backbone_matches_golden():
    i1, i2 = seeded_inputs()
    jnet = JNet(jax_tiny_config())
    params = jax.jit(jnet.init)(jax.random.PRNGKey(7), i1, i2)["params"]
    net = UFMNet(ufm_tiny_config())
    load_jax_params(net, flatten_params(params))
    with torch.no_grad():
        out = net.backbone(torch.tensor(np.asarray(i1)), torch.tensor(np.asarray(i2)))
    golden = np.load(GOLDEN)
    assert set(golden.files) == {"flow", "covis_mask", "keypoint_confidence", "flow_cov"}
    for k in golden.files:
        np.testing.assert_allclose(out[k].numpy(), golden[k], atol=ATOL, rtol=0, err_msg=k)


@pytest.fixture(scope="module")
def models():
    """The JAX tiny UFM-Base with perturbed weights, and the port on the CPU
    with the same weights."""
    jmodel = JModel.from_config(jax_tiny_config(inference_resolution=RESOLUTIONS), seed=0)
    rng = np.random.default_rng(11)
    flat = {k: v + rng.normal(0.0, 0.02, v.shape).astype(v.dtype) for k, v in flatten_params(jmodel.params).items()}
    jmodel.params = unflatten_params(flat)
    model = UniFlowMatchConfidence.from_config(ufm_tiny_config(inference_resolution=RESOLUTIONS), device="cpu")
    load_jax_params(model, flat)
    return jmodel, model


def _compare(got, want, name):
    got = got.detach().cpu().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, name
    rtol = 1e-5 if "cov" in name else 0.0
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=rtol, err_msg=name)


def _rand_u8(rng, shape):
    return rng.integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize(
    "case",
    ["u8_landscape_hwc", "u8_portrait_bchw_b2", "f32_identity_norm"],
)
def test_predict_matches_jax(models, case):
    """uint8 pairs of two aspect ratios (each picks its own model resolution,
    with an antialiased downscale and an upscale) and one float32 input in a
    non-default normalization."""
    jmodel, model = models
    rng = np.random.default_rng(12)
    kwargs = {}
    if case == "u8_landscape_hwc":
        src, tgt = _rand_u8(rng, (60, 80, 3)), _rand_u8(rng, (60, 80, 3))
    elif case == "u8_portrait_bchw_b2":
        src, tgt = _rand_u8(rng, (2, 3, 90, 64)), _rand_u8(rng, (2, 3, 90, 64))
    else:
        src = rng.random((1, 50, 70, 3), dtype=np.float32)
        tgt = rng.random((1, 50, 70, 3), dtype=np.float32)
        kwargs = {"data_norm_type": "identity"}
    want = jmodel.predict_correspondences_batched(source_image=src, target_image=tgt, **kwargs)
    got = model.predict_correspondences_batched(source_image=src, target_image=tgt, **kwargs)
    _compare(got.flow.flow_output, want.flow.flow_output, "flow")
    _compare(got.flow.flow_covariance, want.flow.flow_covariance, "flow_covariance")
    _compare(got.covisibility.mask, want.covisibility.mask, "covisibility")
    _compare(got.keypoint_confidence, want.keypoint_confidence, "keypoint_confidence")


@pytest.mark.parametrize("symmetrized", [False, True])
def test_forward_matches_jax(models, symmetrized):
    """The reference ``forward(view1, view2)`` contract, including the
    symmetric-pair dedup of an (a,b),(b,a)-interleaved batch."""
    jmodel, model = models
    rng = np.random.default_rng(13)
    a, b = (rng.standard_normal((1, 3, 42, 56)).astype(np.float32) for _ in range(2))
    if symmetrized:
        img1, img2 = np.concatenate([a, b]), np.concatenate([b, a])
    else:
        img1, img2 = a, b
    views = [{"img": img1, "symmetrized": symmetrized}, {"img": img2, "symmetrized": symmetrized}]
    want = jmodel.forward(*views)
    with torch.no_grad():
        got = model.forward(*[dict(v, img=torch.from_numpy(v["img"])) for v in views])
    _compare(got.flow.flow_output, want.flow.flow_output, "flow")
    _compare(got.flow.flow_covariance, want.flow.flow_covariance, "flow_cov")
    _compare(got.flow.flow_covariance_log_det, want.flow.flow_covariance_log_det, "flow_cov_log_det")
    _compare(got.covisibility.logits, want.covisibility.logits, "covis_logits")


def test_attention_impl_reaches_every_block(models):
    _, model = models
    attns = [m for m in model.net.modules() if isinstance(m, Attention)]
    assert len(attns) == 4  # 2 encoder + 2 info-sharing layers
    model.attention_impl = "torch"
    try:
        assert all(m.impl == "torch" for m in attns)
        with pytest.raises(ValueError, match="unknown attention impl"):
            model.attention_impl = "pallas"
    finally:
        model.attention_impl = None
    assert all(m.impl is None for m in attns)


def test_unsupported_configs_raise():
    moge = {"head_type": "moge_conv", "feature_head_kwargs": {"input_dim": 48, "dims": (16, 8), "output_dim": 2}}
    assert type(UniFlowMatch.from_config(ufm_tiny_config(**moge), device="cpu").net.head1).__name__ == "MoGeConvFeature"
    with pytest.raises(ValueError, match="load-bearing"):  # DPT kwargs for the moge head
        UniFlowMatch.from_config(ufm_tiny_config(head_type="moge_conv"), device="cpu")
    with pytest.raises(ValueError, match="not supported"):
        UniFlowMatch.from_config(ufm_tiny_config(head_type="linear"), device="cpu")
    bad = ufm_tiny_config()
    bad.encoder_kwargs = dict(bad.encoder_kwargs, norm_eps=1e-5)
    with pytest.raises(ValueError, match="load-bearing"):
        UniFlowMatchConfidence.from_config(bad, device="cpu")


def test_flagship_config_builds_at_full_width():
    """ufm_base_config at its published widths on the meta device (no
    memory): the encoder is ViT-L/14 (24 x 1024, 16 heads of 64), info
    sharing 12 x 768 (12 heads of 64), both DPT heads present."""
    with torch.device("meta"):
        net = UFMNet(ufm_base_config())
    enc, info = net.encoder, net.info_sharing
    assert (len(enc.blocks), enc.embed_dim, enc.blocks[0].attn.num_heads) == (24, 1024, 16)
    assert (len(info.blocks), info.dim, info.blocks[0].attn.num_heads) == (12, 768, 12)
    assert enc.taps == (0, 23) and info.taps == (5, 8)
    assert next(enc.parameters()).dtype == torch.bfloat16
    assert next(net.head1.parameters()).dtype == torch.float32
    assert hasattr(net, "uncertainty_head")
