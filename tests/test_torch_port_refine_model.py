"""ufm_torch UFM-Refine end to end on the CPU, against the JAX package.

- The port's ``UFMNet`` on the tiny refine configs (fp32), with the
  parameters of ``UFMNet.init(PRNGKey(7))`` carried over, must reproduce the
  three committed refine goldens on every key (atol 1e-4): the refinement on
  the XLA path, on the Pallas path (interpret mode: the TPU kernel's math),
  and with the UNet fine features ("conv" combine).
- The "modulate" combine against the JAX network on the same parameters.
- ``predict_correspondences_batched`` and ``forward`` (with the
  ``classification_refinement`` fields) match JAX's
  ``UniFlowMatchClassificationRefinement`` on the same perturbed weights
  (atol 1e-4; the covariance relatively at 1e-5).
"""

import os

import jax
import numpy as np
import pytest
import torch

from ufm_tpu.checkpoint.convert import flatten_params, unflatten_params
from ufm_tpu.models import UFMNet as JNet
from ufm_tpu.models import UniFlowMatchClassificationRefinement as JRefine
from ufm_tpu.models import ufm_tiny_config as jax_tiny_config
from ufm_tpu.utils.anchor import seeded_inputs
from ufm_torch.checkpoint import load_jax_params
from ufm_torch.models import (
    UFMNet,
    UniFlowMatchClassificationRefinement,
    UniFlowMatchConfidence,
    ufm_refine_config,
    ufm_tiny_config,
)

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
ATOL = 1e-4
RESOLUTIONS = [(56, 42), (42, 56)]
UNET = {"use_unet_feature": True, "unet_kwargs": {"out_channels": 8, "features": (8, 16)}}
GOLDEN_CONFIGS = {
    "ufm_refine_tiny_xla": {"refinement_impl": "xla"},
    "ufm_refine_tiny_pallas": {"refinement_impl": "pallas"},
    "ufm_refine_unet_tiny": {**UNET, "refinement_impl": "xla"},
}


def _carried_net(overrides):
    """JAX ``UFMNet.init(PRNGKey(7))`` on the anchor inputs, and the port's
    net with those parameters, on the CPU's plain refinement."""
    i1, i2 = seeded_inputs()
    jnet = JNet(jax_tiny_config(has_classification_head=True, **overrides))
    params = jax.jit(jnet.init)(jax.random.PRNGKey(7), i1, i2)["params"]
    net = UFMNet(ufm_tiny_config(has_classification_head=True, **overrides))
    load_jax_params(net, flatten_params(params))
    net.refinement_impl = None  # "pallas" asks for the kernel, which runs on the GPU only
    return jnet, params, net, (torch.tensor(np.asarray(i1)), torch.tensor(np.asarray(i2)))


@pytest.mark.parametrize("name", list(GOLDEN_CONFIGS))
def test_refine_matches_golden(name):
    _, _, net, (i1, i2) = _carried_net(GOLDEN_CONFIGS[name])
    with torch.no_grad():
        out = net(i1, i2)
    golden = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))
    assert len(golden.files) == 7
    for k in golden.files:
        np.testing.assert_allclose(out[k].numpy(), golden[k], atol=ATOL, rtol=0, err_msg=f"{name}:{k}")


def test_modulate_combine_matches_jax():
    """``cls * tanh(unet)`` then conv2; flax makes no conv1 parameters for it
    (never called), and the port builds none (the load is strict)."""
    jnet, params, net, (i1, i2) = _carried_net({**UNET, "feature_combine_method": "modulate"})
    assert "conv1" not in params and not hasattr(net, "conv1")
    want = jax.jit(jnet.apply)({"params": params}, *(i.numpy() for i in (i1, i2)))
    with torch.no_grad():
        out = net(i1, i2)
    for k in ("flow", "refinement_residual", "refinement_log_softmax", "refinement_feature_map_1"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(want[k]), atol=ATOL, rtol=0, err_msg=k)


@pytest.fixture(scope="module")
def models():
    """The JAX tiny UFM-Refine (UNet features, uncertainty head) with
    perturbed weights, and the port on the CPU with the same weights."""
    cfg = dict(inference_resolution=RESOLUTIONS, **UNET)
    jmodel = JRefine.from_config(jax_tiny_config(has_classification_head=True, **cfg), seed=0)
    rng = np.random.default_rng(21)
    flat = {k: v + rng.normal(0.0, 0.02, v.shape).astype(v.dtype) for k, v in flatten_params(jmodel.params).items()}
    jmodel.params = unflatten_params(flat)
    model = UniFlowMatchClassificationRefinement.from_config(ufm_tiny_config(**cfg), device="cpu")
    load_jax_params(model, flat)
    return jmodel, model


def _compare(got, want, name):
    got = got.detach().cpu().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, name
    rtol = 1e-5 if "cov" in name else 0.0
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=rtol, err_msg=name)


@pytest.mark.parametrize("case", ["u8_landscape_hwc", "u8_portrait_bchw_b2"])
def test_refine_predict_matches_jax(models, case):
    """uint8 pairs of two aspect ratios; the portrait one runs the UNet's
    nearest-resize branch (42 columns -> 21 -> 10)."""
    jmodel, model = models
    rng = np.random.default_rng(22)
    shape = (60, 80, 3) if case == "u8_landscape_hwc" else (2, 3, 90, 64)
    src, tgt = (rng.integers(0, 256, shape, dtype=np.uint8) for _ in range(2))
    want = jmodel.predict_correspondences_batched(source_image=src, target_image=tgt)
    got = model.predict_correspondences_batched(source_image=src, target_image=tgt)
    _compare(got.flow.flow_output, want.flow.flow_output, "flow")
    _compare(got.flow.flow_covariance, want.flow.flow_covariance, "flow_covariance")
    _compare(got.covisibility.mask, want.covisibility.mask, "covisibility")
    _compare(got.keypoint_confidence, want.keypoint_confidence, "keypoint_confidence")


def test_refine_forward_matches_jax(models):
    jmodel, model = models
    rng = np.random.default_rng(23)
    views = [{"img": rng.standard_normal((2, 3, 42, 56)).astype(np.float32)} for _ in range(2)]
    want = jmodel.forward(*views)
    with torch.no_grad():
        got = model.forward(*[{"img": torch.from_numpy(v["img"])} for v in views])
    _compare(got.flow.flow_output, want.flow.flow_output, "flow")
    _compare(got.covisibility.logits, want.covisibility.logits, "covis_logits")
    g, w = got.classification_refinement, want.classification_refinement
    for field in ("regression_flow_output", "residual", "log_softmax", "feature_map_0", "feature_map_1"):
        _compare(getattr(g, field), getattr(w, field), field)


def test_refinement_impl_follows_the_config():
    """"auto" lets the device decide, "pallas" asks for the kernel, "xla" for
    the plain version; the property sets it; a model without the refinement
    stage has none to set."""
    for name, impl in (("auto", None), ("pallas", "cuda"), ("xla", "torch")):
        cfg = ufm_tiny_config(refinement_impl=name)
        assert UniFlowMatchClassificationRefinement.from_config(cfg, device="cpu").refinement_impl == impl
    model = UniFlowMatchClassificationRefinement.from_config(ufm_tiny_config(), device="cpu")
    model.refinement_impl = "torch"
    assert model.net.refinement_impl == "torch"
    with pytest.raises(ValueError, match="unknown refinement impl"):
        model.refinement_impl = "pallas"
    with pytest.raises(ValueError, match="unknown refinement_impl"):
        UniFlowMatchClassificationRefinement.from_config(ufm_tiny_config(refinement_impl="mosaic"), device="cpu")
    with pytest.raises(ValueError, match="UFM-Refine"):
        UniFlowMatchConfidence.from_config(ufm_tiny_config(), device="cpu").refinement_impl = "torch"


def test_refine_config_builds_at_full_width():
    """ufm_refine_config at its published widths on the meta device (no
    memory): UFM-Base's backbone and heads, the patch MLP 1792 -> 512 ->
    14 * 14 * 16, the bf16 UNet (64, 128, 256, 512) -> 16, the 1x1 combine
    convs and the 5 x 5 bias."""
    with torch.device("meta"):
        net = UFMNet(ufm_refine_config())
    head = net.classification_head
    assert (head.fc0.in_features, head.fc0.out_features, head.fc_out.out_features) == (1792, 512, 14 * 14 * 16)
    unet = net.unet_feature
    assert [getattr(unet, f"down_{i}").conv2.out_channels for i in range(4)] == [64, 128, 256, 512]
    assert unet.final.out_channels == 16 and next(unet.parameters()).dtype == torch.bfloat16
    assert (net.conv1.in_channels, net.conv1.out_channels, net.conv2.out_channels) == (32, 32, 16)
    assert net.classification_bias.shape == (25,) and net.refinement_impl is None
    assert hasattr(net, "uncertainty_head") and len(net.encoder.blocks) == 24
