"""The ``moge_conv`` head in ufm_torch on the CPU, against the JAX package.

- ``MoGeConvFeature`` against JAX's on the same input and parameters (made
  from a seed with numpy) at 1e-5: the conv stages, the bilinear 2x resizes
  and the resize to the target resolution.
- A tiny ``UFMNet(head_type="moge_conv")`` (the head reads the 48-wide
  info-sharing output), JAX parameters carried across by
  ``load_jax_params``, against JAX's forward at 1e-4 on every output.
- Its model saves and loads with the config that names the head.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_seeded import net_params, numpy_params
from ufm_tpu.checkpoint.convert import flatten_params
from ufm_tpu.models import UFMNet as JNet
from ufm_tpu.models import ufm_tiny_config as jax_tiny_config
from ufm_tpu.nn.prediction_heads.base import PredictionHeadLayeredInput as JInput
from ufm_tpu.nn.prediction_heads.moge_conv import MoGeConvFeature as JMoGe
from ufm_torch.checkpoint import jax_params_to_state_dict, load_jax_params
from ufm_torch.models import UFMNet, UniFlowMatchConfidence, ufm_tiny_config
from ufm_torch.nn.prediction_heads import MoGeConvFeature, PredictionHeadLayeredInput

H, W = 42, 56
MOGE = {"head_type": "moge_conv", "feature_head_kwargs": {"input_dim": 48, "dims": (16, 8), "output_dim": 2}}


@pytest.mark.parametrize("target", [(42, 56), (30, 17)])
def test_moge_head_matches_jax(target):
    x = np.random.default_rng(0).standard_normal((2, 3, 4, 32)).astype(np.float32)
    jmod = JMoGe(input_dim=32, dims=(16, 8), output_dim=2)
    jin = JInput(list_features=[jnp.asarray(x)], target_output_shape=target)
    params = numpy_params(jmod, jin, std=0.2)
    want = np.asarray(jmod.apply({"params": params}, jin).value)

    mod = MoGeConvFeature(input_dim=32, dims=(16, 8), output_dim=2)
    mod.load_state_dict(jax_params_to_state_dict(flatten_params(params)), strict=True)
    with torch.no_grad():
        got = mod(PredictionHeadLayeredInput(list_features=[torch.from_numpy(x)], target_output_shape=target)).value
    assert got.shape == (2, *target, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_moge_model_matches_jax():
    jnet = JNet(jax_tiny_config(**MOGE))
    params, flat = net_params(jnet, (H, W), seed=2)
    assert {k.split("/")[1] for k in flat if k.startswith("head1/")} == {"proj", "conv0", "conv1", "out"}
    rng = np.random.default_rng(1)
    img1, img2 = (rng.standard_normal((2, H, W, 3)).astype(np.float32) for _ in range(2))
    want = jax.jit(jnet.apply)({"params": params}, img1, img2)

    net = UFMNet(ufm_tiny_config(**MOGE))
    assert isinstance(net.head1, MoGeConvFeature)
    load_jax_params(net, flat)
    with torch.no_grad():
        got = net(torch.from_numpy(img1), torch.from_numpy(img2))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=1e-4, atol=1e-4, err_msg=k)


def test_moge_model_checkpoint_round_trip(tmp_path):
    model = UniFlowMatchConfidence.from_config(ufm_tiny_config(**MOGE), device="cpu")
    model.save_pretrained(str(tmp_path))
    again = UniFlowMatchConfidence.from_pretrained(str(tmp_path), device="cpu")
    assert again.config.head_type == "moge_conv"
    for (n, a), (_, b) in zip(model.net.state_dict().items(), again.net.state_dict().items()):
        assert torch.equal(a, b), n
