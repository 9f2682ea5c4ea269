"""UFM-Refine with a widened window on the CPU, against the JAX package.

The window kernels take 1 <= C <= 64 and odd P <= 9; these are the model
configurations that reach the shapes outside the JAX package's Pallas
kernel (C in {4, 8, 16}, P <= 5). For each (P, C) of ``CASES``, a tiny fp32
UFM-Refine (the tiny config with the patch MLP's ``output_dim`` = C,
``refinement_range`` = P and the UNet fine features) is built by the JAX
package with ``PRNGKey(7)`` on the anchor inputs and carried into the port
with ``load_jax_params``. On the JAX side the refinement runs its XLA path
(the only one it has for these shapes), on the port's the plain window
refinement (the CPU implementation of the window op).

- Every output of the network within 1e-4 of JAX's.
- The gradient of ``ufm_total_loss`` of every parameter at
  ``test_torch_port_training``'s bar (rtol 2e-4, atol 1e-6). The ground
  truth is JAX's regression flow plus whole-pixel offsets inside the
  window, so that the refinement loss's target class (a rounded offset) is
  the same on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ufm_tpu.checkpoint.convert import flatten_params
from ufm_tpu.models import UFMNet as JNet
from ufm_tpu.models import ufm_tiny_config as jax_tiny_config
from ufm_tpu.training import trainer as jtrainer
from ufm_tpu.utils.anchor import seeded_inputs
from ufm_torch.checkpoint import jax_params_to_state_dict, load_jax_params
from ufm_torch.models import UFMNet, ufm_tiny_config
from ufm_torch.training import synthetic_batch, ufm_total_loss

ATOL = 1e-4
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-6
# (P, C): the widest feature width of the test grid at P = 7, a width that
# is no multiple of 4 and the widened model chip_smoke runs, both at P = 9
CASES = [(7, 32), (9, 5), (9, 12)]
UNET = {"use_unet_feature": True, "unet_kwargs": {"out_channels": 8, "features": (8, 16)}}


def _overrides(p, c):
    head = dict(ufm_tiny_config().classification_head_kwargs, output_dim=c)
    return dict(has_classification_head=True, classification_head_kwargs=head, refinement_range=p, **UNET)


@pytest.mark.parametrize("p,c", CASES)
def test_widened_refine_matches_jax(p, c):
    overrides = _overrides(p, c)
    i1, i2 = seeded_inputs()
    jnet = JNet(jax_tiny_config(refinement_impl="xla", **overrides))
    params = jax.jit(jnet.init)(jax.random.PRNGKey(7), i1, i2)["params"]
    flat = flatten_params(params)
    net = UFMNet(ufm_tiny_config(**overrides))
    load_jax_params(net, flat)
    assert net.refinement_impl is None  # the plain window refinement on the CPU

    # outputs on the anchor inputs
    apply = jax.jit(jnet.apply)
    want = apply({"params": params}, i1, i2)
    with torch.no_grad():
        out = net(torch.tensor(np.asarray(i1)), torch.tensor(np.asarray(i2)))
    assert out["refinement_log_softmax"].shape[-2:] == (p, p)
    assert out["refinement_feature_map_1"].shape[-1] == c
    assert set(want) <= set(out)
    for k in want:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(want[k]), atol=ATOL, rtol=0, err_msg=k)

    # gradients of the total loss on a batch at the anchor resolution
    h, w = np.asarray(i1).shape[1:3]
    batch = {k: v.numpy() for k, v in synthetic_batch(2, h, w, seed=p * 100 + c, device="cpu").items()}
    reg = np.asarray(apply({"params": params}, batch["img1"], batch["img2"])["regression_flow"])
    r = (p - 1) // 2
    # whole-pixel offsets inside the window, never 0 (the Charbonnier loss's kink)
    offsets = np.random.default_rng(c).choice([-r, -1.0, 1.0, r], reg.shape).astype(np.float32)
    batch["gt_flow"] = reg + offsets

    def loss_fn(prm):
        o = jnet.apply({"params": prm}, batch["img1"], batch["img2"])
        return jtrainer.ufm_total_loss(o, {k: jnp.asarray(v) for k, v in batch.items()})[0]

    j_grads = jax.jit(jax.grad(loss_fn))(params)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, metrics = ufm_total_loss(net(tbatch["img1"], tbatch["img2"]), tbatch)
    assert metrics["refinement_loss"].item() > 0
    loss.backward()
    want_grads = {k: v.numpy() for k, v in jax_params_to_state_dict(flatten_params(j_grads)).items()}
    assert set(want_grads) == {n for n, _ in net.named_parameters()}
    for n, prm in net.named_parameters():
        np.testing.assert_allclose(prm.grad.numpy(), want_grads[n], rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=n)
