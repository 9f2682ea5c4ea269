"""ufm_torch training losses against the JAX package's, values and gradients.

The same numpy arrays (seeded) go through ``ufm_tpu.training.losses`` and
``ufm_torch.training.losses``: a UFM-Base output dict (flow, covariance,
covisibility) and a UFM-Refine one (plus regression flow and the refinement
log-softmax), with and without a ``valid`` mask. fp32 on both sides; only
the summation order differs (rtol 1e-5, atol 1e-6 on values and on the
gradient of the total loss with respect to every output).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ufm_tpu.training import losses as jl
from ufm_torch.training import losses as tl

TOL = dict(rtol=1e-5, atol=1e-6)
B, H, W, P = 2, 6, 7, 5


def _outputs(refine: bool, seed: int = 0):
    rng = np.random.default_rng(seed)
    f32 = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    inv = np.concatenate([np.exp(f32(B, H, W, 2)), 0.1 * f32(B, H, W, 1)], axis=-1)
    out = {
        "flow": 3.0 * f32(B, H, W, 2),
        "flow_cov_inv": inv,
        "flow_cov_log_det": f32(B, H, W),
        "covis_logits": 2.0 * f32(B, H, W),
    }
    if refine:
        logits = f32(B, H, W, P * P)
        ls = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
        out["refinement_log_softmax"] = ls.reshape(B, H, W, P, P).astype(np.float32)
        out["regression_flow"] = out["flow"] + 0.3 * f32(B, H, W, 2)
    batch = {
        "gt_flow": out["flow"] + 1.5 * f32(B, H, W, 2),
        "gt_covisibility": (rng.random((B, H, W)) > 0.3).astype(np.float32),
        "valid": (rng.random((B, H, W)) > 0.2).astype(np.float32),
    }
    return out, batch


def _jax_total(out, batch):
    def f(o):
        return jl.ufm_total_loss(o, {k: jnp.asarray(v) for k, v in batch.items()})

    (loss, metrics), grads = jax.value_and_grad(f, has_aux=True)({k: jnp.asarray(v) for k, v in out.items()})
    return loss, metrics, grads


def _torch_total(out, batch):
    o = {k: torch.from_numpy(v).requires_grad_(True) for k, v in out.items()}
    loss, metrics = tl.ufm_total_loss(o, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    return loss, metrics, {k: v.grad for k, v in o.items()}


@pytest.mark.parametrize("masked", [False, True], ids=["all", "valid"])
@pytest.mark.parametrize("refine", [False, True], ids=["base", "refine"])
def test_total_loss_values_and_gradients_match_jax(refine, masked):
    out, batch = _outputs(refine, seed=int(refine) + 2 * int(masked))
    if not masked:
        del batch["valid"]
    j_loss, j_metrics, j_grads = _jax_total(out, batch)
    t_loss, t_metrics, t_grads = _torch_total(out, batch)
    assert set(t_metrics) == set(j_metrics)
    assert ("refinement_loss" in t_metrics) == refine
    for k in j_metrics:
        np.testing.assert_allclose(t_metrics[k].detach().numpy(), np.asarray(j_metrics[k]), err_msg=k, **TOL)
    np.testing.assert_allclose(t_loss.detach().numpy(), np.asarray(j_loss), **TOL)
    for k in out:
        want = np.asarray(j_grads[k])
        got = t_grads[k].numpy() if t_grads[k] is not None else np.zeros_like(want)
        np.testing.assert_allclose(got, want, err_msg=k, **TOL)


@pytest.mark.parametrize("masked", [False, True], ids=["all", "valid"])
def test_each_loss_matches_jax(masked):
    out, batch = _outputs(True, seed=5)
    mask = batch["valid"] if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    J = lambda x: jnp.asarray(x)  # noqa: E731
    T = lambda x: torch.from_numpy(x)  # noqa: E731
    reg, gt = out["regression_flow"], batch["gt_flow"]
    pairs = {
        "epe": (jl.epe(J(reg), J(gt), jm), tl.epe(T(reg), T(gt), tm)),
        "flow_regression": (jl.flow_regression_loss(J(reg), J(gt), jm), tl.flow_regression_loss(T(reg), T(gt), tm)),
        "covariance_nll": (
            jl.covariance_nll_loss(J(reg), J(gt), J(out["flow_cov_inv"]), J(out["flow_cov_log_det"]), jm),
            tl.covariance_nll_loss(T(reg), T(gt), T(out["flow_cov_inv"]), T(out["flow_cov_log_det"]), tm),
        ),
        "covisibility_bce": (
            jl.covisibility_bce_loss(J(out["covis_logits"]), J(batch["gt_covisibility"]), jm),
            tl.covisibility_bce_loss(T(out["covis_logits"]), T(batch["gt_covisibility"]), tm),
        ),
        "refinement": (
            jl.refinement_classification_loss(J(out["refinement_log_softmax"]), J(reg), J(gt), jm),
            tl.refinement_classification_loss(T(out["refinement_log_softmax"]), T(reg), T(gt), tm),
        ),
    }
    for name, (want, got) in pairs.items():
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=name, **TOL)


def test_refinement_loss_rounds_half_to_even():
    """Target offsets of exactly +-0.5 and 1.5 pick the class jnp.round picks
    (half to even), and offsets outside the window are not supervised."""
    ls = np.log(np.full((1, 1, 5, 3, 3), 1.0 / 9, dtype=np.float32))
    ls[0, 0, :, 1, 2] = np.log(0.5)  # class dx = +1, dy = 0
    reg = np.zeros((1, 1, 5, 2), np.float32)
    gt = np.zeros((1, 1, 5, 2), np.float32)
    gt[0, 0, :, 0] = [0.5, -0.5, 1.5, 0.7, 2.0]  # the last lies outside a 3x3 window
    want = jl.refinement_classification_loss(jnp.asarray(ls), jnp.asarray(reg), jnp.asarray(gt))
    got = tl.refinement_classification_loss(torch.from_numpy(ls), torch.from_numpy(reg), torch.from_numpy(gt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_covariance_nll_passes_no_gradient_to_the_flow():
    out, batch = _outputs(False, seed=7)
    flow = torch.from_numpy(out["flow"]).requires_grad_(True)
    inv = torch.from_numpy(out["flow_cov_inv"]).requires_grad_(True)
    loss = tl.covariance_nll_loss(flow, torch.from_numpy(batch["gt_flow"]), inv, torch.from_numpy(out["flow_cov_log_det"]))
    loss.backward()
    assert flow.grad is None
    assert inv.grad is not None and inv.grad.abs().sum() > 0
