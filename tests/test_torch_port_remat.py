"""The ``train_remat_policy`` names in ufm_torch on the CPU.

Each of the JAX package's seven policy names (``jax.checkpoint_policies``
members and the ``+attn_out`` composite, ufm_tpu/nn/layers.py) is a
selective-checkpointing policy (``torch.utils.checkpoint``) over the ATen
ops it saves, and the flash-attention op for the composite. For the fp32 and
bf16 tiny configs, parameters made from a seed with numpy and carried in by
``load_jax_params``:

- every policy's gradients equal no remat's at rtol 2e-4 / atol 1e-6 (the
  bar of tests/test_training_loop.py::test_remat_policy_matches_plain_gradients);
- the attention forward op runs once per layer in a step where its outputs
  are kept (no remat, ``everything_saveable``, the composite) and twice
  where the backward recomputes them, counted at the dispatcher;
- unknown names and the JAX package's policy factories raise ValueError.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from torch_port_seeded import net_params
from ufm_tpu.models import UFMNet as JNet
from ufm_tpu.models import ufm_tiny_config as jax_tiny_config
from ufm_torch.checkpoint import load_jax_params
from ufm_torch.models import UFMNet, ufm_tiny_config
from ufm_torch.nn.layers import REMAT_POLICIES, resolve_remat_policy
from ufm_torch.ops.library import flash_attention_fwd
from ufm_torch.training import synthetic_batch, ufm_total_loss

H, W = 42, 56
LAYERS = 4  # the tiny config: 2 encoder and 2 info-sharing blocks
# the JAX package's allowed names and the composite
JAX_NAMES = (
    "everything_saveable",
    "nothing_saveable",
    "dots_saveable",
    "checkpoint_dots",
    "dots_with_no_batch_dims_saveable",
    "checkpoint_dots_with_no_batch_dims",
    "dots_with_no_batch_dims_and_attn_out_saveable",
)
KEEPS_ATTENTION = {"everything_saveable", "dots_with_no_batch_dims_and_attn_out_saveable"}


@pytest.fixture(scope="module")
def flat():
    return net_params(JNet(jax_tiny_config()), (H, W), seed=1)[1]


class _CountAttention(TorchDispatchMode):
    """Counts executions of the attention forward op (a kept output read
    back by the checkpointing policy is no execution)."""

    def __init__(self):
        super().__init__()
        self.calls = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is flash_attention_fwd:
            self.calls += 1
        return func(*args, **(kwargs or {}))


def _grads(flat, dtype, **remat):
    net = UFMNet(ufm_tiny_config(compute_dtype=dtype, **remat))
    load_jax_params(net, flat)
    batch = synthetic_batch(2, H, W, seed=3, device="cpu")
    with _CountAttention() as counter:
        loss, _ = ufm_total_loss(net(batch["img1"], batch["img2"]), batch)
        loss.backward()
    return {n: p.grad.float() for n, p in net.named_parameters() if p.grad is not None}, counter.calls


def test_policy_names_are_jax_names():
    assert set(REMAT_POLICIES) == set(JAX_NAMES)
    assert resolve_remat_policy(None) is None and resolve_remat_policy("") is None


@pytest.mark.parametrize("policy", [None, *JAX_NAMES])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_policy_matches_plain_gradients(flat, dtype, policy):
    g0, plain_calls = _grads(flat, dtype)
    g1, calls = _grads(flat, dtype, train_remat=True, train_remat_policy=policy)
    assert plain_calls == LAYERS
    assert calls == (LAYERS if policy in KEEPS_ATTENTION else 2 * LAYERS)
    assert set(g0) == set(g1)
    for n in g0:
        np.testing.assert_allclose(g1[n].numpy(), g0[n].numpy(), rtol=2e-4, atol=1e-6, err_msg=n)


def test_policy_follows_the_remat_scope():
    net = UFMNet(ufm_tiny_config(train_remat="encoder", train_remat_policy="dots_saveable"))
    assert net.encoder.remat and net.encoder.remat_policy == "dots_saveable"
    assert not net.info_sharing.remat


@pytest.mark.parametrize("name", ["bogus", "save_only_these_names", "save_from_both_policies"])
def test_unknown_policies_raise(name):
    with pytest.raises(ValueError, match="unknown remat policy"):
        UFMNet(ufm_tiny_config(train_remat=True, train_remat_policy=name))
    with pytest.raises(ValueError, match="unknown remat policy"):
        resolve_remat_policy(name)
