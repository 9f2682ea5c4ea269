"""The MLP's gradient through the GELU gradient in the epilogue of fc2's
input-gradient product (``ufm_torch::linear_gelu_bf16_bwd``,
``ufm_torch/ops/linear_gelu.py``), on the CPU, where the op runs its plain
version.

- The op's plain version is bit for bit the two-op route's ``dh``
  (``gelu_bf16_bwd(g.mm(w2), h)``) at row counts off the kernel's 128-row
  tile, with zero, signed-zero and tiny cotangents among them.
- An ``Mlp``'s five gradients (dx, fc1's and fc2's weight and bias) through
  the new route are bit for bit those of the route it replaces (the fused
  forward op, then fc2 as its own node) and of the two plain ops (fc1, the
  GELU op, fc2), and within JAX_GRAD_REL_L2 of ``jax.vjp`` of the JAX
  package's ``Mlp``.
- The fake implementation gives the output's shape and dtype; the op and
  its plain version refuse non-bf16 inputs and mismatched shapes, and the
  CUDA implementation refuses CPU tensors without counting a launch.
- The route's conditions: inference keeps ``fc2(linear_gelu_bf16(...))``;
  activation checkpointing, a DTensor (tensor-parallel) fc2 and an fc2
  without a bias keep the two nodes (dispatcher calls counted).
Single-threaded (``torch.set_num_threads(1)``): the plain VJP is ~60 torch
ops on small tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from ufm_tpu.checkpoint.convert import flatten_params
from ufm_tpu.nn.layers import Mlp as JaxMlp
from ufm_torch.checkpoint import jax_params_to_state_dict, load_jax_params
from ufm_torch.nn import layers
from ufm_torch.nn.layers import Mlp, run_blocks
from ufm_torch.ops import library
from ufm_torch.ops import linear_gelu as lg
from ufm_torch.ops.gelu import fast_exact_gelu_vjp_reference

# the port's MLP gradients against jax.vjp of the JAX package's bf16 Mlp,
# relative L2: the two packages round fc1's and fc2's products and biases at
# different places (one bf16 ulp of h or dy at most), which the GELU's
# gradient and the products carry on (as tests/test_torch_port_gelu_vjp.py's
# MLP case, which measured at most 8e-3)
JAX_GRAD_REL_L2 = 2e-2


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16)


def _bf16(rng, shape, scale=1.0) -> torch.Tensor:
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(torch.bfloat16)


def _cotangent(rng, shape) -> torch.Tensor:
    """Normal values with a share of +0, -0 and 1e-38 (flushed to zero where
    XLA's CPU flushes) among them."""
    g = rng.standard_normal(shape).astype(np.float32)
    pick = rng.random(shape)
    g = np.where(pick < 0.05, 0.0, np.where(pick < 0.1, -0.0, np.where(pick < 0.15, 1e-38, g))).astype(np.float32)
    return torch.from_numpy(g).to(torch.bfloat16)


class _OpCalls(TorchDispatchMode):
    """Counts the MLP ops' calls that reach the dispatcher."""

    OPS = (library.linear_gelu_bf16, library.linear_gelu_bf16_preact, library.gelu_bf16, library.gelu_bf16_bwd,
           library.linear_gelu_bf16_bwd)

    def __init__(self):
        super().__init__()
        self.calls = dict.fromkeys(self.OPS, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.calls:
            self.calls[func] += 1
        return func(*args, **(kwargs or {}))


def _counts(calls):
    names = ("fused", "fused_preact", "gelu", "gelu_bwd", "fused_bwd")
    return {n: calls[op] for n, op in zip(names, _OpCalls.OPS)}


# (rows, N2, N): rows off the 128-row tile, one row, 3-D leading shapes
CASES = {"rows_130": ((130,), 24, 96), "one_row": ((1,), 16, 64), "rows_3x43": ((3, 43), 32, 128),
         "tails": ((7,), 48, 200)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_is_the_two_op_routes_dh(case):
    lead, n2, n = CASES[case]
    rng = np.random.default_rng(sum(lead) + n)
    g, w2 = _cotangent(rng, (*lead, n2)), _bf16(rng, (n2, n), n2**-0.5)
    h = _bf16(rng, (*lead, n), 2.0)  # reaches the VJP's tail and saturated side
    want = fast_exact_gelu_vjp_reference(h.reshape(-1, n), g.reshape(-1, n2).mm(w2)).view(h.shape)
    two_op = library.gelu_bf16_bwd(g.reshape(-1, n2).mm(w2), h.reshape(-1, n)).view(h.shape)
    for got in (lg.linear_gelu_bwd_reference(g, w2, h), lg.linear_gelu_bf16_bwd(g, w2, h),
                library.linear_gelu_bf16_bwd(g, w2, h)):
        assert got.shape == h.shape and got.dtype == torch.bfloat16
        assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(two_op), _bits(want))


def _mlp(k=32, hidden=128, seed=0, bias2=True):
    torch.manual_seed(seed)
    mlp = Mlp(k, hidden).to(torch.bfloat16)
    if not bias2:
        mlp.fc2.bias = None
    with torch.no_grad():  # a bias that matters
        mlp.fc1.bias.normal_(0.0, 0.5)
    return mlp


def _grads(mlp, x, dy):
    xt = x.clone().requires_grad_(True)
    mlp.zero_grad(set_to_none=True)
    with _OpCalls() as calls:
        out = mlp(xt)
        out.backward(dy)
    return (out.detach(), xt.grad, *(p.grad for p in mlp.parameters())), _counts(calls.calls)


def _two_node_grads(mlp, x, dy, monkeypatch):
    """The route the fused gradient replaces: the fused forward op as one
    node (its gradient the GELU gradient op), then fc2 as its own."""
    with monkeypatch.context() as m:
        m.setattr(Mlp, "_fused_backward", lambda self, x: False)
        return _grads(mlp, x, dy)


def _plain_op_grads(mlp, x, dy):
    """fc1, the GELU op and fc2 as three nodes."""
    xt = x.clone().requires_grad_(True)
    mlp.zero_grad(set_to_none=True)
    out = F.linear(library.gelu_bf16(F.linear(xt, mlp.fc1.weight, mlp.fc1.bias)), mlp.fc2.weight, mlp.fc2.bias)
    out.backward(dy)
    return (out.detach(), xt.grad, *(p.grad for p in mlp.parameters()))


@pytest.mark.parametrize("lead", [(2, 65), (130,)], ids=["2x65", "130"])
def test_mlp_gradients_are_the_two_op_routes_bit_for_bit(lead, monkeypatch):
    rng = np.random.default_rng(len(lead))
    mlp = _mlp()
    x, dy = _bf16(rng, (*lead, 32)), _cotangent(rng, (*lead, 32))
    got, calls = _grads(mlp, x, dy)
    assert calls == {"fused": 0, "fused_preact": 1, "gelu": 0, "gelu_bwd": 0, "fused_bwd": 1}
    want, want_calls = _two_node_grads(mlp, x, dy, monkeypatch)
    assert want_calls == {"fused": 0, "fused_preact": 1, "gelu": 0, "gelu_bwd": 1, "fused_bwd": 0}
    plain = _plain_op_grads(mlp, x, dy)
    names = ("out", "dx", "dw1", "db1", "dw2", "db2")
    for name, a, b, c in zip(names, got, want, plain):
        assert a.dtype == b.dtype == torch.bfloat16 and a.shape == b.shape, name
        assert torch.equal(_bits(a), _bits(b)), name
        assert torch.equal(_bits(a), _bits(c)), name


def test_partial_gradients_take_the_needed_products():
    """Frozen fc1 (only dx and fc2's gradients asked) and a frozen input (no
    dx): each gradient that is asked for is the full route's."""
    rng = np.random.default_rng(5)
    mlp = _mlp(seed=1)
    x, dy = _bf16(rng, (40, 32)), _cotangent(rng, (40, 32))
    full, _ = _grads(mlp, x, dy)
    mlp.fc1.requires_grad_(False)
    part, calls = _grads(mlp, x, dy)
    assert calls["fused_bwd"] == 1
    assert part[2] is None and part[3] is None  # fc1's weight and bias
    for i in (1, 4, 5):
        assert torch.equal(_bits(part[i]), _bits(full[i]))
    mlp.fc1.requires_grad_(True)
    mlp.zero_grad(set_to_none=True)
    with _OpCalls() as calls:
        mlp(x).backward(dy)  # x needs no gradient
    assert _counts(calls.calls)["fused_bwd"] == 1
    for i, p in zip((2, 3, 4, 5), mlp.parameters()):
        assert torch.equal(_bits(p.grad), _bits(full[i]))


def _jax_grads(params, x, dy):
    module = JaxMlp(hidden_dim=128, dtype=jnp.bfloat16)

    @jax.jit
    def grads(p, a, c):
        return jax.vjp(lambda p_, a_: module.apply({"params": p_}, a_), p, a)[1](c)

    dp, dx = grads(params, jnp.asarray(x, jnp.bfloat16), jnp.asarray(dy, jnp.bfloat16))
    return np.asarray(dx, np.float32), jax_params_to_state_dict(flatten_params(jax.tree_util.tree_map(np.asarray, dp)))


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.linalg.norm(got.float().numpy() - want) / np.linalg.norm(want))


def test_mlp_gradients_match_the_jax_mlp():
    """jax.vjp (under jit, as the JAX package's train step runs it) of the
    JAX package's bf16 Mlp, the same numpy weights carried by convert.py."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 17, 32)).astype(np.float32)
    dy = rng.standard_normal((2, 17, 32)).astype(np.float32)
    init = JaxMlp(hidden_dim=128, dtype=jnp.bfloat16).init(jax.random.PRNGKey(0), jnp.asarray(x, jnp.bfloat16))
    params = jax.tree_util.tree_map(lambda v: (np.asarray(v) + rng.normal(0.0, 0.1, v.shape)).astype(np.float32),
                                    init["params"])
    mlp = Mlp(32, 128)
    load_jax_params(mlp, flatten_params(params))
    mlp = mlp.to(torch.bfloat16)
    got, calls = _grads(mlp, torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(dy).to(torch.bfloat16))
    assert calls["fused_bwd"] == 1
    want_dx, want = _jax_grads(params, x, dy)
    assert _rel(got[1], want_dx) <= JAX_GRAD_REL_L2
    for (name, _), grad in zip(mlp.named_parameters(), got[2:]):
        assert _rel(grad, want[name].numpy()) <= JAX_GRAD_REL_L2, name


def test_fake_implementation_gives_the_shape_and_dtype():
    with FakeTensorMode():
        g = torch.empty(3, 43, 32, dtype=torch.bfloat16)
        w2 = torch.empty(32, 128, dtype=torch.bfloat16)
        h = torch.empty(3, 43, 128, dtype=torch.bfloat16)
        out = library.linear_gelu_bf16_bwd(g, w2, h)
    assert tuple(out.shape) == (3, 43, 128) and out.dtype == torch.bfloat16


def test_opcheck():
    rng = np.random.default_rng(3)
    args = (_bf16(rng, (130, 24)), _bf16(rng, (24, 96)), _bf16(rng, (130, 96)))
    result = torch.library.opcheck(library.linear_gelu_bf16_bwd, args)
    assert set(result.values()) == {"SUCCESS"}, result


def test_refusals():
    """Non-bf16 operands and shapes that do not fit are refused by the op,
    its plain version and the CUDA implementation; the CUDA implementation
    refuses CPU tensors before it counts a launch."""
    rng = np.random.default_rng(4)
    g, w2, h = _bf16(rng, (8, 24)), _bf16(rng, (24, 96)), _bf16(rng, (8, 96))
    bad = {
        "fp32_g": ((g.float(), w2, h), "bfloat16"),
        "fp16_w2": ((g, w2.half(), h), "bfloat16"),
        "fp32_h": ((g, w2, h.float()), "bfloat16"),
        "n2_mismatch": ((g[:, :16], w2, h), "takes g"),
        "n_mismatch": ((g, w2, h[:, :64]), "takes g"),
        "rows_mismatch": ((g, w2, h[:7]), "takes g"),
        "w2_rank": ((g, w2[None], h), "takes g"),
    }
    for args, match in bad.values():
        for fn in (library.linear_gelu_bf16_bwd, lg.linear_gelu_bwd_reference, lg.linear_gelu_bf16_bwd,
                   lg.launch_backward):
            with pytest.raises(ValueError, match=match if fn is not lg.launch_backward else "CUDA|" + match):
                fn(*args)
    before = lg.BWD_LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        lg.launch_backward(g, w2, h)
    assert lg.BWD_LAUNCHES == before


def test_inference_keeps_the_forward_op_and_fc2():
    """Without a gradient the MLP is the fused forward op and fc2, bit for
    bit the training route's output."""
    rng = np.random.default_rng(6)
    mlp = _mlp(seed=2)
    x = _bf16(rng, (3, 33, 32))
    with _OpCalls() as calls, torch.no_grad():
        got = mlp(x)
    assert _counts(calls.calls) == {"fused": 1, "fused_preact": 0, "gelu": 0, "gelu_bwd": 0, "fused_bwd": 0}
    assert torch.equal(_bits(got), _bits(mlp(x).detach()))


class _ShardedMarker(torch.nn.Parameter):
    """Stands for a DTensor parameter (tensor-parallel fc2) in Mlp's checks."""


@pytest.mark.parametrize("condition", ["remat", "dtensor_fc2", "dtensor_fc1", "fc2_without_bias"])
def test_conditions_that_keep_the_two_nodes(condition, monkeypatch):
    """Activation checkpointing keeps fc1 and the standalone GELU (their
    gradient the GELU gradient op, in the backward's recompute too); a
    DTensor fc2 or an fc2 without a bias keeps the fused forward op and fc2
    as two nodes; a DTensor fc1 keeps all three ops. None of them runs the
    fused gradient."""
    rng = np.random.default_rng(7)
    mlp = _mlp(seed=3, bias2=condition != "fc2_without_bias")
    x, dy = _bf16(rng, (2, 20, 32)), _cotangent(rng, (2, 20, 32))
    if condition.startswith("dtensor"):
        layer = mlp.fc2 if condition == "dtensor_fc2" else mlp.fc1
        layer.weight = _ShardedMarker(layer.weight.data)
        monkeypatch.setattr(layers, "DTensor", _ShardedMarker)
    xt = x.clone().requires_grad_(True)
    with _OpCalls() as calls:
        if condition == "remat":
            out, _ = run_blocks([mlp], xt, (), remat=True)
        else:
            out = mlp(xt)
        out.backward(dy)
    want = {"remat": {"fused": 0, "fused_preact": 0, "gelu": 2, "gelu_bwd": 1, "fused_bwd": 0},
            "dtensor_fc1": {"fused": 0, "fused_preact": 0, "gelu": 1, "gelu_bwd": 1, "fused_bwd": 0}}.get(
        condition, {"fused": 0, "fused_preact": 1, "gelu": 0, "gelu_bwd": 1, "fused_bwd": 0})
    assert _counts(calls.calls) == want
