"""The fused fc1 + GELU op (``ufm_torch::linear_gelu_bf16``,
``ufm_torch/ops/linear_gelu.py``) on the CPU, where it runs its plain
version, against the two ops it replaces and against the JAX package.

- The op's CPU implementation is bitwise ``fast_exact_gelu_reference``
  of ``F.linear``, at 2-D and 3-D inputs, one row, odd row counts and K / N
  tails; and the JAX package's ``fast_exact_gelu`` of the port's own
  pre-activation is the op's output bit for bit.
- ``nn.layers.Mlp`` takes the fused op in every bf16 forward outside
  activation checkpointing: without a gradient the single-output launch,
  bitwise the grad-mode output (the launch that also writes the
  pre-activation, ``ufm_torch::linear_gelu_bf16_preact``); a tiny bf16
  model's forward calls one of them per MLP and the standalone GELU op
  never (the ops are counted at the dispatcher).
- The port's bf16 MLP against the JAX package's (``fast_exact_gelu``, weights
  carried by ``ufm_torch/checkpoint/convert.py``) within 1e-2 relative L2.
- ``opcheck``; fp32 and wrong shapes refused; the CUDA implementations refuse
  a CPU tensor without counting a launch.
Inputs are made with numpy from a seed and fed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from ufm_tpu.checkpoint.convert import flatten_params
from ufm_tpu.nn.layers import Mlp as JaxMlp
from ufm_tpu.ops.gelu import fast_exact_gelu as jax_fast_exact_gelu
from ufm_torch.checkpoint import load_jax_params
from ufm_torch.models import UniFlowMatchConfidence, ufm_tiny_config
from ufm_torch.nn.layers import Mlp, run_blocks
from ufm_torch.ops import launches, library
from ufm_torch.ops import linear_gelu as lg
from ufm_torch.ops.gelu import fast_exact_gelu_reference

# the port's MLP against the JAX package's, relative L2 of the output: the
# two round fc1's bias at different places (one ulp of h at most), which the
# GELU and fc2 carry on
JAX_MLP_REL_L2 = 1e-2


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16)


def _inputs(lead, k, n, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((*lead, k)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((rng.standard_normal((n, k)) * k**-0.5).astype(np.float32)).to(torch.bfloat16)
    b = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(torch.bfloat16)
    return x, w, b


class _OpCalls(TorchDispatchMode):
    """Counts the calls of the two GELU ops that reach the dispatcher."""

    def __init__(self):
        super().__init__()
        self.calls = {library.gelu_bf16: 0, library.linear_gelu_bf16: 0, library.linear_gelu_bf16_preact: 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.calls:
            self.calls[func] += 1
        return func(*args, **(kwargs or {}))


CASES = {
    "2d": ((16,), 64, 256),
    "one_row": ((1,), 64, 256),
    "odd_rows": ((7,), 64, 256),
    "3d": ((2, 9), 64, 128),
    "k_n_tails": ((5,), 48, 200),
    "tiny_mlp": ((2, 33), 48, 192),
}


@pytest.mark.parametrize("case", list(CASES))
def test_cpu_op_is_linear_then_gelu_bitwise(case):
    lead, k, n = CASES[case]
    x, w, b = _inputs(lead, k, n, seed=len(lead) + k + n)
    got = library.linear_gelu_bf16(x, w, b)
    assert got.shape == (*lead, n) and got.dtype == torch.bfloat16
    assert torch.equal(_bits(got), _bits(fast_exact_gelu_reference(F.linear(x, w, b))))
    assert torch.equal(_bits(got), _bits(lg.linear_gelu_bf16(x, w, b)))
    assert torch.equal(_bits(got), _bits(lg.linear_gelu_reference(x, w, b)))


@pytest.mark.parametrize("case", ["2d", "3d", "k_n_tails"])
def test_jax_gelu_of_the_ports_preactivation_is_the_ops_output(case):
    """The JAX package's fast_exact_gelu of the port's own h (F.linear's
    bf16 output) gives the op's output bit for bit."""
    lead, k, n = CASES[case]
    x, w, b = _inputs(lead, k, n, seed=3)
    h = F.linear(x, w, b)
    want = jax_fast_exact_gelu(jnp.asarray(h.float().numpy()).astype(jnp.bfloat16))
    want_bits = np.asarray(jax.lax.bitcast_convert_type(want, jnp.int16))
    got = library.linear_gelu_bf16(x, w, b)
    np.testing.assert_array_equal(_bits(got).numpy(), want_bits)


def _bf16_mlp(k=48, hidden=192, seed=0):
    torch.manual_seed(seed)
    return Mlp(k, hidden).to(torch.bfloat16)


@pytest.mark.parametrize("mode", ["inference_mode", "no_grad", "frozen_params"])
def test_mlp_takes_the_fused_op_without_a_gradient(mode):
    """Without a recorded gradient the MLP is one fused op and fc2, bitwise
    the grad-mode path (the fused launch that also writes the
    pre-activation, then fc2)."""
    mlp = _bf16_mlp()
    x = _inputs((2, 33), 48, 1)[0]
    with _OpCalls() as grad_calls:
        want = mlp(x)
    assert want.requires_grad
    assert grad_calls.calls == {library.gelu_bf16: 0, library.linear_gelu_bf16: 0, library.linear_gelu_bf16_preact: 1}
    with _OpCalls() as calls:
        if mode == "inference_mode":
            with torch.inference_mode():
                got = mlp(x)
        elif mode == "no_grad":
            with torch.no_grad():
                got = mlp(x)
        else:
            mlp.requires_grad_(False)
            got = mlp(x)
    assert calls.calls == {library.gelu_bf16: 0, library.linear_gelu_bf16: 1, library.linear_gelu_bf16_preact: 0}
    assert torch.equal(_bits(got), _bits(want.detach()))


def test_mlp_keeps_two_ops_where_the_fused_op_does_not_apply():
    """fp32 MLPs take F.gelu, a tanh MLP its own activation, and a bf16 MLP
    inside a checkpointed block the GELU op (in its forward and in the
    backward's recompute): none of them the fused op."""
    x = _inputs((3, 5), 48, 1)[0]
    for mlp, inp in ((Mlp(48, 192), x.float()), (Mlp(48, 192, act="gelu_tanh").to(torch.bfloat16), x)):
        with _OpCalls() as calls:
            mlp(inp)
        assert calls.calls[library.linear_gelu_bf16] == calls.calls[library.linear_gelu_bf16_preact] == 0
    mlp = _bf16_mlp()
    with _OpCalls() as calls:
        out, _ = run_blocks([mlp], x.clone().requires_grad_(True), (), remat=True)
        out.float().sum().backward()
    assert calls.calls == {library.gelu_bf16: 2, library.linear_gelu_bf16: 0, library.linear_gelu_bf16_preact: 0}


def test_tiny_model_forward_calls_one_gelu_op_per_mlp():
    """A tiny bf16 UFM-Base: a grad-mode forward calls the fused op that
    also writes the pre-activation once per MLP, a no-grad forward the
    single-output fused op, with the same outputs bit for bit; neither calls
    the standalone GELU op, and the CPU launches nothing."""
    model = UniFlowMatchConfidence.from_config(ufm_tiny_config(compute_dtype="bfloat16"), device="cpu")
    cfg = model.config
    layers = cfg.encoder_kwargs["depth"] + cfg.info_sharing_kwargs["depth"]
    w, h = model.inference_resolution[0]
    rng = np.random.default_rng(7)
    img1, img2 = (torch.from_numpy(rng.standard_normal((1, h, w, 3)).astype(np.float32)) for _ in range(2))
    before = launches.snapshot()
    with _OpCalls() as grad_calls:
        want = model.net(img1, img2)
    assert grad_calls.calls == {library.gelu_bf16: 0, library.linear_gelu_bf16: 0,
                                library.linear_gelu_bf16_preact: layers}
    with _OpCalls() as calls, torch.no_grad():
        got = model.net(img1, img2)
    assert calls.calls == {library.gelu_bf16: 0, library.linear_gelu_bf16: layers, library.linear_gelu_bf16_preact: 0}
    assert launches.since(before) == dict.fromkeys(before, 0)
    for k in want:
        assert torch.equal(got[k], want[k].detach()), k


def test_port_mlp_matches_the_jax_mlp():
    """The JAX package's bf16 Mlp (fc1, fast_exact_gelu, fc2) against the
    port's fused path, weights carried by convert.py."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 33, 48)).astype(np.float32)
    jmlp = JaxMlp(hidden_dim=192, dtype=jnp.bfloat16)
    params = jmlp.init(jax.random.PRNGKey(0), jnp.asarray(x, jnp.bfloat16))["params"]
    # a bias that matters: the init sets it to zero
    params = {name: dict(layer) for name, layer in params.items()}
    params["fc1"]["bias"] = jnp.asarray(rng.standard_normal(192).astype(np.float32))
    want = np.asarray(jmlp.apply({"params": params}, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    mlp = _bf16_mlp()
    load_jax_params(mlp, flatten_params(params))
    with _OpCalls() as calls, torch.inference_mode():
        got = mlp(torch.from_numpy(x).to(torch.bfloat16)).float().numpy()
    assert calls.calls[library.linear_gelu_bf16] == 1
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= JAX_MLP_REL_L2, rel


@pytest.mark.parametrize("case", ["2d", "3d", "k_n_tails"])
def test_opcheck(case):
    lead, k, n = CASES[case]
    result = torch.library.opcheck(library.linear_gelu_bf16, _inputs(lead, k, n, seed=5))
    assert set(result.values()) == {"SUCCESS"}, result


def test_refusals():
    """fp32 and shapes that do not fit are refused by both ops and their
    plain versions; the CUDA implementations refuse CPU tensors before they
    count a launch."""
    x, w, b = _inputs((4,), 64, 128)
    bad = {
        "fp32": ((x.float(), w, b), "bfloat16"),
        "k_mismatch": ((x[:, :56], w, b), "takes x"),
        "bias_length": ((x, w, b[:64]), "takes x"),
        "w_rank": ((x, w[None], b), "takes x"),
    }
    for args, match in bad.values():
        for fn in (library.linear_gelu_bf16, lg.linear_gelu_reference, lg.linear_gelu_bf16,
                   library.linear_gelu_bf16_preact, lg.linear_gelu_preact_reference):
            with pytest.raises(ValueError, match=match):
                fn(*args)
    before = lg.LAUNCHES
    for fn in (lg.launch, lg.launch_preact):
        with pytest.raises(ValueError, match="CUDA"):
            fn(x, w, b)
    assert lg.LAUNCHES == before
