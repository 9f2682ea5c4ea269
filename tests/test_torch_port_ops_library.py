"""ufm_torch's kernels as dispatcher ops (``ufm_torch/ops/library.py``) on
the CPU, where each op runs its plain version.

- ``torch.library.opcheck`` on each op (schema, autograd registration, fake
  implementation against the real one, AOT dispatch with dynamic shapes).
- The attention op's output and row log-sum-exp, and its gradients, against
  the JAX package's reference path (``_xla_attention`` and its VJP through
  ``jax.vjp``), fp32, at 1e-5.
- The window op's outputs, gradients (autograd over the plain version) and
  staged-tile count.
- The GELU op (``tests/test_torch_port_gelu.py`` holds its values to the JAX
  package on every bf16 input).
- The device picks the implementation: the CPU never launches a kernel, and
  the kernel wrappers refuse CPU tensors; the fake implementation refuses
  what the kernels do not take for a tensor on the card.
- Export: the ops are graph nodes of an exported attention block.
Inputs are made with numpy from a seed and fed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ufm_tpu.ops.attention import dot_product_attention as jax_attention
from ufm_torch.nn.layers import Attention
from ufm_torch.ops import flash_attention as fa
from ufm_torch.ops import gelu
from ufm_torch.ops import library
from ufm_torch.ops import window_refinement as wr
from ufm_torch.ops.attention import dot_product_attention
from ufm_torch.ops.refinement import fused_refinement_attention

TOL = 1e-5
TEMPERATURE = 4.0


def _qkv(b, s, h, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(4)]


def _window(b=1, h=6, w=7, c=8, p=5, seed=0):
    rng = np.random.default_rng(seed)
    q, f = (torch.from_numpy(rng.standard_normal((b, h, w, c)).astype(np.float32)) for _ in range(2))
    flow = torch.from_numpy((rng.standard_normal((b, h, w, 2)) * 3).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(p * p).astype(np.float32))
    return q, f, flow, bias


def _opcheck_cases():
    q, k, v, g = (torch.from_numpy(x) for x in _qkv(1, 9, 2, 16))
    out, lse = library.flash_attention_fwd(q, k, v, 0.25, True)
    grad = [t.clone().requires_grad_(True) for t in (q, k, v)]
    wq, wf, wflow, wbias = _window()
    wgrad = [t.clone().requires_grad_(True) for t in (wq, wf, wbias)]
    h = (torch.from_numpy(_qkv(2, 7, 3, 5, seed=2)[0]) * 3).to(torch.bfloat16)
    return {
        "fwd": (library.flash_attention_fwd, (q, k, v, 0.25, False)),
        "fwd_lse": (library.flash_attention_fwd, (q, k, v, 0.25, True)),
        "fwd_grad": (library.flash_attention_fwd, (*grad, 0.25, True)),
        "bwd": (library.flash_attention_bwd, (q, k, v, out, lse, g, 0.25)),
        "window": (library.window_refinement, (wq, wf, wflow, wbias, TEMPERATURE, 5)),
        "window_staged": (library.window_refinement, (wq, wf, wflow, wbias, TEMPERATURE, 5, torch.zeros(1, dtype=torch.int32))),
        "window_grad": (library.window_refinement, (wgrad[0], wgrad[1], wflow, wgrad[2], TEMPERATURE, 5)),
        "gelu": (library.gelu_bf16, (h,)),
        "gelu_grad": (library.gelu_bf16, (h.clone().requires_grad_(True),)),
    }


@pytest.mark.parametrize("case", list(_opcheck_cases()))
def test_opcheck(case):
    op, args = _opcheck_cases()[case]
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result


@pytest.mark.parametrize("s,d", [(33, 16), (130, 64)])
def test_attention_op_matches_jax(s, d):
    q, k, v, _ = _qkv(2, s, 3, d, seed=s)
    scale = d**-0.5
    out, lse = library.flash_attention_fwd(*(torch.from_numpy(x) for x in (q, k, v)), scale, True)
    want = jax_attention(*(jnp.asarray(x) for x in (q, k, v)), scale=scale, impl="xla")
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    logits = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), k.astype(np.float64)) * scale
    top = logits.max(-1, keepdims=True)
    np.testing.assert_allclose(lse.numpy(), (top + np.log(np.exp(logits - top).sum(-1, keepdims=True)))[..., 0],
                               atol=TOL, rtol=TOL)
    empty = library.flash_attention_fwd(*(torch.from_numpy(x) for x in (q, k, v)), scale, False)[1]
    assert empty.shape == (0,) and empty.dtype == torch.float32


@pytest.mark.parametrize("s,d", [(33, 16), (77, 64)])
def test_attention_op_gradients_match_jax_vjp(s, d):
    """dq, dk, dv through the op (its backward is the backward op, whose CPU
    implementation is the plain backward) against jax.vjp of the JAX
    package's reference attention."""
    q, k, v, g = _qkv(1, s, 2, d, seed=7 + s)
    scale = d**-0.5
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = dot_product_attention(*leaves, scale=scale)
    out.backward(torch.from_numpy(g))
    _, vjp = jax.vjp(lambda a, b, c: jax_attention(a, b, c, scale=scale, impl="xla"), *(jnp.asarray(x) for x in (q, k, v)))
    for name, leaf, want in zip(("dq", "dk", "dv"), leaves, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want), atol=TOL, rtol=TOL, err_msg=name)


def test_window_op_matches_plain_version_and_its_gradient():
    q, f, flow, bias = _window()
    counter = torch.zeros(1, dtype=torch.int32)
    res, ls = library.window_refinement(q, f, flow, bias, TEMPERATURE, 5, counter)
    ref_res, ref_ls = wr.window_refinement_reference(q, f, flow, bias, TEMPERATURE, 5)
    assert torch.equal(res, ref_res) and torch.equal(ls, ref_ls)
    assert counter.item() == wr.staged_tiles(flow, 5)

    leaves = [t.clone().requires_grad_(True) for t in (q, f, bias)]
    ref_leaves = [t.clone().requires_grad_(True) for t in (q, f, bias)]
    gr, gl = torch.randn_like(res), torch.randn_like(ls)
    torch.autograd.backward(fused_refinement_attention(leaves[0], leaves[1], flow, leaves[2], TEMPERATURE, 5), (gr, gl))
    torch.autograd.backward(
        wr.window_refinement_reference(ref_leaves[0], ref_leaves[1], flow, ref_leaves[2], TEMPERATURE, 5), (gr, gl)
    )
    for name, a, b in zip(("q", "f", "bias"), leaves, ref_leaves):
        torch.testing.assert_close(a.grad, b.grad, atol=TOL, rtol=TOL, msg=name)


def test_cpu_tensors_take_the_plain_version_and_the_kernel_wrappers_refuse_them():
    q, k, v, g = (torch.from_numpy(x) for x in _qkv(1, 16, 2, 64, seed=3))
    before = (fa.LAUNCHES, fa.BWD_LAUNCHES, wr.LAUNCHES, gelu.LAUNCHES)
    assert torch.equal(library.attention(q, k, v, 0.125), fa.attention_reference(q, k, v, 0.125))
    out, lse = library.flash_attention_fwd(q, k, v, 0.125, True)
    for got, want in zip(library.flash_attention_bwd(q, k, v, out, lse, g, 0.125),
                         fa.attention_backward_reference(q, k, v, g, 0.125)):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_forward(q, k, v, 0.125)
    with pytest.raises(ValueError, match="CUDA"):
        wr.window_refinement(*_window(), TEMPERATURE, 5)
    h = q.to(torch.bfloat16)
    assert torch.equal(library.gelu_bf16(h), gelu.fast_exact_gelu_reference(h))
    with pytest.raises(ValueError, match="CUDA"):
        gelu.launch(h)
    assert (fa.LAUNCHES, fa.BWD_LAUNCHES, wr.LAUNCHES, gelu.LAUNCHES) == before


def test_fake_implementation_checks_shapes_and_the_kernels_domain_on_the_card():
    with FakeTensorMode():
        x = torch.empty(1, 8, 2, 64, device="cuda", dtype=torch.bfloat16)
        out, lse = library.flash_attention_fwd(x, x, x, 0.125, True)
        assert (out.shape, out.dtype, lse.shape, lse.dtype) == (x.shape, torch.bfloat16, (1, 2, 8), torch.float32)
        with pytest.raises(ValueError, match="float64"):  # outside the forward kernels' domain
            library.flash_attention_fwd(x.double(), x.double(), x.double(), 0.125, False)
        y = torch.empty(1, 8, 1, 64, device="cuda", dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="shape mismatch"):
            library.flash_attention_fwd(x, y, y, 0.125, False)
        q = torch.empty(1, 4, 5, 16, device="cuda")
        res, ls = library.window_refinement(q, q, torch.empty(1, 4, 5, 2, device="cuda"), torch.empty(25, device="cuda"),
                                            TEMPERATURE, 5)
        assert res.shape == (1, 4, 5, 2) and ls.shape == (1, 4, 5, 5, 5)
        with pytest.raises(ValueError, match="bias"):
            library.window_refinement(q, q, torch.empty(1, 4, 5, 2, device="cuda"), torch.empty(9, device="cuda"),
                                      TEMPERATURE, 5)
        h = torch.empty(2, 9, 40, device="cuda", dtype=torch.bfloat16).transpose(1, 2)
        y = library.gelu_bf16(h)
        assert (y.shape, y.dtype, y.device.type) == (h.shape, torch.bfloat16, "cuda")
        with pytest.raises(ValueError, match="bfloat16"):
            library.gelu_bf16(h.float())


def test_exported_attention_block_holds_the_op():
    block = Attention(32, 2)
    x = torch.randn(2, 9, 32)
    with torch.no_grad():
        program = torch.export.export(block, (x,), strict=False)
        want = block(x)
    targets = [n.target for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count(library.flash_attention_fwd) == 1
    assert torch.equal(program.module()(x), want)
    block.impl = "torch"  # the plain version, decomposed: no op node
    with torch.no_grad():
        plain = torch.export.export(block, (x,), strict=False)
    assert library.flash_attention_fwd not in [n.target for n in plain.graph.nodes]
