"""The port's exact GELU against the JAX package's (``ufm_tpu/ops/gelu.py``).

On bf16 the JAX package's MLP activation is ``fast_exact_gelu``: bitwise
``jax.nn.gelu(approximate=False)``, an op-for-op chain that rounds to bf16
after every op, with a polynomial erfc. XLA's CPU flushes subnormal fp32
operands and results to a zero of the same sign, so the port's version
(``ufm_torch/ops/gelu.py``: the op ``ufm_torch::gelu_bf16``, whose CPU
implementation is the plain version) flushes at the same places. These tests
hold it over every finite bf16 input (65,280 values), bit for bit, with no
exception.

``tests/golden/gelu_bf16_table.npz`` is the contract that the card, which
has no JAX, holds the kernel to (``chip_smoke.py``'s ``gelu`` phase and
``tests/test_torch_port_gpu.py``): ``y_bits`` (uint16, 65,536) is
``fast_exact_gelu`` of the bf16 value whose bits are the index, computed by
the JAX package on the CPU; ``finite`` marks the finite inputs (NaN and inf
outputs are not held). Regenerate it (after an intended numerics change in
the JAX package) with ``PYTHONPATH=. python tests/test_torch_port_gelu.py``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ufm_tpu.ops.gelu import fast_erfc_f32 as jax_fast_erfc_f32
from ufm_tpu.ops.gelu import fast_exact_gelu as jax_fast_exact_gelu
from ufm_torch.models import UniFlowMatchConfidence, ufm_tiny_config
from ufm_torch.nn.layers import gelu_exact
from ufm_torch.ops import gelu, launches, library

TABLE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "gelu_bf16_table.npz")
SMALLEST_NORMAL = 2.0**-126


def _all_bf16():
    """Every bf16 bit pattern, as a torch tensor, its bits and its finite mask."""
    bits = np.arange(65536, dtype=np.uint16)
    x = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    return x, bits, torch.isfinite(x).numpy()


def _all_finite_bf16():
    x, bits, finite = _all_bf16()
    return x[torch.from_numpy(finite)], bits[finite]


def _jax_bits(fn, bits: np.ndarray) -> np.ndarray:
    x = jax.lax.bitcast_convert_type(jnp.asarray(bits), jnp.bfloat16)
    return np.asarray(jax.lax.bitcast_convert_type(fn(x), jnp.uint16))


def _jax_gelu_bits(bits: np.ndarray) -> np.ndarray:
    return _jax_bits(lambda x: jax.nn.gelu(x, approximate=False), bits)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16)


def jax_table() -> dict:
    """The table's arrays, computed by the JAX package on the CPU."""
    x, bits, finite = _all_bf16()
    return {"y_bits": _jax_bits(jax_fast_exact_gelu, bits), "finite": finite}


def write_table(path: str = TABLE) -> str:
    np.savez_compressed(path, **jax_table())
    return path


def _table() -> dict:
    with np.load(TABLE) as z:
        return {k: z[k] for k in z.files}


def test_gelu_exact_bf16_matches_jax_over_every_finite_input():
    """``gelu_exact`` on bf16 is the JAX package's ``fast_exact_gelu`` and
    ``jax.nn.gelu`` on every finite input: 0 mismatches, subnormal
    neighbourhoods included (XLA's flushes are reproduced)."""
    x, bits = _all_finite_bf16()
    assert x.numel() == 65280
    got = gelu_exact(x)
    assert got.dtype == torch.bfloat16
    references = {"fast_exact_gelu": _jax_bits(jax_fast_exact_gelu, bits), "jax.nn.gelu": _jax_gelu_bits(bits)}
    for name, want in references.items():
        differ = _bits(got) != want
        assert int(differ.sum()) == 0, f"{int(differ.sum())} differ from {name}: {x[torch.from_numpy(differ)][:8]}"
    # the inputs where the flushes decide the bits: a subnormal 0.5 x, or an
    # erfc flushed to 0 at the tail's end; all of them match above
    half = x.float() * 0.5
    assert int(((half.abs() > 0) & (half.abs() < SMALLEST_NORMAL)).sum()) > 250
    assert (got[x.float() < -13.0] == 0).all()


def test_f_gelu_on_bf16_is_not_the_jax_chain():
    """Why gelu_exact does not call F.gelu on bf16: F.gelu rounds once, and
    differs from jax.nn.gelu on normal results."""
    x, bits = _all_finite_bf16()
    want = torch.from_numpy(_jax_gelu_bits(bits).view(np.int16).copy()).view(torch.bfloat16).float()
    plain = F.gelu(x, approximate="none").float()
    normal = (plain.abs() >= SMALLEST_NORMAL) | (want.abs() >= SMALLEST_NORMAL)
    assert ((plain != want) & normal).sum() > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gelu_exact_other_dtypes_is_f_gelu(dtype):
    x = torch.linspace(-6, 6, 4097, dtype=dtype)
    torch.testing.assert_close(gelu_exact(x), F.gelu(x, approximate="none"), rtol=0, atol=0)
    np.testing.assert_allclose(
        gelu_exact(x.float()).numpy(), np.asarray(jax.nn.gelu(x.float().numpy(), approximate=False)),
        rtol=0, atol=1e-6,
    )


def test_gelu_exact_bf16_gradient_is_finite_and_close_to_fp32():
    """The op is differentiable through autograd (bf16 training on the
    card): its gradient stays within bf16 rounding of the fp32 GELU's."""
    x32 = torch.linspace(-6, 6, 4097, dtype=torch.float32)
    x = x32.to(torch.bfloat16).requires_grad_(True)
    gelu_exact(x).float().sum().backward()
    ref = x32.to(torch.bfloat16).float().requires_grad_(True)
    F.gelu(ref, approximate="none").sum().backward()
    assert torch.isfinite(x.grad).all()
    torch.testing.assert_close(x.grad.float(), ref.grad, rtol=0, atol=2e-2)


@pytest.fixture
def one_thread():
    """One intra-op thread for tests that run the plain GELU gradient (~400
    elementwise ops) on every bf16 input: the threads' synchronisation
    dominates such ops where the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_gelu_exact_bf16_backward_is_f_gelu_backward_on_the_saved_input(one_thread):
    """The op's backward is one op on the saved input, the input the only
    tensor kept for it (autograd through the plain chain would keep three
    intermediates of the hidden activation), and its bf16 gradient is the
    JAX package's (``jax.vjp`` of ``fast_exact_gelu``) bit for bit, where
    ``F.gelu``'s exact derivative, rounded once, is not."""
    x, bits = _all_finite_bf16()
    x = x.clone().requires_grad_(True)
    y = gelu_exact(x)
    (saved,) = y.grad_fn.saved_tensors
    assert torch.equal(saved, x)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    (got,) = torch.autograd.grad(y, x, g)
    vjp = jax.jit(lambda a, c: jax.vjp(jax_fast_exact_gelu, a)[1](c)[0])
    want = np.asarray(jax.lax.bitcast_convert_type(
        vjp(jax.lax.bitcast_convert_type(jnp.asarray(bits), jnp.bfloat16),
            jax.lax.bitcast_convert_type(jnp.asarray(_bits(g)), jnp.bfloat16)), jnp.uint16))
    want_t = torch.from_numpy(want.view(np.int16).copy()).view(torch.bfloat16)
    nan = torch.isnan(got) & torch.isnan(want_t)
    assert int(((_bits(got) != want) & ~nan.numpy()).sum()) == 0
    assert np.array_equal(_bits(got), _bits(gelu.fast_exact_gelu_vjp_reference(x.detach(), g)))
    f_gelu = torch.ops.aten.gelu_backward(g, x.detach(), approximate="none")
    assert int((_bits(f_gelu) != want).sum()) > 0


def test_gelu_exact_bf16_without_grad_is_the_same_chain():
    x, _ = _all_finite_bf16()
    with torch.no_grad():
        plain = gelu_exact(x)
    tracked = gelu_exact(x.clone().requires_grad_(True)).detach()
    assert torch.equal(plain.view(torch.int16), tracked.view(torch.int16))


def test_fast_erfc_f32_matches_jax_on_every_bf16_input():
    """The port's polynomial erfc against the JAX package's on every bf16
    value (fp32 in), compared after rounding to bf16: equal bits at every
    finite input, through the flushed tail."""
    x, bits, finite = _all_bf16()
    got = _bits(gelu.fast_erfc_f32(x.float()).to(torch.bfloat16))
    want = _jax_bits(lambda v: jax_fast_erfc_f32(v.astype(jnp.float32)).astype(jnp.bfloat16), bits)
    differ = (got != want) & finite
    assert int(differ.sum()) == 0, x[torch.from_numpy(differ)][:8]
    assert (gelu.fast_erfc_f32(torch.tensor([9.25, 9.5, 30.0, 1e30])) == 0).all()  # flushed where XLA flushes


def test_committed_table_is_the_jax_package_output():
    """The committed table cannot drift from the JAX package."""
    table, fresh = _table(), jax_table()
    assert set(table) == set(fresh) == {"y_bits", "finite"}
    assert table["y_bits"].dtype == np.uint16 and table["y_bits"].shape == (65536,)
    assert int(table["finite"].sum()) == 65280
    for k in fresh:
        np.testing.assert_array_equal(table[k], fresh[k], err_msg=k)


def test_plain_version_equals_the_table():
    """The plain version (the op's CPU implementation) on all 65,536 bit
    patterns: the table's bits at every finite input, NaN where the table
    has NaN."""
    table = _table()
    x, _, finite = _all_bf16()
    got = gelu.fast_exact_gelu_reference(x)
    got_bits = _bits(got)
    assert int((got_bits != table["y_bits"])[finite].sum()) == 0
    want = torch.from_numpy(table["y_bits"].view(np.int16).copy()).view(torch.bfloat16)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert np.array_equal(_bits(library.gelu_bf16(x))[finite], got_bits[finite])


def test_plain_version_takes_any_layout_and_refuses_other_dtypes():
    """A non-contiguous, a misaligned (offset) and an empty CPU tensor go
    through the op; fp32 is refused by the entry point, the op and the
    plain version; the kernel wrapper refuses a CPU tensor."""
    g = torch.Generator().manual_seed(3)
    base = (torch.randn(6, 40, generator=g) * 4).to(torch.bfloat16)
    for x in (base.t(), base[:, 1:], base.view(-1)[3:].view(-1), base[:0]):
        got = gelu.gelu_bf16(x)
        assert got.shape == x.shape
        assert np.array_equal(_bits(got.contiguous()), _bits(gelu.fast_exact_gelu_reference(x.contiguous())))
    with pytest.raises(ValueError, match="bfloat16"):
        gelu.gelu_bf16(base.float())
    with pytest.raises(ValueError, match="bfloat16"):
        library.gelu_bf16(base.float())
    with pytest.raises(ValueError, match="bfloat16"):
        gelu.fast_exact_gelu_reference(base.float())
    before = gelu.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        gelu.launch(base)
    assert gelu.LAUNCHES == before


def _bf16_tiny_model():
    return UniFlowMatchConfidence.from_config(ufm_tiny_config(compute_dtype="bfloat16"), device="cpu")


def _normalized_pair(model, seed):
    w, h = model.inference_resolution[0]
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((1, h, w, 3)).astype(np.float32)) for _ in range(2)]


def test_cpu_forward_launches_nothing():
    """A tiny bf16 model's CPU forward runs the plain version of the fused
    fc1 + GELU op in every MLP: no counter moves, and every block's MLP
    reaches fc2 with a bf16 hidden activation."""
    model = _bf16_tiny_model()
    x, y = _normalized_pair(model, seed=4)
    before = launches.snapshot()
    seen = []
    handles = [m.register_forward_hook(lambda mod, inp, out: seen.append(inp[0])) for n, m in model.net.named_modules()
               if n.endswith("mlp.fc2")]
    try:
        with torch.no_grad():
            out = model.net(x, y)
    finally:
        for h in handles:
            h.remove()
    assert launches.since(before) == dict.fromkeys(launches.COUNTERS, 0)
    cfg = model.config
    assert len(seen) == cfg.encoder_kwargs["depth"] + cfg.info_sharing_kwargs["depth"]
    assert all(t.dtype == torch.bfloat16 for t in seen)
    assert all(torch.isfinite(v).all() for v in out.values())


def test_exported_bf16_model_has_one_gelu_node_per_mlp(tmp_path):
    """``torch.export`` on the CPU of a tiny bf16 UFM-Base: one GELU node per
    transformer block's MLP, the fused ``ufm_torch::linear_gelu_bf16`` (fc1
    with the GELU as its epilogue; the trace records no gradient), named in
    the manifest's ops, no standalone ``ufm_torch::gelu_bf16``, and the
    loaded artifact answers bitwise as the live network."""
    from ufm_torch.runtime import export_model, load_exported

    model = _bf16_tiny_model()
    path = str(tmp_path / "tiny_bf16.ufmt")
    manifest = export_model(model, path)
    art = load_exported(path, device="cpu")
    targets = [n.target for n in art.program.graph.nodes if n.op == "call_function"]
    cfg = model.config
    layers = cfg.encoder_kwargs["depth"] + cfg.info_sharing_kwargs["depth"]
    assert targets.count(library.linear_gelu_bf16) == layers
    assert targets.count(library.gelu_bf16) == 0
    assert targets.count(library.flash_attention_fwd) == layers
    assert str(library.linear_gelu_bf16) in manifest["ops"] and str(library.gelu_bf16) not in manifest["ops"]
    x, y = _normalized_pair(model, seed=5)
    got = art(x, y)
    with torch.no_grad():
        want = model.net(x, y)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    p = write_table()
    print(f"wrote {p} ({os.path.getsize(p)} bytes)")
