"""The bf16 GELU's gradient and the fused fc1 + GELU op's training route
(``ufm_torch/ops/gelu.py``, ``ufm_torch/ops/library.py``) on the CPU,
against the JAX package's ``jax.vjp`` of ``fast_exact_gelu``.

The JAX package trains through the VJP of ``fast_exact_gelu`` as XLA's CPU
compiles it (one fused loop: its roundings, its fused multiply-adds, its
flushes of subnormal operands and results). The port's plain version
``fast_exact_gelu_vjp_reference`` spells that program out op by op, and is
held here bit for bit (NaN equal to NaN) on every finite bf16 input under
six cotangent sets: unit cotangents, four sets of numpy standard normals
(seeds 0 to 3) and one set of normals scaled by 10^U(-40, 37) (seed 4: the
flushes and the overflows). ``aten.gelu_backward``, the exact derivative
rounded once, which the port used before, differs from it on thousands of
inputs of each set.

``tests/golden/gelu_bf16_vjp_table.npz`` is the contract that the card, which
has no JAX, holds the kernel ``csrc/gelu_bf16_bwd.cu`` to (``chip_smoke.py``'s
``gelu_backward`` phase): ``g_bits`` (6, 65,536) the cotangents' bf16 bits,
``dx_bits`` (6, 65,536) JAX's gradient at the bf16 value whose bits are the
column index, ``finite`` the finite inputs, ``sets`` the sets' names.
Regenerate it with ``PYTHONPATH=. python tests/test_torch_port_gelu_vjp.py``.

Also here: a model of the kernel's branch-only evaluation against the plain
version (every bit pattern, zero and signed-zero cotangents too); the fp64
rounding of the tail's transcendentals; the ops' gradients and the fused
op's autograd against the two-op route bit for bit; a tiny bf16 MLP and
transformer block against the JAX package's in gradients; every remat
policy on a tiny bf16 UFMNet bitwise no remat, with the ops each one calls.
"""

import os

import jax
import jax.numpy as jnp
import mpmath
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from torch_port_seeded import net_params
from ufm_tpu.checkpoint.convert import flatten_params
from ufm_tpu.models import UFMNet as JNet
from ufm_tpu.models import ufm_tiny_config as jax_tiny_config
from ufm_tpu.nn.layers import Mlp as JaxMlp
from ufm_tpu.nn.layers import TransformerBlock as JBlock
from ufm_tpu.ops.gelu import fast_exact_gelu as jax_fast_exact_gelu
from ufm_torch.checkpoint import jax_params_to_state_dict, load_jax_params
from ufm_torch.models import UFMNet, ufm_tiny_config
from ufm_torch.nn.layers import REMAT_POLICIES, Mlp, TransformerBlock
from ufm_torch.ops import gelu, launches, library
from ufm_torch.ops.gelu import _CLAMP, _LN2, _LOG2E, _MAIN, _SAT, _SQRT_HALF_BF16, _TAIL, _flush, _fma
from ufm_torch.training import synthetic_batch, ufm_total_loss

TABLE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "gelu_bf16_vjp_table.npz")
SETS = ("unit", "normal_0", "normal_1", "normal_2", "normal_3", "wide_4")
# the port's MLP / block gradients against the JAX package's, relative L2:
# the two round fc1's bias at different places (one ulp of h at most), which
# the GELU's gradient and the products carry on; the block's attention and
# LayerNorms round at other places too (at most 8e-3 for the MLP, 1.2e-2
# for the block, measured here)
JAX_GRAD_REL_L2 = 2e-2
H, W = 42, 56  # the tiny UFMNet's input (tests/test_torch_port_remat.py)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy().view(np.uint16)


def _bf16(bits: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)


def _all_bf16():
    bits = np.arange(65536, dtype=np.uint16)
    return _bf16(bits), bits


def cotangents(name: str) -> np.ndarray:
    """A cotangent set's bf16 bits, one cotangent a bf16 bit pattern."""
    if name == "unit":
        g = np.ones(65536, np.float32)
    else:
        rng = np.random.default_rng(int(name.rsplit("_", 1)[1]))
        g = rng.standard_normal(65536)
        if name.startswith("wide"):
            g = g * 10.0 ** rng.uniform(-40, 37, 65536)
        g = g.astype(np.float32)
    return _bits(torch.from_numpy(g).to(torch.bfloat16))


@jax.jit
def _jax_vjp(x, g):
    return jax.vjp(jax_fast_exact_gelu, x)[1](g)[0]


def jax_vjp_bits(g_bits: np.ndarray) -> np.ndarray:
    """``jax.vjp(fast_exact_gelu)`` at every bf16 bit pattern under the
    cotangents ``g_bits``, as bf16 bits."""
    x = jax.lax.bitcast_convert_type(jnp.asarray(np.arange(65536, dtype=np.uint16)), jnp.bfloat16)
    g = jax.lax.bitcast_convert_type(jnp.asarray(g_bits), jnp.bfloat16)
    return np.asarray(jax.lax.bitcast_convert_type(_jax_vjp(x, g), jnp.uint16))


def jax_table() -> dict:
    g = np.stack([cotangents(n) for n in SETS])
    x, _ = _all_bf16()
    return {"sets": np.array(SETS), "g_bits": g, "dx_bits": np.stack([jax_vjp_bits(r) for r in g]),
            "finite": torch.isfinite(x).numpy()}


def write_table(path: str = TABLE) -> str:
    np.savez_compressed(path, **jax_table())
    return path


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain VJP is ~400 elementwise ops on 65,536 elements: each one
    splits across the intra-op threads, whose synchronisation dominates
    them where the suite's workers share the cores; one thread keeps each
    call near 0.1 s."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def table():
    with np.load(TABLE) as z:
        return {k: z[k] for k in z.files}


def _differ(got_bits: np.ndarray, want_bits: np.ndarray, mask=None) -> int:
    """Elements whose bits differ, NaN counted equal to NaN."""
    nan = (torch.isnan(_bf16(got_bits)) & torch.isnan(_bf16(want_bits))).numpy()
    differ = (got_bits != want_bits) & ~nan
    return int((differ if mask is None else differ & mask).sum())


# ---- the plain version against JAX -----------------------------------------
@pytest.mark.parametrize("name", SETS)
def test_plain_vjp_is_jax_vjp_bit_for_bit(name):
    """Every finite bf16 input under the set's cotangents: the plain version
    is the JAX package's VJP; F.gelu's derivative is not."""
    x, _ = _all_bf16()
    finite = torch.isfinite(x).numpy()
    g_bits = cotangents(name)
    want = jax_vjp_bits(g_bits)
    g = _bf16(g_bits)
    assert _differ(_bits(gelu.fast_exact_gelu_vjp_reference(x, g)), want, finite) == 0
    assert _differ(_bits(torch.ops.aten.gelu_backward(g, x, approximate="none")), want, finite) > 1000


def test_committed_vjp_table_is_the_jax_package_output(table):
    """The committed table cannot drift from the seeds or from JAX."""
    fresh = jax_table()
    assert set(table) == set(fresh)
    assert table["dx_bits"].dtype == np.uint16 and table["dx_bits"].shape == (len(SETS), 65536)
    assert int(table["finite"].sum()) == 65280
    for k in fresh:
        np.testing.assert_array_equal(table[k], fresh[k], err_msg=k)


def test_plain_vjp_equals_the_table_at_every_bit_pattern(table):
    """Through the op on CPU tensors: the table's bits at every finite
    input of every set; a non-finite input gives NaN, as JAX's does."""
    x, _ = _all_bf16()
    finite = table["finite"]
    for name, g_bits, want in zip(SETS, table["g_bits"], table["dx_bits"]):
        got = library.gelu_bf16_bwd(_bf16(g_bits), x)
        assert _differ(_bits(got), want, finite) == 0, name
        assert torch.isnan(got[torch.from_numpy(~finite)]).all(), name


# ---- the kernel's design ----------------------------------------------------
def kernel_model(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """csrc/gelu_bf16_bwd.cu's arithmetic, element by element in torch:
    each element evaluates only the branch it selects (the masks stand for
    the kernel's branches), the other branches' zeros by the kernel's rules."""
    def bf16(v):
        return v.to(torch.bfloat16).float()

    f = _flush
    xf, gf = f(x.float()), f(g.float())
    out = torch.empty_like(xf)
    t = f(-xf * _SQRT_HALF_BF16)
    ta = t.abs()
    tc = torch.clamp(ta, max=_CLAMP)
    u = f(tc * tc)
    h = bf16(f(xf * 0.5))
    sat, tail = t <= -_SAT, t > _SAT
    main = ~sat & ~tail

    def half_share(gm, e):
        return bf16(f(bf16(f(gm * e)) * 0.5))

    def finish(dx_h, d_t):
        return f(dx_h - bf16(f(bf16(d_t) * _SQRT_HALF_BF16)))

    out[sat] = half_share(gf[sat], 2.0)
    # main: the transposed chain from a +0 cotangent of u
    tm, um, gm = t[main], u[main], gf[main]
    hp = [torch.full_like(um, _MAIN[-1])]
    for c in _MAIN[-2::-1]:
        hp.append(_fma(hp[-1], um, c))
    dx_h = half_share(gm, bf16(_fma(-tm, hp[8], 1.0)))
    g_p = -f(h[main] * gm)
    g_t = f(tm * g_p)
    g_u = torch.zeros_like(um)
    for k in range(8):
        g_u = _fma(hp[7 - k], g_t, g_u)
        g_t = f(g_t * um)
    g_tc = f(tc[main] * g_u)
    g_ta = f(g_tc + g_tc)
    nonneg = tm >= 0
    d_t = f(_fma(g_p, hp[8], torch.where(nonneg, g_ta, 0.0)) + torch.where(nonneg, -0.0, -g_ta))
    out[main] = finish(dx_h, d_t)
    # tail
    tm, um, gm = t[tail], u[tail], gf[tail]
    ex = f(torch.exp(-um.double()).float())
    inv = (1.0 / torch.sqrt(um.double())).float()
    ex_inv = f(ex * inv)
    hq = [torch.full_like(um, _TAIL[-1])]
    for c in _TAIL[-2::-1]:
        hq.append(_fma(hq[-1], inv, c))
    dx_h = half_share(gm, bf16(f(ex_inv * hq[5])))
    g_e = f(h[tail] * gm)
    g_ex_inv = f(g_e * hq[5])
    g_q = f(ex_inv * g_e)
    g_inv = _fma(ex, g_ex_inv, f(hq[4] * g_q))
    for k in range(1, 5):
        g_q = f(g_q * inv)
        g_inv = _fma(hq[4 - k], g_q, g_inv)
    d_exp = f(f(f(g_ex_inv * inv) * _LN2) * ex)
    g_u = _fma(-d_exp, _LOG2E, f(g_inv * f(f(inv / um) * -0.5)))
    hp = torch.full_like(um, _MAIN[-1])
    negative = torch.zeros_like(um, dtype=torch.bool)
    for c in _MAIN[-2:0:-1]:
        hp = _fma(hp, um, c)
        negative |= hp < 0
    g_u = torch.where((g_u == 0) & negative, 0.0, g_u)
    g_tc = f(tc[tail] * g_u)
    share = torch.where(ta[tail] < _CLAMP, 1.0, torch.where(ta[tail] == _CLAMP, 0.5, 0.0))
    out[tail] = finish(dx_h, f(f(g_tc + g_tc) * share))
    out[~torch.isfinite(xf)] = torch.nan
    return out.to(torch.bfloat16)


def _model_sets():
    rng = np.random.default_rng(40)
    normal = rng.standard_normal(65536)
    zeros = np.where(rng.uniform(size=65536) < 0.5, 0.0, -0.0)
    extra = {
        "zero": np.zeros(65536), "negative_zero": -np.zeros(65536),
        "some_zeros": np.where(rng.uniform(size=65536) < 0.3, zeros, normal),
        "tiny": normal * 1e-36, "subnormal": normal * 1e-39, "huge": normal * 1e37,
    }
    return [*SETS, *extra], extra


@pytest.mark.parametrize("name", _model_sets()[0])
def test_kernel_branch_model_is_the_plain_vjp(name):
    """The kernel's branch-only evaluation (its signed zeros, its flushes,
    its non-finite rule) gives the plain version's bits at every bit
    pattern, under the table's sets and under zero, signed-zero, tiny,
    subnormal and huge cotangents."""
    extra = _model_sets()[1]
    x, _ = _all_bf16()
    g_bits = cotangents(name) if name in SETS else _bits(torch.from_numpy(extra[name].astype(np.float32)).bfloat16())
    g = _bf16(g_bits)
    want = _bits(gelu.fast_exact_gelu_vjp_reference(x, g))
    assert _differ(_bits(kernel_model(g, x)), want) == 0
    finite = torch.isfinite(x)
    assert np.array_equal(_bits(kernel_model(g, x))[finite.numpy()], want[finite.numpy()])


def test_tail_transcendentals_round_unambiguously():
    """The tail's exp(-u) and 1 / sqrt(u), at every u a finite bf16 input
    gives it, lie farther than 4 fp64 ulps from an fp32 rounding boundary:
    any fp64 evaluation within an ulp (the CPU's, the card's) rounds to the
    plain version's fp32 value, and that value is the correctly rounded one."""
    x, _ = _all_bf16()
    t = _flush(-x.float() * _SQRT_HALF_BF16)
    t = t[torch.isfinite(t) & (t > _SAT)]
    u = torch.unique(_flush(torch.clamp(t, max=_CLAMP) ** 2))
    ex = _flush(torch.exp(-u.double()).float())
    inv = (1.0 / torch.sqrt(u.double())).float()
    mpmath.mp.prec = 120
    checked = 0
    for ui, exi, invi in zip(u.tolist(), ex.tolist(), inv.tolist()):
        for exact, got in ((mpmath.exp(-mpmath.mpf(ui)), exi), (1 / mpmath.sqrt(mpmath.mpf(ui)), invi)):
            if exact < 2.0**-126:
                assert got == 0.0  # flushed where XLA's CPU flushes
                continue
            e = int(mpmath.floor(mpmath.log(exact, 2)))
            ulp32 = mpmath.mpf(2) ** (e - 23)
            boundary = (mpmath.floor(exact / ulp32 - 0.5) + 0.5) * ulp32
            nearest = min(abs(exact - boundary), abs(exact - boundary - ulp32))
            assert nearest > 4 * mpmath.mpf(2) ** (e - 52), (ui, float(exact))
            assert got == float(mpmath.nint(exact / ulp32) * ulp32), (ui, got, float(exact))
            checked += 1
    assert checked > 200


# ---- the ops' gradients -----------------------------------------------------
def _inputs(lead, k, n, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal((*lead, k)) * 2).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((rng.standard_normal((n, k)) * k**-0.5).astype(np.float32)).to(torch.bfloat16)
    b = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(torch.bfloat16)
    dy = torch.from_numpy(rng.standard_normal((*lead, n)).astype(np.float32)).to(torch.bfloat16)
    return x, w, b, dy


CASES = {"2d": ((16,), 64, 256), "3d": ((2, 9), 64, 128), "k_n_tails": ((5,), 48, 200), "tiny_mlp": ((2, 33), 48, 192)}


def test_gelu_op_gradient_is_the_plain_vjp():
    """The GELU op's autograd: the plain VJP at the saved input, bitwise,
    for a non-contiguous cotangent too."""
    x, _, _, _ = _inputs((6, 40), 1, 1, seed=2)
    x = (x[..., 0] * 3).requires_grad_(True)
    g = torch.from_numpy(np.random.default_rng(3).standard_normal((40, 6)).astype(np.float32)).bfloat16().t()
    (got,) = torch.autograd.grad(library.gelu_bf16(x), x, g)
    assert np.array_equal(_bits(got), _bits(gelu.fast_exact_gelu_vjp_reference(x.detach(), g)))


@pytest.mark.parametrize("case", list(CASES))
def test_fused_autograd_is_the_two_op_route(case):
    """The fused op under autograd against F.linear then the GELU op: y,
    dx, dw and db bit for bit, and the GELU's gradient at the saved h is the
    plain VJP (dh = plain VJP(h, dy) gives db)."""
    lead, k, n = CASES[case]
    x, w, b, dy = _inputs(lead, k, n, seed=len(case))
    fused = [t.clone().requires_grad_(True) for t in (x, w, b)]
    two = [t.clone().requires_grad_(True) for t in (x, w, b)]
    y = library.linear_gelu_bf16(*fused)
    y_two = library.gelu_bf16(F.linear(*two))
    assert np.array_equal(_bits(y), _bits(y_two))
    got = torch.autograd.grad(y, fused, dy)
    want = torch.autograd.grad(y_two, two, dy)
    for name, a, c in zip(("dx", "dw", "db"), got, want):
        assert a.dtype == torch.bfloat16 and a.shape == c.shape, name
        assert np.array_equal(_bits(a), _bits(c)), name
    dh = gelu.fast_exact_gelu_vjp_reference(F.linear(x, w, b), dy)
    assert np.array_equal(_bits(got[2]), _bits(dh.reshape(-1, n).sum(0)))


def test_fused_forward_keeps_x_w_and_h():
    """Under grad mode the fused op keeps x, w and the pre-activation h for
    its gradient, not its output; one call of the launch that writes h."""
    x, w, b, _ = _inputs((2, 9), 64, 128, seed=4)
    w = w.clone().requires_grad_(True)
    y = library.linear_gelu_bf16(x, w, b)
    saved = y.grad_fn.saved_tensors
    assert len(saved) == 3
    assert saved[0] is x or torch.equal(saved[0], x)
    assert torch.equal(saved[1], w.detach())
    assert torch.equal(saved[2], F.linear(x, w.detach(), b))


@pytest.mark.parametrize("case", ["gelu_bwd", "preact", "fused_grad"])
def test_opcheck(case):
    x, w, b, dy = _inputs((3, 5), 48, 64, seed=6)
    args = {
        "gelu_bwd": (library.gelu_bf16_bwd, (dy, F.linear(x, w, b))),
        "preact": (library.linear_gelu_bf16_preact, (x, w, b)),
        "fused_grad": (library.linear_gelu_bf16, (x, w.clone().requires_grad_(True), b.clone().requires_grad_(True))),
    }[case]
    result = torch.library.opcheck(*args)
    assert set(result.values()) == {"SUCCESS"}, result


def test_gradient_op_refusals():
    """fp32 and mismatched shapes are refused by the op, its fake and its
    entry point; the CUDA implementation refuses CPU tensors without
    counting a launch."""
    h = torch.zeros(4, 8, dtype=torch.bfloat16)
    for args, match in (((h.float(), h), "bfloat16"), ((h, h.float()), "bfloat16"), ((h, h[:2]), "shape")):
        with pytest.raises(ValueError, match=match):
            gelu.gelu_bf16_bwd(*args) if match == "bfloat16" else library.gelu_bf16_bwd(*args)
    with pytest.raises(ValueError, match="share a shape"):
        gelu.fast_exact_gelu_vjp_reference(h, h[:2])
    before = launches.snapshot()
    with pytest.raises(ValueError, match="CUDA"):
        gelu.launch_backward(h, h)
    assert launches.since(before) == dict.fromkeys(before, 0)


# ---- the port's modules against the JAX package's ----------------------------
def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.linalg.norm(got.float().numpy() - want) / np.linalg.norm(want))


def _jax_grads(module, params, x, dy):
    """x's and the parameters' gradients of a bf16 flax module's output
    under the cotangent ``dy`` (jax.vjp under jit, as the JAX package's
    train step runs it; fp32 parameters as the JAX package keeps them)."""
    @jax.jit
    def grads(p, a, c):
        return jax.vjp(lambda p_, a_: module.apply({"params": p_}, a_), p, a)[1](c)

    dp, dx = grads(params, jnp.asarray(x, jnp.bfloat16), jnp.asarray(dy, jnp.bfloat16))
    return dx, flatten_params(jax.tree_util.tree_map(np.asarray, dp))


def _port_grads(module, x, dy):
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    out = module(xt)
    out.backward(torch.from_numpy(dy).to(torch.bfloat16))
    return xt.grad, {n: p.grad for n, p in module.named_parameters()}


@pytest.mark.parametrize("kind", ["mlp", "block"])
def test_port_gradients_match_the_jax_module(kind):
    """A tiny bf16 Mlp and transformer block (the port's fused route) and
    the JAX package's, the same numpy weights: the input's and every
    parameter's gradient within JAX_GRAD_REL_L2."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 17, 32)).astype(np.float32)
    dy = rng.standard_normal((2, 17, 32)).astype(np.float32)
    if kind == "mlp":
        jmod, port = JaxMlp(hidden_dim=128, dtype=jnp.bfloat16), Mlp(32, 128)
    else:
        jmod, port = JBlock(num_heads=2, dtype=jnp.bfloat16), TransformerBlock(32, 2)
    params = jax.tree_util.tree_map(
        lambda v: (v + rng.normal(0.0, 0.1, v.shape)).astype(np.float32),
        jax.tree_util.tree_map(np.asarray, jmod.init(jax.random.PRNGKey(0), jnp.asarray(x, jnp.bfloat16))["params"]))
    load_jax_params(port, flatten_params(params))
    port = port.to(torch.bfloat16)
    want_dx, want = _jax_grads(jmod, params, x, dy)
    with _OpCalls() as calls:
        got_dx, got = _port_grads(port, x, dy)
    # the MLP's gradient through the GELU gradient in fc2's input-gradient epilogue
    assert calls.calls == {library.linear_gelu_bf16_preact: 1, library.gelu_bf16: 0, library.gelu_bf16_bwd: 0,
                           library.linear_gelu_bf16_bwd: 1}
    assert _rel(got_dx, want_dx) <= JAX_GRAD_REL_L2
    want = jax_params_to_state_dict(want)  # the port's names and layouts
    assert set(got) == set(want)
    for name, grad in got.items():
        assert _rel(grad, want[name].numpy()) <= JAX_GRAD_REL_L2, name


# ---- remat ----------------------------------------------------------------------
class _OpCalls(TorchDispatchMode):
    """Counts executions of the MLP's ops below autograd (a kept output read
    back by a checkpointing policy is no execution)."""

    OPS = (library.gelu_bf16, library.linear_gelu_bf16_preact, library.gelu_bf16_bwd, library.linear_gelu_bf16_bwd)

    def __init__(self):
        super().__init__()
        self.calls = dict.fromkeys(self.OPS, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.calls:
            self.calls[func] += 1
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def remat_net():
    flat = net_params(JNet(jax_tiny_config()), (H, W), seed=1)[1]
    batch = synthetic_batch(2, H, W, seed=3, device="cpu")

    def grads(**remat):
        net = UFMNet(ufm_tiny_config(compute_dtype="bfloat16", **remat))
        load_jax_params(net, flat)
        with _OpCalls() as counter:
            loss, _ = ufm_total_loss(net(batch["img1"], batch["img2"]), batch)
            loss.backward()
        return loss.detach(), {n: p.grad for n, p in net.named_parameters() if p.grad is not None}, counter.calls

    return grads, grads()


@pytest.mark.parametrize("policy", ["full", *REMAT_POLICIES])
def test_remat_policy_values_are_no_remat_bitwise(remat_net, policy):
    """A tiny bf16 UFMNet's loss and gradients under each remat policy are
    no remat's bit for bit (no remat runs the fused op, remat the two ops,
    whose CPU implementations give the same bits). No remat launches the
    fused op once a layer and the fused gradient (fc2's input gradient with
    the GELU's gradient) once a layer; under remat the standalone GELU runs
    once a layer and again in the backward unless the policy keeps its
    output, and the GELU's gradient op once a layer."""
    grads, (loss0, g0, calls0) = remat_net
    layers = 4  # 2 encoder and 2 info-sharing blocks
    assert calls0 == {library.gelu_bf16: 0, library.linear_gelu_bf16_preact: layers, library.gelu_bf16_bwd: 0,
                      library.linear_gelu_bf16_bwd: layers}
    loss, g, calls = grads(train_remat=True, train_remat_policy=None if policy == "full" else policy)
    runs = layers if policy == "everything_saveable" else 2 * layers
    assert calls == {library.gelu_bf16: runs, library.linear_gelu_bf16_preact: 0, library.gelu_bf16_bwd: layers,
                     library.linear_gelu_bf16_bwd: 0}
    assert torch.equal(loss, loss0)
    assert set(g) == set(g0)
    for n in g0:
        assert np.array_equal(_bits(g[n]) if g[n].dtype == torch.bfloat16 else g[n].numpy(),
                              _bits(g0[n]) if g0[n].dtype == torch.bfloat16 else g0[n].numpy()), n


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    p = write_table()
    print(f"wrote {p} ({os.path.getsize(p)} bytes)")
