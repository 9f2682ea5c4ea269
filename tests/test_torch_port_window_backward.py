"""The window refinement's backward on the CPU, against the JAX package.

- The closed-form plain backward (``window_refinement_backward_reference``,
  the formulas the backward kernel follows) against the JAX package's own
  backward, ``_fused_refinement_pallas_bwd`` (the XLA VJP of
  ``_fused_refinement_xla``), and against autograd over the plain forward,
  over the kernels' widened domain (C from 3 to 32, P from 1 to 9), with
  windows inside, across and wholly outside the border: each gradient
  within 1e-5 of the largest element of JAX's. On the same inputs the op's
  gradient path (``fused_refinement_attention`` -> the forward op -> its
  autograd formula, the backward op), with the flow requiring a gradient
  and not.
- The plain forward at the new widths and windows (C = 5, 32, 64; P = 7,
  9) against ``fused_refinement_attention(impl="xla")`` (residual 2e-5,
  log_softmax 2e-4, the bars of tests/test_window_dots.py).
- The backward op: its CPU implementation is the plain backward,
  ``torch.library.opcheck`` passes, its fake implementation refuses C = 65
  and P = 11 for tensors on the card.
- A tiny UFM-Refine train step reaches the backward op once and runs the
  plain forward only as the forward op's CPU implementation.
Inputs are made with numpy from a seed and fed to both packages.
"""

from concurrent.futures import ThreadPoolExecutor
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ufm_tpu.ops.refinement import _fused_refinement_pallas_bwd
from ufm_tpu.ops.refinement import fused_refinement_attention as jax_fused_refinement_attention
from ufm_torch.models import UniFlowMatchClassificationRefinement, ufm_tiny_config
from ufm_torch.ops import library
from ufm_torch.ops import window_refinement as wr
from ufm_torch.ops.refinement import fused_refinement_attention
from ufm_torch.training import make_optimizer, make_train_step, synthetic_batch

TEMPERATURE = 4.0
GRAD_REL = 1e-5  # each gradient within this of the largest element of JAX's
RES_ATOL, LS_ATOL = 2e-5, 2e-4
NAMES = ("dq", "df", "dflow", "dbias")


def _inputs(b, h, w, c, p, seed=0, scale=4.0):
    """Seeded numpy inputs and cotangents. Beside iid flows of ``scale`` px,
    one window of each image lies wholly outside it on each side, and two
    straddle the left and top borders."""
    rng = np.random.default_rng(seed)
    q, f = (rng.standard_normal((b, h, w, c)).astype(np.float32) for _ in range(2))
    flow = (rng.standard_normal((b, h, w, 2)) * scale).astype(np.float32)
    flow[:, 0, 0] = -500.0
    flow[:, -1, -1] = 1e6
    flow[:, 1, 1] = (-1.5 - p / 2, 0.25)
    flow[:, 2, 1] = (0.5, -3.0 - p / 2)
    bias = rng.standard_normal(p * p).astype(np.float32)
    g_res = rng.standard_normal((b, h, w, 2)).astype(np.float32)
    g_ls = rng.standard_normal((b, h, w, p, p)).astype(np.float32)
    return q, f, flow, bias, g_res, g_ls


def _close_to(got, want, name):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= GRAD_REL * max(np.abs(want).max(), 1.0), (name, err, np.abs(want).max())


# (C, P): every width and window of the test grid once (3 is no multiple of
# 4; 32 takes the 8-lane forward, 9 the 16-lane one)
CASES = [(3, 1), (4, 3), (8, 5), (16, 7), (32, 9)]
# XLA's backend optimisations are of no use to a graph that runs once, and
# take a third of the compile at P = 9
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _case_inputs(c, p):
    return _inputs(2, 9, 13, c, p, seed=10 * c + p)


# (C, P) of the plain forward at the new widths and windows
FORWARD_CASES = [(5, 7), (32, 9), (64, 9)]


def _forward_inputs(c, p):
    return _inputs(2, 9, 13, c, p, seed=c + p, scale=6.0)[:4]


@pytest.fixture(scope="module")
def jax_results():
    """By case: JAX's backward (``_fused_refinement_pallas_bwd``) at every
    case of CASES on ``_case_inputs``, and its XLA forward
    (``fused_refinement_attention(impl="xla")``) at every case of
    FORWARD_CASES on ``_forward_inputs``. Each is compiled once, and the
    compiles run side by side: XLA releases the GIL while it compiles, and
    the unrolled tap loops make each take seconds (run op by op, the same
    backward spends them on a hundred small compiles instead)."""
    lowered = {}
    for c, p in CASES:
        q, f, flow, bias, g_res, g_ls = map(jnp.asarray, _case_inputs(c, p))
        fn, args = partial(_fused_refinement_pallas_bwd, TEMPERATURE, p, "default"), ((q, f, flow, bias), (g_res, g_ls))
        lowered["bwd", c, p] = (jax.jit(fn).lower(*args), args)
    for c, p in FORWARD_CASES:
        fn = partial(jax_fused_refinement_attention, temperature=TEMPERATURE, local_patch=p, impl="xla")
        args = tuple(map(jnp.asarray, _forward_inputs(c, p)))
        lowered["fwd", c, p] = (jax.jit(fn).lower(*args), args)
    with ThreadPoolExecutor(len(lowered)) as pool:
        compiled = pool.map(lambda la: la[0].compile(compiler_options=FAST_COMPILE), lowered.values())
        return {key: run(*args) for (key, (_, args)), run in zip(lowered.items(), compiled)}


@pytest.mark.parametrize("c,p", CASES)
def test_backward_matches_jax(c, p, jax_results):
    """On the same inputs, against JAX's backward (``_fused_refinement_pallas_bwd``):
    the plain backward, also against autograd over the plain forward; and
    the op's gradient path (``fused_refinement_attention`` -> the forward
    op -> its autograd formula, the backward op) with the flow requiring a
    gradient (all four equal JAX's) and not (the flow gets none)."""
    q, f, flow, bias, g_res, g_ls = _case_inputs(c, p)
    want = jax_results["bwd", c, p]
    tq, tf, tflow, tbias, tg_res, tg_ls = map(torch.from_numpy, (q, f, flow, bias, g_res, g_ls))
    _, ls = wr.window_refinement_reference(tq, tf, tflow, tbias, TEMPERATURE, p)

    got = wr.window_refinement_backward_reference(tq, tf, tflow, tbias, ls, tg_res, tg_ls, TEMPERATURE, p)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tf, tflow, tbias)]
    auto = torch.autograd.grad(wr.window_refinement_reference(*leaves, TEMPERATURE, p), leaves, (tg_res, tg_ls))
    for name, g, w_jax, w_auto in zip(NAMES, got, want, auto):
        assert g.shape == w_auto.shape and g.dtype == torch.float32
        _close_to(g.numpy(), w_jax, name)
        _close_to(g.numpy(), w_auto.numpy(), name)
    # the windows wholly outside the image move no flow
    assert not got[2][:, 0, 0].any() and not got[2][:, -1, -1].any()

    for flow_grad in (True, False):
        leaves = [t.clone().requires_grad_(need) for t, need in zip((tq, tf, tflow, tbias), (True, True, flow_grad, True))]
        torch.autograd.backward(fused_refinement_attention(*leaves, TEMPERATURE, p), (tg_res, tg_ls))
        for name, leaf, w in zip(NAMES, leaves, want):
            if leaf.requires_grad:
                _close_to(leaf.grad.numpy(), w, name)
            else:
                assert leaf.grad is None


@pytest.mark.parametrize("c,p", FORWARD_CASES)
def test_plain_forward_matches_jax_at_the_new_shapes(c, p, jax_results):
    want_res, want_ls = jax_results["fwd", c, p]
    res, ls = wr.window_refinement_reference(*map(torch.from_numpy, _forward_inputs(c, p)), TEMPERATURE, p)
    np.testing.assert_allclose(res.numpy(), np.asarray(want_res), atol=RES_ATOL, rtol=0)
    np.testing.assert_allclose(ls.numpy(), np.asarray(want_ls), atol=LS_ATOL, rtol=0)


def _op_args(c=6, p=3):
    q, f, flow, bias, g_res, g_ls = map(torch.from_numpy, _inputs(1, 5, 7, c, p, seed=1))
    _, ls = wr.window_refinement_reference(q, f, flow, bias, TEMPERATURE, p)
    return q, f, flow, bias, ls, g_res, g_ls, TEMPERATURE, p


def test_backward_op_on_the_cpu_is_the_plain_backward():
    args = _op_args()
    before = wr.BWD_LAUNCHES
    for got, want in zip(library.window_refinement_bwd(*args), wr.window_refinement_backward_reference(*args)):
        assert torch.equal(got, want)
    assert wr.BWD_LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        wr.launch_backward(*args)


def test_backward_opcheck():
    result = torch.library.opcheck(library.window_refinement_bwd, _op_args())
    assert set(result.values()) == {"SUCCESS"}, result


def test_fake_implementations_hold_the_kernels_domain_on_the_card():
    """C <= 64 and odd P <= 9 pass for tensors on the card, C = 65 and
    P = 11 raise naming the limit; on the CPU (the plain versions) both
    pass."""
    with FakeTensorMode():
        for c, p, match in ((64, 9, None), (65, 5, "C <= 64"), (16, 11, "P <= 9")):
            q = torch.empty(1, 4, 5, c, device="cuda")
            flow, bias = torch.empty(1, 4, 5, 2, device="cuda"), torch.empty(p * p, device="cuda")
            ls = torch.empty(1, 4, 5, p, p, device="cuda")
            calls = (lambda: library.window_refinement(q, q, flow, bias, TEMPERATURE, p),
                     lambda: library.window_refinement_bwd(q, q, flow, bias, ls, flow, ls, TEMPERATURE, p))
            for call in calls:
                if match is None:
                    call()
                else:
                    with pytest.raises(ValueError, match=match):
                        call()
        q = torch.empty(1, 4, 5, 65)
        dq, df, dflow, dbias = library.window_refinement_bwd(q, q, torch.empty(1, 4, 5, 2), torch.empty(121),
                                                             torch.empty(1, 4, 5, 11, 11), torch.empty(1, 4, 5, 2),
                                                             torch.empty(1, 4, 5, 11, 11), TEMPERATURE, 11)
        assert dq.shape == df.shape == q.shape and dflow.shape == (1, 4, 5, 2) and dbias.shape == (121,)


def test_tiny_refine_train_step_takes_the_backward_op(monkeypatch):
    """One train step of a tiny UFM-Refine on the CPU: the refinement's
    backward is one call of the backward op; the plain forward runs once,
    as the forward op's CPU implementation, and never again for a
    gradient."""
    cfg = ufm_tiny_config(has_classification_head=True, use_unet_feature=True,
                          unet_kwargs={"out_channels": 8, "features": (8, 16)})
    model = UniFlowMatchClassificationRefinement.from_config(cfg, seed=0, device="cpu")
    h, w = (int(x) for x in model.inference_resolution[0][::-1])
    batch = synthetic_batch(1, h, w, seed=0, device="cpu")
    step = make_train_step(model.net, make_optimizer(model.net, learning_rate=1e-4, warmup_steps=0, total_steps=10))
    calls = {"forward": 0, "backward": 0}
    forward, backward = wr.window_refinement_reference, wr.window_refinement_backward_reference

    def counted_forward(*a, **k):
        calls["forward"] += 1
        return forward(*a, **k)

    def counted_backward(*a, **k):
        calls["backward"] += 1
        return backward(*a, **k)

    monkeypatch.setattr(wr, "window_refinement_reference", counted_forward)
    monkeypatch.setattr(wr, "window_refinement_backward_reference", counted_backward)
    metrics = step(batch)
    assert calls == {"forward": 1, "backward": 1}
    assert np.isfinite(metrics["refinement_loss"].item())


def test_staged_tiles_only_at_the_widths_the_kernel_stages():
    """The forward kernel stages a tile's taps only at C <= 16 with C a
    multiple of 4 (a tensor map of f; two boxes in shared memory):
    ``staged_tiles`` counts none elsewhere, the same tiles at every staged
    width."""
    flow = torch.zeros(1, 16, 64, 2)  # every tile's taps fit the box
    tiles = wr.tile_count(1, 16, 64)
    assert [wr.staged_tiles(flow, 5, c) for c in (4, 8, 12, 16)] == [tiles] * 4
    assert [wr.staged_tiles(flow, 5, c) for c in (3, 5, 20, 32, 64)] == [0] * 5


def _motion_flow(b, h, w, kind, rng):
    """(B, H, W, 2) xy flows: iid noise of 4 px; a smooth affine motion
    (scale 1.05, 3 degrees, a shift) plus noise of 0.5 px; the same with the
    pixels below the diagonal moved 12 px further along y (an occlusion
    edge); or "edges"' windows across and wholly outside the border."""
    if kind == "edges":
        return _inputs(b, h, w, 1, 5, seed=3)[2]
    noise = rng.standard_normal((b, h, w, 2)).astype(np.float32)
    if kind == "iid":
        return 4.0 * noise
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32), indexing="ij")
    a, s = np.radians(3.0), 1.05
    dx, dy = xs - (w - 1) / 2, ys - (h - 1) / 2
    fx = s * (np.cos(a) * dx - np.sin(a) * dy) - dx + 6.0
    fy = s * (np.sin(a) * dx + np.cos(a) * dy) - dy - 3.0
    if kind == "split":
        fy = fy + 12.0 * (ys / h > xs / w)
    return np.stack([fx, fy], axis=-1)[None] + 0.5 * noise


# the windows at which the backward kernel gathers df (csrc/window_refinement_bwd.cu)
GATHER_P = (1, 3, 5)


def _df_by_boxes(q, f, flow, bias, log_softmax, g_res, g_ls, temperature, p):
    """A plain model of the backward kernel's df accumulation, in fp64: each
    tile of ``TILE`` pixels whose taps fit one ``BOX`` (the forward's fit
    rule, at the widths the kernels stage) is staged. In a staged tile at P
    in GATHER_P, the least pixel (by index in the tile) at each tap origin
    owns it: the owners' df terms are summed over a box at
    the tile's least tap origin, taps outside the image included (the kernel
    sums each box pixel over the owned origins whose windows cover it), and
    then the box's pixels inside the image are added into df; every other
    pixel adds its in-image taps into df directly. Returns (df, staged tiles,
    pixels whose terms a box took)."""
    b, h, w, c = f.shape
    r, k = (p - 1) // 2, p + 3
    q, f = q.double(), f.double()
    pos_x, pos_y = wr._sample_positions(flow, p)
    x0, y0 = torch.floor(pos_x), torch.floor(pos_y)
    wx = torch.stack(wr.cubic_weights((pos_x - x0).double()), dim=-1)
    wy = torch.stack(wr.cubic_weights((pos_y - y0).double()), dim=-1)
    a = torch.exp(log_softmax.double()).reshape(b, h, w, p * p)
    offs = wr.neighborhood_offsets_xy(p).double().reshape(p * p, 2)
    g = g_ls.double().reshape(b, h, w, p * p)
    g_s = a * ((offs - (a @ offs)[..., None, :]) * g_res.double()[..., None, :]).sum(-1) + g - a * g.sum(-1, keepdim=True)
    ddots = wr._spread((g_s / temperature).reshape(b, h, w, p, p), wy, wx, k)  # (B, H, W, K, K)
    xb, yb = x0.long() - r - 1, y0.long() - r - 1

    # each pixel's tile and index in it, and each tile's least and greatest tap origin
    tw, th = wr.TILE
    ty, tx = -(-h // th), -(-w // tw)
    ys, xs = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    tile = (torch.arange(b)[:, None, None] * ty + ys // th) * tx + xs // tw
    index = ((ys % th) * tw + xs % tw).expand(b, h, w)
    n_tiles = b * ty * tx
    lo = [torch.full((n_tiles,), 2**40).scatter_reduce(0, tile.flatten(), o.flatten(), "amin") for o in (xb, yb)]
    hi = [torch.full((n_tiles,), -2**40).scatter_reduce(0, tile.flatten(), o.flatten(), "amax") for o in (xb, yb)]
    fits = (hi[0] - lo[0] + k <= wr.BOX[0]) & (hi[1] - lo[1] + k <= wr.BOX[1]) & (c <= 16 and c % 4 == 0)
    # each pixel's rank among the pixels of its tile at its tap origin
    key = (tile * 2**20 + (yb - lo[1][tile]) * 2**10 + xb - lo[0][tile]).flatten()
    order = torch.argsort(key * 2**10 + index.flatten())
    sorted_key = key[order]
    starts = torch.ones_like(sorted_key, dtype=torch.bool)
    starts[1:] = sorted_key[1:] != sorted_key[:-1]
    first = torch.cummax(torch.where(starts, torch.arange(len(key)), 0), 0).values
    rank = torch.empty_like(order)
    rank[order] = torch.arange(len(key)) - first
    staged = fits[tile] & (rank.reshape(b, h, w) == 0) & (p in GATHER_P)  # (B, H, W): terms to a box

    df = torch.zeros(b * h * w, c, dtype=torch.float64)
    boxes = torch.zeros(n_tiles * wr.BOX[1] * wr.BOX[0], c, dtype=torch.float64)
    img = torch.arange(b)[:, None, None].expand(b, h, w)
    for v in range(k):
        for u in range(k):
            iy, ix = yb + v, xb + u
            term = ddots[..., v, u, None] * q
            inside = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
            direct = inside & ~staged
            lin = ((img * h + iy.clamp(0, h - 1)) * w + ix.clamp(0, w - 1))[direct]
            df.index_add_(0, lin, term[direct])
            slot = (tile * wr.BOX[1] + iy - lo[1][tile]) * wr.BOX[0] + ix - lo[0][tile]
            boxes.index_add_(0, slot[staged], term[staged])
    # each staged tile's box into df, its pixels outside the image dropped
    t, by, bx = torch.meshgrid(torch.arange(n_tiles), torch.arange(wr.BOX[1]), torch.arange(wr.BOX[0]), indexing="ij")
    gy, gx = lo[1][t] + by, lo[0][t] + bx
    keep = fits[t] & (gy >= 0) & (gy < h) & (gx >= 0) & (gx < w)
    lin = ((t // (ty * tx) * h + gy.clamp(0, h - 1)) * w + gx.clamp(0, w - 1))[keep]
    df.index_add_(0, lin, boxes.reshape(n_tiles, wr.BOX[1], wr.BOX[0], c)[keep])
    return df.reshape(b, h, w, c), int(fits.sum()), int(staged.sum())


@pytest.mark.parametrize("kind,c,p", [("iid", 8, 5), ("smooth", 12, 9), ("smooth", 5, 5), ("split", 16, 5),
                                      ("edges", 4, 7)])
def test_df_by_boxes_matches_the_plain_backward(kind, c, p):
    """The backward kernel's rule for df, modelled in plain PyTorch
    (``_df_by_boxes``), against the plain backward's df on the same inputs
    (fp64, within 1e-6); its staged tiles are ``staged_tiles``' (some of a
    smooth flow's tiles at a staged width and not all of a split flow's;
    none at C = 5), and at P <= 5 a box takes most of a smooth flow's
    pixels' df terms."""
    rng = np.random.default_rng(c * 10 + p)
    b, h, w = 2, 20, 70
    q, f = (torch.from_numpy(rng.standard_normal((b, h, w, c)).astype(np.float32)) for _ in range(2))
    flow = torch.from_numpy(_motion_flow(b, h, w, kind, rng).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(p * p).astype(np.float32))
    g_res = torch.from_numpy(rng.standard_normal((b, h, w, 2)).astype(np.float32))
    g_ls = torch.from_numpy(rng.standard_normal((b, h, w, p, p)).astype(np.float32))
    _, ls = wr.window_refinement_reference(q, f, flow, bias, TEMPERATURE, p)
    args = (q, f, flow, bias, ls, g_res, g_ls)
    want = wr.window_refinement_backward_reference(*(t.double() for t in args), TEMPERATURE, p)[1]
    got, staged, gathered = _df_by_boxes(*args, TEMPERATURE, p)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)
    assert staged == wr.staged_tiles(flow, p, c)
    if kind == "smooth" and c % 4 == 0 and p in GATHER_P:
        assert gathered > 0.6 * b * h * w
    tiles = wr.tile_count(b, h, w)
    if kind == "smooth":
        assert (staged > 0) == (c % 4 == 0)
    if kind == "split":
        assert 0 < staged < tiles
