"""ufm_torch on the card: the Hopper kernels and the models' kernel paths.

These tests need an NVIDIA GPU and nvcc and skip elsewhere. This file imports
neither JAX nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_port_gpu.py -m cuda --noconftest -q
"""

import math
import os

import numpy as np
import pytest
import torch

from ufm_torch.models import UniFlowMatchClassificationRefinement, UniFlowMatchConfidence, ufm_tiny_config
from ufm_torch.ops import flash_attention as fa
from ufm_torch.ops import gelu as ge
from ufm_torch.ops import linear_gelu as lg
from ufm_torch.ops import linear_swiglu as ls
from ufm_torch.ops import window_refinement as wr
from ufm_torch.training import make_optimizer, make_train_step, synthetic_batch, ufm_total_loss
from ufm_torch.training.trainer import group_of

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the GPU machine)")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(2, 1201, 16, 64), (1, 2400, 12, 64), (1, 77, 2, 64), (3, 1, 1, 64)])
def test_kernel_matches_fp32_reference(cuda, shape):
    """The kernel on bf16 views of a fused qkv tensor, held to an fp32
    reference on the same inputs: at most twice as far as the plain bf16
    version (which rounds its logits to bf16), and 4e-3 at the tightest."""
    b, s, h, d = shape
    g = torch.Generator(device=cuda).manual_seed(0)
    qkv = torch.randn(b, s, 3, h, d, generator=g, device=cuda).to(torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    before = fa.LAUNCHES
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    ref = fa.attention_reference(q.float(), k.float(), v.float(), d**-0.5)
    plain = fa.attention_reference(q, k, v, d**-0.5)
    err = (out.float() - ref).abs().max().item()
    plain_err = (plain.float() - ref).abs().max().item()
    assert err <= max(2 * plain_err, 4e-3)


def test_kernel_refuses_what_it_does_not_take(cuda):
    """float64 and D > 256 lie outside the TPU kernel's domain the port takes
    (fp32, bf16 and fp16 at 1 <= D <= 256); both raise before any launch."""
    before = (fa.LAUNCHES, fa.ANY_LAUNCHES)
    x = torch.zeros(1, 8, 2, 64, device=cuda, dtype=torch.float64)
    with pytest.raises(ValueError, match="float64 with D = 64"):
        fa.flash_attention(x, x, x)
    y = torch.zeros(1, 8, 2, 320, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="256"):
        fa.flash_attention(y, y, y)
    assert (fa.LAUNCHES, fa.ANY_LAUNCHES) == before


# the backward's bar: each gradient within twice the plain bf16 backward's
# error of the fp32 reference, and never tighter than two bf16 ulps of the
# reference's largest element (2^-7 of it)
BWD_ERR_FLOOR_REL = 2.0**-7
# a gradient that is zero in exact arithmetic (one key: P = 1, so dP = delta
# and dS = 0) comes out of the kernel as the fp32 rounding of dP - delta
ZERO_GRAD_ATOL = 1e-5


def _qkv_views(device, shape, seed=0):
    b, s, h, d = shape
    g = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn(b, s, 3, h, d, generator=g, device=device).to(torch.bfloat16)
    dout = torch.randn(b, s, h, d, generator=g, device=device).to(torch.bfloat16)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], dout


@pytest.mark.parametrize("shape", [(4, 1201, 16, 64), (2, 2400, 12, 64), (1, 77, 2, 64)])
def test_backward_kernel_matches_fp32_reference(cuda, shape):
    """dq, dk, dv of one backward call (views of a fused qkv tensor, as the
    main path passes them) against the fp32 reference on the same inputs, at
    most twice as far as the plain bf16 backward; the forward's lse against
    torch.logsumexp of the fp32 scores."""
    q, k, v, dout = _qkv_views(cuda, shape)
    scale = shape[-1] ** -0.5
    out, lse = fa.flash_attention_forward(q, k, v, scale, with_lse=True)
    before = fa.BWD_LAUNCHES
    grads = fa.flash_attention_backward(q, k, v, out, lse, dout, scale)
    torch.cuda.synchronize()
    assert fa.BWD_LAUNCHES == before + 1
    ref = fa.attention_backward_reference(q.float(), k.float(), v.float(), dout.float(), scale)
    plain = fa.attention_backward_reference(q, k, v, dout, scale)
    for name, got, want, pl in zip(("dq", "dk", "dv"), grads, ref, plain):
        assert got.shape == want.shape and got.dtype == torch.bfloat16
        err = (got.float() - want).abs().max().item()
        plain_err = (pl.float() - want).abs().max().item()
        assert err <= max(2 * plain_err, BWD_ERR_FLOOR_REL * want.abs().max().item()), name
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    torch.testing.assert_close(lse, torch.logsumexp(scores, dim=-1), rtol=0, atol=1e-4)


def _check_backward(q, k, v, dout, scale):
    """One forward (with lse) and one backward call against the fp32
    reference at the bars above (and ZERO_GRAD_ATOL where the reference
    gradient is zero); returns the gradients."""
    out, lse = fa.flash_attention_forward(q, k, v, scale, with_lse=True)
    ref_out = fa.attention_reference(q.float(), k.float(), v.float(), scale)
    plain_out = fa.attention_reference(q, k, v, scale)
    err = (out.float() - ref_out).abs().max().item()
    assert err <= max(2 * (plain_out.float() - ref_out).abs().max().item(), 4e-3)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    torch.testing.assert_close(lse, torch.logsumexp(scores, dim=-1), rtol=0, atol=1e-4)
    grads = fa.flash_attention_backward(q, k, v, out, lse, dout, scale)
    torch.cuda.synchronize()
    ref = fa.attention_backward_reference(q.float(), k.float(), v.float(), dout.float(), scale)
    plain = fa.attention_backward_reference(q, k, v, dout, scale)
    for name, got, want, pl in zip(("dq", "dk", "dv"), grads, ref, plain):
        assert got.shape == want.shape and got.dtype == torch.bfloat16
        err = (got.float() - want).abs().max().item()
        plain_err = (pl.float() - want).abs().max().item()
        assert err <= max(2 * plain_err, BWD_ERR_FLOOR_REL * want.abs().max().item(), ZERO_GRAD_ATOL), name
    return grads


@pytest.mark.parametrize("s", [1, 63, 64, 65, 127, 128, 129, 1201, 2400])
def test_kernels_at_ragged_lengths(cuda, s):
    """Forward, lse and backward at lengths around the 64- and 128-row tile
    edges (the TMA boxes' zero fill and the key mask), fused qkv views."""
    q, k, v, dout = _qkv_views(cuda, (1, s, 2, 64), seed=s)
    _check_backward(q, k, v, dout, 64**-0.5)


@pytest.mark.parametrize("sq,sk", [(65, 200), (300, 1), (129, 63), (1201, 2400)])
def test_kernels_with_sq_not_sk(cuda, sq, sk):
    g = torch.Generator(device=cuda).manual_seed(sq + sk)
    q = torch.randn(2, sq, 3, 64, generator=g, device=cuda).to(torch.bfloat16)
    kv = torch.randn(2, sk, 2, 3, 64, generator=g, device=cuda).to(torch.bfloat16)
    dout = torch.randn(2, sq, 3, 64, generator=g, device=cuda).to(torch.bfloat16)
    _check_backward(q, kv[:, :, 0], kv[:, :, 1], dout, 0.2)


def test_kernels_with_one_batch_head(cuda):
    q, k, v, dout = _qkv_views(cuda, (1, 300, 1, 64), seed=3)
    _check_backward(q, k, v, dout, 64**-0.5)


def test_backward_reads_strided_g_in_place_and_is_deterministic(cuda):
    """A g that is a strided view (not contiguous, but rows TMA can read)
    gives the same gradients as its contiguous copy, and two backward calls
    on the same inputs give bitwise-equal dq, dk and dv (no atomics)."""
    q, k, v, _ = _qkv_views(cuda, (2, 333, 3, 64), seed=4)
    g = torch.Generator(device=cuda).manual_seed(5)
    wide = torch.randn(2, 333, 2, 3, 64, generator=g, device=cuda).to(torch.bfloat16)
    dout = wide[:, :, 1]
    assert not dout.is_contiguous() and fa.tma_layout_error(dout.shape, dout.stride(), dout.data_ptr(), 2) is None
    first = _check_backward(q, k, v, dout, 64**-0.5)
    out, lse = fa.flash_attention_forward(q, k, v, 64**-0.5, with_lse=True)
    again = fa.flash_attention_backward(q, k, v, out, lse, dout, 64**-0.5)
    copied = fa.flash_attention_backward(q, k, v, out, lse, dout.contiguous(), 64**-0.5)
    for a, b, c in zip(first, again, copied):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_kernels_refuse_layouts_tma_cannot_read(cuda):
    base = torch.zeros(1, 16, 2, 68, device=cuda, dtype=torch.bfloat16)
    padded = base[..., :64]  # heads 136 bytes apart: not a multiple of 16
    with pytest.raises(ValueError, match="stride"):
        fa.flash_attention(padded, padded, padded)
    flat = torch.zeros(1 * 16 * 2 * 64 + 1, device=cuda, dtype=torch.bfloat16)
    shifted = flat[1:].view(1, 16, 2, 64)  # base 2 bytes past a 16-byte boundary
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention(shifted, shifted, shifted)
    swapped = torch.zeros(1, 16, 64, 2, device=cuda, dtype=torch.bfloat16).transpose(2, 3)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(swapped, swapped, swapped)
    ok = torch.zeros(1, 16, 2, 64, device=cuda, dtype=torch.bfloat16)
    out, lse = fa.flash_attention_forward(ok, ok, ok, 0.125, with_lse=True)
    with pytest.raises(ValueError, match="bfloat16"):
        fa.flash_attention_backward(ok.float(), ok, ok, out, lse, ok, 0.125)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_backward(ok, ok, ok, out, lse[:, :1], ok, 0.125)


def test_kernel_gradients_through_autograd(cuda):
    """With grad enabled, flash_attention records the kernel pair: one forward
    launch and one backward call, the backward's output equal to a direct
    call's, and a non-contiguous output gradient is taken."""
    q, k, v, _ = _qkv_views(cuda, (2, 130, 2, 64), seed=1)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    fwd, bwd = fa.LAUNCHES, fa.BWD_LAUNCHES
    out = fa.flash_attention(*leaves)
    g = torch.randn(2, 130, 64, 2, device=cuda).to(torch.bfloat16).transpose(2, 3)  # head dim not contiguous
    got = torch.autograd.grad(out, leaves, g)
    assert (fa.LAUNCHES - fwd, fa.BWD_LAUNCHES - bwd) == (1, 1)
    o, lse = fa.flash_attention_forward(q, k, v, 64**-0.5, with_lse=True)
    torch.testing.assert_close(out.detach(), o, rtol=0, atol=0)
    want = fa.flash_attention_backward(q, k, v, o, lse, g.contiguous(), 64**-0.5)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    bwd = fa.BWD_LAUNCHES
    with torch.no_grad():
        assert not fa.flash_attention(*leaves).requires_grad
    assert fa.BWD_LAUNCHES == bwd


def _small_config(**overrides):
    """The tiny topology at head_dim 64 (the attention kernel's), bf16."""
    cfg = ufm_tiny_config(compute_dtype="bfloat16", **overrides)
    cfg.encoder_kwargs = dict(cfg.encoder_kwargs, embed_dim=128, num_heads=2)
    cfg.info_sharing_kwargs = dict(cfg.info_sharing_kwargs, input_embed_dim=128, dim=128, num_heads=2)
    for head in (cfg.feature_head_kwargs, cfg.uncertainty_head_kwargs):
        head["dpt_feature"] = dict(head["dpt_feature"], input_dims=(128, 128, 128, 128))
    cfg.classification_head_kwargs = dict(cfg.classification_head_kwargs, input_feature_dim=256)
    return cfg


def _pairs():
    g = torch.Generator().manual_seed(1)
    src = torch.randint(0, 256, (2, 60, 80, 3), generator=g, dtype=torch.uint8)
    tgt = torch.randint(0, 256, (2, 60, 80, 3), generator=g, dtype=torch.uint8)
    return src, tgt


def test_small_model_kernel_path(cuda):
    """A small bf16 UFM-Base (head_dim 64) on the card: every attention call
    of a forward goes through the kernel, every MLP through the fused fc1 +
    GELU kernel (no standalone GELU), and the outputs stay close to the
    plain-attention path (bf16 rounding over 4 layers)."""
    model = UniFlowMatchConfidence.from_config(_small_config(), seed=0)
    src, tgt = _pairs()
    before, gelu_before, fused_before = fa.LAUNCHES, ge.LAUNCHES, lg.LAUNCHES
    res = model.predict_correspondences_batched(src, tgt)
    torch.cuda.synchronize()
    # one fused fc1 + GELU per block's MLP
    assert (fa.LAUNCHES - before, ge.LAUNCHES - gelu_before, lg.LAUNCHES - fused_before) == (4, 0, 4)
    model.attention_impl = "torch"
    plain = model.predict_correspondences_batched(src, tgt)
    assert fa.LAUNCHES - before == 4
    f, p = res.flow.flow_output.float(), plain.flow.flow_output.float()
    assert torch.isfinite(f).all()
    assert ((f - p).norm() / p.norm()).item() < 2e-2


# (B, H, W, C), P, flow scale: chip_smoke.py's window cases
WINDOW_CASES = {
    "flagship": ((1, 420, 560, 16), 5, 6.0),
    "edges": ((2, 24, 44, 8), 5, 40.0),
    "small_window": ((2, 24, 44, 4), 3, 15.0),
}


def _window_inputs(device, shape, p, scale, far=False, seed=0):
    """Seeded q, f, flow, bias on the card; with ``far``, one window of each
    image lies far outside it on each side."""
    g = torch.Generator(device=device).manual_seed(seed)
    q, f = (torch.randn(shape, generator=g, device=device) for _ in range(2))
    flow = torch.randn((*shape[:3], 2), generator=g, device=device) * scale
    if far:
        flow[:, 0, 0] = -500.0
        flow[:, -1, -1] = 1e6
    bias = torch.randn(p * p, generator=g, device=device)
    return q, f, flow, bias


@pytest.mark.parametrize("case", list(WINDOW_CASES))
def test_window_kernel_matches_plain(cuda, case):
    """The kernel against its plain version on the same inputs, at the bars
    of tests/test_window_dots.py (residual 2e-5, log_softmax 2e-4)."""
    shape, p, scale = WINDOW_CASES[case]
    q, f, flow, bias = _window_inputs(cuda, shape, p, scale, far=case == "edges")
    before = wr.LAUNCHES
    res, ls = wr.window_refinement(q, f, flow, bias, 4.0, p)
    torch.cuda.synchronize()
    assert wr.LAUNCHES == before + 1
    ref_res, ref_ls = wr.window_refinement_reference(q, f, flow, bias, 4.0, p)
    assert (res - ref_res).abs().max().item() <= 2e-5
    assert (ls - ref_ls).abs().max().item() <= 2e-4


# chip_smoke.py's five window cases: (B, H, W, C), P, flow kind, its scale
# in px ("smooth" / "split": MOTION plus iid noise of that sigma)
WINDOW_PATH_CASES = {
    "flagship": ((1, 420, 560, 16), 5, "iid", 6.0),
    "edges": ((2, 24, 44, 8), 5, "iid", 40.0),
    "small_window": ((2, 24, 44, 4), 3, "iid", 15.0),
    "flagship_smooth": ((1, 420, 560, 16), 5, "smooth", 0.5),
    "flagship_split": ((1, 420, 560, 16), 5, "split", 0.5),
}


def _motion_flow(device, h, w, split):
    """chip_smoke.py's MOTION: scale 1.05, rotation 3 degrees, translation
    (25, -12) px about the image centre; with ``split``, the pixels below the
    diagonal move 40 px further along y."""
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    a = math.radians(3.0)
    dx, dy = xs - (w - 1) / 2, ys - (h - 1) / 2
    fx = 1.05 * (math.cos(a) * dx - math.sin(a) * dy) - dx + 25.0
    fy = 1.05 * (math.sin(a) * dx + math.cos(a) * dy) - dy - 12.0
    if split:
        fy = fy + 40.0 * (ys / h > xs / w)
    return torch.stack([fx, fy], dim=-1)


@pytest.mark.parametrize("case", list(WINDOW_PATH_CASES))
def test_window_kernel_paths(cuda, case):
    """The kernel against its plain version (residual 2e-5, log_softmax 2e-4)
    on chip_smoke.py's five cases, and its count of tiles staged through TMA
    equal to staged_tiles: all but a few of a smooth flow's, both paths at a
    split flow's edge."""
    shape, p, kind, scale = WINDOW_PATH_CASES[case]
    q, f, flow, bias = _window_inputs(cuda, shape, p, scale, far=case == "edges")
    if kind != "iid":
        flow += _motion_flow(cuda, *shape[1:3], split=kind == "split")
    counter = torch.zeros(1, dtype=torch.int32, device=cuda)
    res, ls = wr.window_refinement(q, f, flow, bias, 4.0, p, staged_count=counter)
    torch.cuda.synchronize()
    ref_res, ref_ls = wr.window_refinement_reference(q, f, flow, bias, 4.0, p)
    assert (res - ref_res).abs().max().item() <= 2e-5
    assert (ls - ref_ls).abs().max().item() <= 2e-4
    staged, tiles = wr.staged_tiles(flow, p), wr.tile_count(*shape[:3])
    assert counter.item() == staged
    if kind == "smooth":
        assert staged >= 0.95 * tiles
    if kind == "split":
        assert 0 < staged < tiles
    again, _ = wr.window_refinement(q, f, flow, bias, 4.0, p)  # no counter: the main path's call
    assert torch.equal(again, res)


def test_window_kernel_refuses_what_it_does_not_take(cuda):
    """CPU tensors, other dtypes, and widths and windows past the kernels'
    domain (C <= 64, odd P <= 9: C = 65 and P = 11 here) raise before any
    launch, naming the limit."""
    q, f, flow, bias = _window_inputs(cuda, (1, 6, 7, 8), 5, 3.0)
    before = (wr.LAUNCHES, wr.BWD_LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        wr.window_refinement(q.cpu(), f.cpu(), flow.cpu(), bias.cpu(), 4.0, 5)
    with pytest.raises(ValueError, match="float32"):
        wr.window_refinement(q.half(), f.half(), flow, bias, 4.0, 5)
    q65, f65, flow65, bias65 = _window_inputs(cuda, (1, 6, 7, 65), 5, 3.0)
    with pytest.raises(ValueError, match="C <= 64"):
        wr.window_refinement(q65, f65, flow65, bias65, 4.0, 5)
    q11, f11, flow11, bias11 = _window_inputs(cuda, (1, 6, 7, 8), 11, 3.0)
    with pytest.raises(ValueError, match="P <= 9"):
        wr.window_refinement(q11, f11, flow11, bias11, 4.0, 11)
    ls = torch.zeros(1, 6, 7, 11, 11, device=cuda)
    with pytest.raises(ValueError, match="P <= 9"):
        wr.launch_backward(q11, f11, flow11, bias11, ls, flow11, ls, 4.0, 11)
    with pytest.raises(ValueError, match="staged_count"):
        wr.window_refinement(q, f, flow, bias, 4.0, 5, staged_count=torch.zeros(1, device=cuda))
    assert (wr.LAUNCHES, wr.BWD_LAUNCHES) == before


def test_window_kernel_gradients_match_plain(cuda):
    """Gradients through the op on the card (the forward kernel, then the
    backward kernel, one launch each) against autograd through the plain
    version."""
    inputs = _window_inputs(cuda, (1, 8, 8, 16), 5, 6.0)

    def grads(fn):
        ins = [t.clone().requires_grad_(True) for t in inputs]
        res, ls = fn(*ins, 4.0, 5)
        (res.pow(2).sum() + ls.mean()).backward()
        return [t.grad for t in ins]

    before = (wr.LAUNCHES, wr.BWD_LAUNCHES)
    got = grads(wr.window_refinement)
    torch.cuda.synchronize()
    assert (wr.LAUNCHES - before[0], wr.BWD_LAUNCHES - before[1]) == (1, 1)
    for got, want in zip(got, grads(wr.window_refinement_reference)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


# the rest of the window kernels' domain: (B, H, W, C), P, flow kind, its
# scale (chip_smoke.py's cases; "edges..." puts windows outside the image)
WINDOW_ANY_CASES = {
    "edges_c5_p7": ((2, 24, 44, 5), 7, "iid", 40.0),
    "c32_p7": ((1, 64, 96, 32), 7, "iid", 6.0),
    "c64_p9": ((1, 64, 96, 64), 9, "iid", 6.0),
    "smooth_c12_p9": ((1, 420, 560, 12), 9, "smooth", 0.5),
    "c3_p1": ((1, 16, 40, 3), 1, "iid", 3.0),
}


def _any_case_inputs(device, case, seed=0):
    shape, p, kind, scale = WINDOW_ANY_CASES[case]
    q, f, flow, bias = _window_inputs(device, shape, p, scale, far=case.startswith("edges"), seed=seed)
    if kind != "iid":
        flow += _motion_flow(device, *shape[1:3], split=kind == "split")
    return shape, p, (q, f, flow, bias)


@pytest.mark.parametrize("case", list(WINDOW_ANY_CASES))
def test_window_kernel_over_the_widened_domain(cuda, case):
    """The forward kernel at widths and windows past the Pallas kernel's
    (C not a multiple of 4, C = 32 / 64, P = 7 / 9) against its plain
    version (residual 2e-5, log_softmax 2e-4), its staged count equal to
    staged_tiles (none at C = 3, 5, 32, 64)."""
    shape, p, (q, f, flow, bias) = _any_case_inputs(cuda, case)
    counter = torch.zeros(1, dtype=torch.int32, device=cuda)
    res, ls = wr.window_refinement(q, f, flow, bias, 4.0, p, staged_count=counter)
    torch.cuda.synchronize()
    ref_res, ref_ls = wr.window_refinement_reference(q, f, flow, bias, 4.0, p)
    assert (res - ref_res).abs().max().item() <= 2e-5
    assert (ls - ref_ls).abs().max().item() <= 2e-4
    assert counter.item() == wr.staged_tiles(flow, p, shape[-1])
    if case == "smooth_c12_p9":
        assert 0 < counter.item() < wr.tile_count(*shape[:3])


# chip_smoke.py's bar for the window backward: max(2x the plain fp32
# backward's error, 1e-5 of the fp64 gradient's largest element)
WINDOW_BWD_FLOOR_REL = 1e-5


@pytest.mark.parametrize("case", ["edges_c5_p7", "c32_p7", "c64_p9", "c3_p1", "train"])
def test_window_backward_kernel_against_fp64(cuda, case):
    """The backward kernel against the plain backward in fp64 on the same
    inputs (and the forward kernel's log_softmax): each gradient within
    max(2x the plain fp32 backward's error, 1e-5 of its largest element);
    dq, dflow and dbias the same bits on a second call."""
    if case == "train":  # UFM-Refine's training shape
        shape, p = (2, 420, 560, 16), 5
        q, f, flow, bias = _window_inputs(cuda, shape, p, 6.0, seed=1)
    else:
        shape, p, (q, f, flow, bias) = _any_case_inputs(cuda, case, seed=1)
    _, ls = wr.window_refinement(q, f, flow, bias, 4.0, p)
    g = torch.Generator(device=cuda).manual_seed(2)
    g_res = torch.randn((*shape[:3], 2), generator=g, device=cuda)
    g_ls = torch.randn((*shape[:3], p, p), generator=g, device=cuda)
    args = (q, f, flow, bias, ls, g_res, g_ls, 4.0, p)
    before = wr.BWD_LAUNCHES
    got = wr.launch_backward(*args)
    again = wr.launch_backward(*args)
    torch.cuda.synchronize()
    assert wr.BWD_LAUNCHES == before + 2
    plain = wr.window_refinement_backward_reference(*args)
    ref = wr.window_refinement_backward_reference(*(t.double() for t in args[:7]), 4.0, p)
    for name, k, pl, r in zip(("dq", "df", "dflow", "dbias"), got, plain, ref):
        bar = max(2 * (pl.double() - r).abs().max().item(), WINDOW_BWD_FLOOR_REL * r.abs().max().item())
        assert (k.double() - r).abs().max().item() <= bar, name
    for name, a, b in zip(("dq", "dflow", "dbias"), (got[0], got[2], got[3]), (again[0], again[2], again[3])):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("kind", ["smooth", "iid"])
@pytest.mark.parametrize("c,p", [(12, 5), (16, 5), (12, 9), (16, 9)])
def test_window_backward_boxes_against_fp64(cuda, c, p, kind):
    """The backward kernel's staged path (f and df in shared-memory boxes,
    one TMA reduce-add a tile) and its direct path at the widths that stage,
    against the plain backward in fp64: each gradient within chip_smoke.py's
    bar; dq, dflow and dbias the same bits on every call; the tiles it
    staged (its counter) those of staged_tiles: some of a smooth flow's,
    none of an iid flow's."""
    shape = (2, 96, 128, c)
    q, f, flow, bias = _window_inputs(cuda, shape, p, 0.5 if kind == "smooth" else 6.0, seed=3)
    if kind == "smooth":
        flow += _motion_flow(cuda, *shape[1:3], split=False)
    _, ls = wr.window_refinement(q, f, flow, bias, 4.0, p)
    g = torch.Generator(device=cuda).manual_seed(4)
    g_res = torch.randn((*shape[:3], 2), generator=g, device=cuda)
    g_ls = torch.randn((*shape[:3], p, p), generator=g, device=cuda)
    args = (q, f, flow, bias, ls, g_res, g_ls, 4.0, p)
    counter = torch.zeros(1, dtype=torch.int32, device=cuda)
    got = wr.launch_backward(*args, staged_count=counter)
    again = wr.launch_backward(*args)
    torch.cuda.synchronize()
    staged, tiles = wr.staged_tiles(flow, p, c), wr.tile_count(*shape[:3])
    assert counter.item() == staged
    assert staged > 0 if kind == "smooth" else staged == 0
    plain = wr.window_refinement_backward_reference(*args)
    ref = wr.window_refinement_backward_reference(*(t.double() for t in args[:7]), 4.0, p)
    for name, k, pl, r in zip(("dq", "df", "dflow", "dbias"), got, plain, ref):
        bar = max(2 * (pl.double() - r).abs().max().item(), WINDOW_BWD_FLOOR_REL * r.abs().max().item())
        assert (k.double() - r).abs().max().item() <= bar, name
    for name, a, b in zip(("dq", "dflow", "dbias"), (got[0], got[2], got[3]), (again[0], again[2], again[3])):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("kind", ["iid", "smooth", "split"])
def test_any_forward_on_the_fixed_instances_shape(cuda, kind):
    """window_refinement_fwd_any_kernel (``any_kernel=True``) at the fixed
    C = 16, P = 5 instance's shape, against the plain version (residual
    2e-5, log_softmax 2e-4), staging the tiles of staged_tiles."""
    shape, p = (1, 420, 560, 16), 5
    q, f, flow, bias = _window_inputs(cuda, shape, p, 6.0 if kind == "iid" else 0.5)
    if kind != "iid":
        flow += _motion_flow(cuda, *shape[1:3], split=kind == "split")
    counter = torch.zeros(1, dtype=torch.int32, device=cuda)
    res, ls = wr.launch(q, f, flow, bias, 4.0, p, counter, any_kernel=True)
    torch.cuda.synchronize()
    ref_res, ref_ls = wr.window_refinement_reference(q, f, flow, bias, 4.0, p)
    assert (res - ref_res).abs().max().item() <= 2e-5
    assert (ls - ref_ls).abs().max().item() <= 2e-4
    assert counter.item() == wr.staged_tiles(flow, p, 16)


def test_small_refine_model_kernel_path(cuda):
    """A small bf16 UFM-Refine with the UNet on the card: one window launch
    per forward, and the refined flow within 1e-3 px of the same weights
    with the plain refinement (attention kernel in both runs)."""
    cfg = _small_config(has_classification_head=True, use_unet_feature=True, unet_kwargs={"out_channels": 8, "features": (8, 16)})
    model = UniFlowMatchClassificationRefinement.from_config(cfg, seed=0)
    src, tgt = _pairs()
    before = wr.LAUNCHES
    res = model.predict_correspondences_batched(src, tgt)
    torch.cuda.synchronize()
    assert wr.LAUNCHES - before == 1
    model.refinement_impl = "torch"
    plain = model.predict_correspondences_batched(src, tgt)
    assert wr.LAUNCHES - before == 1
    f, p = res.flow.flow_output, plain.flow.flow_output
    assert torch.isfinite(f).all()
    assert (f - p).abs().max().item() <= 1e-3


def _group_grads(net):
    out = {}
    for name, p in net.named_parameters():
        if p.grad is not None:
            out.setdefault(group_of(name), []).append(p.grad.float().flatten())
    return {k: torch.cat(v) for k, v in out.items()}


# kernel vs plain-attention gradients of a small bf16 model, relative L2 per
# optimizer group: the plain path rounds its logits to bf16 (the kernel keeps
# them in fp32), and that rounding reaches every weight gradient through 4
# bf16 attention layers; UFM-Refine's refinement loss also reaches them
# through the window positions (the regression flow), a path more sensitive
# to that rounding. The bound of chip_smoke.py's full-size check.
TRAIN_GRAD_REL_L2 = 1e-1


@pytest.mark.parametrize("refine", [False, True], ids=["base", "refine"])
def test_small_model_train_step_kernel_vs_plain(cuda, refine):
    """One train step of a small bf16 UFM-Base / UFM-Refine on the card: 4
    forward launches and 4 backward calls, finite metrics, and gradients
    close to the plain-attention path's (no kernel launched there). The
    UFM-Refine window backward is the backward kernel in both.
    For UFM-Refine the ground truth is the kernel path's regression flow plus
    whole-pixel offsets: the refinement loss's class (the rounded offset) is
    then the same on both paths, where a random flow would put pixels near a
    half-pixel boundary whose class the two paths' rounding differences flip.
    No offset is 0: a zero flow error sits on the Charbonnier loss's kink."""
    cfg = _small_config(**({"has_classification_head": True, "use_unet_feature": True,
                            "unet_kwargs": {"out_channels": 8, "features": (8, 16)}} if refine else {}))
    cls = UniFlowMatchClassificationRefinement if refine else UniFlowMatchConfidence
    model = cls.from_config(cfg, seed=0)
    batch = synthetic_batch(2, 42, 56, seed=0, device=cuda)
    opt = make_optimizer(model.net, learning_rate=1e-4, warmup_steps=0, total_steps=10)
    step = make_train_step(model.net, opt)
    if refine:
        with torch.no_grad():
            reg = model.net(batch["img1"], batch["img2"])["regression_flow"]
        g = torch.Generator(device=cuda).manual_seed(1)
        offsets = torch.tensor([-2.0, -1.0, 1.0, 2.0], device=cuda)
        batch["gt_flow"] = reg + offsets[torch.randint(0, 4, reg.shape, generator=g, device=cuda)]

    def grads():
        opt.zero_grad()
        loss, _ = ufm_total_loss(model.net(batch["img1"], batch["img2"]), batch)
        loss.backward()
        return _group_grads(model.net)

    fwd, bwd = fa.LAUNCHES, fa.BWD_LAUNCHES
    g_kernel = grads()
    assert (fa.LAUNCHES - fwd, fa.BWD_LAUNCHES - bwd) == (4, 4)
    model.attention_impl = "torch"
    g_plain = grads()
    assert (fa.LAUNCHES - fwd, fa.BWD_LAUNCHES - bwd) == (4, 4)
    model.attention_impl = None
    for group, gp in g_plain.items():
        rel = ((g_kernel[group] - gp).norm() / gp.norm()).item()
        assert rel < TRAIN_GRAD_REL_L2, (group, rel)
    metrics = step(batch)
    assert (fa.LAUNCHES - fwd, fa.BWD_LAUNCHES - bwd) == (8, 8)
    assert all(torch.isfinite(v) for v in metrics.values())


def test_small_refine_train_step_runs_no_plain_window(cuda, monkeypatch):
    """A small bf16 UFM-Refine train step on the card: one window forward
    and one window backward launch, and no call of the window refinement's
    plain versions (forward or backward)."""
    model = UniFlowMatchClassificationRefinement.from_config(_small_refine_config(), seed=0)
    batch = synthetic_batch(2, 42, 56, seed=0, device=cuda)
    step = make_train_step(model.net, make_optimizer(model.net, learning_rate=1e-4, warmup_steps=0, total_steps=10))
    plain_calls = []
    for module, name in ((wr, "window_refinement_reference"), (wr, "window_refinement_backward_reference")):
        fn = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, _fn=fn, **k: plain_calls.append(1) or _fn(*a, **k))
    from ufm_torch.ops import refinement

    monkeypatch.setattr(refinement, "window_refinement_reference", wr.window_refinement_reference)
    before = (wr.LAUNCHES, wr.BWD_LAUNCHES)
    metrics = step(batch)
    torch.cuda.synchronize()
    assert (wr.LAUNCHES - before[0], wr.BWD_LAUNCHES - before[1]) == (1, 1)
    assert plain_calls == []
    assert all(torch.isfinite(v) for v in metrics.values()) and "refinement_loss" in metrics


# ---- checkpoints, tiled inference and the bf16 goldens on the card ----------------


def test_checkpoint_round_trip_on_the_card(cuda, tmp_path):
    """``save_pretrained`` of a bf16 model on the card, ``from_pretrained``
    back onto the card (the default device): the same parameters and the same
    answer, bit for bit; and onto the CPU, the same parameters."""
    model = UniFlowMatchConfidence.from_config(_small_config(), seed=3)
    model.save_pretrained(str(tmp_path / "ckpt"))
    loaded = UniFlowMatchConfidence.from_pretrained(str(tmp_path / "ckpt"))
    assert loaded.device.type == "cuda"
    for a, b in zip(model.net.state_dict().values(), loaded.net.state_dict().values()):
        assert a.dtype == b.dtype and torch.equal(a, b)
    src, tgt = _pairs()
    want = model.predict_correspondences_batched(src, tgt)
    got = loaded.predict_correspondences_batched(src, tgt)
    assert torch.equal(want.flow.flow_output, got.flow.flow_output)
    assert torch.equal(want.covisibility.mask, got.covisibility.mask)
    on_cpu = UniFlowMatchConfidence.from_pretrained(str(tmp_path / "ckpt"), device="cpu")
    for a, b in zip(model.net.state_dict().values(), on_cpu.net.state_dict().values()):
        assert torch.equal(a.cpu(), b)


def test_tiled_inference_card_against_cpu(cuda):
    """Tiled inference of the d = 64 tiny model: 4 tiles answered in one
    batched forward on the card (4 attention launches each forward), held to
    the same call on the CPU's plain path at the bar of the model's bf16
    paths (relative L2 2e-2)."""
    from ufm_torch.models import tiled

    model = UniFlowMatchConfidence.from_config(_small_config(), seed=4)
    cpu = UniFlowMatchConfidence.from_config(_small_config(), seed=4, device="cpu")
    cpu.net.load_state_dict(model.net.state_dict())
    g = torch.Generator().manual_seed(2)
    src, tgt = (torch.randint(0, 256, (70, 90, 3), generator=g, dtype=torch.uint8).numpy() for _ in range(2))
    before = fa.LAUNCHES
    flow, covis = tiled.predict_correspondences_tiled(model, src, tgt)
    assert fa.LAUNCHES - before == 2 * 4  # the coarse forward, then one of 4 tiles
    assert tiled.last_tile_stats["tiles"] == 4
    plain_flow, plain_covis = tiled.predict_correspondences_tiled(cpu, src, tgt)
    assert np.isfinite(flow).all() and np.isfinite(covis).all()
    assert np.linalg.norm(flow - plain_flow) / np.linalg.norm(plain_flow) < 2e-2


@pytest.mark.parametrize("name", ["base", "refine"])
def test_kernel_path_holds_the_bf16_golden(cuda, name):
    """The d = 64 tiny models' kernel path (attention; the window kernel for
    UFM-Refine), from the golden's JAX parameters, within the cross-backend
    0.15 of the JAX package's bf16 outputs (tests/test_torch_port_bf16.py
    writes the goldens)."""
    import json
    import os

    from ufm_torch.checkpoint import load_jax_params
    from ufm_torch.models import UFMArchConfig, UFMNet

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", f"torch_port_bf16_d64_{name}.npz")
    with np.load(path) as z:
        files = {k: z[k] for k in z.files}
    with torch.device(cuda):
        net = UFMNet(UFMArchConfig.from_dict(json.loads(str(files["config"]))))
    load_jax_params(net, {k[len("params/"):]: v for k, v in files.items() if k.startswith("params/")})
    if net.cfg.has_classification_head:
        net.refinement_impl = None  # the window kernel
    before = (fa.LAUNCHES, wr.LAUNCHES)
    with torch.inference_mode():
        got = net(torch.from_numpy(files["input_1"]).to(cuda), torch.from_numpy(files["input_2"]).to(cuda))
    torch.cuda.synchronize()
    assert (fa.LAUNCHES - before[0], wr.LAUNCHES - before[1]) == (4, int(net.cfg.has_classification_head))
    for k, want in ((k[len("out/"):], v) for k, v in files.items() if k.startswith("out/")):
        assert (got[k].float().cpu() - torch.from_numpy(want)).abs().max().item() <= 0.15, k


# ---- captured predict programs (one CUDA graph per key) ---------------------------

# captured vs eager pipeline on the same inputs: the graph replays the eager
# run's kernels (chip_smoke.py's bar)
CAPTURED_BAR = 1e-5


def _small_refine_config():
    return _small_config(has_classification_head=True, use_unet_feature=True,
                         unet_kwargs={"out_channels": 8, "features": (8, 16)})


def _fields(res):
    return {"flow": res.flow.flow_output, "covisibility": res.covisibility.mask,
            "flow_covariance": res.flow.flow_covariance, "keypoint_confidence": res.keypoint_confidence}


@pytest.mark.parametrize("refine", [False, True], ids=["base", "refine"])
def test_captured_program_matches_eager(cuda, refine):
    """The first captured call (the warm-up's answer) and two replays against
    the eager pipeline, every output field within the bar; one program."""
    cls = UniFlowMatchClassificationRefinement if refine else UniFlowMatchConfidence
    model = cls.from_config(_small_refine_config() if refine else _small_config(), seed=0)
    src, tgt = _pairs()
    model.capture_graphs = False
    eager = _fields(model.predict_correspondences_batched(src, tgt))
    model.capture_graphs = True
    for _ in range(3):
        got = _fields(model.predict_correspondences_batched(src, tgt))
        for k, want in eager.items():
            rel = ((got[k].float() - want.float()).norm() / want.float().norm()).item()
            assert rel <= CAPTURED_BAR, (k, rel)
    (program,) = model._programs.values()
    assert program.graph is not None


def test_captured_launch_counts(cuda):
    """The counters count device launches: 4 attention launches, 1 window
    launch and 4 fused fc1 + GELU launches per call (no standalone GELU), on
    the first call (the eager warm-up; the capture runs nothing) and on every
    replay."""
    model = UniFlowMatchClassificationRefinement.from_config(_small_refine_config(), seed=0)
    src, tgt = _pairs()
    for _ in range(3):
        before = (fa.LAUNCHES, wr.LAUNCHES, ge.LAUNCHES, lg.LAUNCHES)
        model.predict_correspondences_batched(src, tgt)
        torch.cuda.synchronize()
        got = (fa.LAUNCHES - before[0], wr.LAUNCHES - before[1], ge.LAUNCHES - before[2], lg.LAUNCHES - before[3])
        assert got == (4, 1, 0, 4)
    (program,) = model._programs.values()
    assert {name: n for name, n in program.launches.items() if n} == {
        "flash_attention_fwd": 4, "window_refinement_fwd": 1, "linear_gelu_bf16_fwd": 4}


def test_captured_replay_stage_times(cuda):
    """The stage spans' timing events in a captured UFM-Refine graph: under a
    profile each traced replay's stages are read (positive device ms, one
    reading of each stage a call), and they sum to within 10% of the call's
    device time: events around the call (the inputs' copy, the replay, the
    output clones), queued behind a device sleep so that no host time lies
    between them, in the same profile (its kernel tracing slows every
    kernel of a small model)."""
    from torch.profiler import ProfilerActivity, profile

    from ufm_torch.utils import profiling

    model = UniFlowMatchClassificationRefinement.from_config(_small_refine_config(), seed=0)
    src, tgt = _pairs()
    model.predict_correspondences_batched(src, tgt)  # captures
    (program,) = model._programs.values()
    stages = ["predict.pre", "net.encoder", "net.info_sharing", "net.heads", "net.refine", "predict.post"]
    assert [name for name, _, _ in program.stages.stages] == stages
    profiling.clear()
    whole = []
    with profile(activities=[ProfilerActivity.CUDA]):
        for _ in range(3):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(100_000_000)  # ~50 ms: the call is enqueued before the device reaches start
            start.record()
            model.predict_correspondences_batched(src, tgt)
            end.record()
            end.synchronize()
            whole.append(start.elapsed_time(end))
    spans = profiling.spans()
    profiling.clear()
    calls = [sp.call for sp in spans if sp.name == "predict.call"]
    assert len(calls) == 3
    for call, call_ms in zip(calls, whole):
        got = [(sp.name, sp.device_ms) for sp in spans if sp.call == call and sp.start_ns is None]
        assert [name for name, _ in got] == stages, got
        assert all(ms > 0 for _, ms in got), got
        assert 0.9 * call_ms <= sum(ms for _, ms in got) <= call_ms, (got, call_ms)


def test_captured_output_survives_the_next_call(cuda):
    """Each call returns fresh tensors: a result stays as it was after the
    next replay of the same program (inputs on the card and on the host)."""
    model = UniFlowMatchConfidence.from_config(_small_config(), seed=0)
    src, tgt = _pairs()
    model.predict_correspondences_batched(src, tgt)  # captures
    first = model.predict_correspondences_batched(src, tgt).flow.flow_output
    kept = first.clone()
    model.predict_correspondences_batched(src.cuda(), tgt.flip(0).cuda())
    second = model.predict_correspondences_batched(src, tgt.flip(0)).flow.flow_output
    torch.cuda.synchronize()
    assert torch.equal(first, kept)
    assert not torch.equal(first, second)


def test_captured_programs_from_two_threads(cuda):
    """Two threads calling two keys of one model at once (the server's
    lanes): each answer equals the same call made alone."""
    import threading

    model = UniFlowMatchConfidence.from_config(_small_config(), seed=0)
    src, tgt = _pairs()
    inputs = {"b2": (src, tgt), "b1": (src[:1], tgt[1:])}
    alone = {k: model.predict_correspondences_batched(*v).flow.flow_output.cpu() for k, v in inputs.items()}
    got, errors = {k: [] for k in inputs}, []

    def worker(k):
        try:
            for _ in range(5):
                got[k].append(model.predict_correspondences_batched(*inputs[k]).flow.flow_output.cpu())
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(k,)) for k in inputs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads)
    for k, outs in got.items():
        assert len(outs) == 5 and all(torch.equal(o, alone[k]) for o in outs), k


def test_tf32_flag_reaches_the_program_key(cuda):
    """cuDNN's TF32 flag is part of the key: toggling it builds a second
    program, and toggling back replays the first."""
    model = UniFlowMatchConfidence.from_config(_small_config(), seed=0)
    src, tgt = _pairs()
    prev = torch.backends.cudnn.allow_tf32
    try:
        for allow in (True, False, True):
            torch.backends.cudnn.allow_tf32 = allow
            model.predict_correspondences_batched(src, tgt)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert len(model._programs) == 2
    assert all(p.graph is not None for p in model._programs.values())


def test_captured_input_layouts(cuda):
    """Each input staged in its own memory order: a planar source with a
    channel-last target, the reverse, and BCHW arrays each capture one
    program with buffers in the inputs' orders, and its replays equal the
    channel-last program's replays bit for bit (its first call, the
    warm-up, the channel-last warm-up); one ``own_order`` staging a
    replayed input, and the launches a replay makes unchanged."""
    from ufm_torch.models import input_layout
    from ufm_torch.ops import launches

    def planar(a):  # the channels outermost in memory, as tensor.permute(0, 2, 3, 1).numpy()
        return np.ascontiguousarray(a.transpose(0, 3, 1, 2)).transpose(0, 2, 3, 1)

    model = UniFlowMatchClassificationRefinement.from_config(_small_refine_config(), seed=0)
    src, tgt = (t.numpy() for t in _pairs())
    first = _fields(model.predict_correspondences_batched(src, tgt))
    replay = _fields(model.predict_correspondences_batched(src, tgt))
    torch.cuda.synchronize()
    (base,) = model._programs.values()
    cases = {
        "planar_source": ((planar(src), tgt), ((0, 1, 2, 3), (0, 2, 3, 1))),
        "planar_target": ((src, planar(tgt)), ((0, 2, 3, 1), (0, 1, 2, 3))),
        "bchw": ((src.transpose(0, 3, 1, 2).copy(), tgt.transpose(0, 3, 1, 2).copy()), ((0, 1, 2, 3),) * 2),
    }
    for name, (pair, orders) in cases.items():
        before = set(map(id, model._programs.values()))
        for call in range(3):
            staged, counted = input_layout.snapshot(), launches.snapshot()
            got = _fields(model.predict_correspondences_batched(*pair))
            torch.cuda.synchronize()
            assert input_layout.since(staged) == {"own_order": 2, "gathered": 0, "host_copy": 0}, name
            assert launches.since(counted) == base.launches, name
            for k, want in (first if call == 0 else replay).items():
                assert torch.equal(got[k], want), (name, call, k)
        (program,) = [p for p in model._programs.values() if id(p) not in before]
        assert program.graph is not None and program.orders == orders, name
        assert [input_layout.memory_order(t) for t in program.static_in] == list(orders), name
        assert [input_layout.memory_order(t) for t in program.staging] == list(orders), name
        assert program.launches == base.launches, name
    assert len(model._programs) == 1 + len(cases)


@pytest.mark.parametrize("staged",[False, True], ids=["stream_predict", "stream_predict_staged"])
def test_stream_predict_on_the_card(cuda, staged):
    """The streaming loops on the card: pinned copies on the copy stream, the
    compute stream's wait, the one-deep pipeline into a captured program.
    Five pairs in batches of 2: outputs in order, the padded last batch cut to
    one row, each batch bitwise the direct predict of the same stacked batch,
    4 attention launches a batch."""
    from ufm_torch.runtime import stream_predict, stream_predict_staged

    model = UniFlowMatchConfidence.from_config(_small_config(), seed=0)
    g = np.random.default_rng(5)
    pairs = [tuple(g.integers(0, 256, (60, 80, 3), dtype=np.uint8) for _ in range(2)) for _ in range(5)]
    batches = [pairs[0:2], pairs[2:4], [pairs[4], pairs[4]]]
    direct = [model.predict_correspondences_batched(np.stack([p[0] for p in b]), np.stack([p[1] for p in b]))
              for b in batches]
    predict = model.predict_correspondences_batched
    before = fa.LAUNCHES
    if staged:
        outs = list(stream_predict_staged(lambda s, t: (s, t), predict, iter(pairs), batch_size=2, device="cuda"))
    else:
        outs = list(stream_predict(predict, iter(pairs), batch_size=2, device="cuda"))
    torch.cuda.synchronize()
    assert fa.LAUNCHES - before == 4 * len(batches)
    assert [o.flow.flow_output.shape[0] for o in outs] == [2, 2, 1]
    for got, want in zip(outs, direct):
        n = got.flow.flow_output.shape[0]
        assert got.flow.flow_output.is_cuda
        assert torch.equal(got.flow.flow_output, want.flow.flow_output[:n])
        assert torch.equal(got.covisibility.mask, want.covisibility.mask[:n])


@pytest.mark.parametrize("threads", [1, 4])
def test_loader_feeds_stream_predict_on_the_card(cuda, threads):
    """The committed JPEG cases (tests/golden/jpeg_cases, 117x157) decoded by
    the native loader into ``stream_predict`` on the card: each decoded frame
    bitwise its committed libjpeg decode, and the streamed outputs bitwise
    the stream of the same frames from memory."""
    from ufm_torch.runtime import iter_decoded_pairs, stream_predict

    cases = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "jpeg_cases")
    names = ["s444_prog.jpg", "s422_base_opt.jpg", "s420_base_rst_opt.jpg", "s411_prog_rst.jpg", "s440_prog.jpg"]
    paths = [(os.path.join(cases, a), os.path.join(cases, b)) for a, b in zip(names, names[1:] + names[:1])]
    with np.load(os.path.join(cases, "decodes.npz")) as z:
        stored = {n: z[f"libjpeg/{n}"] for n in names}
    frames = list(iter_decoded_pairs(paths, (117, 157), num_threads=threads))
    for (a, b), (src, tgt) in zip(frames, paths):
        assert np.array_equal(a, stored[os.path.basename(src)]) and np.array_equal(b, stored[os.path.basename(tgt)])
    model = UniFlowMatchConfidence.from_config(_small_config(), seed=0)
    predict = model.predict_correspondences_batched
    from_files = list(stream_predict(predict, iter_decoded_pairs(paths, (117, 157), num_threads=threads),
                                     batch_size=2, device="cuda"))
    from_memory = list(stream_predict(predict, iter(frames), batch_size=2, device="cuda"))
    torch.cuda.synchronize()
    assert [o.flow.flow_output.shape[0] for o in from_files] == [2, 2, 1]
    for got, want in zip(from_files, from_memory):
        assert torch.equal(got.flow.flow_output, want.flow.flow_output)
        assert torch.equal(got.covisibility.mask, want.covisibility.mask)


def test_arithmetic_pair_streams_as_the_huffman_pair_on_the_card(cuda):
    """The 1080x1920 pair transcoded to arithmetic coding
    (tests/golden/jpeg_pair_arith: the same DCT coefficients) decoded by the
    loader at 240x320 into a lane of 2 on the card: outputs bitwise the
    Huffman pair's (tests/golden/jpeg_pair)."""
    from ufm_torch.runtime import iter_decoded_pairs, stream_predict

    golden = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
    model = UniFlowMatchConfidence.from_config(_small_config(), seed=0)
    outs = {}
    for folder in ("jpeg_pair", "jpeg_pair_arith"):
        pair = tuple(os.path.join(golden, folder, n) for n in ("frame0.jpg", "frame1.jpg"))
        outs[folder] = list(stream_predict(model.predict_correspondences_batched,
                                           iter_decoded_pairs([pair, pair[::-1], pair], (240, 320), num_threads=2),
                                           batch_size=2, device="cuda"))
    torch.cuda.synchronize()
    assert [o.flow.flow_output.shape[0] for o in outs["jpeg_pair_arith"]] == [2, 1]
    for got, want in zip(outs["jpeg_pair_arith"], outs["jpeg_pair"]):
        assert torch.equal(got.flow.flow_output, want.flow.flow_output)
        assert torch.equal(got.covisibility.mask, want.covisibility.mask)


def test_ops_on_the_card_match_their_plain_versions(cuda):
    """Each dispatcher op on CUDA tensors runs its kernel (one launch each)
    and agrees with the plain version on the same inputs: the attention op
    with the bars above, the window op with chip_smoke's, its staged count
    with ``staged_tiles``; a gradient through the attention op is the
    backward op's."""
    from ufm_torch.ops import library

    q, k, v, dout = _qkv_views(cuda, (1, 200, 2, 64), seed=8)
    before = (fa.LAUNCHES, fa.BWD_LAUNCHES)
    out, lse = library.flash_attention_fwd(q, k, v, 0.125, True)
    dq, dk, dv = library.flash_attention_bwd(q, k, v, out, lse, dout, 0.125)
    torch.cuda.synchronize()
    assert (fa.LAUNCHES - before[0], fa.BWD_LAUNCHES - before[1]) == (1, 1)
    ref, ref_lse = fa.attention_reference(q.float(), k.float(), v.float(), 0.125, with_lse=True)
    plain = fa.attention_reference(q, k, v, 0.125)
    assert (out.float() - ref).abs().max().item() <= max(2 * (plain.float() - ref).abs().max().item(), 4e-3)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-4)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    grads = torch.autograd.grad(library.attention(*leaves, 0.125), leaves, dout)
    for a, b in zip(grads, (dq, dk, dv)):
        assert torch.equal(a, b)

    wq, wf, wflow, wbias = _window_inputs(cuda, (1, 24, 44, 16), 5, 6.0)
    counter = torch.zeros(1, dtype=torch.int32, device=cuda)
    launched = wr.LAUNCHES
    res, ls = library.window_refinement(wq, wf, wflow, wbias, 4.0, 5, counter)
    torch.cuda.synchronize()
    assert wr.LAUNCHES - launched == 1
    ref_res, ref_ls = wr.window_refinement_reference(wq, wf, wflow, wbias, 4.0, 5)
    assert (res - ref_res).abs().max().item() <= 2e-5 and (ls - ref_ls).abs().max().item() <= 2e-4
    assert counter.item() == wr.staged_tiles(wflow, 5)


@pytest.mark.parametrize("where", ["cpu", "cuda"])
@pytest.mark.parametrize("refine", [False, True], ids=["base", "refine"])
def test_artifact_launches_the_kernels_on_the_card(cuda, tmp_path, where, refine):
    """A small bf16 model (head_dim 64) exported on the CPU or on the card,
    loaded onto the card: its program launches the kernels (4 attention, 1
    window for UFM-Refine) and answers as the live model on the card does."""
    from ufm_torch.runtime import export_model, load_exported

    cls = UniFlowMatchClassificationRefinement if refine else UniFlowMatchConfidence
    model = cls.from_config(_small_config(has_classification_head=refine), seed=0, device=where)
    path = str(tmp_path / "small.ufmt")
    manifest = export_model(model, path)
    assert manifest["devices"][0].startswith(where)
    art = load_exported(path)
    assert art.device.type == "cuda"
    model.net.to(cuda)
    w, h = model.inference_resolution[0]
    g = torch.Generator(device=cuda).manual_seed(9)
    x, y = (torch.randn(1, h, w, 3, generator=g, device=cuda) for _ in range(2))
    before = (fa.LAUNCHES, wr.LAUNCHES)
    with torch.inference_mode():
        got = art(x, y)
        torch.cuda.synchronize()
        assert (fa.LAUNCHES - before[0], wr.LAUNCHES - before[1]) == (4, int(refine))
        want = model.net(x, y)
    for key in want:
        a, b = got[key].float(), want[key].float()
        assert ((a - b).norm() / b.norm().clamp_min(1e-12)).item() <= 1e-5, key


# ---- the model x entry-point paths: UFM-Refine served and exported at batch 2,
# UniFlowMatch (no uncertainty head) trained --------------------------------------


def test_refine_served_at_lane_width_two(cuda):
    """A small bf16 UFM-Refine behind ``UFMServer`` with lanes of 2: two
    clients send three pairs each; every lane batch is one replay of the
    lane's program (4 attention, 1 window, 4 fused fc1 + GELU launches), and
    each response is bitwise the direct predict of the batch it ran in, at
    its slot."""
    import threading

    from ufm_torch.ops import launches as counters
    from ufm_torch.runtime import UFMServer

    model = UniFlowMatchClassificationRefinement.from_config(_small_config(has_classification_head=True), seed=0)
    g = np.random.default_rng(12)
    pairs = [tuple(g.integers(0, 256, (60, 80, 3), dtype=np.uint8) for _ in range(2)) for _ in range(6)]
    server = UFMServer(model, port=0, max_batch=2, max_delay_ms=20.0)
    lane_batches, predict_batch = [], server._predict_batch

    def recording(src, tgt):
        lane_batches.append((src.copy(), tgt.copy()))
        return predict_batch(src, tgt)

    server._predict_batch = recording
    server.predict(*pairs[0])  # the lane's program is captured
    lane_batches.clear()
    counters.reset()
    served = [None] * len(pairs)

    def client(k):
        for i in range(k, len(pairs), 2):
            served[i] = server.predict(*pairs[i])

    try:
        threads = [threading.Thread(target=client, args=(k,)) for k in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        server.close()
    assert not any(t.is_alive() for t in threads) and all(r is not None for r in served)
    launched = counters.snapshot()
    n = len(lane_batches)
    assert {k: v for k, v in launched.items() if v} == {
        "flash_attention_fwd": 4 * n, "window_refinement_fwd": n, "linear_gelu_bf16_fwd": 4 * n}
    for i, (src, tgt) in enumerate(pairs):
        (bs, bt), slot = next((b, r) for b in lane_batches for r in range(2)
                              if np.array_equal(b[0][r], src) and np.array_equal(b[1][r], tgt))
        direct = model.predict_correspondences_batched(bs, bt)
        assert np.array_equal(served[i]["flow"], direct.flow.flow_output[slot].float().cpu().numpy())
        assert np.array_equal(served[i]["covisibility"], direct.covisibility.mask[slot].cpu().numpy())


def test_flow_only_train_step_on_the_card(cuda):
    """A small bf16 UniFlowMatch (``has_uncertainty_head=False``): one train
    step launches 4 attention forwards, 4 backward calls, 4 fused fc1 + GELU
    and 4 fused fc2 input-gradient + GELU gradient kernels and nothing else;
    its metrics are the flow loss, the EPE and the total."""
    from ufm_torch.models import UniFlowMatch
    from ufm_torch.ops import launches as counters

    model = UniFlowMatch.from_config(_small_config(has_uncertainty_head=False), seed=0)
    assert not hasattr(model.net, "uncertainty_head")
    step = make_train_step(model.net, make_optimizer(model.net, warmup_steps=0, total_steps=10))
    batch = synthetic_batch(2, 42, 56, seed=0, device=cuda)
    before = counters.snapshot()
    metrics = step(batch)
    torch.cuda.synchronize()
    assert {k: v for k, v in counters.since(before).items() if v} == {
        "flash_attention_fwd": 4, "flash_attention_bwd": 4, "linear_gelu_bf16_fwd": 4, "linear_gelu_bf16_bwd": 4}
    assert set(metrics) == {"flow_loss", "epe", "total_loss"}
    assert all(torch.isfinite(v) for v in metrics.values())


def test_refine_artifact_at_batch_two_on_the_card(cuda, tmp_path):
    """A small bf16 UFM-Refine exported on the card at batch 2: one call of
    the loaded program launches 4 attention, 1 window and 4 fused fc1 + GELU
    kernels, and its raw outputs are bitwise the live network's."""
    from ufm_torch.ops import launches as counters
    from ufm_torch.runtime import export_model, load_exported

    model = UniFlowMatchClassificationRefinement.from_config(_small_config(has_classification_head=True), seed=0)
    path = str(tmp_path / "refine_b2.ufmt")
    export_model(model, path, batch=2)
    art = load_exported(path)
    assert art.batch == 2
    w, h = model.inference_resolution[0]
    g = torch.Generator(device=cuda).manual_seed(10)
    x, y = (torch.randn(2, h, w, 3, generator=g, device=cuda) for _ in range(2))
    with torch.inference_mode():
        want = model.net(x, y)
        before = counters.snapshot()
        got = art(x, y)
        torch.cuda.synchronize()
    assert {k: v for k, v in counters.since(before).items() if v} == {
        "flash_attention_fwd": 4, "window_refinement_fwd": 1, "linear_gelu_bf16_fwd": 4}
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key


# ---- sharded training and the remat policies on the card ---------------------


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_sharded_step_at_world_one(cuda):
    """make_sharded_train_step on a (1, 1, 1) mesh over NCCL (FSDP2, one
    rank): a small bf16 UFM-Base's step launches 4 attention forwards and 4
    backward calls, its metrics are finite and equal the unsharded step's
    from the same weights at 1e-3 relative."""
    import torch.distributed as dist

    from ufm_torch.parallel import make_mesh
    from ufm_torch.training import make_sharded_train_step

    batch = synthetic_batch(2, 42, 56, seed=0, device=cuda)
    model = UniFlowMatchConfidence.from_config(_small_config(), seed=0)
    want = make_train_step(model.net, make_optimizer(model.net, warmup_steps=0, total_steps=10))(batch)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}", world_size=1, rank=0)
    try:
        model = UniFlowMatchConfidence.from_config(_small_config(), seed=0)
        step, net, _, place = make_sharded_train_step(model.net, make_mesh(1), warmup_steps=0, total_steps=10)
        placed = place(batch)
        before = (fa.LAUNCHES, fa.BWD_LAUNCHES)
        metrics = step(placed)
        torch.cuda.synchronize()
        assert (fa.LAUNCHES - before[0], fa.BWD_LAUNCHES - before[1]) == (4, 4)
    finally:
        dist.destroy_process_group()
    for k, v in want.items():
        assert torch.isfinite(metrics[k])
        assert abs(metrics[k].item() - v.item()) <= 1e-3 * abs(v.item()), k


@pytest.mark.parametrize("policy, forwards", [("dots_with_no_batch_dims_and_attn_out_saveable", 4),
                                              ("dots_with_no_batch_dims_saveable", 8), (None, 8)])
def test_remat_step_attention_launches(cuda, policy, forwards):
    """Under train_remat, the backward runs the attention forward kernel
    again (8 launches a step of the small model) unless the policy keeps its
    outputs (the "+attn_out" composite: 4); 4 backward calls either way.
    Under checkpointing the MLP takes fc1 and the GELU op, never the fused
    fc1 + GELU op; no policy here keeps the GELU op's output: 8 GELU launches
    a step, and 4 of the GELU gradient."""
    cfg = _small_config(train_remat=True, train_remat_policy=policy)
    model = UniFlowMatchConfidence.from_config(cfg, seed=0)
    step = make_train_step(model.net, make_optimizer(model.net, warmup_steps=0, total_steps=10))
    batch = synthetic_batch(2, 42, 56, seed=0, device=cuda)
    before = (fa.LAUNCHES, fa.BWD_LAUNCHES, ge.LAUNCHES, lg.LAUNCHES, ge.BWD_LAUNCHES)
    metrics = step(batch)
    torch.cuda.synchronize()
    got = (fa.LAUNCHES - before[0], fa.BWD_LAUNCHES - before[1], ge.LAUNCHES - before[2], lg.LAUNCHES - before[3],
           ge.BWD_LAUNCHES - before[4])
    assert got == (forwards, 4, 8, 0, 4)
    assert all(torch.isfinite(v) for v in metrics.values())


# ---- the bf16 GELU kernel ------------------------------------------------------

GELU_TABLE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "gelu_bf16_table.npz")


def _bits(t):
    return t.view(torch.int16)


def test_gelu_kernel_matches_the_table_bit_for_bit(cuda):
    """The kernel on every bf16 bit pattern: the JAX package's bits
    (tests/golden/gelu_bf16_table.npz) at every finite input, and the plain
    version's on the card, one launch."""
    with np.load(GELU_TABLE) as z:
        want, finite = torch.from_numpy(z["y_bits"].view(np.int16).copy()), torch.from_numpy(z["finite"])
    x = torch.from_numpy(np.arange(65536, dtype=np.uint16).view(np.int16)).view(torch.bfloat16).to(cuda)
    before = ge.LAUNCHES
    got = ge.gelu_bf16(x)
    torch.cuda.synchronize()
    assert ge.LAUNCHES - before == 1
    assert int((_bits(got).cpu() != want)[finite].sum()) == 0
    plain = ge.fast_exact_gelu_reference(x)
    assert int((_bits(got) != _bits(plain))[finite.to(cuda)].sum()) == 0


@pytest.mark.parametrize("n", [1, 7, 8, 8 * 1001 + 3, 2 * 1201 * 4096 + 5, 0])
@pytest.mark.parametrize("offset", [0, 3], ids=["aligned", "misaligned"])
def test_gelu_kernel_odd_counts_and_alignment(cuda, n, offset):
    """Element counts off the 8-element vector (the scalar tail), an empty
    tensor (no launch), and a base 6 bytes past a 16-byte boundary (the
    scalar instance): bitwise the plain version."""
    g = torch.Generator(device=cuda).manual_seed(n)
    base = (torch.randn(n + 8, generator=g, device=cuda) * 4).to(torch.bfloat16)
    x = base[offset:offset + n]
    before = ge.LAUNCHES
    got = ge.gelu_bf16(x)
    torch.cuda.synchronize()
    assert ge.LAUNCHES - before == int(n > 0)
    assert got.shape == x.shape and torch.equal(_bits(got), _bits(ge.fast_exact_gelu_reference(x)))


def test_gelu_kernel_non_contiguous_input_and_refusals(cuda):
    """A transposed input is read through a contiguous copy; fp32 is refused
    by the entry point and by the op; an input on the CPU never reaches the
    kernel wrapper."""
    from ufm_torch.ops import library

    g = torch.Generator(device=cuda).manual_seed(1)
    x = (torch.randn(2, 300, 4096, generator=g, device=cuda) * 3).to(torch.bfloat16).transpose(1, 2)
    got = ge.gelu_bf16(x)
    assert got.shape == x.shape and got.is_contiguous()
    assert torch.equal(_bits(got), _bits(ge.fast_exact_gelu_reference(x.contiguous())))
    for fn in (ge.gelu_bf16, library.gelu_bf16, ge.launch):
        with pytest.raises(ValueError, match="bfloat16"):
            fn(x.float())
    with pytest.raises(ValueError, match="CUDA"):
        ge.launch(x.cpu())


def test_gelu_kernel_in_a_captured_graph(cuda):
    """The launch syncs nothing and allocates only from the caching
    allocator: it captures in the strictest mode, and each replay computes
    the new input's GELU."""
    g = torch.Generator(device=cuda).manual_seed(2)
    static_in = torch.randn(1, 2400, 3072, generator=g, device=cuda).to(torch.bfloat16)
    ge.gelu_bf16(static_in)  # warm-up: builds and loads the kernel
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="global"):
        static_out = ge.gelu_bf16(static_in)
    for seed in (3, 4):
        static_in.copy_(torch.randn(static_in.shape, generator=g.manual_seed(seed), device=cuda).to(torch.bfloat16))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(_bits(static_out), _bits(ge.fast_exact_gelu_reference(static_in)))


def test_gelu_op_gradient_on_the_card(cuda):
    """The op's backward on the card is one launch of the gradient kernel on
    the saved input, bit for bit the plain VJP (the JAX package's)."""
    g = torch.Generator(device=cuda).manual_seed(5)
    x = (torch.randn(4, 1201, 512, generator=g, device=cuda) * 3).to(torch.bfloat16).requires_grad_(True)
    dy = torch.randn(x.shape, generator=g, device=cuda).to(torch.bfloat16)
    before = ge.BWD_LAUNCHES
    (got,) = torch.autograd.grad(ge.gelu_bf16(x), x, dy)
    torch.cuda.synchronize()
    assert ge.BWD_LAUNCHES - before == 1
    assert not _differ(got, ge.fast_exact_gelu_vjp_reference(x.detach(), dy)).any()


# ---- the bf16 GELU's gradient kernel ---------------------------------------------

GELU_VJP_TABLE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "gelu_bf16_vjp_table.npz")


def _differ(a, b):
    """Where two bf16 tensors' bits differ, NaN counted equal to NaN."""
    return (_bits(a) != _bits(b)) & ~(torch.isnan(a) & torch.isnan(b))


def test_gelu_backward_kernel_matches_the_vjp_table_bit_for_bit(cuda):
    """The gradient kernel at every bf16 bit pattern under each cotangent
    set of tests/golden/gelu_bf16_vjp_table.npz: the JAX package's bits at
    every finite input (NaN equal to NaN), NaN at the others, the plain
    version's everywhere, one launch a call."""
    with np.load(GELU_VJP_TABLE) as z:
        g_bits, dx_bits, finite = z["g_bits"], z["dx_bits"], torch.from_numpy(z["finite"]).to(cuda)
    x = torch.from_numpy(np.arange(65536, dtype=np.uint16).view(np.int16)).view(torch.bfloat16).to(cuda)
    for gb, db in zip(g_bits, dx_bits):
        g = torch.from_numpy(gb.view(np.int16).copy()).view(torch.bfloat16).to(cuda)
        want = torch.from_numpy(db.view(np.int16).copy()).view(torch.bfloat16).to(cuda)
        before = ge.BWD_LAUNCHES
        got = ge.gelu_bf16_bwd(g, x)
        torch.cuda.synchronize()
        assert ge.BWD_LAUNCHES - before == 1
        assert int(_differ(got, want)[finite].sum()) == 0
        assert bool(torch.isnan(got[~finite]).all())
        assert int(_differ(got, ge.fast_exact_gelu_vjp_reference(x, g)).sum()) == 0


@pytest.mark.parametrize("n", [1, 7, 8, 8 * 1001 + 3, 4 * 1201 * 4096 + 5, 0])
@pytest.mark.parametrize("offset", [0, 3], ids=["aligned", "misaligned"])
def test_gelu_backward_kernel_odd_counts_and_alignment(cuda, n, offset):
    """Counts off the 8-element vector, an empty tensor (no launch) and a
    cotangent 6 bytes past a 16-byte boundary (the scalar instance), with a
    share of the cotangents zero, negative zero and subnormal: bitwise the
    plain version."""
    gen = torch.Generator(device=cuda).manual_seed(n)
    x = (torch.randn(n, generator=gen, device=cuda) * 4).to(torch.bfloat16)
    base = torch.randn(n + 8, generator=gen, device=cuda)
    pick = torch.rand(n + 8, generator=gen, device=cuda)
    base = torch.where(pick < 0.05, 0.0, torch.where(pick < 0.1, -0.0, torch.where(pick < 0.15, 1e-39, base)))
    g = base.to(torch.bfloat16)[offset:offset + n]
    before = ge.BWD_LAUNCHES
    got = ge.gelu_bf16_bwd(g, x)
    torch.cuda.synchronize()
    assert ge.BWD_LAUNCHES - before == int(n > 0)
    assert got.shape == x.shape and not _differ(got, ge.fast_exact_gelu_vjp_reference(x, g)).any()


def test_gelu_backward_kernel_refusals(cuda):
    """fp32 and mismatched shapes are refused by the wrapper and the op, CPU
    tensors by the wrapper, none of them launching; a non-contiguous pair
    is read through contiguous copies."""
    from ufm_torch.ops import library

    x = torch.zeros(4, 64, dtype=torch.bfloat16, device=cuda)
    before = ge.BWD_LAUNCHES
    for fn in (ge.launch_backward, library.gelu_bf16_bwd):
        for args in ((x.float(), x), (x, x[:2])):
            with pytest.raises(ValueError):
                fn(*args)
    with pytest.raises(ValueError, match="CUDA"):
        ge.launch_backward(x.cpu(), x.cpu())
    assert ge.BWD_LAUNCHES == before
    gen = torch.Generator(device=cuda).manual_seed(9)
    h = torch.randn(64, 300, generator=gen, device=cuda).to(torch.bfloat16).t()
    g = torch.randn(300, 64, generator=gen, device=cuda).to(torch.bfloat16)
    got = ge.gelu_bf16_bwd(g, h)
    assert got.is_contiguous() and not _differ(got, ge.fast_exact_gelu_vjp_reference(h.contiguous(), g)).any()


# ---- the fused fc1 + GELU kernel ----------------------------------------------


def _linear_gelu_inputs(device, m, k, n, seed=0, lead=()):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(*lead, m, k, generator=g, device=device).to(torch.bfloat16)
    w = (torch.randn(n, k, generator=g, device=device) * k**-0.5).to(torch.bfloat16)
    b = torch.randn(n, generator=g, device=device).to(torch.bfloat16)
    return x, w, b


@pytest.mark.parametrize("schedule", list(lg.SCHEDULES))
@pytest.mark.parametrize("m,k,n", [(1, 64, 256), (7, 48, 200), (129, 1024, 4096), (2402, 1024, 4096),
                                   (2400, 768, 3072), (300, 8, 8)])
def test_linear_gelu_kernel_against_plain(cuda, schedule, m, k, n):
    """The fused kernel at the MLP shapes and at M, K and N tails: y is the
    bf16 GELU of its own h bit for bit (read back through preact_out); h is
    within one bf16 ulp of the exact product + bias (float64) on all but
    0.1% of the elements, within 2 ulps wherever fp32 summation cannot move
    the sum by half an ulp, and within an ulp plus fp32 summation's error
    bound (K 2^-24 sum |x w| + |b| 2^-24) everywhere (a sum that cancels to
    near zero has few correct bits in any fp32 order); y is within 4e-3
    relative L2 of the plain version (F.linear, then the GELU's plain chain)."""
    x, w, b = _linear_gelu_inputs(cuda, m, k, n, seed=m + k + n)
    pre = torch.empty(m, n, dtype=torch.bfloat16, device=cuda)
    before = lg.LAUNCHES
    y = lg.launch(x, w, b, preact_out=pre, schedule=schedule)
    torch.cuda.synchronize()
    assert lg.LAUNCHES - before == 1
    assert torch.equal(_bits(y), _bits(ge.fast_exact_gelu_reference(pre)))
    err, ulp, gamma, ulps = _preact_errors(pre, x, w, b)
    assert bool((err <= ulp + gamma).all())
    assert (ulps <= 1).double().mean().item() >= 0.999
    assert int(ulps[gamma <= 0.5 * ulp].max()) <= 2
    plain = lg.linear_gelu_reference(x, w, b).float()
    assert ((y.float() - plain).norm() / plain.norm().clamp_min(1e-30)).item() <= 4e-3


def _ordered(t):
    """bf16 values as integers in the order of the values (one apart for one ulp)."""
    u = t.view(torch.int16).to(torch.int32) & 0xFFFF
    return torch.where(u < 0x8000, u + 0x8000, 0xFFFF - u)


def _preact_errors(pre, x, w, b):
    """|h - exact| (float64), one bf16 ulp of the exact value, fp32
    summation's error bound, and h's distance in bf16 ulps from the exact
    value rounded to bf16."""
    xd, wd, bd = x.double(), w.double(), b.double()
    ref = xd @ wd.t() + bd
    gamma = x.shape[-1] * 2.0**-24 * (xd.abs() @ wd.abs().t() + bd.abs())
    ulp = torch.ldexp(torch.ones_like(ref), (torch.frexp(ref).exponent - 8).clamp_min(-133))
    return (pre.double() - ref).abs(), ulp, gamma, (_ordered(pre) - _ordered(ref.to(torch.bfloat16))).abs()


def test_linear_gelu_kernel_layouts_and_refusals(cuda):
    """A 3-D and a non-contiguous x, an empty x (no launch); fp32, a K that
    does not match, K or N off a multiple of 8, a misaligned operand and a
    CPU tensor are refused without a launch."""
    x, w, b = _linear_gelu_inputs(cuda, 130, 64, 96, seed=1, lead=(2,))
    plain = lg.linear_gelu_reference(x, w, b)
    got = lg.linear_gelu_bf16(x, w, b)
    strided = x.transpose(0, 1).contiguous().transpose(0, 1)  # the same values, not contiguous
    assert torch.equal(_bits(got), _bits(lg.linear_gelu_bf16(strided, w, b)))
    assert got.shape == (2, 130, 96)
    assert ((got.float() - plain.float()).norm() / plain.float().norm()).item() <= 4e-3
    before = lg.LAUNCHES
    assert lg.linear_gelu_bf16(x[:, :0], w, b).shape == (2, 0, 96) and lg.LAUNCHES == before
    flat = torch.zeros(65 * 64 + 8, dtype=torch.bfloat16, device=cuda)
    refusals = [
        ((x.float(), w, b), "bfloat16"),
        ((x[..., :56], w, b), "x \\(\\.\\.\\., K\\)"),
        ((x[..., :60], w[:, :60], b), "multiples of 8"),
        ((flat[1:1 + 65 * 64].view(65, 64), w, b), "aligned"),
        ((x.cpu(), w, b), "CUDA"),
    ]
    for args, match in refusals:
        with pytest.raises(ValueError, match=match):
            lg.launch(*args)
    assert lg.LAUNCHES == before


def test_linear_gelu_kernel_in_a_captured_graph(cuda):
    """The launch captures in the strictest mode, and each replay computes
    the new input's output."""
    x, w, b = _linear_gelu_inputs(cuda, 2400, 768, 3072, seed=3)
    lg.linear_gelu_bf16(x, w, b)  # warm-up: builds and loads the kernel
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="global"):
        out = lg.linear_gelu_bf16(x, w, b)
    for seed in (4, 5):
        x.copy_(_linear_gelu_inputs(cuda, 2400, 768, 3072, seed=seed)[0])
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(_bits(out), _bits(lg.launch(x, w, b)))


# the fused op's gradient against the two-op route's (F.linear's h, an ulp
# from the kernel's where fp32 sums round apart), relative L2: the bar of y
# against the plain version (chip_smoke's LINEAR_GELU_REL_L2)
LINEAR_GELU_GRAD_REL_L2 = 4e-3


@pytest.mark.parametrize("m,k,n", [(4804, 1024, 4096), (4800, 768, 3072), (130, 48, 200)])
def test_fused_op_trains_on_the_card(cuda, m, k, n):
    """The fused op under autograd: one fused launch (writing h) and, in the
    backward, one gradient launch; y bit for bit the inference launch's, h
    the inference launch's preact_out; dx, dw and db bit for bit the
    gradient kernel's dh through dh w, dh^T x and its column sums, and
    within LINEAR_GELU_GRAD_REL_L2 of the two-op route."""
    import torch.nn.functional as F

    from ufm_torch.ops import library

    x, w, b = _linear_gelu_inputs(cuda, m, k, n, seed=m)
    dy = torch.randn(m, n, generator=torch.Generator(device=cuda).manual_seed(1), device=cuda).to(torch.bfloat16)
    pre = torch.empty(m, n, dtype=torch.bfloat16, device=cuda)
    y_inf = lg.launch(x, w, b, preact_out=pre)
    leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
    before = (lg.LAUNCHES, ge.LAUNCHES, ge.BWD_LAUNCHES)
    y = library.linear_gelu_bf16(*leaves)
    h = y.grad_fn.saved_tensors[2]
    got = torch.autograd.grad(y, leaves, dy)
    torch.cuda.synchronize()
    assert (lg.LAUNCHES - before[0], ge.LAUNCHES - before[1], ge.BWD_LAUNCHES - before[2]) == (1, 0, 1)
    assert torch.equal(_bits(y.detach()), _bits(y_inf)) and torch.equal(_bits(h), _bits(pre))
    dh = ge.gelu_bf16_bwd(dy, h)
    for a, c in zip(got, (dh.mm(w), dh.t().mm(x), dh.sum(0))):
        assert torch.equal(_bits(a), _bits(c))
    two = [t.clone().requires_grad_(True) for t in (x, w, b)]
    want = torch.autograd.grad(ge.gelu_bf16(F.linear(*two)), two, dy)
    for name, a, c in zip(("dx", "dw", "db"), got, want):
        rel = ((a.float() - c.float()).norm() / c.float().norm()).item()
        assert rel <= LINEAR_GELU_GRAD_REL_L2, (name, rel)


def test_small_model_train_step_takes_the_fused_op(cuda):
    """A small bf16 UFM-Base train step without remat: every MLP through the
    fused fc1 + GELU kernel (writing h) and the fused fc2 input-gradient +
    GELU gradient kernel, no standalone GELU or GELU gradient launch; finite
    metrics."""
    model = UniFlowMatchConfidence.from_config(_small_config(), seed=0)
    step = make_train_step(model.net, make_optimizer(model.net, warmup_steps=0, total_steps=10))
    batch = synthetic_batch(2, 42, 56, seed=0, device=cuda)
    before = (fa.LAUNCHES, fa.BWD_LAUNCHES, ge.LAUNCHES, lg.LAUNCHES, ge.BWD_LAUNCHES, lg.BWD_LAUNCHES)
    metrics = step(batch)
    torch.cuda.synchronize()
    got = (fa.LAUNCHES - before[0], fa.BWD_LAUNCHES - before[1], ge.LAUNCHES - before[2], lg.LAUNCHES - before[3],
           ge.BWD_LAUNCHES - before[4], lg.BWD_LAUNCHES - before[5])
    assert got == (4, 4, 0, 4, 0, 4)
    assert all(torch.isfinite(v) for v in metrics.values())


# ---- the fp32-FMA attention forward (csrc/flash_attention_fwd_any.cu) ------
# (dtype, (B, Sq, Sk, H, D)): the fp32 flagship's two shapes, the fp32
# anchors' D = 32 and 24, bf16 at D != 64, head dims across the domain at
# ragged lengths and Sq != Sk
ANY_CASES = [
    ("float32", (2, 1201, 1201, 16, 64)),
    ("float32", (1, 2400, 2400, 12, 64)),
    ("float32", (2, 13, 13, 2, 32)),
    ("float32", (1, 26, 26, 2, 24)),
    ("float32", (1, 77, 130, 3, 80)),
    ("float32", (2, 130, 65, 2, 128)),
    ("float32", (1, 65, 200, 2, 256)),
    ("float32", (1, 1, 1, 1, 1)),
    ("bfloat16", (2, 1201, 1201, 16, 32)),
    ("bfloat16", (1, 300, 300, 4, 128)),
    ("bfloat16", (1, 77, 130, 3, 24)),
    ("bfloat16", (1, 129, 63, 2, 256)),
    ("float16", (2, 1201, 1201, 16, 64)),
    ("float16", (1, 77, 130, 3, 40)),
]
ANY_FP32_FLOOR = 1e-5
ANY_BF16_FLOOR = 4e-3
LSE_ATOL = 1e-4


def _any_inputs(device, dtype, shape, seed=0):
    """q, k, v as strided views of one (B, S, 3, H, D) tensor where Sq == Sk
    (the models' fused qkv), else three contiguous tensors."""
    b, sq, sk, h, d = shape
    g = torch.Generator(device=device).manual_seed(seed)
    dt = getattr(torch, dtype)
    if sq == sk:
        qkv = torch.randn(b, sq, 3, h, d, generator=g, device=device).to(dt)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    return (torch.randn(b, s, h, d, generator=g, device=device).to(dt) for s in (sq, sk, sk))


def _any_bar(q, k, v, out, scale):
    """(error, bar): the kernel's largest error against an fp64 (fp32 inputs)
    or fp32 (bf16 inputs) reference, and max(2x the plain version's, floor)."""
    fp32 = q.dtype == torch.float32
    wide = torch.float64 if fp32 else torch.float32
    ref = fa.attention_reference(q.to(wide), k.to(wide), v.to(wide), scale)
    plain = fa.attention_reference(q, k, v, scale)
    err = (out.to(wide) - ref).abs().max().item()
    plain_err = (plain.to(wide) - ref).abs().max().item()
    return err, max(2 * plain_err, ANY_FP32_FLOOR if fp32 else ANY_BF16_FLOOR)


@pytest.mark.parametrize("dtype, shape", ANY_CASES, ids=[f"{t}-{'x'.join(map(str, s))}" for t, s in ANY_CASES])
def test_any_kernel_matches_its_plain_version(cuda, dtype, shape):
    """The fp32-FMA kernel (matmul TF32 off) against its plain version's
    error, with the row log-sum-exp; one launch of it, none of the wgmma
    kernel."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _any_inputs(cuda, dtype, shape)
    scale = shape[-1] ** -0.5
    before = (fa.LAUNCHES, fa.ANY_LAUNCHES)
    out, lse = fa.flash_attention_forward(q, k, v, scale, with_lse=True)
    torch.cuda.synchronize()
    assert (fa.LAUNCHES - before[0], fa.ANY_LAUNCHES - before[1]) == (0, 1)
    assert out.dtype == q.dtype and out.shape == q.shape and out.is_contiguous()
    err, bar = _any_bar(q, k, v, out, scale)
    assert torch.isfinite(out).all() and err <= bar, (err, bar)
    _, want_lse = fa.attention_reference(q.double(), k.double(), v.double(), scale, with_lse=True)
    assert (lse.double() - want_lse).abs().max().item() <= LSE_ATOL


def test_forward_routes_by_dtype_and_head_dim(cuda):
    """bf16 at D = 64 keeps the wgmma kernel (its bits unchanged by the
    routing); fp32 at D = 64 and bf16 at D = 32 take the fp32-FMA kernel."""
    q, k, v = _any_inputs(cuda, "bfloat16", (1, 77, 77, 2, 64))
    before = (fa.LAUNCHES, fa.ANY_LAUNCHES)
    first = fa.flash_attention(q, k, v)
    assert torch.equal(first, fa.flash_attention(q, k, v))
    assert (fa.LAUNCHES - before[0], fa.ANY_LAUNCHES - before[1]) == (2, 0)
    fa.flash_attention(q.float(), k.float(), v.float())
    fa.flash_attention(q[..., :32], k[..., :32], v[..., :32])
    torch.cuda.synchronize()
    assert (fa.LAUNCHES - before[0], fa.ANY_LAUNCHES - before[1]) == (2, 2)


def test_any_kernel_reads_any_strides(cuda):
    """A head dim that is not contiguous and an unaligned base are read in
    place: the output equals the kernel's on contiguous copies."""
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(1, 40, 24, 3, device=cuda, generator=g).transpose(2, 3)  # (1, 40, 3, 24), D stride 3
    flat = torch.randn(1 * 40 * 3 * 24 + 1, device=cuda, generator=g)
    shifted = flat[1:].view(1, 40, 3, 24)
    got = fa.flash_attention(x, shifted, shifted)
    want = fa.flash_attention(x.contiguous(), shifted.contiguous(), shifted.contiguous())
    assert torch.equal(got, want)


def test_fp32_backward_raises_naming_dtype_and_head_dim(cuda):
    """The backward takes fp32 now; what lies outside the TPU kernel's
    domain (float64, D = 257) raises naming the dtype and D, before any
    launch."""
    before = (fa.BWD_LAUNCHES, fa.ANY_BWD_LAUNCHES)
    x = torch.zeros(1, 33, 2, 32, device=cuda, dtype=torch.float64)
    lse = torch.zeros(1, 2, 33, device=cuda)
    with pytest.raises(ValueError, match=r"float64 with D = 32"):
        fa.flash_attention_backward(x, x, x, x, lse, x, 0.2)
    y = torch.zeros(1, 33, 2, 257, device=cuda)
    with pytest.raises(ValueError, match=r"float32 with D = 257"):
        fa.flash_attention_backward(y, y, y, y, lse, y, 0.2)
    assert (fa.BWD_LAUNCHES, fa.ANY_BWD_LAUNCHES) == before


def test_fp32_tiny_models_on_the_card(cuda):
    """The fp32 tiny config (D = 32 encoder, D = 24 info sharing) through the
    fp32-FMA kernel against plain attention on the card, both with TF32 off:
    2 + 2 launches a forward, flow within 1e-4."""
    torch.backends.cudnn.allow_tf32 = False
    try:
        model = UniFlowMatchConfidence.from_config(ufm_tiny_config(), seed=0)
        src, tgt = _pairs()
        model.capture_graphs = False
        before = fa.ANY_LAUNCHES
        res = model.predict_correspondences_batched(src, tgt)
        torch.cuda.synchronize()
        layers = model.config.encoder_kwargs["depth"] + model.config.info_sharing_kwargs["depth"]
        assert fa.ANY_LAUNCHES - before == layers
        model.attention_impl = "torch"
        plain = model.predict_correspondences_batched(src, tgt)
        assert (res.flow.flow_output - plain.flow.flow_output).abs().max().item() <= 1e-4
    finally:
        torch.backends.cudnn.allow_tf32 = True


# ---- the fp32-FMA backward (csrc/flash_attention_bwd_any.cu) ------------------

# (dtype, (B, Sq, Sk, H, D)): two small shapes per dtype, ragged against the
# 64-row tiles, one with Sq != Sk and a head dim off the 32-wide instances
ANY_BWD_CASES = [
    ("float32", (2, 77, 77, 2, 64)),
    ("float32", (1, 77, 130, 3, 40)),
    ("bfloat16", (1, 130, 130, 2, 32)),
    ("bfloat16", (1, 65, 129, 2, 128)),
    ("float16", (2, 77, 77, 2, 64)),
    ("float16", (1, 100, 33, 1, 200)),
]
# each gradient within max(2x the plain version's error, this times the
# reference's largest element), both against fp64: fp32's own floor, two bf16
# ulps (the wgmma backward's), and two fp16 ulps
ANY_BWD_FLOOR_REL = {"float32": 1e-5, "bfloat16": 2.0**-7, "float16": 2.0**-10}


@pytest.mark.parametrize("dtype, shape", ANY_BWD_CASES, ids=[f"{t}-{'x'.join(map(str, s))}" for t, s in ANY_BWD_CASES])
def test_any_backward_kernel_matches_fp64(cuda, dtype, shape):
    """One fp32-FMA backward call (after the fp32-FMA forward with lse)
    against the plain version's error of an fp64 reference, with a
    non-contiguous output gradient; one launch of it and none of the wgmma
    backward; a second call gives the same bits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _any_inputs(cuda, dtype, shape, seed=5)
    b, sq, _, h, d = shape
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(6)
    g = torch.randn(b, sq, h, d + 3, generator=gen, device=cuda).to(dt)[..., 3:]
    scale = d**-0.5
    out, lse = fa.flash_attention_forward(q, k, v, scale, with_lse=True)
    before = (fa.BWD_LAUNCHES, fa.ANY_BWD_LAUNCHES)
    grads = fa.flash_attention_backward(q, k, v, out, lse, g, scale)
    again = fa.flash_attention_backward(q, k, v, out, lse, g, scale)
    torch.cuda.synchronize()
    assert (fa.BWD_LAUNCHES - before[0], fa.ANY_BWD_LAUNCHES - before[1]) == (0, 2)
    assert all(torch.equal(a, c) for a, c in zip(grads, again))
    wide = torch.float64
    ref = fa.attention_backward_reference(q.to(wide), k.to(wide), v.to(wide), g.to(wide), scale)
    plain = fa.attention_backward_reference(q, k, v, g, scale)
    for name, got, want, pl in zip(("dq", "dk", "dv"), grads, ref, plain):
        assert got.dtype == dt and got.shape == want.shape and got.is_contiguous(), name
        err = (got.to(wide) - want).abs().max().item()
        bar = max(2 * (pl.to(wide) - want).abs().max().item(), ANY_BWD_FLOOR_REL[dtype] * want.abs().max().item())
        assert torch.isfinite(got).all() and err <= bar, (name, err, bar)


def test_any_backward_through_autograd(cuda):
    """With grad enabled an fp32 call records the fp32-FMA pair: one forward
    launch with lse and one backward call, its gradients those of a direct
    call."""
    q, k, v = (t.detach().clone().requires_grad_(True) for t in _any_inputs(cuda, "float32", (1, 90, 90, 2, 24)))
    before = (fa.ANY_LAUNCHES, fa.ANY_BWD_LAUNCHES, fa.LAUNCHES, fa.BWD_LAUNCHES)
    out = fa.flash_attention(q, k, v)
    g = torch.randn_like(out)
    got = torch.autograd.grad(out, (q, k, v), g)
    assert (fa.ANY_LAUNCHES - before[0], fa.ANY_BWD_LAUNCHES - before[1]) == (1, 1)
    assert (fa.LAUNCHES, fa.BWD_LAUNCHES) == before[2:]
    o, lse = fa.flash_attention_forward(q.detach(), k.detach(), v.detach(), 24**-0.5, with_lse=True)
    want = fa.flash_attention_backward(q.detach(), k.detach(), v.detach(), o, lse, g, 24**-0.5)
    for a, c in zip(got, want):
        assert torch.equal(a, c)


def test_fp32_tiny_train_step_matches_the_cpu(cuda):
    """The fp32 tiny config (D = 32 / 24) takes one train step's gradients on
    the card through the fp32-FMA forward and backward (2 + 2 launches each,
    none of the wgmma kernels) and on the CPU port from the same weights and
    batch, TF32 off: each optimizer group's gradient within 1e-4 relative L2."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = ufm_tiny_config()
        cpu = UniFlowMatchConfidence.from_config(cfg, seed=0, device="cpu")
        card = UniFlowMatchConfidence.from_config(cfg, seed=0)
        card.net.load_state_dict(cpu.net.state_dict())
        batch = synthetic_batch(2, 42, 56, seed=0, device="cpu")
        grads = {}
        for name, model in (("cpu", cpu), ("cuda", card)):
            device = next(model.net.parameters()).device
            b = {k: t.to(device) for k, t in batch.items()}
            before = (fa.ANY_LAUNCHES, fa.ANY_BWD_LAUNCHES, fa.LAUNCHES, fa.BWD_LAUNCHES)
            loss, _ = ufm_total_loss(model.net(b["img1"], b["img2"]), b)
            loss.backward()
            if device.type == "cuda":
                torch.cuda.synchronize()
                layers = cfg.encoder_kwargs["depth"] + cfg.info_sharing_kwargs["depth"]
                assert (fa.ANY_LAUNCHES - before[0], fa.ANY_BWD_LAUNCHES - before[1]) == (layers, layers)
                assert (fa.LAUNCHES, fa.BWD_LAUNCHES) == before[2:]
            grads[name] = {k: t.cpu() for k, t in _group_grads(model.net).items()}
        assert set(grads["cpu"]) == set(grads["cuda"])
        for group, want in grads["cpu"].items():
            rel = ((grads["cuda"][group] - want).norm() / want.norm()).item()
            assert rel <= 1e-4, (group, rel)
    finally:
        torch.backends.cudnn.allow_tf32 = True


# ---- the tensor-core (mma) pair over the rest of the domain: staging paths ----

# (dtype, (B, Sq, Sk, H, D)): ragged Sq and Sk (not multiples of 16 or 64),
# Sq != Sk, the head dims 1, 24, 40 and 256
MMA_CASES = [
    ("float32", (1, 77, 130, 3, 1)),
    ("float32", (2, 13, 50, 2, 24)),
    ("float32", (1, 100, 33, 1, 256)),
    ("float16", (1, 77, 130, 3, 40)),
    ("bfloat16", (1, 33, 100, 2, 256)),
    ("bfloat16", (2, 50, 71, 2, 24)),
]


def _strided(t: torch.Tensor) -> torch.Tensor:
    """The values of ``t`` as a view with D stride 2: no 16-byte copy can take
    its rows, so fp32 is staged by 4-byte cp.async and bf16 / fp16 by plain
    loads."""
    wide = torch.zeros(*t.shape[:-1], 2 * t.shape[-1], dtype=t.dtype, device=t.device)
    view = wide[..., ::2]
    view.copy_(t)
    return view


@pytest.mark.parametrize("dtype, shape", MMA_CASES, ids=[f"{t}-{'x'.join(map(str, s))}" for t, s in MMA_CASES])
def test_mma_pair_against_fp64_on_both_staging_paths(cuda, dtype, shape):
    """The forward and the backward at ragged lengths, Sq != Sk and D = 1 /
    24 / 40 / 256 against fp64 (the forward at chip_smoke's bars, each
    gradient within max(2x the plain version's error, ANY_BWD_FLOOR_REL of
    the largest element)); q and g also as D-strided views, which the
    kernels stage element by element instead of by 16-byte cp.async: the
    same bits either way, and the backward bitwise repeatable."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _any_inputs(cuda, dtype, shape, seed=7)
    b, sq, _, h, d = shape
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(8)
    g = torch.randn(b, sq, h, d, generator=gen, device=cuda).to(dt)
    scale = d**-0.5
    out, lse = fa.flash_attention_forward(q, k, v, scale, with_lse=True)
    out_s, lse_s = fa.flash_attention_forward(_strided(q), k, v, scale, with_lse=True)
    grads = fa.flash_attention_backward(q, k, v, out, lse, g, scale)
    grads_s = fa.flash_attention_backward(_strided(q), k, v, out, lse, _strided(g), scale)
    again = fa.flash_attention_backward(q, k, v, out, lse, g, scale)
    torch.cuda.synchronize()
    assert torch.equal(out, out_s) and torch.equal(lse, lse_s)
    assert all(torch.equal(a, c) for a, c in zip(grads, grads_s))
    assert all(torch.equal(a, c) for a, c in zip(grads, again))
    err, bar = _any_bar(q, k, v, out, scale)
    assert torch.isfinite(out).all() and err <= bar, (err, bar)
    wide = torch.float64
    ref = fa.attention_backward_reference(q.to(wide), k.to(wide), v.to(wide), g.to(wide), scale)
    plain = fa.attention_backward_reference(q, k, v, g, scale)
    for name, got, want, pl in zip(("dq", "dk", "dv"), grads, ref, plain):
        err = (got.to(wide) - want).abs().max().item()
        bar = max(2 * (pl.to(wide) - want).abs().max().item(), ANY_BWD_FLOOR_REL[dtype] * want.abs().max().item())
        assert torch.isfinite(got).all() and err <= bar, (name, err, bar)


@pytest.mark.parametrize("dtype, shape", [("float32", (2, 1201, 1201, 4, 64)), ("float32", (1, 77, 130, 3, 40)),
                                          ("float32", (1, 300, 65, 2, 256))])
def test_mma_backward_recomputes_the_forwards_row_statistics(cuda, dtype, shape):
    """The backward's P, recomputed from the scores and the forward's lse,
    sums to 1 over each row's keys: dv = P^T g, so the sum of dv over the
    keys equals the sum of g over the queries (fp32, within 1e-5 of its
    largest element). A backward whose scores left the forward's order, or
    an lse that was not the scores' own, would miss it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _any_inputs(cuda, dtype, shape, seed=9)
    b, sq, _, h, d = shape
    g = torch.randn(b, sq, h, d, generator=torch.Generator(device=cuda).manual_seed(10), device=cuda)
    scale = d**-0.5
    out, lse = fa.flash_attention_forward(q, k, v, scale, with_lse=True)
    _, _, dv = fa.flash_attention_backward(q, k, v, out, lse, g, scale)
    want = g.double().sum(1)
    assert (dv.double().sum(1) - want).abs().max().item() <= 1e-5 * want.abs().max().item()


# ---- fc2's input gradient with the GELU gradient as its epilogue ----------------


def _linear_gelu_bwd_inputs(device, m, n2, n, seed=0, h_scale=1.0):
    gen = torch.Generator(device=device).manual_seed(seed)
    g = torch.randn(m, n2, generator=gen, device=device).to(torch.bfloat16)
    w2 = (torch.randn(n2, n, generator=gen, device=device) * n2**-0.5).to(torch.bfloat16)
    h = (torch.randn(m, n, generator=gen, device=device) * h_scale).to(torch.bfloat16)
    return g, w2, h


@pytest.mark.parametrize("schedule", list(lg.BWD_SCHEDULES))
@pytest.mark.parametrize("m,n2,n", [(1, 64, 128), (7, 48, 200), (129, 1024, 4096), (300, 200, 136),
                                    (4804, 1024, 4096), (4800, 768, 3072)])
def test_linear_gelu_backward_kernel_against_plain(cuda, schedule, m, n2, n):
    """The fused kernel at the train step's MLP shapes and at M, N2 and N
    tails: dh is bit for bit the plain VJP (and the standalone gradient
    kernel) of the kernel's own dy (the check instance's dy_out); dy is
    within one bf16 ulp of the exact product on all but 0.1% of the
    elements."""
    g, w2, h = _linear_gelu_bwd_inputs(cuda, m, n2, n, seed=m + n, h_scale=3.0)
    dy = torch.empty(m, n, dtype=torch.bfloat16, device=cuda)
    before = lg.BWD_LAUNCHES
    dh = lg.launch_backward(g, w2, h, dy_out=dy, schedule=schedule)
    torch.cuda.synchronize()
    assert lg.BWD_LAUNCHES - before == 1
    assert not _differ(dh, ge.fast_exact_gelu_vjp_reference(h, dy)).any()
    assert not _differ(dh, ge.gelu_bf16_bwd(dy, h)).any()
    assert torch.equal(_bits(lg.launch_backward(g, w2, h, schedule=schedule)), _bits(dh))
    exact = g.double() @ w2.double()
    ulps = (_ordered(dy) - _ordered(exact.to(torch.bfloat16))).abs()
    assert (ulps <= 1).double().mean().item() >= 0.999


def test_linear_gelu_backward_kernel_on_every_bf16_h(cuda):
    """Every bf16 bit pattern as h, under small, unit and large cotangents:
    bit for bit the plain VJP of the kernel's dy (NaN equal to NaN)."""
    h = torch.arange(65536, dtype=torch.int32).to(torch.int16).view(torch.bfloat16).reshape(128, 512).to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(11)
    for scale in (1e-3, 1.0, 30.0):
        g = (torch.randn(128, 64, generator=gen, device=cuda) * scale).to(torch.bfloat16)
        w2 = (torch.randn(64, 512, generator=gen, device=cuda) / 8).to(torch.bfloat16)
        dy = torch.empty(128, 512, dtype=torch.bfloat16, device=cuda)
        dh = lg.launch_backward(g, w2, h, dy_out=dy)
        assert not _differ(dh, ge.fast_exact_gelu_vjp_reference(h, dy)).any()


def test_linear_gelu_backward_kernel_refusals(cuda):
    """Rows off the tile and 3-D operands are taken; fp32, N or N2 off a
    multiple of 8, a misaligned or non-contiguous w2 and CPU tensors are
    refused without a launch."""
    g, w2, h = _linear_gelu_bwd_inputs(cuda, 3 * 43, 32, 128, seed=2)
    got = lg.linear_gelu_bf16_bwd(g.view(3, 43, 32), w2, h.view(3, 43, 128))
    assert got.shape == (3, 43, 128)
    assert torch.equal(_bits(got.view(-1, 128)), _bits(lg.launch_backward(g, w2, h)))
    before = lg.BWD_LAUNCHES
    base = torch.zeros(32 * 128 + 8, dtype=torch.bfloat16, device=cuda)
    bad = [(g.float(), w2, h), (g[:, :30], w2[:30, :], h), (g, w2[:, :100], h[:, :100]),
           (g, base[1:1 + 32 * 128].view(32, 128), h), (g, w2.t().contiguous().t(), h), (g.cpu(), w2.cpu(), h.cpu())]
    for args in bad:
        with pytest.raises(ValueError):
            lg.launch_backward(*args)
    assert lg.BWD_LAUNCHES == before


def test_mlp_gradients_through_the_fused_backward_on_the_card(cuda):
    """A bf16 MLP at the encoder's widths: one fused gradient launch and no
    standalone one; the five gradients against the two-node route's (cuBLAS
    dy, then the standalone gradient) within 4e-3 relative L2, and bit for
    bit where the kernel's dy equals cuBLAS's."""
    from ufm_torch.nn.layers import Mlp

    torch.manual_seed(0)
    mlp = Mlp(1024, 4096).to(cuda, torch.bfloat16)
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(2, 601, 1024, generator=gen, device=cuda).to(torch.bfloat16)
    dy = torch.randn(2, 601, 1024, generator=gen, device=cuda).to(torch.bfloat16)

    def grads(fused):
        xt = x.clone().requires_grad_(True)
        mlp.zero_grad(set_to_none=True)
        before = (lg.BWD_LAUNCHES, ge.BWD_LAUNCHES)
        if fused:
            mlp(xt).backward(dy)
        else:
            mlp.fc2(lg.linear_gelu_bf16(xt, mlp.fc1.weight, mlp.fc1.bias)).backward(dy)
        torch.cuda.synchronize()
        launched = (lg.BWD_LAUNCHES - before[0], ge.BWD_LAUNCHES - before[1])
        return [xt.grad] + [p.grad for p in mlp.parameters()], launched

    got, launched = grads(True)
    assert launched == (1, 0)
    want, launched = grads(False)
    assert launched == (0, 1)
    for a, b in zip(got, want):
        rel = ((a.float() - b.float()).norm() / b.float().norm()).item()
        assert rel <= 4e-3, rel


# ---- the SwiGLU FFN's w12 with the gate in its epilogue (linear_swiglu_bf16_fwd.cu)
def _swiglu_inputs(device, m, k, hidden, seed):
    """x ~ N(0, 1) (a LayerNorm's output), w12 of std 1 / sqrt(K) (the
    seeded init), a bias of std 0.02: h1, h2 ~ N(0, 1)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(m, k, generator=gen, device=device).to(torch.bfloat16)
    w12 = (torch.randn(2 * hidden, k, generator=gen, device=device) * k**-0.5).to(torch.bfloat16)
    b12 = (torch.randn(2 * hidden, generator=gen, device=device) * 0.02).to(torch.bfloat16)
    return x, w12, b12


@pytest.mark.parametrize("m,k,hidden", [(2410, 1536, 4096), (1077, 1536, 4096), (130, 48, 200), (1, 64, 64)])
def test_linear_swiglu_kernel_against_its_rounded_halves(cuda, m, k, hidden):
    """The kernel at the ViT-g/14 cell's shape (M = 2 x 1205), at a ragged M
    and at M, K and H tails: y within one bf16 ulp of the exact gate
    (float64) of the exact halves rounded to bf16, on all but 0.5% of the
    elements (where fp32 summation lands a half on the other side of a bf16
    rounding boundary: ~K 2^-24 / 2^-9 of them a half); within 4e-3 relative
    L2 (bf16's epsilon) of the composition the FFN runs without it (cuBLAS's
    F.linear, then the gate)."""
    x, w12, b12 = _swiglu_inputs(cuda, m, k, hidden, seed=m + k + hidden)
    before = ls.LAUNCHES
    y = ls.launch(x, w12, b12)
    torch.cuda.synchronize()
    assert ls.LAUNCHES - before == 1 and y.shape == (m, hidden)
    h = (x.double() @ w12.double().t() + b12.double()).float().to(torch.bfloat16).double()
    h1, h2 = h.chunk(2, dim=-1)
    want = h1 * torch.sigmoid(h1) * h2
    ulps = (_ordered(y) - _ordered(want.float().to(torch.bfloat16))).abs()
    assert (ulps <= 1).double().mean().item() >= 0.995
    plain = ls.linear_swiglu_reference(x, w12, b12).float()
    assert ((y.float() - plain).norm() / plain.norm().clamp_min(1e-30)).item() <= 4e-3


def test_linear_swiglu_kernel_layouts_refusals_and_capture(cuda):
    """A 3-D and a non-contiguous x; an empty x launches nothing; fp32, an
    odd w12, K or H off a multiple of 8, a misaligned operand and a CPU
    tensor are refused without a launch; the launch captures in the
    strictest mode and each replay computes the new input's output."""
    x, w12, b12 = _swiglu_inputs(cuda, 260, 64, 96, seed=1)
    x3 = x.view(2, 130, 64)
    got = ls.linear_swiglu_bf16(x3, w12, b12)
    strided = x3.transpose(0, 1).contiguous().transpose(0, 1)
    assert got.shape == (2, 130, 96) and torch.equal(_bits(got), _bits(ls.linear_swiglu_bf16(strided, w12, b12)))
    before = ls.LAUNCHES
    assert ls.linear_swiglu_bf16(x3[:, :0], w12, b12).shape == (2, 0, 96) and ls.LAUNCHES == before
    flat = torch.zeros(65 * 64 + 8, dtype=torch.bfloat16, device=cuda)
    for args, match in [((x.float(), w12, b12), "bfloat16"), ((x, w12[:191], b12[:191]), "2H"),
                        ((x[:, :60], w12[:, :60], b12), "multiples of 8"),
                        ((x, w12[:180], b12[:180]), "multiples of 8"),
                        ((flat[1:1 + 65 * 64].view(65, 64), w12, b12), "aligned"), ((x.cpu(), w12, b12), "CUDA")]:
        with pytest.raises(ValueError, match=match):
            ls.launch(*args)
    assert ls.LAUNCHES == before
    x, w12, b12 = _swiglu_inputs(cuda, 2410, 1536, 4096, seed=3)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="global"):
        out = ls.linear_swiglu_bf16(x, w12, b12)
    for seed in (4, 5):
        x.copy_(_swiglu_inputs(cuda, 2410, 1536, 4096, seed=seed)[0])
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(_bits(out), _bits(ls.launch(x, w12, b12)))


def test_vitg_reg_replay_runs_the_swiglu_kernel(cuda):
    """UFM-Base on DINOv2 ViT-g/14 with registers, captured at batch 1: every
    replay adds 40 to the SwiGLU counter (one a ViT-g block), 12 to the fused
    fc1 + GELU counter (the info sharing) and 52 to the attention's; the
    profiler sees 40 ``linear_swiglu_bf16_fwd_kernel`` and 12
    ``linear_gelu_bf16_fwd_kernel`` in one replay; the outputs are finite.
    Under grad mode the FFN takes the plain composition (no launch)."""
    import re

    from torch.profiler import ProfilerActivity, profile

    from ufm_torch.models import ufm_base_vitg_reg_config

    model = UniFlowMatchConfidence.from_config(ufm_base_vitg_reg_config(), seed=0)
    src, tgt = _pairs()
    model.predict_correspondences_batched(src, tgt)  # captures
    torch.cuda.synchronize()
    for _ in range(2):
        before = (ls.LAUNCHES, lg.LAUNCHES, fa.LAUNCHES)
        res = model.predict_correspondences_batched(src, tgt)
        torch.cuda.synchronize()
        assert (ls.LAUNCHES - before[0], lg.LAUNCHES - before[1], fa.LAUNCHES - before[2]) == (40, 12, 52)
        assert all(bool(torch.isfinite(t).all()) for t in _fields(res).values())
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        model.predict_correspondences_batched(src, tgt)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    count = {k: sum(bool(re.search(rf"(?<![A-Za-z_]){k}", n)) for n in names)
             for k in ("linear_swiglu_bf16_fwd_kernel", "linear_gelu_bf16_fwd_kernel")}
    assert count == {"linear_swiglu_bf16_fwd_kernel": 40, "linear_gelu_bf16_fwd_kernel": 12}
    ffn = model.net.encoder.blocks[0].mlp
    x = torch.randn(1, 8, 1536, device=cuda).to(torch.bfloat16).requires_grad_(True)
    before = ls.LAUNCHES
    ffn(x).float().sum().backward()
    assert ls.LAUNCHES == before and x.grad is not None
