"""ufm_torch on the card: the Hopper kernels and the models' kernel paths.

These tests need an NVIDIA GPU and nvcc and skip elsewhere. This file imports
neither JAX nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_port_gpu.py -m cuda --noconftest -q
"""

import pytest
import torch

from ufm_torch.models import UniFlowMatchClassificationRefinement, UniFlowMatchConfidence, ufm_tiny_config
from ufm_torch.ops import flash_attention as fa
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
    x = torch.zeros(1, 8, 2, 64, device=cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        fa.flash_attention(x, x, x)
    y = torch.zeros(1, 8, 2, 32, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="64"):
        fa.flash_attention(y, y, y)


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
    of a forward goes through the kernel, and the outputs stay close to the
    plain-attention path (bf16 rounding over 4 layers)."""
    model = UniFlowMatchConfidence.from_config(_small_config(), seed=0)
    src, tgt = _pairs()
    before = fa.LAUNCHES
    res = model.predict_correspondences_batched(src, tgt)
    torch.cuda.synchronize()
    assert fa.LAUNCHES - before == 4
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


def test_window_kernel_refuses_what_it_does_not_take(cuda):
    q, f, flow, bias = _window_inputs(cuda, (1, 6, 7, 8), 5, 3.0)
    with pytest.raises(ValueError, match="CUDA"):
        wr.window_refinement(q.cpu(), f.cpu(), flow.cpu(), bias.cpu(), 4.0, 5)
    with pytest.raises(ValueError, match="float32"):
        wr.window_refinement(q.half(), f.half(), flow, bias, 4.0, 5)
    q5, f5, flow5, bias5 = _window_inputs(cuda, (1, 6, 7, 5), 5, 3.0)
    with pytest.raises(ValueError, match="impl='torch'"):
        wr.window_refinement(q5, f5, flow5, bias5, 4.0, 5)


def test_window_kernel_gradients_match_plain(cuda):
    """The autograd.Function's backward (autograd over the plain version)
    against autograd through the plain version itself."""
    inputs = _window_inputs(cuda, (1, 8, 8, 16), 5, 6.0)

    def grads(fn):
        ins = [t.clone().requires_grad_(True) for t in inputs]
        res, ls = fn(*ins, 4.0, 5)
        (res.pow(2).sum() + ls.mean()).backward()
        return [t.grad for t in ins]

    for got, want in zip(grads(wr.window_refinement), grads(wr.window_refinement_reference)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


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
    UFM-Refine window backward is autograd over its plain version in both.
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
