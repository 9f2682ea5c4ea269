"""The arithmetic of the tensor-core attention kernels, emulated on the CPU.

``csrc/flash_attention_fwd_any.cu`` and ``csrc/flash_attention_bwd_any.cu``
run every product on the tensor cores as ``mma.sync.m16n8k8`` with TF32
operands (``csrc/attention_mma.cuh``). An fp32 operand x takes two TF32
terms, hi = ``cvt.rna.tf32.f32(x)`` and lo = ``cvt.rna.tf32.f32(x - hi)``,
and a product of two such operands sums lo x hi, hi x lo, then hi x hi
(3xTF32); bf16 and fp16 values are exact in TF32 and take one term. This
file emulates that arithmetic in torch at tiny sizes, with no card and no
JAX, and holds it to the bars ``chip_smoke.py`` holds the kernels to:

- the emulated ``cvt.rna.tf32.f32`` (round to nearest, ties away from zero,
  on an int32 view) leaves every finite bf16 and fp16 value unchanged;
- the emulated 3xTF32 forward (64-key tiles and the online softmax, as the
  kernel walks them) and backward, at B = 1, S = 193 (a ragged last tile)
  and D in {24, 32, 64}, lie within max(2x the plain fp32 version's error,
  1e-5) of an fp64 reference (the forward's ``ANY_FP32_ERR_FLOOR``; the
  backward's 1e-5 of the largest element, ``ANY_BWD_FLOOR_REL``);
- a single TF32 term misses that bar at the same inputs, which is why an
  fp32 operand takes two;
- the bf16 and fp16 forwards, S from one term of each operand and P V from
  two terms of P against the exact V, put every output element within one
  ulp of its type of the fp64 reference (+1e-5, chip_smoke's bar);
- a sum over a long row (1201 keys, the flagship's) kept inside one chain
  of mma misses the backward's fp32 bar, and the kernels' partial sums (the
  forward's P V a 64-key tile at a time, the backward's gradients 128
  streamed rows at a time, each added to the running sum in fp32) meet it.

The tensor core's sum inside one ``mma`` is modelled as exact, rounded to
fp32 toward zero once a k-step (the pessimistic rounding), in the kernels'
order of k-steps and terms. Inputs are made from a seed with numpy.
"""

import numpy as np
import pytest
import torch

from ufm_torch.ops import flash_attention as fa

SEED = 20261017
B, S, H = 1, 193, 2
BLOCK_K = 64  # the forward's key tile at D <= 64
BLOCK_S = 128  # the backward's partial sums: two 64-row streamed tiles at D <= 64
FWD_FLOOR = 1e-5  # chip_smoke ANY_FP32_ERR_FLOOR
BWD_FLOOR_REL = 1e-5  # chip_smoke ANY_BWD_FLOOR_REL["float32"]
# significant bits and the smallest normal exponent (frexp's) of the 16-bit types
HALF_TYPES = {torch.bfloat16: (8, -125), torch.float16: (11, -13)}


@pytest.fixture(autouse=True)
def one_thread():
    """The emulation is many small fp64 products and elementwise passes: one
    torch thread a test, so that parallel test workers do not oversubscribe
    the cores (8 threads in each of 6 workers made the long-row test ~100x
    slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: fp32 rounded to 10 fraction bits, to nearest,
    ties away from zero (the low 13 bits cleared)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def terms(x: torch.Tensor, n: int):
    """x (fp32) as n TF32 terms: (x,) where x is exact (n = 1 on a 16-bit
    value, or the single-term emulation), (hi, lo) for n = 2."""
    if n == 1:
        return (tf32_rna(x),)
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def _fp32_toward_zero(x: torch.Tensor) -> torch.Tensor:
    y = x.to(torch.float32)
    over = y.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)


def mma(a: torch.Tensor, b: torch.Tensor, na: int, nb: int, acc=None) -> torch.Tensor:
    """acc + a @ b (fp32 (..., M, K) and (..., K, N)) as the kernels' mma
    run it: K in steps of 8, each step the small-term products (a.lo b.hi,
    then a.hi b.lo, where an operand has two terms), then hi x hi, each mma
    summed exactly and added to the fp32 accumulator rounded toward zero."""
    at, bt = terms(a, na), terms(b, nb)
    pairs = []
    if na == 2:
        pairs.append((at[1], bt[0]))
    if nb == 2:
        pairs.append((at[0], bt[1]))
    pairs.append((at[0], bt[0]))
    k = a.shape[-1]
    out = torch.zeros(*a.shape[:-1], b.shape[-1], dtype=torch.float32) if acc is None else acc
    for k0 in range(0, k, 8):
        for x, y in pairs:
            part = x[..., k0:k0 + 8].double() @ y[..., k0:k0 + 8, :].double()
            out = _fp32_toward_zero(out.double() + part)
    return out


def tiled_mma(a: torch.Tensor, b: torch.Tensor, na: int, nb: int, block) -> torch.Tensor:
    """a @ b over K in tiles of ``block``, each tile summed by :func:`mma`
    in a fresh accumulator and added to the running sum in fp32 (the
    kernels' per-tile sums); ``block=None`` keeps all of K in one chain."""
    if block is None:
        return mma(a, b, na, nb)
    out = None
    for k0 in range(0, a.shape[-1], block):
        part = mma(a[..., k0:k0 + block], b[..., k0:k0 + block, :], na, nb)
        out = part if out is None else out + part
    return out


def emulated_forward(q, k, v, scale, n: int, chained: bool = False):
    """The kernel's forward on (B, S, H, D) inputs: S = Q K^T with n terms
    an fp32 operand (one for a 16-bit input), the online softmax over 64-key
    tiles in fp32, O = O alpha + P V with P in two terms (n for the
    single-term emulation) and V in n (one if 16-bit), each tile's P V summed
    apart (``chained``: inside O's own chain), then O / l. Returns (out fp32
    (B, S, H, D), lse (B, H, S))."""
    two = n == 2 and q.dtype == torch.float32
    nq = 2 if two else 1
    qh, kh, vh = (x.float().transpose(1, 2) for x in (q, k, v))  # (B, H, S, D)
    sq, sk = qh.shape[2], kh.shape[2]
    m = torch.full((*qh.shape[:3], 1), -torch.inf)
    l = torch.zeros_like(m)
    o = torch.zeros_like(qh)
    for k0 in range(0, sk, BLOCK_K):
        kt, vt = kh[:, :, k0:k0 + BLOCK_K], vh[:, :, k0:k0 + BLOCK_K]
        s = mma(qh, kt.transpose(-1, -2), nq, nq) * scale
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        if chained:
            o = mma(p, vt, 2 if n == 2 else 1, nq, acc=o * alpha)
        else:
            o = o * alpha + mma(p, vt, 2 if n == 2 else 1, nq)
        m = m_new
    return (o / l).transpose(1, 2), (m + torch.log(l)).squeeze(-1)


def emulated_backward(q, k, v, g, o, lse, scale, n: int, chained: bool = False):
    """The kernel's backward on fp32 inputs with n terms an operand: P =
    exp(S * scale - lse) from the recomputed scores, dP = g V^T, delta =
    rowsum(g * o), dS = P (dP - delta), dQ = dS K * scale, dK = dS^T Q *
    scale, dV = P^T g, every product emulated, the gradients summed in
    partial sums of 128 streamed rows (``chained``: in one chain)."""
    qh, kh, vh, gh, oh = (x.float().transpose(1, 2) for x in (q, k, v, g, o))
    s = mma(qh, kh.transpose(-1, -2), n, n)
    p = torch.exp(s * scale - lse[..., None])
    dp = mma(gh, vh.transpose(-1, -2), n, n)
    delta = (gh * oh).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    block = None if chained else BLOCK_S
    dq = tiled_mma(ds, kh, n, n, block) * scale
    dk = tiled_mma(ds.transpose(-1, -2), qh, n, n, block) * scale
    dv = tiled_mma(p.transpose(-1, -2), gh, n, n, block)
    return tuple(x.transpose(1, 2) for x in (dq, dk, dv)), p


def _inputs(d: int, dtype=torch.float32, s: int = S, h: int = H):
    rng = np.random.default_rng(SEED + d)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((B, s, h, d), dtype=np.float32)).to(dtype) for _ in range(4))
    return q, k, v, g


def _fwd_error(d: int, n: int, s: int = S, h: int = H, chained: bool = False):
    q, k, v, _ = _inputs(d, s=s, h=h)
    scale = d**-0.5
    wide = torch.float64
    ref = fa.attention_reference(q.to(wide), k.to(wide), v.to(wide), scale)
    plain = fa.attention_reference(q, k, v, scale)
    out, _ = emulated_forward(q, k, v, scale, n, chained)
    bar = max(2 * (plain.to(wide) - ref).abs().max().item(), FWD_FLOOR)
    return (out.to(wide) - ref).abs().max().item(), bar


def _bwd_errors(d: int, n: int, s: int = S, h: int = H, chained: bool = False):
    q, k, v, g = _inputs(d, s=s, h=h)
    scale = d**-0.5
    wide = torch.float64
    out, lse = emulated_forward(q, k, v, scale, n, chained)
    grads, p = emulated_backward(q, k, v, g, out, lse, scale, n, chained)
    ref = fa.attention_backward_reference(q.to(wide), k.to(wide), v.to(wide), g.to(wide), scale)
    plain = fa.attention_backward_reference(q, k, v, g, scale)
    errs = {}
    for name, got, want, pl in zip(("dq", "dk", "dv"), grads, ref, plain):
        bar = max(2 * (pl.to(wide) - want).abs().max().item(), BWD_FLOOR_REL * want.abs().max().item())
        errs[name] = ((got.to(wide) - want).abs().max().item(), bar)
    return errs, p


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_tf32_rounding_keeps_every_16_bit_value(dtype):
    """Every finite bf16 / fp16 value, widened to fp32, is a TF32 value: the
    emulated cvt.rna.tf32.f32 returns it bit for bit (so a 16-bit operand
    takes one term and its lo term is 0)."""
    x = torch.arange(-(2**15), 2**15, dtype=torch.int32).to(torch.int16).view(dtype).float()
    x = x[torch.isfinite(x)]
    assert x.numel() == (65280 if dtype == torch.bfloat16 else 63488)
    assert torch.equal(tf32_rna(x).view(torch.int32), x.view(torch.int32))
    hi, lo = terms(x, 2)
    assert torch.equal(hi, x) and not lo.any()


def test_tf32_rounding_is_to_nearest_ties_away():
    """The emulation rounds at bit 13: below half down, half and above away
    from zero, on both signs; two terms hold an fp32 value to ~2^-22."""
    one = torch.tensor([1.0], dtype=torch.float32).view(torch.int32).item()
    raw = torch.tensor([one + 0xFFF, one + 0x1000, one + 0x2FFF, one + 0x3000], dtype=torch.int32)
    x = torch.cat([raw.view(torch.float32), -raw.view(torch.float32)])
    want = torch.tensor([one, one + 0x2000, one + 0x2000, one + 0x4000], dtype=torch.int32).view(torch.float32)
    assert torch.equal(tf32_rna(x), torch.cat([want, -want]))
    y = torch.from_numpy(np.random.default_rng(SEED).standard_normal(4096, dtype=np.float32))
    hi, lo = terms(y, 2)
    assert ((hi.double() + lo.double() - y.double()).abs() <= y.double().abs() * 2.0**-21).all()


@pytest.mark.parametrize("d", [24, 32, 64])
def test_3xtf32_forward_within_the_fp32_bar(d):
    """The emulated 3xTF32 forward (ragged 64-key tiles, the online softmax)
    within max(2x the plain fp32 error, 1e-5) of fp64, and its lse within
    chip_smoke's 1e-4."""
    err, bar = _fwd_error(d, 2)
    assert err <= bar, (err, bar)
    q, k, v, _ = _inputs(d)
    _, lse = emulated_forward(q, k, v, d**-0.5, 2)
    _, want = fa.attention_reference(q.double(), k.double(), v.double(), d**-0.5, with_lse=True)
    assert (lse.double() - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("d", [24, 32, 64])
def test_3xtf32_backward_within_the_fp32_bar(d):
    """The emulated 3xTF32 backward (P recomputed from the emulated forward's
    lse) within max(2x the plain fp32 error, 1e-5 of the largest element) of
    fp64 for dq, dk and dv; P's rows sum to 1 (the lse is the recomputed
    scores' own)."""
    errs, p = _bwd_errors(d, 2)
    for name, (err, bar) in errs.items():
        assert err <= bar, (name, err, bar)
    assert (p.sum(-1).double() - 1).abs().max().item() <= 1e-5


def test_single_tf32_term_misses_the_fp32_bar():
    """One TF32 term an fp32 operand (~3 decimal digits) misses both bars at
    the same inputs: the reason an fp32 operand takes two."""
    err, bar = _fwd_error(64, 1)
    assert err > bar, (err, bar)
    errs, _ = _bwd_errors(64, 1)
    assert all(err > bar for err, bar in errs.values()), errs


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [24, 32, 64])
def test_16_bit_forward_within_one_ulp(dtype, d):
    """bf16 / fp16 inputs: S from one term of each operand, P in two terms
    against the exact V, the output rounded once to the type: every element
    within one ulp of the fp64 reference rounded to the type (+1e-5)."""
    q, k, v, _ = _inputs(d, dtype)
    scale = d**-0.5
    out, _ = emulated_forward(q, k, v, scale, 2)
    out = out.to(dtype).double()
    ref = fa.attention_reference(q.double(), k.double(), v.double(), scale).to(dtype).double()
    bits, min_e = HALF_TYPES[dtype]
    _, e = torch.frexp(ref)
    ulp = torch.where(ref == 0, torch.zeros_like(ref), torch.ldexp(torch.ones_like(ref), e.clamp(min=min_e) - bits))
    excess = ((out - ref).abs() - ulp).max().item()
    assert excess <= FWD_FLOOR, excess


def test_per_tile_sums_keep_long_rows_within_the_bar():
    """At the flagship's row length (1201 keys, D = 64), a 3xTF32 sum kept
    inside one chain of truncating mma misses the fp32 bar in the backward
    and loses several times the forward's error; the kernels' partial sums
    meet both."""
    long_row = dict(d=64, n=2, s=1201, h=1)
    chained, bar = _fwd_error(**long_row, chained=True)
    err, _ = _fwd_error(**long_row)
    assert err <= bar and 3 * err < chained, (err, chained, bar)
    chained, _ = _bwd_errors(**long_row, chained=True)
    assert any(err > bar for err, bar in chained.values()), chained
    tiled, _ = _bwd_errors(**long_row)
    assert all(err <= bar for err, bar in tiled.values()), tiled
