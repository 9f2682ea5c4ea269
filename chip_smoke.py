#!/usr/bin/env python3
"""Chip smoke check of the PyTorch / CUDA port (``ufm_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``ufm_torch/csrc`` (nvcc, sm_90a, one
process per source, all started together) and reads their SASS (the
attention libraries must hold wgmma (HGMMA) instructions, and ptxas must not
have serialized them), holds each kernel against its plain PyTorch version
at the main paths' shapes (the attention backward also for bitwise
repeatability), compares the card's bf16 GELU with the CPU's on every finite
bf16 input, then drives three paths with seeded random weights at full
width:

- UFM-Base (ViT-L/14 encoder, 24 layers; 12 info-sharing layers; both DPT
  heads; 560x420), answering requests through
  ``predict_correspondences_batched``: 36 flash-attention launches per
  forward;
- UFM-Refine (the same backbone and heads, the patch-MLP classification head,
  the UNet and the window refinement), the same way: 36 flash-attention
  launches and 1 window-refinement launch per forward;
- UFM-Base training at batch 2 on 420x560 (``make_train_step`` and ``fit``,
  fp32 master weights): 36 flash-attention forward launches and 36 backward
  calls per step.

Each path's launch counts are set to 0 just before it and read just after.
Each phase prints one JSON line; any failed check raises and the script exits
non-zero without printing a result. The last three lines are the card's name
and power limit (as ``nvidia-smi`` prints them), the kernels' summary, and
``{"ok": true, "device": {...}}``.

Needs a CUDA device and the ``ufm_torch`` package beside this script.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published dense peaks (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12  # without tensor cores
PEAK_BYTES = 3.35e12

# main-path attention shapes at batch 1 and their calls per forward
ATTN_SHAPES = (
    ("encoder", (2, 1201, 16, 64), 24),
    ("info_sharing", (1, 2400, 12, 64), 12),
    ("ragged", (1, 77, 2, 64), 0),
)
LAUNCHES_PER_FORWARD = sum(n for _, _, n in ATTN_SHAPES)  # 36

# kernel vs the fp32 reference on the same bf16 inputs: at most twice the
# plain bf16 version's error (which rounds the logits to bf16), and never
# held tighter than 4e-3 (a few bf16 ulps of outputs of order 1)
KERNEL_ERR_FLOOR = 4e-3

# main-path attention shapes of a batch-2 train step (the encoder sees both
# views: 2B) and their backward calls per step
ATTN_BWD_SHAPES = (
    ("encoder", (4, 1201, 16, 64), 24),
    ("info_sharing", (2, 2400, 12, 64), 12),
    ("ragged", (1, 77, 2, 64), 0),
)
# backward kernel vs the fp32 reference: each of dq, dk, dv within twice the
# plain bf16 backward's error, and never held tighter than two bf16 ulps of
# the reference's largest element (2^-7 of it)
BWD_ERR_FLOOR_REL = 2.0**-7
# the forward's row log-sum-exp vs torch.logsumexp of the fp32 scores
# (values ~10: fp32 rounding of the scores and of exp2 / log2)
LSE_ATOL = 1e-4
# time_ms queues each timed batch behind this many cycles of device sleep
# (~25 ms at 1.98 GHz), far longer than the host takes to enqueue a batch
QUEUE_SLEEP_CYCLES = 50_000_000
# host time per launch: back-to-back launches without a sync at a shape whose
# kernels take less device time than the host spends launching them
LAUNCH_HOST_REPS = 1000
# card vs CPU bf16 GELU (the JAX chain, four bf16 roundings): the two
# frameworks' fp32 erfc may differ in the last fp32 bit, one bf16 ulp after
# rounding
GELU_MAX_ULP = 1
# the MLP hidden activations of one batch-1 forward, and their MLPs per
# forward: the encoder's (2 views x 1201 tokens, 4096) and the info
# sharing's (2400 tokens, 3072)
GELU_SHAPES = (("encoder", (2, 1201, 4096), 24), ("info_sharing", (1, 2400, 3072), 12))
ATTENTION_LIBRARIES = ("flash_attention_fwd", "flash_attention_bwd")

# training: batch 2 at the model resolution (the JAX package's train
# benchmark shape, bench_train.py), one warm-up and 3 timed steps of
# make_train_step at the JAX package's defaults (peak learning rate 1e-4,
# 100 warm-up steps of 10000; the first step's rate is 0), then 2 steps of
# fit. fit's schedule spans its own 2 steps and so cannot warm up: it runs
# at 3e-6, the rate the warm-up has reached by then (1e-4 without warm-up
# makes the loss of the random model jump, measured on an H100)
TRAIN_BATCH, TRAIN_HW = 2, (420, 560)
TRAIN_STEPS, FIT_STEPS = 4, 2
TRAIN_LR, TRAIN_WARMUP, TRAIN_TOTAL_STEPS = 1e-4, 100, 10000
FIT_LR = 3e-6
# kernel vs plain-attention gradients at batch 1, relative L2 per optimizer
# group: the plain path rounds all 36 layers' logits to bf16 where the kernels
# keep them in fp32 (forward flow relative L2 1.5e-2 for the same reason);
# the gradients carry that rounding through the forward and the backward
TRAIN_GRAD_REL_L2_BOUND = 1e-1
# main path with the kernel vs the same weights with the plain attention:
# bf16 rounding of 36 attention layers (the plain version rounds its logits to
# bf16, the kernel keeps them in fp32) feeds the fp32 heads
FLOW_REL_L2_BOUND = 2e-2

# window-refinement cases: (B, H, W, C), P, flow scale in px. "flagship" is
# the main path's shape at batch 1 (one call per forward); "edges" puts
# windows across every border plus one far outside each image on both sides
WINDOW_CASES = (
    ("flagship", (1, 420, 560, 16), 5, 6.0, 1),
    ("edges", (2, 24, 44, 8), 5, 40.0, 0),
    ("small_window", (2, 24, 44, 4), 3, 15.0, 0),
)
# kernel vs plain version, both fp32 (the bars of tests/test_window_dots.py)
WINDOW_RESIDUAL_ATOL = 2e-5
WINDOW_LOG_SOFTMAX_ATOL = 2e-4
# refined flow with the window kernel vs the plain refinement, same weights
# and attention path: only the fp32 summation order differs
REFINED_FLOW_MAX_ABS = 1e-3
WINDOW_TEMPERATURE = 4.0


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def time_ms(fn, reps: int = 10, batches: int = 7) -> float:
    """Median over ``batches`` of CUDA-event time per call, ``reps`` calls a
    batch, after a warm-up. Each batch queues behind a device sleep, so the
    events time the card even where a call's launch costs the host more than
    the card's run of it."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def phase_device() -> str:
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false: this check needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    emit(
        "device",
        nvidia_smi=smi,
        name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(),
        torch=torch.__version__,
        cuda=torch.version.cuda,
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
    )
    return smi


def sass_counts(path) -> dict:
    """HGMMA (wgmma) and UTMALDG (TMA load) instructions in a library's SASS."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "--dump-sass", str(path)], capture_output=True, text=True, timeout=300,
                          check=True).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in ("HGMMA", "UTMALDG")}


def ptxas_report(log: str) -> dict:
    """Registers and spill bytes of each kernel in nvcc's ``-Xptxas -v``
    output, by kernel name (template arguments kept, as mangled)."""
    out = {}
    for m in re.finditer(r"Compiling entry function '(\w+)'.*?(\d+) bytes spill stores, (\d+) bytes spill loads"
                         r".*?Used (\d+) registers", log, re.S):
        short = re.search(r"[a-z][a-z_]*_kernel(?:I(?:L[ib]\d+E)+E)?", m.group(1))
        out[short.group(0) if short else m.group(1)] = {
            "registers": int(m.group(4)), "spill_stores": int(m.group(2)), "spill_loads": int(m.group(3))}
    return out


def phase_build():
    import ufm_torch
    from ufm_torch.ops import _build

    pkg = os.path.dirname(os.path.abspath(ufm_torch.__file__))
    check(os.path.dirname(pkg) == HERE, f"ufm_torch imported from {pkg}, not from this checkout")
    t0 = time.perf_counter()
    paths = _build.build(force=True)  # from this checkout's sources, with nvcc's report
    seconds = time.perf_counter() - t0
    ptxas = {n: ptxas_report(log) for n, log in _build.BUILD_LOGS.items()}
    sass = {n: sass_counts(p) for n, p in zip(_build.KERNEL_SOURCES, paths)}
    # ptxas's warning when it cannot keep wgmma instructions in flight together
    # ("... wgmma.mma_async instructions are serialized due to ...")
    serialized = {n: [ln.strip() for ln in log.splitlines() if "wgmma" in ln and "serialized" in ln]
                  for n, log in _build.BUILD_LOGS.items()}
    serialized = {n: lines for n, lines in serialized.items() if lines}
    emit("build", seconds=seconds, kernels=list(_build.KERNEL_SOURCES), ptxas=ptxas, sass=sass,
         wgmma_serialized=serialized)
    for name in ATTENTION_LIBRARIES:
        check(sass[name]["HGMMA"] > 0, f"{name}: no HGMMA (wgmma) instruction in its SASS")
    check(not serialized, f"ptxas serialized the wgmma instructions of {sorted(serialized)}")


def attention_bound_ms(b, s, h, d):
    flops = 4 * b * h * s * s * d
    nbytes = 4 * b * s * h * d * 2  # q, k, v read once, out written once, bf16
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase_kernel():
    import torch.nn.functional as F

    from ufm_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for name, (b, s, h, d), calls in ATTN_SHAPES:
        if calls:  # the main path's layout: strided views of the fused qkv projection
            qkv = torch.randn(b, s, 3, h, d, generator=gen, device="cuda").to(torch.bfloat16)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        else:
            q, k, v = (torch.randn(b, s, h, d, generator=gen, device="cuda").to(torch.bfloat16) for _ in range(3))
        scale = d**-0.5
        out = fa.flash_attention(q, k, v, scale=scale)
        plain = fa.attention_reference(q, k, v, scale)
        torch.cuda.synchronize()
        ref = fa.attention_reference(q.float(), k.float(), v.float(), scale)
        err = (out.float() - ref).abs().max().item()
        plain_err = (plain.float() - ref).abs().max().item()
        tol = max(2 * plain_err, KERNEL_ERR_FLOOR)
        check(bool(torch.isfinite(out).all()), f"{name}: kernel output not finite")
        check(err <= tol, f"{name}: kernel error {err:.3e} > {tol:.3e}")

        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        ms = time_ms(lambda: fa.flash_attention(q, k, v, scale=scale))
        plain_ms = time_ms(lambda: fa.attention_reference(q, k, v, scale), reps=3, batches=5)
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale))
        bound_ms, bound_by = attention_bound_ms(b, s, h, d)
        rows[name] = dict(
            shape=[b, s, h, d], calls_per_forward=calls, max_abs_err=err, plain_max_abs_err=plain_err, tol=tol,
            ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
            share_of_bound=bound_ms / ms, tflops=4 * b * h * s * s * d / ms / 1e9,
        )
        emit("kernel", kernel="flash_attention_fwd", case=name, **rows[name])
    return rows


def attention_bwd_bound_ms(b, s, h, d):
    """The backward's own cost: 10 B H S^2 D operations (five S x S x D
    products, the TPU kernel's CostEstimate); q, k, v, o, g read once, dq,
    dk, dv written once (bf16), lse read and delta written once (fp32)."""
    flops = 10 * b * h * s * s * d
    nbytes = 8 * b * s * h * d * 2 + 2 * b * h * s * 4
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase_bwd_kernel():
    import torch.nn.functional as F

    from ufm_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = {}
    for name, (b, s, h, d), calls in ATTN_BWD_SHAPES:
        if calls:  # the main path's layout: strided views of the fused qkv projection
            qkv = torch.randn(b, s, 3, h, d, generator=gen, device="cuda").to(torch.bfloat16)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        else:
            q, k, v = (torch.randn(b, s, h, d, generator=gen, device="cuda").to(torch.bfloat16) for _ in range(3))
        g = torch.randn(b, s, h, d, generator=gen, device="cuda").to(torch.bfloat16)
        scale = d**-0.5
        out, lse = fa.flash_attention_forward(q, k, v, scale, with_lse=True)
        grads = fa.flash_attention_backward(q, k, v, out, lse, g, scale)
        plain = fa.attention_backward_reference(q, k, v, g, scale)
        torch.cuda.synchronize()
        ref = fa.attention_backward_reference(q.float(), k.float(), v.float(), g.float(), scale)
        errs = {}
        for gname, got, want, pl in zip(("dq", "dk", "dv"), grads, ref, plain):
            err = (got.float() - want).abs().max().item()
            plain_err = (pl.float() - want).abs().max().item()
            tol = max(2 * plain_err, BWD_ERR_FLOOR_REL * want.abs().max().item())
            check(_finite(got), f"backward {name}: {gname} not finite")
            check(err <= tol, f"backward {name}: {gname} error {err:.3e} > {tol:.3e}")
            errs[gname] = dict(max_abs_err=err, plain_max_abs_err=plain_err, tol=tol)
        del ref, plain
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
        lse_err = (lse - torch.logsumexp(scores, dim=-1)).abs().max().item()
        del scores
        check(lse_err <= LSE_ATOL, f"backward {name}: lse error {lse_err:.3e} > {LSE_ATOL}")
        again = fa.flash_attention_backward(q, k, v, out, lse, g, scale)
        repeatable = all(torch.equal(a, b) for a, b in zip(grads, again))
        check(repeatable, f"backward {name}: two calls on the same inputs differ")
        del again

        ms = time_ms(lambda: fa.flash_attention_backward(q, k, v, out, lse, g, scale))
        plain_ms = time_ms(lambda: fa.attention_backward_reference(q, k, v, g, scale), reps=3, batches=5)
        fwd_ms = time_ms(lambda: fa.flash_attention_forward(q, k, v, scale))
        fwd_lse_ms = time_ms(lambda: fa.flash_attention_forward(q, k, v, scale, with_lse=True))
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, scale=scale)
        gt = g.transpose(1, 2)
        library_ms = time_ms(lambda: torch.autograd.grad(lib_out, (qt, kt, vt), gt, retain_graph=True))
        del lib_out
        bound_ms, bound_by = attention_bwd_bound_ms(b, s, h, d)
        rows[name] = dict(
            shape=[b, s, h, d], calls_per_step=calls, **{f"{k}_{f}": v for k, e in errs.items() for f, v in e.items()},
            lse_max_abs_err=lse_err, max_abs_err=max(e["max_abs_err"] for e in errs.values()),
            bitwise_repeatable=repeatable,
            ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
            share_of_bound=bound_ms / ms, tflops=10 * b * h * s * s * d / ms / 1e9,
            fwd_ms=fwd_ms, fwd_with_lse_ms=fwd_lse_ms,
        )
        if not calls:  # a shape whose kernels are shorter than their launch: the host's cost
            rows[name]["host_us_per_launch"] = {
                "fwd": host_us_per_launch(lambda: fa.flash_attention_forward(q, k, v, scale)),
                "fwd_with_lse": host_us_per_launch(lambda: fa.flash_attention_forward(q, k, v, scale, with_lse=True)),
                "bwd": host_us_per_launch(lambda: fa.flash_attention_backward(q, k, v, out, lse, g, scale)),
            }
        emit("kernel", kernel="flash_attention_bwd", case=name, **rows[name])
    return rows


def host_us_per_launch(fn, reps: int = LAUNCH_HOST_REPS) -> float:
    """Host wall time per call of ``reps`` back-to-back calls without a sync
    (the device drains afterwards, outside the clock)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t) / reps * 1e6
    torch.cuda.synchronize()
    return us


def _bf16_order(t: torch.Tensor) -> torch.Tensor:
    """bf16 bits as integers in the order of the values (adjacent values
    differ by 1: an ulp)."""
    i = t.view(torch.int16).to(torch.int32)
    return torch.where(i < 0, -(i & 0x7FFF), i)


def phase_gelu():
    """The card's bf16 GELU (the JAX chain of ``gelu_exact``) against the
    CPU's on every finite bf16 input, and what the chain costs at the MLP
    shapes of one batch-1 forward against one ``F.gelu``."""
    import torch.nn.functional as F

    from ufm_torch.nn.layers import gelu_exact

    x = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    x = x[torch.isfinite(x)]
    check(x.numel() == 65280, f"{x.numel()} finite bf16 values")
    cpu = gelu_exact(x)
    card = gelu_exact(x.cuda()).cpu()
    ulps = (_bf16_order(card) - _bf16_order(cpu)).abs()
    mismatches = int((card.view(torch.int16) != cpu.view(torch.int16)).sum())
    max_ulp = int(ulps.max())
    rows = {}
    gen = torch.Generator(device="cuda").manual_seed(5)
    for name, shape, per_forward in GELU_SHAPES:
        h = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        chain_ms = time_ms(lambda: gelu_exact(h))
        f_gelu_ms = time_ms(lambda: F.gelu(h, approximate="none"))
        rows[name] = dict(shape=list(shape), mlps_per_forward=per_forward, chain_ms=chain_ms, f_gelu_ms=f_gelu_ms)
    small = torch.randn(1, 64, generator=gen, device="cuda").to(torch.bfloat16)
    host = {"chain": host_us_per_launch(lambda: gelu_exact(small)),
            "f_gelu": host_us_per_launch(lambda: F.gelu(small, approximate="none"))}
    extra_ms = sum(r["mlps_per_forward"] * (r["chain_ms"] - r["f_gelu_ms"]) for r in rows.values())
    mlps = sum(r["mlps_per_forward"] for r in rows.values())
    emit("gelu", inputs=x.numel(), card_vs_cpu_mismatches=mismatches, max_ulp=max_ulp, max_ulp_bound=GELU_MAX_ULP,
         shapes=rows, launches_per_mlp={"chain": 4, "f_gelu": 1}, device_ms_added_per_forward=extra_ms,
         host_us_per_call=host, host_us_added_per_forward=mlps * (host["chain"] - host["f_gelu"]))
    check(max_ulp <= GELU_MAX_ULP, f"card vs CPU bf16 GELU: {max_ulp} ulps apart > {GELU_MAX_ULP}")


def _finite(t: torch.Tensor) -> bool:
    return bool(torch.isfinite(t).all())


def phase_main_path():
    from ufm_torch.models import UniFlowMatchConfidence, ufm_base_config
    from ufm_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    model = UniFlowMatchConfidence.from_config(ufm_base_config(), seed=0)
    torch.cuda.synchronize()
    emit("model", seconds=time.perf_counter() - t0, params=sum(p.numel() for p in model.parameters()),
         device=str(model.device), compute_dtype=model.config.compute_dtype)

    rng = np.random.default_rng(0)
    requests = (
        ("480x640_b1", rng.integers(0, 256, (2, 480, 640, 3), dtype=np.uint8)),
        ("1080x1920_b1", rng.integers(0, 256, (2, 1080, 1920, 3), dtype=np.uint8)),
        ("480x640_b2", rng.integers(0, 256, (2, 2, 480, 640, 3), dtype=np.uint8)),
    )
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES = 0  # the main path's count starts here
    results, latencies = {}, {}
    for name, pair in requests:
        src, tgt = pair[0], pair[1]
        b = src.shape[0] if src.ndim == 4 else 1
        h, w = src.shape[-3], src.shape[-2]
        times = []
        for _ in range(4):  # one warm-up, three timed
            before = fa.LAUNCHES
            t = time.perf_counter()
            res = model.predict_correspondences_batched(source_image=src, target_image=tgt)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            check(fa.LAUNCHES - before == LAUNCHES_PER_FORWARD,
                  f"{name}: {fa.LAUNCHES - before} kernel launches in one forward, expected {LAUNCHES_PER_FORWARD}")
        flow, covis = res.flow.flow_output, res.covisibility.mask
        cov, conf = res.flow.flow_covariance, res.keypoint_confidence
        check(tuple(flow.shape) == (b, 2, h, w), f"{name}: flow shape {tuple(flow.shape)}")
        check(tuple(covis.shape) == (b, h, w), f"{name}: covisibility shape {tuple(covis.shape)}")
        check(tuple(cov.shape) == (b, 3, h, w), f"{name}: covariance shape {tuple(cov.shape)}")
        check(tuple(conf.shape) == (b, h, w), f"{name}: confidence shape {tuple(conf.shape)}")
        check(all(_finite(x) for x in (flow, covis, cov, conf)), f"{name}: non-finite outputs")
        latencies[name] = statistics.median(times[1:])
        results[name] = res
        emit("request", request=name, batch=b, input_hw=[h, w], first_s=times[0], latency_s=latencies[name],
             pairs_per_s=b / latencies[name], flow_abs_mean=flow.abs().mean().item(),
             covis_mean=covis.mean().item())
    launches = fa.LAUNCHES
    emit("main_path", launches=launches, forwards=4 * len(requests), launches_per_forward=LAUNCHES_PER_FORWARD,
         pairs_per_s_b1=1.0 / latencies["480x640_b1"], max_memory_allocated=torch.cuda.max_memory_allocated())
    return model, requests[0][1], results["480x640_b1"], launches


def phase_self_check(model, pair, kernel_res):
    from ufm_torch.ops import flash_attention as fa

    model.attention_impl = "torch"
    fa.LAUNCHES = 0
    res = model.predict_correspondences_batched(source_image=pair[0], target_image=pair[1])
    torch.cuda.synchronize()
    check(fa.LAUNCHES == 0, "the plain-attention run launched the kernel")
    model.attention_impl = None
    f_k, f_t = kernel_res.flow.flow_output.float(), res.flow.flow_output.float()
    rel = ((f_k - f_t).norm() / f_t.norm()).item()
    covis_diff = (kernel_res.covisibility.mask - res.covisibility.mask).abs().max().item()
    emit("self_check", flow_rel_l2=rel, flow_rel_l2_bound=FLOW_REL_L2_BOUND, covis_max_abs_diff=covis_diff)
    check(rel <= FLOW_REL_L2_BOUND, f"kernel vs plain attention: flow relative L2 {rel:.3e} > {FLOW_REL_L2_BOUND}")


def window_inputs(shape, p, scale, far, seed=0):
    """Seeded q, f, flow, bias on the card; with ``far``, one window of each
    image lies far outside it on each side."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, f = (torch.randn(shape, generator=gen, device="cuda") for _ in range(2))
    flow = torch.randn((*shape[:3], 2), generator=gen, device="cuda") * scale
    if far:
        flow[:, 0, 0] = -500.0
        flow[:, -1, -1] = 1e6
    return q, f, flow, torch.randn(p * p, generator=gen, device="cuda")


def window_taps(flow: torch.Tensor, p: int):
    """In-image taps of each pixel's (P+3)^2 window (the kernel's clamp and
    floor): (their total, the share of pixels whose window touches the
    image)."""
    from ufm_torch.ops.window_refinement import base_grid

    _, h, w, _ = flow.shape
    r, m = (p - 1) // 2, (p - 1) // 2 + 4
    pos = flow.float() + base_grid(h, w, flow.device)
    x0 = pos[..., 0].clamp(-m, w + m).floor()
    y0 = pos[..., 1].clamp(-m, h + m).floor()
    nx = ((x0 + r + 2).clamp(max=w - 1) - (x0 - r - 1).clamp(min=0) + 1).clamp(min=0)
    ny = ((y0 + r + 2).clamp(max=h - 1) - (y0 - r - 1).clamp(min=0) + 1).clamp(min=0)
    taps = nx * ny
    return taps.sum().item(), (taps > 0).float().mean().item()


def window_bound_ms(shape, p, in_image_taps):
    """Bytes: q, f, flow read once, residual and log_softmax written once.
    Operations: 2C per in-image tap (the taps outside the image are zeros the
    kernel never reads), the cubic x pass (K rows x P x 4 FMA) and y pass
    (P x P x 4 FMA), and ~10 per score for temperature, bias, softmax,
    log_softmax and the residual."""
    b, h, w, c = shape
    n, k = b * h * w, p + 3
    nbytes = 4 * (n * (2 * c + 2 + 2 + p * p) + p * p)
    flops = 2 * c * in_image_taps + n * (8 * k * p + 8 * p * p + 10 * p * p)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase_window_kernel():
    from ufm_torch.ops import window_refinement as wr

    rows = {}
    for name, shape, p, scale, calls in WINDOW_CASES:
        q, f, flow, bias = window_inputs(shape, p, scale, far=name == "edges")
        res, ls = wr.window_refinement(q, f, flow, bias, WINDOW_TEMPERATURE, p)
        ref_res, ref_ls = wr.window_refinement_reference(q, f, flow, bias, WINDOW_TEMPERATURE, p)
        torch.cuda.synchronize()
        res_err = (res - ref_res).abs().max().item()
        ls_err = (ls - ref_ls).abs().max().item()
        taps, share = window_taps(flow, p)
        check(_finite(res) and _finite(ls), f"window {name}: kernel output not finite")
        check(res_err <= WINDOW_RESIDUAL_ATOL, f"window {name}: residual error {res_err:.3e} > {WINDOW_RESIDUAL_ATOL}")
        check(ls_err <= WINDOW_LOG_SOFTMAX_ATOL, f"window {name}: log_softmax error {ls_err:.3e} > {WINDOW_LOG_SOFTMAX_ATOL}")
        if name == "flagship":
            check(share > 0.5, f"window {name}: only {share:.3f} of the windows touch the image")

        ms = time_ms(lambda: wr.window_refinement(q, f, flow, bias, WINDOW_TEMPERATURE, p))
        plain_ms = time_ms(lambda: wr.window_refinement_reference(q, f, flow, bias, WINDOW_TEMPERATURE, p), reps=3, batches=5)
        bound_ms, bound_by = window_bound_ms(shape, p, taps)
        rows[name] = dict(
            shape=list(shape), p=p, flow_scale=scale, calls_per_forward=calls, residual_max_abs_err=res_err,
            log_softmax_max_abs_err=ls_err, in_image_share=share, in_image_taps=taps, ms=ms, plain_ms=plain_ms,
            library_ms=None, bound_ms=bound_ms, bound_by=bound_by, share_of_bound=bound_ms / ms,
        )
        emit("kernel", kernel="window_refinement_fwd", case=name, **rows[name])
    return rows


def _timed(fn, events):
    """``fn`` with a CUDA event pair recorded around each call (device time
    between the two points, waits for the host included)."""

    def wrapper(*args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kwargs)
        end.record()
        events.append((start, end, args))
        return out

    return wrapper


def phase_refine_path():
    from ufm_torch.models import UniFlowMatchClassificationRefinement, ufm_refine_config
    from ufm_torch.ops import flash_attention as fa
    from ufm_torch.ops import window_refinement as wr

    t0 = time.perf_counter()
    model = UniFlowMatchClassificationRefinement.from_config(ufm_refine_config(), seed=0)
    torch.cuda.synchronize()
    emit("refine_model", seconds=time.perf_counter() - t0, params=sum(p.numel() for p in model.parameters()),
         device=str(model.device), compute_dtype=model.config.compute_dtype)
    forward_events, tail_events = [], []
    model.network_apply = _timed(model.network_apply, forward_events)
    model.net.refine_tail = _timed(model.net.refine_tail, tail_events)

    rng = np.random.default_rng(1)
    requests = (
        ("refine_480x640_b1", rng.integers(0, 256, (2, 480, 640, 3), dtype=np.uint8)),
        ("refine_480x640_b2", rng.integers(0, 256, (2, 2, 480, 640, 3), dtype=np.uint8)),
    )
    p = model.config.refinement_range
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES = wr.LAUNCHES = 0  # the refine path's counts start here
    results, latencies = {}, {}
    for name, pair in requests:
        src, tgt = pair[0], pair[1]
        b = src.shape[0] if src.ndim == 4 else 1
        h, w = src.shape[-3], src.shape[-2]
        times = []
        forward_events.clear()
        tail_events.clear()
        for _ in range(4):  # one warm-up, three timed
            before = (fa.LAUNCHES, wr.LAUNCHES)
            t = time.perf_counter()
            res = model.predict_correspondences_batched(source_image=src, target_image=tgt)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            launched = (fa.LAUNCHES - before[0], wr.LAUNCHES - before[1])
            check(launched == (LAUNCHES_PER_FORWARD, 1),
                  f"{name}: {launched} attention / window launches in one forward, expected ({LAUNCHES_PER_FORWARD}, 1)")
        flow, covis = res.flow.flow_output, res.covisibility.mask
        check(tuple(flow.shape) == (b, 2, h, w), f"{name}: flow shape {tuple(flow.shape)}")
        check(tuple(covis.shape) == (b, h, w), f"{name}: covisibility shape {tuple(covis.shape)}")
        check(_finite(flow) and _finite(covis) and _finite(res.flow.flow_covariance), f"{name}: non-finite outputs")
        latencies[name] = statistics.median(times[1:])
        results[name] = res
        fwd_ms = statistics.median(s.elapsed_time(e) for s, e, _ in forward_events[1:])
        tail_ms = statistics.median(s.elapsed_time(e) for s, e, _ in tail_events[1:])
        regression_flow = tail_events[-1][2][2]
        _, share = window_taps(regression_flow, p)
        emit("refine_request", request=name, batch=b, input_hw=[h, w], first_s=times[0], latency_s=latencies[name],
             pairs_per_s=b / latencies[name], forward_ms=fwd_ms, refine_tail_ms=tail_ms,
             refine_tail_share=tail_ms / fwd_ms, window_in_image_share=share,
             regression_flow_abs_max=regression_flow.abs().max().item(), flow_abs_mean=flow.abs().mean().item())
    launches = {"flash_attention_fwd": fa.LAUNCHES, "window_refinement_fwd": wr.LAUNCHES}
    emit("refine_path", launches=launches, forwards=4 * len(requests),
         pairs_per_s_b1=1.0 / latencies["refine_480x640_b1"], max_memory_allocated=torch.cuda.max_memory_allocated())
    del model.network_apply, model.net.refine_tail  # back to the unwrapped methods
    return model, requests[0][1], results["refine_480x640_b1"], launches


def phase_refine_self_check(model, pair, kernel_res):
    from ufm_torch.ops import flash_attention as fa
    from ufm_torch.ops import window_refinement as wr

    def run():
        res = model.predict_correspondences_batched(source_image=pair[0], target_image=pair[1])
        torch.cuda.synchronize()
        return res.flow.flow_output.float()

    f_k = kernel_res.flow.flow_output.float()
    model.refinement_impl = "torch"
    wr.LAUNCHES = 0
    f_plain_window = run()
    check(wr.LAUNCHES == 0, "the plain-refinement run launched the window kernel")
    model.refinement_impl = None
    window_diff = (f_k - f_plain_window).abs().max().item()

    model.attention_impl = "torch"
    fa.LAUNCHES = 0
    f_plain_attn = run()
    check(fa.LAUNCHES == 0, "the plain-attention run launched the attention kernel")
    model.attention_impl = None
    rel = ((f_k - f_plain_attn).norm() / f_plain_attn.norm()).item()
    emit("refine_self_check", window_flow_max_abs_diff=window_diff, window_bound=REFINED_FLOW_MAX_ABS,
         attention_flow_rel_l2=rel, attention_bound=FLOW_REL_L2_BOUND)
    check(window_diff <= REFINED_FLOW_MAX_ABS,
          f"window kernel vs plain refinement: refined flow max abs diff {window_diff:.3e} > {REFINED_FLOW_MAX_ABS}")
    check(rel <= FLOW_REL_L2_BOUND, f"kernel vs plain attention (refine): flow relative L2 {rel:.3e} > {FLOW_REL_L2_BOUND}")


def _group_grads(net):
    from ufm_torch.training.trainer import group_of

    out = {}
    for name, p in net.named_parameters():
        if p.grad is not None:
            out.setdefault(group_of(name), []).append(p.grad.float().flatten())
    return {k: torch.cat(v) for k, v in out.items()}


def phase_train():
    from ufm_torch.models import UniFlowMatchConfidence, ufm_base_config
    from ufm_torch.ops import flash_attention as fa
    from ufm_torch.training import fit, make_optimizer, make_train_step, synthetic_batch

    t0 = time.perf_counter()
    model = UniFlowMatchConfidence.from_config(ufm_base_config(), seed=0)
    net = model.net
    batch = synthetic_batch(TRAIN_BATCH, *TRAIN_HW, seed=0, device="cuda")
    optimizer = make_optimizer(net, learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_TOTAL_STEPS)
    step = make_train_step(net, optimizer)
    masters = optimizer.masters()
    torch.cuda.synchronize()
    emit("train_model", seconds=time.perf_counter() - t0, params=sum(p.numel() for p in net.parameters()),
         bf16_params=sum(p.numel() for p in net.parameters() if p.dtype == torch.bfloat16),
         fp32_masters=sum(m.numel() for m in masters.values()),
         groups={label: sum(p.numel() for p, _ in pairs) for label, _, pairs in optimizer.groups})

    fwd_events, opt_events = [], []
    net.forward = _timed(net.forward, fwd_events)
    optimizer.step = _timed(optimizer.step, opt_events)
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES = fa.BWD_LAUNCHES = 0  # the training path's counts start here
    losses, times = [], []
    for i in range(TRAIN_STEPS):
        before = (fa.LAUNCHES, fa.BWD_LAUNCHES)
        t = time.perf_counter()
        metrics = step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        launched = (fa.LAUNCHES - before[0], fa.BWD_LAUNCHES - before[1])
        check(launched == (LAUNCHES_PER_FORWARD, LAUNCHES_PER_FORWARD),
              f"train step {i}: {launched} attention forward launches / backward calls, expected 36 / 36")
        vals = {k: v.item() for k, v in metrics.items()}
        check(all(np.isfinite(v) for v in vals.values()), f"train step {i}: non-finite metrics {vals}")
        losses.append(vals["total_loss"])
        emit("train_step", step=i, seconds=times[-1], **vals)
    del net.forward, optimizer.step  # back to the unwrapped methods
    fwd_ms = [s.elapsed_time(e) for s, e, _ in fwd_events]
    bwd_ms = [fe.elapsed_time(os_) for (_, fe, _), (os_, _, _) in zip(fwd_events, opt_events)]
    opt_ms = [s.elapsed_time(e) for s, e, _ in opt_events]
    step_s = statistics.median(times[1:])

    fit_losses = []
    out = fit(net, (batch for _ in range(FIT_STEPS)), num_steps=FIT_STEPS, learning_rate=FIT_LR,
              warmup_steps=0, log_every=1, log_fn=lambda line: None,
              on_metrics=lambda _, vals: fit_losses.append(vals["total_loss"]))
    torch.cuda.synchronize()
    check(out["step"] == FIT_STEPS and len(fit_losses) == FIT_STEPS, f"fit ran {out['step']} steps")
    check(all(np.isfinite(v) for v in fit_losses), f"fit: non-finite losses {fit_losses}")
    launches = {"flash_attention_fwd": fa.LAUNCHES, "flash_attention_bwd": fa.BWD_LAUNCHES}
    steps = TRAIN_STEPS + FIT_STEPS
    check(launches == {"flash_attention_fwd": steps * LAUNCHES_PER_FORWARD, "flash_attention_bwd": steps * LAUNCHES_PER_FORWARD},
          f"training path launches {launches} over {steps} steps, expected 36 + 36 per step")
    trajectory = losses + fit_losses
    check(trajectory[-1] < trajectory[0], f"loss did not fall on the fixed batch: {trajectory}")
    emit("train_path", batch=TRAIN_BATCH, input_hw=list(TRAIN_HW), learning_rate=TRAIN_LR,
         warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_TOTAL_STEPS, fit_learning_rate=FIT_LR, steps=steps,
         launches=launches,
         first_step_s=times[0], step_ms=step_s * 1e3, pairs_per_s=TRAIN_BATCH / step_s,
         forward_loss_ms=statistics.median(fwd_ms[1:]), backward_ms=statistics.median(bwd_ms[1:]),
         optimizer_ms=statistics.median(opt_ms[1:]), max_memory_allocated=torch.cuda.max_memory_allocated(),
         loss_trajectory=trajectory)
    return model, batch, launches


def phase_train_self_check(model, batch):
    from ufm_torch.ops import flash_attention as fa
    from ufm_torch.training import ufm_total_loss

    net = model.net
    one = {k: v[:1] for k, v in batch.items()}

    def grads():
        net.zero_grad(set_to_none=True)
        loss, _ = ufm_total_loss(net(one["img1"], one["img2"]), one)
        loss.backward()
        torch.cuda.synchronize()
        return _group_grads(net)

    fa.LAUNCHES = fa.BWD_LAUNCHES = 0
    g_kernel = grads()
    check((fa.LAUNCHES, fa.BWD_LAUNCHES) == (LAUNCHES_PER_FORWARD, LAUNCHES_PER_FORWARD),
          f"kernel gradient: {(fa.LAUNCHES, fa.BWD_LAUNCHES)} launches, expected 36 / 36")
    model.attention_impl = "torch"
    fa.LAUNCHES = fa.BWD_LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    g_plain = grads()
    plain_peak = torch.cuda.max_memory_allocated()
    check((fa.LAUNCHES, fa.BWD_LAUNCHES) == (0, 0), "the plain-attention gradient launched a kernel")
    model.attention_impl = None
    net.zero_grad(set_to_none=True)
    rel = {k: ((g_kernel[k] - g_plain[k]).norm() / g_plain[k].norm()).item() for k in g_plain}
    emit("train_self_check", batch=1, grad_rel_l2=rel, bound=TRAIN_GRAD_REL_L2_BOUND,
         plain_max_memory_allocated=plain_peak)
    check(set(rel) == set(g_kernel), f"gradient groups differ: {sorted(g_kernel)} vs {sorted(rel)}")
    for k, r in rel.items():
        check(r <= TRAIN_GRAD_REL_L2_BOUND, f"kernel vs plain gradient, group {k}: relative L2 {r:.3e} > {TRAIN_GRAD_REL_L2_BOUND}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this check needs a GPU", file=sys.stderr)
        return 1
    smi = phase_device()
    phase_build()
    rows = phase_kernel()
    bwd_rows = phase_bwd_kernel()
    window_rows = phase_window_kernel()
    phase_gelu()
    model, pair, kernel_res, launches = phase_main_path()
    phase_self_check(model, pair, kernel_res)
    del model, kernel_res
    refine_model, refine_pair, refine_res, refine_launches = phase_refine_path()
    phase_refine_self_check(refine_model, refine_pair, refine_res)
    del refine_model, refine_res
    torch.cuda.empty_cache()
    train_model, train_batch, train_launches = phase_train()
    phase_train_self_check(train_model, train_batch)

    # one batch-1 forward's attention: each number sums its 36 calls
    fwd = [rows[n] for n, _, calls in ATTN_SHAPES for _ in range(calls)]
    # one batch-2 train step's attention backward: each number sums its 36 calls
    bwd = [bwd_rows[n] for n, _, calls in ATTN_BWD_SHAPES for _ in range(calls)]
    attention = {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "ufm_torch/csrc/flash_attention_fwd.cu",
        "replaces": "ufm_tpu/ops/flash_attention.py:558",
        "launches": launches + refine_launches["flash_attention_fwd"] + train_launches["flash_attention_fwd"],
        "launches_by_path": {"ufm_base": launches, "ufm_refine": refine_launches["flash_attention_fwd"],
                             "ufm_base_train": train_launches["flash_attention_fwd"]},
        "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
        "ms": sum(r["ms"] for r in fwd),
        "plain_ms": sum(r["plain_ms"] for r in fwd),
        "bound_ms": sum(r["bound_ms"] for r in fwd),
        "bound_by": "operations" if all(r["bound_by"] == "operations" for r in fwd) else "bytes",
        "library_ms": sum(r["library_ms"] for r in fwd),
        "per_forward": "times sum the 24 encoder and 12 info-sharing calls of one batch-1 forward",
        "train_step_ms_without_lse": sum(r["fwd_ms"] for r in bwd),
        "train_step_ms_with_lse": sum(r["fwd_with_lse_ms"] for r in bwd),
        "host_us_per_launch": bwd_rows["ragged"]["host_us_per_launch"]["fwd"],
    }
    backward = {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "ufm_torch/csrc/flash_attention_bwd.cu",
        "replaces": "ufm_tpu/ops/flash_attention.py:452",
        "launches": train_launches["flash_attention_bwd"],
        "launches_by_path": {"ufm_base_train": train_launches["flash_attention_bwd"]},
        "max_abs_err": max(r["max_abs_err"] for r in bwd_rows.values()),
        "ms": sum(r["ms"] for r in bwd),
        "plain_ms": sum(r["plain_ms"] for r in bwd),
        "bound_ms": sum(r["bound_ms"] for r in bwd),
        "bound_by": "operations" if all(r["bound_by"] == "operations" for r in bwd) else "bytes",
        "library_ms": sum(r["library_ms"] for r in bwd),
        "per_step": "times sum the 24 encoder and 12 info-sharing calls of one batch-2 train step; "
                    "a launch is one backward call (two CUDA kernels: delta, then one grid of dK/dV and dQ blocks)",
        "library": "backward of scaled_dot_product_attention, torch.autograd.grad on the same (B, H, S, D) views",
        "bitwise_repeatable": all(r["bitwise_repeatable"] for r in bwd_rows.values()),
        "host_us_per_launch": bwd_rows["ragged"]["host_us_per_launch"]["bwd"],
    }
    flagship = window_rows["flagship"]
    window = {
        "name": "window_refinement_fwd",
        "route": "cuda",
        "source": "ufm_torch/csrc/window_refinement_fwd.cu",
        "replaces": "ufm_tpu/ops/window_dots.py:280",
        "replaces_also": "ufm_tpu/ops/window_dots.py:238",
        "launches": refine_launches["window_refinement_fwd"],
        "launches_by_path": {"ufm_refine": refine_launches["window_refinement_fwd"]},
        "max_abs_err": max(max(r["residual_max_abs_err"], r["log_softmax_max_abs_err"]) for r in window_rows.values()),
        "ms": flagship["ms"],
        "plain_ms": flagship["plain_ms"],
        "bound_ms": flagship["bound_ms"],
        "bound_by": flagship["bound_by"],
        "library_ms": None,
        "per_forward": "the one call of a batch-1 UFM-Refine forward, (1, 420, 560, 16), P = 5",
        "library_none": "no single PyTorch call computes this function",
    }
    print(smi)
    print(json.dumps({"kernels": [attention, backward, window]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
