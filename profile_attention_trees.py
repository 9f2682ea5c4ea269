#!/usr/bin/env python3
"""Time the attention kernels of several checkouts of the port in one process.

    python3 profile_attention_trees.py PARENT . . PARENT [--train-steps 8] [--requests 5] [--any]
        [--fp32-requests 5] [--fp32-train-steps 4] [--remat-steps 3]

Each argument is the root of a checkout that holds ``ufm_torch`` (an
unpacked ``git archive`` of another commit, or this one). The trees are
taken in the order given, so "parent, change, change, parent" puts both
versions on one card in turns. For each tree it builds the kernels from that
tree's sources and prints one JSON line per kernel and shape:

- ``ms``: CUDA-event time per call, each batch of calls queued behind a
  device sleep so that the card and not the host sets the pace, at the main
  path's shapes (forward at batch 1, forward with lse and backward at the
  batch-2 train step's), on strided views of a fused qkv tensor, as
  ``chip_smoke.py`` times them;
- ``host_us_per_launch``: host wall time per call of 1,000 back-to-back
  calls without a sync, at a shape (1, 77, 2, 64) whose kernels take less
  device time than their launch, so the host's own cost per launch shows:
  the forward (with and without lse) and the backward through the tree's
  kernel wrappers, ``dispatch`` (the models' call,
  ``ops.attention.dot_product_attention`` with the tensors' device deciding)
  and ``window`` (the window kernel's wrapper at (1, 8, 32, 16), P = 5),
  with grad mode on (as training calls them) and in inference mode (as the
  predict API does);
- ``library_ms``: beside each kernel time, ``scaled_dot_product_attention``
  (forward, or its backward through autograd) on the same inputs in the same
  turn, the yardstick that shows how far the card's speed drifts;
- with ``--train-steps N``, the UFM-Base train step at batch 2, 420x560, as
  ``chip_smoke.py`` trains it: the median host time of N steps that each end
  in a synchronize (after 2 warm-up steps), the kernel time of one step
  (``torch.profiler``; the rest of the step the card is idle), the peak
  memory, and both times once more with every MLP's activation swapped for
  one ``F.gelu`` (what the tree's ``gelu_exact`` costs a step beyond it);
- with ``--remat-steps N``, the same train step under no remat, full remat
  and each of the seven ``train_remat_policy`` names: the median host time
  of N steps (after one warm-up step) and their peak memory, by case;
- with ``--requests N``, a batch-1 480x640 UFM-Base request through the
  predict API, captured (a CUDA graph replay) and eager: N requests, each
  waited for, inside one ``torch.profiler`` window: the host clock a
  request, the device busy time (the union of the kernels' intervals) and
  the idle share, the kernels a request (as ``chip_smoke.py``'s
  ``captured`` phase reads them) and the device ms a request of the
  kernels that take the most, by name;
- with ``--any``, the attention kernels over the rest of the domain (fp32,
  fp16, bf16 at D != 64) at each case of ``chip_smoke.py``'s
  ``ANY_ATTN_CASES`` (forward) and ``ANY_BWD_CASES`` (backward after the
  forward with lse), on the same inputs as there, beside SDPA's forward or
  backward, matmul TF32 off;
- with ``--fp32-requests N`` and ``--fp32-train-steps N``, the same request
  and train step of UFM-Base in fp32 (``compute_dtype="float32"``: every
  attention call on those kernels), each with the device ms of its kernels
  by name.

The last line sums each tree's runs. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

FWD_SHAPES = (("encoder", (2, 1201, 16, 64)), ("info_sharing", (1, 2400, 12, 64)))
TRAIN_SHAPES = (("encoder", (4, 1201, 16, 64)), ("info_sharing", (2, 2400, 12, 64)))
SMALL_SHAPE = (1, 77, 2, 64)
WINDOW_SMALL_SHAPE = (1, 8, 32, 16)  # one tile of the window kernel, P = 5
HOST_REPS = 1000
QUEUE_SLEEP_CYCLES = 50_000_000  # ~25 ms at 1.98 GHz
TRAIN_BATCH, TRAIN_HW = 2, (420, 560)


def time_ms(fn, reps: int = 10, batches: int = 7) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(QUEUE_SLEEP_CYCLES)  # the batch queues behind it: the card's time, not the host's
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def host_us(fn, reps: int = HOST_REPS) -> float:
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t) / reps * 1e6
    torch.cuda.synchronize()
    return us


def load_tree(root: str):
    """``ufm_torch.ops.flash_attention`` of the checkout at ``root``."""
    root = os.path.abspath(root)
    library = sys.modules.get("ufm_torch.ops.library")
    if library is not None:  # a tree with dispatcher ops: free their names for the next tree's
        library._LIB._destroy()
    for name in [m for m in sys.modules if m == "ufm_torch" or m.startswith("ufm_torch.")]:
        del sys.modules[name]
    sys.path.insert(0, root)
    try:
        fa = importlib.import_module("ufm_torch.ops.flash_attention")
    finally:
        sys.path.remove(root)
    if not os.path.abspath(fa.__file__).startswith(root + os.sep):
        raise RuntimeError(f"ufm_torch came from {fa.__file__}, not from {root}")
    build = importlib.import_module("ufm_torch.ops._build")
    build.build(build.KERNEL_SOURCES)  # every kernel of the tree, one nvcc each, all at once
    return fa


def views(shape, seed):
    b, s, h, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(b, s, 3, h, d, generator=gen, device="cuda").to(torch.bfloat16)
    g = torch.randn(b, s, h, d, generator=gen, device="cuda").to(torch.bfloat16)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], g


def run_tree(root: str, turn: int, train_steps: int = 0, requests: int = 0, any_cases: bool = False,
             fp32_requests: int = 0, fp32_train_steps: int = 0, remat_steps: int = 0) -> dict:
    fa = load_tree(root)
    scale = 64**-0.5
    out = {}

    def emit(kernel, case, **fields):
        out[(kernel, case)] = fields
        print(json.dumps({"tree": root, "turn": turn, "kernel": kernel, "case": case, **fields}), flush=True)

    for case, shape in FWD_SHAPES:
        q, k, v, _ = views(shape, 0)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        emit("fwd", case, shape=list(shape), ms=time_ms(lambda: fa.flash_attention_forward(q, k, v, scale)),
             library_ms=time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale)))
    for case, shape in TRAIN_SHAPES:
        q, k, v, g = views(shape, 1)
        o, lse = fa.flash_attention_forward(q, k, v, scale, with_lse=True)
        emit("fwd_with_lse", case, shape=list(shape),
             ms=time_ms(lambda: fa.flash_attention_forward(q, k, v, scale, with_lse=True)))
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, scale=scale)
        gt = g.transpose(1, 2)
        emit("bwd", case, shape=list(shape), ms=time_ms(lambda: fa.flash_attention_backward(q, k, v, o, lse, g, scale)),
             library_ms=time_ms(lambda: torch.autograd.grad(lib_out, (qt, kt, vt), gt, retain_graph=True)))
    q, k, v, g = views(SMALL_SHAPE, 2)
    o, lse = fa.flash_attention_forward(q, k, v, scale, with_lse=True)
    dispatch = importlib.import_module("ufm_torch.ops.attention").dot_product_attention
    wr = importlib.import_module("ufm_torch.ops.window_refinement")
    gen = torch.Generator(device="cuda").manual_seed(3)
    wq, wf = (torch.randn(WINDOW_SMALL_SHAPE, generator=gen, device="cuda") for _ in range(2))
    wflow = torch.randn((*WINDOW_SMALL_SHAPE[:3], 2), generator=gen, device="cuda")
    wbias = torch.randn(25, generator=gen, device="cuda")

    def launch_costs():
        return {
            "fwd": host_us(lambda: fa.flash_attention_forward(q, k, v, scale)),
            "fwd_with_lse": host_us(lambda: fa.flash_attention_forward(q, k, v, scale, with_lse=True)),
            "bwd": host_us(lambda: fa.flash_attention_backward(q, k, v, o, lse, g, scale)),
            "dispatch": host_us(lambda: dispatch(q, k, v, scale=scale)),
            "window": host_us(lambda: wr.window_refinement(wq, wf, wflow, wbias, 4.0, 5)),
        }

    shapes = dict(shape=list(SMALL_SHAPE), window_shape=list(WINDOW_SMALL_SHAPE))
    emit("launch", "small", **shapes, host_us_per_launch=launch_costs())
    with torch.inference_mode():  # the predict API's mode: no autograd dispatch
        emit("launch", "small_inference_mode", **shapes, host_us_per_launch=launch_costs())
    if any_cases:
        time_any_cases(fa, emit)
    if train_steps:
        emit("train_step", "ufm_base_b2", **train_step(train_steps))
    if remat_steps:
        for case, fields in remat_train_steps(remat_steps).items():
            emit("remat_step", case, **fields)
    if requests:
        for mode, fields in predict_requests(requests).items():
            emit("request", f"ufm_base_480x640_b1_{mode}", **fields)
    if fp32_train_steps:
        emit("train_step", "ufm_base_fp32_b2", **train_step(fp32_train_steps, "float32"))
    if fp32_requests:
        for mode, fields in predict_requests(fp32_requests, "float32").items():
            emit("request", f"ufm_base_fp32_480x640_b1_{mode}", **fields)
    return out


def time_any_cases(fa, emit) -> None:
    """The tree's forward and backward at chip_smoke.py's ANY_ATTN_CASES /
    ANY_BWD_CASES (inputs from its any_inputs and seeds), beside SDPA."""
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, dtype, (b, sq, h, d), sk, _ in cs.ANY_ATTN_CASES:
        q, k, v = cs.any_inputs(gen, getattr(torch, dtype), b, sq, sk, h, d)
        scale = d**-0.5
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        emit("fwd_any", name, dtype=dtype, shape=[b, sq, h, d], sk=sk,
             ms=time_ms(lambda: fa.flash_attention_forward(q, k, v, scale)),
             library_ms=time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale)))
    gen = torch.Generator(device="cuda").manual_seed(4)
    for name, dtype, (b, sq, h, d), sk, _ in cs.ANY_BWD_CASES:
        dt = getattr(torch, dtype)
        q, k, v = cs.any_inputs(gen, dt, b, sq, sk, h, d)
        if sq == sk:
            g = torch.randn(b, sq, h, d, generator=gen, device="cuda").to(dt)
        else:  # a non-contiguous output gradient, as chip_smoke's
            g = torch.randn(b, sq, h, d + 8, generator=gen, device="cuda").to(dt)[..., 8:]
        scale = d**-0.5
        o, lse = fa.flash_attention_forward(q, k, v, scale, with_lse=True)
        emit("bwd_any", name, dtype=dtype, shape=[b, sq, h, d], sk=sk,
             ms=time_ms(lambda: fa.flash_attention_backward(q, k, v, o, lse, g, scale)),
             library_ms=cs.sdpa_backward_ms(q, k, v, g, scale))
        del q, k, v, g, o, lse
    torch.cuda.empty_cache()


def profile_requests(fn, reps: int) -> dict:
    """``reps`` calls of ``fn``, each waited for, in one profiler window
    (CUDA activity): host ms, device busy ms and kernels a request, idle
    share, and the device ms a request of the kernels that take the most,
    by name (the first 12)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            fn()
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / reps
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA and not e.name.startswith(("Memcpy", "Memset"))]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3 / reps
    busy_us, end = 0.0, -float("inf")
    for start, stop in spans:
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    busy_ms = busy_us / 1e3 / reps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
            "kernels_per_request": len(spans) / reps, "ms_by_kernel": {name[:120]: ms for name, ms in top}}


def predict_requests(reps: int, compute_dtype: str = "bfloat16") -> dict:
    """A batch-1 480x640 UFM-Base request of the tree loaded last, captured
    and eager (after warm-up calls), profiled over ``reps`` requests each."""
    from ufm_torch.models import UniFlowMatchConfidence, ufm_base_config

    model = UniFlowMatchConfidence.from_config(ufm_base_config(compute_dtype=compute_dtype), seed=0)
    src, tgt = np.random.default_rng(0).integers(0, 256, (2, 480, 640, 3), dtype=np.uint8)

    def request():
        model.predict_correspondences_batched(source_image=src, target_image=tgt)

    out = {}
    for mode, capture in (("captured", True), ("eager", False)):
        model.capture_graphs = capture
        for _ in range(3):  # the first captured call warms up and captures
            request()
        out[mode] = profile_requests(request, reps)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_step(steps: int, compute_dtype: str = "bfloat16") -> dict:
    """The batch-2 UFM-Base train step of the tree loaded last: the median
    step ms, one step's kernel ms (and, by name, the kernels that take the
    most), the peak memory; in bf16 also both times with ``F.gelu`` as every
    MLP's activation."""
    from ufm_torch.models import UniFlowMatchConfidence, ufm_base_config
    from ufm_torch.nn.layers import Mlp
    from ufm_torch.training import make_optimizer, make_train_step, synthetic_batch

    model = UniFlowMatchConfidence.from_config(ufm_base_config(compute_dtype=compute_dtype), seed=0)
    batch = synthetic_batch(TRAIN_BATCH, *TRAIN_HW, seed=0, device="cuda")
    optimizer = make_optimizer(model.net, learning_rate=1e-4, warmup_steps=100, total_steps=10000)
    step = make_train_step(model.net, optimizer)

    def median_ms():
        for _ in range(2):
            step(batch)
        torch.cuda.synchronize()
        times = []
        for _ in range(steps):
            t = time.perf_counter()
            step(batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times)

    def kernel_ms(by_name=None):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            step(batch)
            torch.cuda.synchronize()
        times = {e.key: getattr(e, "self_device_time_total", 0) / 1e3 for e in prof.key_averages()}
        if by_name is not None:
            by_name.update({k[:120]: ms for k, ms in sorted(times.items(), key=lambda kv: -kv[1])[:8]})
        return sum(times.values())

    torch.cuda.reset_peak_memory_stats()
    by_name = {}
    out = {"step_ms": median_ms(), "kernel_ms": kernel_ms(by_name),
           "max_memory_allocated": torch.cuda.max_memory_allocated(), "ms_by_kernel": by_name}
    if compute_dtype == "bfloat16":
        for m in model.net.modules():
            if isinstance(m, Mlp):
                m.act = lambda x: F.gelu(x, approximate="none")
        out["step_ms_f_gelu"] = median_ms()
        out["kernel_ms_f_gelu"] = kernel_ms()
    del model, optimizer, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def remat_train_steps(steps: int) -> dict:
    """The batch-2 UFM-Base train step of the tree loaded last under no
    remat, full remat and each remat policy of its ``REMAT_POLICIES``: the
    median step ms of ``steps`` steps after one warm-up step, and the peak
    memory of those steps, by case."""
    from ufm_torch.models import UniFlowMatchConfidence, ufm_base_config
    from ufm_torch.nn.layers import REMAT_POLICIES
    from ufm_torch.training import make_optimizer, make_train_step, synthetic_batch

    model = UniFlowMatchConfidence.from_config(ufm_base_config(), seed=0)
    batch = synthetic_batch(TRAIN_BATCH, *TRAIN_HW, seed=0, device="cuda")
    optimizer = make_optimizer(model.net, learning_rate=1e-4, warmup_steps=100, total_steps=10000)
    step = make_train_step(model.net, optimizer)
    out = {}
    for case, remat, policy in (("none", False, None), ("full", True, None), *((p, True, p) for p in REMAT_POLICIES)):
        for stack in (model.net.encoder, model.net.info_sharing):
            stack.remat, stack.remat_policy = remat, policy
        step(batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(steps):
            t = time.perf_counter()
            step(batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        out[case] = {"step_ms": statistics.median(times), "max_memory_allocated": torch.cuda.max_memory_allocated()}
    del model, optimizer, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("trees", nargs="+", help="checkout roots, timed in this order")
    parser.add_argument("--train-steps", type=int, default=0, help="also time N batch-2 train steps per tree")
    parser.add_argument("--requests", type=int, default=0,
                        help="also profile N batch-1 UFM-Base requests per tree, captured and eager")
    parser.add_argument("--any", action="store_true",
                        help="also time the fp32 / fp16 / any-D attention kernels at chip_smoke's cases")
    parser.add_argument("--fp32-requests", type=int, default=0,
                        help="also profile N batch-1 fp32 UFM-Base requests per tree, captured and eager")
    parser.add_argument("--fp32-train-steps", type=int, default=0,
                        help="also time N batch-2 fp32 UFM-Base train steps per tree")
    parser.add_argument("--remat-steps", type=int, default=0,
                        help="also time N batch-2 UFM-Base train steps per tree under each remat case")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_attention_trees: needs a CUDA device", file=sys.stderr)
        return 1
    argv = args.trees
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"device": smi, "torch": torch.__version__, "trees": argv}), flush=True)
    runs = {}
    for turn, root in enumerate(argv):
        runs.setdefault(root, []).append(run_tree(root, turn, args.train_steps, args.requests, args.any,
                                                  args.fp32_requests, args.fp32_train_steps, args.remat_steps))
    summary = {}
    for root, outs in runs.items():
        summary[root] = {}
        for (kernel, case), fields in outs[0].items():
            for field, val in fields.items():
                if isinstance(val, dict):  # host_us_per_launch, ms_by_kernel: one list per name
                    suffix = "host_us" if field == "host_us_per_launch" else field
                    for name in val:
                        summary[root][f"{kernel}/{case}/{name}_{suffix}"] = [o[(kernel, case)][field].get(name)
                                                                             for o in outs]
                elif isinstance(val, (int, float)):
                    summary[root][f"{kernel}/{case}_{field}"] = [o[(kernel, case)][field] for o in outs]
    print(json.dumps({"summary": summary, "device": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
