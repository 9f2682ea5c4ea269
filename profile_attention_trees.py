#!/usr/bin/env python3
"""Time the attention kernels of several checkouts of the port in one process.

    python3 profile_attention_trees.py PARENT . . PARENT [--train-steps 8]

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
  device time than their launch, so the host's own cost per launch shows;
- ``library_ms``: beside each kernel time, ``scaled_dot_product_attention``
  (forward, or its backward through autograd) on the same inputs in the same
  turn, the yardstick that shows how far the card's speed drifts;
- with ``--train-steps N``, the UFM-Base train step at batch 2, 420x560, as
  ``chip_smoke.py`` trains it: the median host time of N steps that each end
  in a synchronize (after 2 warm-up steps), the kernel time of one step
  (``torch.profiler``; the rest of the step the card is idle), the peak
  memory, and both times once more with every MLP's activation swapped for
  one ``F.gelu`` (what the JAX GELU chain of ``gelu_exact`` costs a step).

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

import torch
import torch.nn.functional as F

FWD_SHAPES = (("encoder", (2, 1201, 16, 64)), ("info_sharing", (1, 2400, 12, 64)))
TRAIN_SHAPES = (("encoder", (4, 1201, 16, 64)), ("info_sharing", (2, 2400, 12, 64)))
SMALL_SHAPE = (1, 77, 2, 64)
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
    for name in [m for m in sys.modules if m == "ufm_torch" or m.startswith("ufm_torch.")]:
        del sys.modules[name]
    sys.path.insert(0, root)
    try:
        fa = importlib.import_module("ufm_torch.ops.flash_attention")
    finally:
        sys.path.remove(root)
    if not os.path.abspath(fa.__file__).startswith(root + os.sep):
        raise RuntimeError(f"ufm_torch came from {fa.__file__}, not from {root}")
    importlib.import_module("ufm_torch.ops._build").build(["flash_attention_fwd", "flash_attention_bwd"])
    return fa


def views(shape, seed):
    b, s, h, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(b, s, 3, h, d, generator=gen, device="cuda").to(torch.bfloat16)
    g = torch.randn(b, s, h, d, generator=gen, device="cuda").to(torch.bfloat16)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], g


def run_tree(root: str, turn: int, train_steps: int = 0) -> dict:
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
    emit("launch", "small", shape=list(SMALL_SHAPE), host_us_per_launch={
        "fwd": host_us(lambda: fa.flash_attention_forward(q, k, v, scale)),
        "fwd_with_lse": host_us(lambda: fa.flash_attention_forward(q, k, v, scale, with_lse=True)),
        "bwd": host_us(lambda: fa.flash_attention_backward(q, k, v, o, lse, g, scale)),
    })
    if train_steps:
        emit("train_step", "ufm_base_b2", **train_step(train_steps))
    return out


def train_step(steps: int) -> dict:
    """The batch-2 UFM-Base train step of the tree loaded last."""
    from ufm_torch.models import UniFlowMatchConfidence, ufm_base_config
    from ufm_torch.nn.layers import Mlp
    from ufm_torch.training import make_optimizer, make_train_step, synthetic_batch

    model = UniFlowMatchConfidence.from_config(ufm_base_config(), seed=0)
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

    def kernel_ms():
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            step(batch)
            torch.cuda.synchronize()
        return sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages()) / 1e3

    torch.cuda.reset_peak_memory_stats()
    out = {"step_ms": median_ms(), "kernel_ms": kernel_ms(), "max_memory_allocated": torch.cuda.max_memory_allocated()}
    for m in model.net.modules():
        if isinstance(m, Mlp):
            m.act = lambda x: F.gelu(x, approximate="none")
    out["step_ms_f_gelu"] = median_ms()
    out["kernel_ms_f_gelu"] = kernel_ms()
    del model, optimizer, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("trees", nargs="+", help="checkout roots, timed in this order")
    parser.add_argument("--train-steps", type=int, default=0, help="also time N batch-2 train steps per tree")
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
        runs.setdefault(root, []).append(run_tree(root, turn, args.train_steps))
    summary = {}
    for root, outs in runs.items():
        summary[root] = {}
        for (kernel, case), fields in outs[0].items():
            for field, val in fields.items():
                if isinstance(val, dict):  # host_us_per_launch: one list per launch kind
                    for name in val:
                        summary[root][f"{kernel}/{name}_host_us"] = [o[(kernel, case)][field][name] for o in outs]
                elif isinstance(val, (int, float)):
                    summary[root][f"{kernel}/{case}_{field}"] = [o[(kernel, case)][field] for o in outs]
    print(json.dumps({"summary": summary, "device": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
