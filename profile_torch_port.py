#!/usr/bin/env python3
"""Where the time goes on the PyTorch / CUDA port's main path (one GPU).

    python3 profile_torch_port.py

Builds UFM-Base at full width (seeded random weights, 560x420) on the GPU,
warms it up, then times batch-1 and batch-2 requests of 480x640 uint8 pairs
through ``predict_correspondences_batched``, run eagerly
(``capture_graphs = False``: the stage hooks are Python calls, which a
captured graph's replay does not make; ``chip_smoke.py``'s ``captured`` phase
profiles the captured programs):

- wall time per request (host clock, ending in a synchronize);
- device time per stage (encoder, info sharing, the two DPT heads, and the
  rest: normalize / resize / unmap), from CUDA events recorded by forward
  hooks on the stage modules;
- device busy time per request and kernel time by category and by kernel,
  from ``torch.profiler``; idle share = 1 - busy / wall.

Prints one JSON line per measurement, then the card's name and power limit.
Needs a CUDA device.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch

CATEGORIES = (
    ("attention (flash_attention_fwd)", ("flash_attention_fwd",)),
    ("matmul", ("gemm", "nvjet", "cutlass", "xmma_gemm", "sm90_xmma", "splitk", "cublas")),
    ("convolution", ("conv", "fprop", "dgrad", "implicit", "winograd", "cudnn", "nhwc", "nchw")),
    ("layer_norm", ("layer_norm",)),
    ("softmax", ("softmax",)),
    ("copy / layout", ("copy", "memcpy", "memset", "cat", "transpose", "permute", "index")),
    ("elementwise / other", ("",)),
)


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "elementwise / other"


def emit(what: str, **fields) -> None:
    print(json.dumps({"measure": what, **fields}), flush=True)


def stage_timers(net):
    """CUDA events around each stage module's forward, via hooks."""
    stages = {"encoder": net.encoder, "info_sharing": net.info_sharing, "head1": net.head1}
    if hasattr(net, "uncertainty_head"):
        stages["uncertainty_head"] = net.uncertainty_head
    spans = defaultdict(list)

    def pre(name):
        def hook(_module, _args):
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            spans[name].append([start, None])
        return hook

    def post(name):
        def hook(_module, _args, _out):
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            spans[name][-1][1] = end
        return hook

    for name, mod in stages.items():
        mod.register_forward_pre_hook(pre(name))
        mod.register_forward_hook(post(name))
    return spans


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_port: needs a CUDA device", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ufm_torch.models import UniFlowMatchConfidence, ufm_base_config

    model = UniFlowMatchConfidence.from_config(ufm_base_config(), seed=0)
    model.capture_graphs = False
    spans = stage_timers(model.net)
    rng = np.random.default_rng(0)

    for batch in (1, 2):
        shape = (batch, 480, 640, 3)
        src, tgt = rng.integers(0, 256, shape, dtype=np.uint8), rng.integers(0, 256, shape, dtype=np.uint8)
        for _ in range(3):  # warm-up
            model.predict_correspondences_batched(source_image=src, target_image=tgt)
        torch.cuda.synchronize()
        spans.clear()

        walls, totals = [], []
        for _ in range(5):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t = time.perf_counter()
            start.record()
            model.predict_correspondences_batched(source_image=src, target_image=tgt)
            end.record()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            totals.append(start.elapsed_time(end))
        stage_ms = {n: statistics.median(s.elapsed_time(e) for s, e in v) for n, v in spans.items()}
        stage_ms["rest (normalize, resize, unmap, gaps)"] = statistics.median(totals) - sum(stage_ms.values())
        wall_ms = 1e3 * statistics.median(walls)
        emit("request", batch=batch, input_hw=[480, 640], wall_ms=wall_ms,
             event_span_ms=statistics.median(totals), stage_ms=stage_ms)

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                model.predict_correspondences_batched(source_image=src, target_image=tgt)
            torch.cuda.synchronize()
        kernels = defaultdict(float)
        for evt in prof.key_averages():
            # device-side events only: the CPU ops above them report their
            # kernels' time again
            if evt.device_type != DeviceType.CUDA:
                continue
            dev_us = getattr(evt, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(evt, "self_cuda_time_total", 0.0)
            if dev_us > 0:
                kernels[evt.key] += dev_us / 1e3 / 3
        busy_ms = sum(kernels.values())
        by_cat = defaultdict(float)
        for name, ms in kernels.items():
            by_cat[category(name)] += ms
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
        # busy time from the profiled requests, wall time from the unprofiled
        # ones (the profiler slows the host, not the kernels)
        emit("profile", batch=batch, device_busy_ms=busy_ms, idle_share=1 - busy_ms / wall_ms,
             by_category_ms=dict(sorted(by_cat.items(), key=lambda kv: -kv[1])),
             top_kernels_ms=[[n[:90], ms] for n, ms in top])

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
