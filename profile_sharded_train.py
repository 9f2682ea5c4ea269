#!/usr/bin/env python3
"""Sharded training and data-parallel inference of UFM-Base across the GPUs
of one host (``ufm_torch.parallel`` over NCCL).

    python3 profile_sharded_train.py                # one rank per card of the host
    python3 profile_sharded_train.py --device cpu   # a rehearsal: gloo ranks, the tiny config

One process per card, meeting over localhost. Rank 0 first runs the
unsharded step (``make_train_step``) at the global batch from the seed-0
weights on its own card: the reference. Then every rank runs
``make_sharded_train_step`` on each mesh of ``meshes(world)`` from the same
weights and global batch (4 pairs at 420x560): the first step's metrics
against the reference's, then ``STEPS`` timed steps. One JSON line per mesh
holds each rank's step ms, peak memory and attention launches a step. Then
``make_data_parallel_forward`` on a (world, 1, 1) mesh splits a batch of
``world`` pairs, each held to rank 0's batch-1 forward of that pair, timed
against rank 0's forward of the whole batch on one card. Each check that
fails raises; the last two lines are the card's name and power limit (as
``nvidia-smi`` prints them) and ``{"ok": true, ...}``.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import socket
import statistics
import subprocess
import sys
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

BATCH = 4
STEPS = 3
LEARNING_RATE = 3e-6  # chip_smoke's FIT_LR: the loss falls step by step without warm-up
ATTENTION_LAUNCHES = 36  # attention forward launches and backward calls a step, per rank
# step-0 metrics against the unsharded step: fsdp / data sharding moves no
# product; tensor parallelism sums bf16 partial products in another order
METRIC_REL, METRIC_REL_MODEL = 1e-3, 2e-2
DATA_PARALLEL_BAR = 1e-5


def meshes(world: int):
    """(data, fsdp, model) meshes of ``world`` ranks: pure data, pure FSDP,
    pure tensor parallelism and their pairings."""
    out = [(world, 1, 1), (1, world, 1), (1, 1, world)]
    if world == 4:
        out += [(2, 2, 1), (1, 2, 2), (2, 1, 2)]
    return out


def emit(tag: str, **fields) -> None:
    print(json.dumps({"phase": tag, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"profile_sharded_train check failed: {msg}")


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def _peak(device) -> int:
    return torch.cuda.max_memory_allocated() if device.type == "cuda" else 0


def _reset_peak(device) -> None:
    gc.collect()  # FSDP-wrapped nets hold reference cycles
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def _steps(step, batch, device, n):
    """``n`` steps: host seconds, metrics and (forward, backward) attention
    launches of each."""
    from ufm_torch.ops import flash_attention as fa

    out = []
    for _ in range(n):
        before = (fa.LAUNCHES, fa.BWD_LAUNCHES)
        t = time.perf_counter()
        metrics = step(batch)
        _sync(device)
        seconds = time.perf_counter() - t
        out.append((seconds, {k: v.item() for k, v in metrics.items()}, (fa.LAUNCHES - before[0], fa.BWD_LAUNCHES - before[1])))
    return out


def _rank(rank: int, world: int, port: int, device_type: str, queue) -> None:
    from ufm_torch.models import UniFlowMatchConfidence, ufm_base_config, ufm_tiny_config
    from ufm_torch.parallel import make_mesh
    from ufm_torch.training import make_optimizer, make_sharded_train_step, make_train_step, synthetic_batch

    cuda = device_type == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(1)
    device = torch.device(device_type, rank) if cuda else torch.device("cpu")
    dist.init_process_group("nccl" if cuda else "gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
    try:
        config, hw = (ufm_base_config(), (420, 560)) if cuda else (ufm_tiny_config(compute_dtype="bfloat16"), (42, 56))
        launches = ATTENTION_LAUNCHES if cuda else 0  # the CPU runs the plain attention
        batch = synthetic_batch(BATCH, *hw, seed=1, device=device)
        opt_kwargs = dict(learning_rate=LEARNING_RATE, warmup_steps=0, total_steps=10000)

        reference = None
        if rank == 0:
            model = UniFlowMatchConfidence.from_config(config, seed=0, device=device)
            step = make_train_step(model.net, make_optimizer(model.net, **opt_kwargs))
            _reset_peak(device)
            ran = _steps(step, batch, device, STEPS + 1)
            reference = {"metrics": ran[0][1], "step_ms": statistics.median(s for s, _, _ in ran[1:]) * 1e3,
                         "losses": [m["total_loss"] for _, m, _ in ran], "max_memory_allocated": _peak(device)}
            emit("unsharded", world=1, batch=BATCH, input_hw=list(hw), **reference)
            del model, step
        reference = _broadcast(reference)

        for shape in meshes(world):
            model = UniFlowMatchConfidence.from_config(config, seed=0, device=device)
            mesh = make_mesh(data=shape[0], fsdp=shape[1], model=shape[2], device_type=device_type)
            step, net, _, place = make_sharded_train_step(model.net, mesh, **opt_kwargs)
            placed = place(batch)
            _reset_peak(device)
            ran = _steps(step, placed, device, STEPS + 1)
            mine = {"rank": rank, "step_s": [s for s, _, _ in ran], "launches": [list(n) for _, _, n in ran],
                    "max_memory_allocated": _peak(device), "metrics0": ran[0][1],
                    "losses": [m["total_loss"] for _, m, _ in ran]}
            ranks = [None] * world
            dist.all_gather_object(ranks, mine)
            if rank == 0:
                step_ms = statistics.median(max(r["step_s"][i] for r in ranks) for i in range(1, STEPS + 1)) * 1e3
                rel = {k: abs(ranks[0]["metrics0"][k] - v) / max(abs(v), 1e-12) for k, v in reference["metrics"].items()}
                bar = METRIC_REL_MODEL if shape[2] > 1 else METRIC_REL
                emit("sharded_step", mesh=dict(zip(("data", "fsdp", "model"), shape)), batch=BATCH, input_hw=list(hw),
                     step_ms=step_ms, pairs_per_s=BATCH / step_ms * 1e3, unsharded_step_ms=reference["step_ms"],
                     max_memory_allocated=[r["max_memory_allocated"] for r in ranks],
                     unsharded_max_memory_allocated=reference["max_memory_allocated"],
                     step0_metric_rel=rel, bar=bar, losses=ranks[0]["losses"],
                     launches_per_step=sorted({tuple(n) for r in ranks for n in r["launches"]}),
                     step_s_by_rank=[r["step_s"] for r in ranks])
                for k, r in rel.items():
                    check(r <= bar, f"mesh {shape}: step-0 {k} differs from the unsharded step's by {r:.3e}")
                check(all(r["launches"] == [[launches, launches]] * (STEPS + 1) for r in ranks),
                      f"mesh {shape}: attention launches {[r['launches'] for r in ranks]}, expected {launches} + {launches} a step")
                check(all(r["losses"] == ranks[0]["losses"] for r in ranks), f"mesh {shape}: ranks report different losses")
                check(ranks[0]["losses"][-1] < ranks[0]["losses"][0], f"mesh {shape}: the loss did not fall {ranks[0]['losses']}")
            del model, net, step, placed
            dist.barrier()

        _data_parallel(rank, world, config, hw, device, launches)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        queue.put("ok")


def _broadcast(obj):
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _data_parallel(rank, world, config, hw, device, launches) -> None:
    from ufm_torch.models import UniFlowMatchConfidence
    from ufm_torch.ops import flash_attention as fa
    from ufm_torch.parallel import make_data_parallel_forward, make_mesh

    model = UniFlowMatchConfidence.from_config(config, seed=0, device=device)
    forward = make_data_parallel_forward(model, make_mesh(world, device_type=device.type))
    g = torch.Generator(device=device).manual_seed(2)
    img1, img2 = (torch.randn((world, *hw, 3), generator=g, device=device) for _ in range(2))
    forward(img1, img2)  # warm-up
    _sync(device)
    times = []
    for _ in range(STEPS):
        before = fa.LAUNCHES
        t = time.perf_counter()
        out = forward(img1, img2)
        _sync(device)
        times.append(time.perf_counter() - t)
        check(fa.LAUNCHES - before == launches, f"rank {rank}: {fa.LAUNCHES - before} attention launches in a data-parallel forward")
    seconds = [None] * world
    dist.all_gather_object(seconds, times)
    if rank == 0:
        with torch.no_grad():
            single = []
            for _ in range(STEPS + 1):
                t = time.perf_counter()
                model.net(img1, img2)
                _sync(device)
                single.append(time.perf_counter() - t)
            diff = 0.0
            for i in range(world):  # each pair against its own batch-1 forward
                want = model.net(img1[i : i + 1], img2[i : i + 1])
                for k, v in want.items():
                    d = ((out[k][i : i + 1].float() - v.float()).abs().max() / v.float().abs().max().clamp(min=1e-12)).item()
                    diff = max(diff, d)
        ms = statistics.median(max(s[i] for s in seconds) for i in range(STEPS)) * 1e3
        single_ms = statistics.median(single[1:]) * 1e3
        emit("data_parallel", mesh={"data": world, "fsdp": 1, "model": 1}, batch=world, input_hw=list(hw),
             forward_ms=ms, pairs_per_s=world / ms * 1e3, single_card_forward_ms=single_ms,
             single_card_pairs_per_s=world / single_ms * 1e3, max_rel_diff_vs_batch1=diff, bar=DATA_PARALLEL_BAR)
        check(diff <= DATA_PARALLEL_BAR, f"data-parallel outputs differ from their batch-1 forwards by {diff:.3e}")
    dist.barrier()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--world", type=int, default=None, help="ranks (default: the host's cards; 4 on the CPU)")
    args = parser.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("profile_sharded_train: no CUDA device (pass --device cpu for the CPU rehearsal)", file=sys.stderr)
        return 1
    world = args.world or (torch.cuda.device_count() if args.device == "cuda" else 4)
    if args.device == "cuda":
        from ufm_torch.ops import _build

        _build.build()  # once, before the ranks start
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()
        emit("device", world=world, nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    queue = mp.get_context("spawn").SimpleQueue()
    mp.start_processes(_rank, args=(world, _free_port(), args.device, queue), nprocs=world, start_method="spawn")
    check(not queue.empty() and queue.get() == "ok", "rank 0 did not finish")
    if args.device == "cuda":
        print(smi[0])
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
    else:
        print(json.dumps({"ok": True, "device": {"platform": "cpu", "count": world}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
