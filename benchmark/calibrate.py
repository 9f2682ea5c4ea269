"""The readings that a cell's limits are set from, taken on the card at the
cell's own size (``benchmark/limits/<cell>.json`` records them).

    python benchmark/calibrate.py --workload <cell> --seeds 1 2 3 ... [--program] [--control] [--half-batch]

- ``--program``: the system's numbers on each seed, through the cell's own
  timed path (a run of ``--seconds``, then the comparison with the reference):
  the lower readings.
- ``--control``: the reference put in the system's place and computed one
  precision step below what the configuration states (the configuration's
  reference module's ``CONTROL``; ``ufm``'s: fp8 e4m3 products in the bf16
  backbone, bf16 in the fp32 heads), compared with the float32 reference on
  the same inputs: the upper readings (the flow's numbers, shares of the
  control's own error, read 1).
- ``--half-batch`` (training cells): the float32 reference stepping on the
  first half of each batch only, its loss the mean over that half, compared
  with the reference on the whole batch: one of the faults a training
  number is held against.

Each reading is one JSON line on standard output. The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def _predict_control(run_cfg, traffic, seed: int, device) -> dict:
    import numpy as np
    import torch

    from benchmark.harness import check, inputs
    from benchmark.reference import load

    ref = load(run_cfg)
    arch = ref.Arch(run_cfg["model"])
    params = {k: v.float() for k, v in inputs.make_params(arch, seed, device, run_cfg["weights"]).items()}
    pool = inputs.predict_pool(seed, traffic, device)
    rng = np.random.default_rng([seed % 2**63, 7])  # as many pairs as a run compares, drawn from the pool
    sample = rng.choice(len(pool), size=min(traffic["sample_calls"], len(pool)), replace=False).tolist()
    worst = {}
    with torch.no_grad():
        for i in sample:
            src, tgt = (torch.from_numpy(a).to(device) for a in pool[i])
            if src.dim() == 3:
                src, tgt = src[None], tgt[None]
            want = ref.predict(params, arch, src, tgt)
            got = ref.predict(params, arch, src, tgt, ref.CONTROL)
            for k, v in check.predict_gaps(got, want, got).items():
                worst[k] = max(worst.get(k, 0.0), v)
    return worst


def _train_readings(run_cfg, traffic, seed: int, device, numerics=None, half: bool = False) -> dict:
    """The reference's three steps under ``numerics`` (or on half of each
    batch) against the float32 reference's."""
    import torch

    from benchmark.harness import check, inputs
    from benchmark.harness.cells import _leaf_norms
    from benchmark.reference import load
    from benchmark.reference import train as ref_train

    ref = load(run_cfg)
    arch = ref.Arch(run_cfg["model"])
    batches = inputs.train_pool(seed, traffic, device)[:3]

    def follow(nm, halved):
        tr = ref_train.Trainer(inputs.make_params(arch, seed, device, run_cfg["weights"]), arch, numerics=nm)
        start = {k: v.detach().clone() for k, v in tr.params.items()}
        losses, grad = [], None
        for b in batches:
            if halved:
                b = {k: v[: max(1, v.shape[0] // 2)] for k, v in b.items()}
            losses.append(tr.step(b))
            if grad is None:
                grad = {k: g.clone() for k, g in tr.last_grads.items()}
        with torch.no_grad():
            delta = {k: (tr.params[k] - start[k]).cpu() for k in start}
        del tr, start
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        return losses, grad, delta

    want = follow(ref.FP32, False)
    got = follow(numerics or ref.FP32, half)
    got_change, want_change, _ = check.change_norms(got[2], {k: v.to(device) for k, v in want[2].items()}, want[1])
    got_grad, want_grad = _leaf_norms(got[1]), _leaf_norms(want[1])
    values = check.train_gaps(got[0], want[0], got_grad, want_grad, got_change, want_change)
    leaves = {"losses": [got[0], want[0]], "gradient": {k: [got_grad[k], v] for k, v in want_grad.items()},
              "change": {k: [got_change.get(k), v] for k, v in want_change.items()}}
    return values, leaves


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--program", action="store_true")
    parser.add_argument("--control", action="store_true")
    parser.add_argument("--half-batch", action="store_true")
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)

    import torch

    from benchmark import run as bench_run
    from benchmark.reference import load

    bench = bench_run.load_json("BENCHMARK.json")
    entry = next(w for w in bench["workloads"] if w["name"] == args.workload)
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    cfg = bench_run.load_json(conf["file"])
    ref = load(cfg)
    torch.set_num_threads(cfg["deployment"]["intra_op_threads"])  # as benchmark/run.py runs the system
    traffic = bench_run.load_json("benchmark", "traffic", f"{entry['traffic']}.json")
    training = traffic["kind"] == "train_steps"
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    for seed in args.seeds:
        if args.program:  # the system runs with TF32 as the configuration leaves it
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
            t0 = time.time()
            run, result = bench_run.run_cell(args.workload, seed, args.seconds, False, "cuda", time.time())
            _emit(kind="program", seed=seed, values=run.values, correct=result["correct"], metrics=result["metrics"],
                  readings=run.readings, reference_s=run.reference_s, seconds=time.time() - t0)
            del run, result
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if args.control:
            t0 = time.time()
            if training:
                values, leaves = _train_readings(cfg, traffic, seed, "cuda", ref.CONTROL)
            else:
                values, leaves = _predict_control(cfg, traffic, seed, "cuda"), None
            _emit(kind="control", seed=seed, values=values, leaves=leaves, seconds=time.time() - t0)
        if args.half_batch and training:
            t0 = time.time()
            values, leaves = _train_readings(cfg, traffic, seed, "cuda", half=True)
            _emit(kind="half_batch", seed=seed, values=values, leaves=leaves, seconds=time.time() - t0)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
