#!/usr/bin/env python3
"""Time the window-refinement kernel of several checkouts of the port in one process.

    python3 profile_window_trees.py PARENT . . PARENT

Each argument is the root of a checkout that holds ``ufm_torch`` (an
unpacked ``git archive`` of another commit, or this one). The trees are
taken in the order given, so "parent, change, change, parent" puts both
versions on one card in turns. For each tree it builds that tree's window
kernel and prints one JSON line per case of ``chip_smoke.py``'s
``WINDOW_CASES``:

- ``ms``: CUDA-event time per call, each batch of calls queued behind a
  device sleep, as ``chip_smoke.py`` times it; ``bound_ms`` and
  ``share_of_bound`` as there;
- ``residual_max_abs_err`` / ``log_softmax_max_abs_err``: the tree's kernel
  against this checkout's plain version on the same inputs.

The inputs (seeded, made on the card) and the plain version come from this
checkout, so every tree sees the same ones; each case line also gives
``staged_tile_share``, this checkout's ``staged_tiles`` over its tile count.
The last line sums each tree's times by case. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys

import torch

import chip_smoke as cs


def load_tree(root: str):
    """``ufm_torch.ops.window_refinement`` of the checkout at ``root``, its
    kernel built."""
    root = os.path.abspath(root)
    for name in [m for m in sys.modules if m == "ufm_torch" or m.startswith("ufm_torch.")]:
        del sys.modules[name]
    sys.path.insert(0, root)
    try:
        wr = importlib.import_module("ufm_torch.ops.window_refinement")
    finally:
        sys.path.remove(root)
    if not os.path.abspath(wr.__file__).startswith(root + os.sep):
        raise RuntimeError(f"ufm_torch came from {wr.__file__}, not from {root}")
    importlib.import_module("ufm_torch.ops._build").build(["window_refinement_fwd"])
    return wr


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("trees", nargs="+", help="checkout roots, timed in this order")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_window_trees: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"device": smi, "torch": torch.__version__, "trees": args.trees}), flush=True)

    here = load_tree(os.path.dirname(os.path.abspath(__file__)))
    cases = []
    for name, shape, p, kind, scale, _ in cs.WINDOW_CASES:
        q, f, flow, bias = cs.window_inputs(shape, p, kind, scale, far=name == "edges")
        ref = here.window_refinement_reference(q, f, flow, bias, cs.WINDOW_TEMPERATURE, p)
        taps, _ = cs.window_taps(flow, p)
        bound_ms, bound_by = cs.window_bound_ms(shape, p, taps)
        share = here.staged_tiles(flow, p) / here.tile_count(*shape[:3])
        cases.append((name, shape, p, (q, f, flow, bias), ref, bound_ms, bound_by, share))

    summary = {}
    for turn, root in enumerate(args.trees):
        wr = load_tree(root)
        for name, shape, p, inputs, (ref_res, ref_ls), bound_ms, bound_by, share in cases:
            res, ls = wr.window_refinement(*inputs, cs.WINDOW_TEMPERATURE, p)
            torch.cuda.synchronize()
            ms = cs.time_ms(lambda: wr.window_refinement(*inputs, cs.WINDOW_TEMPERATURE, p))
            row = {"tree": root, "turn": turn, "case": name, "shape": list(shape), "p": p, "ms": ms,
                   "bound_ms": bound_ms, "bound_by": bound_by, "share_of_bound": bound_ms / ms,
                   "staged_tile_share": share, "residual_max_abs_err": (res - ref_res).abs().max().item(),
                   "log_softmax_max_abs_err": (ls - ref_ls).abs().max().item()}
            print(json.dumps(row), flush=True)
            summary.setdefault(root, {}).setdefault(name, []).append(ms)
    print(json.dumps({"summary_ms": summary, "device": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
