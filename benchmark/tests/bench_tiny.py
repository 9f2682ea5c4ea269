"""Tiny stand-ins for the benchmark's cells, for its CPU tests: the cells'
configurations swapped for ``ufm_tiny_config`` (with UFM-Refine's
classification head and a two-level UNet where the cell runs UFM-Refine),
optionally naming another reference module, and their traffic shrunk to
48 x 64 pairs or 42 x 56 training batches."""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Optional

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SEED = 2**33 + 12345  # wider than 32 bits, as the driver's seeds are


def tiny_config(cell: str, reference: Optional[str] = None) -> dict:
    from ufm_torch.models import ufm_tiny_config

    refine = cell.startswith("ufm_refine")
    cfg = ufm_tiny_config(has_classification_head=refine, use_unet_feature=refine,
                          unet_kwargs={"features": [4, 8]} if refine else {})
    with open(os.path.join(ROOT, "benchmark", "configs", f"{cell.split('.')[0]}.json")) as f:
        conf = json.load(f)
    conf["model"] = json.loads(json.dumps(cfg.to_dict()))
    if reference is not None:
        conf["reference"] = reference
    return conf


def tiny_traffic(cell: str) -> dict:
    with open(os.path.join(ROOT, "benchmark", "traffic", f"{cell.split('.')[1]}.json")) as f:
        traffic = json.load(f)
    if traffic["kind"] == "closed_loop_predict":
        traffic.update(height=48, width=64, sample_calls=2)
    else:
        traffic.update(height=42, width=56)
    return traffic


def run_tiny(cell: str, seed: int = SEED, seconds: float = 1.5, reference: Optional[str] = None):
    """One run of ``cell`` at the tiny sizes on the CPU, held to the
    reference module ``reference`` names (default: the configuration's):
    (Run, result)."""
    from benchmark import run as bench_run

    return bench_run.run_cell(cell, seed, seconds, False, "cpu", time.time(),
                              config_override=tiny_config(cell, reference), traffic_override=tiny_traffic(cell))
