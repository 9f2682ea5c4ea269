"""On the card: one short traced run of each inference cell through the
command as the benchmark's checks run it (run with ``python -m pytest
benchmark/tests/test_harness_card.py -m cuda``; skips without a card)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from bench_tiny import ROOT


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark runs only on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell,metrics", [
    ("ufm_base.predict_b1", {"call_host_ms.infer", "mfu.infer", "idle_share.infer", "attn_fwd_roofline.infer",
                             "mlp_fwd_roofline.infer"}),
    ("ufm_refine.predict_b4", {"window_fwd_roofline.infer"}),
])
def test_traced_run_on_the_card(card, cell, metrics):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed", str(2**32 + 17),
                          "--seconds", "2", "--trace", "1"], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["compared"]
    assert metrics <= set(result["metrics"])
    for name, m in result["metrics"].items():
        if "roofline" in name or "mfu" in name:
            assert 0 < m["value"] <= 105, name
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    assert result["breakdown"]["device_ops"] and len(result["breakdown"]["idle_gaps"]) <= 10
