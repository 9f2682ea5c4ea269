"""The benchmark's frozen reference against ``ufm_torch``'s plain CPU path at
the tiny configuration: every predict output field of UFM-Base and
UFM-Refine, one training run's three checked steps, and the parameter names
and shapes of the full-size models."""

from __future__ import annotations

import math

import pytest
import torch

from bench_tiny import run_tiny, tiny_config

from benchmark.reference import ufm as ref

# the tiny models run in fp32 on both sides: only summation order differs
FP32_GAP = 1e-4


@pytest.mark.parametrize("cell", ["ufm_base.predict_b1", "ufm_refine.predict_b4"])
def test_predict_fields_match_the_plain_path(cell):
    run, result = run_tiny(cell)
    assert set(run.values) == {"flow", "flow_px", "flow_tail", "flow_tail_px", "covariance", "covisibility",
                               "confidence"}
    for name, gap in run.values.items():
        assert gap < FP32_GAP, (name, gap)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0


def test_train_steps_match_the_plain_path():
    run, result = run_tiny("ufm_base.train_b8")
    assert run.values["loss"] < FP32_GAP
    assert run.values["gradient"] < FP32_GAP
    # three steps of Adam: the changes differ by rounding of the update's sign-like normalisation
    assert run.values["change"] < 1e-3
    assert result["correct"]


@pytest.mark.parametrize("config,cls", [("ufm_base", "UniFlowMatchConfidence"),
                                        ("ufm_refine", "UniFlowMatchClassificationRefinement")])
def test_full_size_parameters_are_the_systems(config, cls):
    import json
    import os

    from bench_tiny import ROOT
    from ufm_torch import models

    with open(os.path.join(ROOT, "benchmark", "configs", f"{config}.json")) as f:
        conf = json.load(f)
    assert conf["model_class"] == cls
    model = getattr(models, cls)(**conf["model"], device="meta")
    got = {k: tuple(v.shape) for k, v in model.net.named_parameters()}
    want = {k: tuple(shape) for k, (shape, _) in ref.param_specs(ref.Arch(conf["model"])).items()}
    assert got == want
    dtypes = {k: v.dtype for k, v in model.net.named_parameters()}
    for k, (_, part) in ref.param_specs(ref.Arch(conf["model"])).items():
        assert dtypes[k] == (torch.bfloat16 if part == "backbone" else torch.float32), k


def test_base_has_428_million_parameters():
    import json
    import os

    from bench_tiny import ROOT

    with open(os.path.join(ROOT, "benchmark", "configs", "ufm_base.json")) as f:
        arch = ref.Arch(json.load(f)["model"])
    total = sum(math.prod(s) for s, _ in ref.param_specs(arch).values())
    assert round(total / 1e5) == 4281


def test_tiny_config_keeps_the_topology():
    conf = tiny_config("ufm_refine.predict_b4")
    arch = ref.Arch(conf["model"])
    assert arch.refine and arch.unet and arch.uncertainty is not None
