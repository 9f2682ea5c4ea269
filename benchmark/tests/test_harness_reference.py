"""The benchmark's frozen reference against ``ufm_torch``'s plain CPU path at
the tiny configuration: every predict output field of UFM-Base and
UFM-Refine, one training run's three checked steps, and the parameter names,
shapes and types of every configuration's full-size model, through the
reference module the configuration names."""

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


def _bench_configs():
    import json
    import os

    from bench_tiny import ROOT

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        entries = json.load(f)["configs"]
    confs = []
    for c in entries:
        with open(os.path.join(ROOT, c["file"])) as f:
            confs.append(pytest.param(json.load(f), id=c["name"]))
    return confs


@pytest.mark.parametrize("conf", _bench_configs())
def test_full_size_parameters_are_the_systems(conf):
    """Every configuration of ``BENCHMARK.json``, through the reference
    module it names: the system's parameters, names, shapes and types."""
    from ufm_torch import models

    from benchmark.reference import load

    module = load(conf)
    model = getattr(models, conf["model_class"])(**conf["model"], device="meta")
    specs = module.param_specs(module.Arch(conf["model"]))
    got = {k: tuple(v.shape) for k, v in model.net.named_parameters()}
    assert got == {k: tuple(shape) for k, (shape, _) in specs.items()}
    dtypes = {k: v.dtype for k, v in model.net.named_parameters()}
    for k, (_, part) in specs.items():
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
