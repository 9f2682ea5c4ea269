"""The comparison fails what it must: a run at the tiny sizes on the CPU (the
harness's look for a chip skipped, the rest of the run driven as on the
card) with the timed path broken underneath comes out not correct, once for
each fault the cell can have; and the control, the reference one precision
step below the configuration's, fails the cell's limits."""

from __future__ import annotations

import pytest
import torch

from bench_tiny import SEED, run_tiny, tiny_config, tiny_traffic


def _patch_forward(monkeypatch, change):
    from ufm_torch.models.network import UFMNet

    inner = UFMNet.forward

    def broken(self, img1, img2, symmetrized=False):
        return change(inner, self, img1, img2)

    monkeypatch.setattr(UFMNet, "forward", broken)


def _flow_altered(inner, net, img1, img2):
    out = inner(net, img1, img2)
    out["flow"] = out["flow"] + 1.0  # one pixel off where the flow is produced
    return out


def _half_batch(inner, net, img1, img2):
    half = img1.shape[0] // 2
    out = inner(net, img1[:half], img2[:half])
    return {k: torch.cat([v, v], dim=0) for k, v in out.items()}  # the left-out half answered by the rest


@pytest.mark.parametrize("cell,fault", [
    ("ufm_base.predict_b1", _flow_altered),
    ("ufm_refine.predict_b4", _flow_altered),
    ("ufm_refine.predict_b4", _half_batch),
])
def test_predict_fault_is_not_correct(monkeypatch, cell, fault):
    _patch_forward(monkeypatch, fault)
    _, result = run_tiny(cell)
    assert result["correct"] is False


def test_predict_sound_run_is_correct():
    _, result = run_tiny("ufm_refine.predict_b4")
    assert result["correct"] is True


def _state_unchanged(monkeypatch):
    from ufm_torch.training.trainer import MasterWeightAdamW

    monkeypatch.setattr(MasterWeightAdamW, "step", lambda self: None)


def _train_half_batch(monkeypatch):
    from ufm_torch.training import trainer

    inner = trainer.ufm_total_loss

    def half(outputs, batch, weights=None, group=None):
        h = batch["img1"].shape[0] // 2
        return inner({k: v[:h] for k, v in outputs.items()}, {k: v[:h] for k, v in batch.items()}, weights, group)

    monkeypatch.setattr(trainer, "ufm_total_loss", half)


def _loss_altered(monkeypatch):
    from ufm_torch.training import trainer

    inner = trainer.ufm_total_loss

    def scaled(outputs, batch, weights=None, group=None):
        loss, metrics = inner(outputs, batch, weights, group)
        return loss * 1.05, {**metrics, "total_loss": metrics["total_loss"] * 1.05}

    monkeypatch.setattr(trainer, "ufm_total_loss", scaled)


@pytest.mark.parametrize("fault", [_state_unchanged, _train_half_batch, _loss_altered])
def test_train_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    run, result = run_tiny("ufm_base.train_b8")
    assert result["correct"] is False, run.values


@pytest.mark.parametrize("cell", ["ufm_base.predict_b1", "ufm_refine.predict_b4"])
def test_predict_control_fails_the_limits(cell):
    from bench_tiny import ROOT
    from benchmark.calibrate import _predict_control
    from benchmark.harness import check

    values = _predict_control(tiny_config(cell), tiny_traffic(cell), SEED, "cpu")
    assert check.judge(values, check.load_limits(ROOT, cell))["correct"] is False, values


def test_train_control_fails_the_limits():
    from bench_tiny import ROOT
    from benchmark.calibrate import _train_readings
    from benchmark.harness import check
    from benchmark.reference.ufm import CONTROL

    cell = "ufm_base.train_b8"
    values, _ = _train_readings(tiny_config(cell), tiny_traffic(cell), SEED, "cpu", CONTROL)
    assert check.judge(values, check.load_limits(ROOT, cell))["correct"] is False, values
