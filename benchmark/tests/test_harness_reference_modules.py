"""A configuration names its reference module (``benchmark/reference/
__init__.py``): without the key the harness reaches ``ufm`` and every number
is what it was before configurations could name one (pinned below, as the
code before that change gave them); a module named by a configuration is the
one the harness holds the system to; a name or a module that breaks the
contract is refused before set-up; and ``ufm.Arch`` refuses what it does not
model."""

from __future__ import annotations

import hashlib
import json
import os
import sys
import types

import pytest
import torch

from bench_tiny import ROOT, SEED, run_tiny, tiny_config

from benchmark.harness import yardstick as ys
from benchmark.reference import Refused, load
from benchmark.reference import ufm

# sha256 over each tensor's name, shape, dtype and bytes, in order, of make_params(tiny arch, SEED, "cpu")
PARAMS_DIGEST = {
    "ufm_base.predict_b1": (184, "bd07561de2e29632d620873c5af4a4a82421f7d6a0c84e79d5aaefeec8aa454e"),
    "ufm_refine.predict_b4": (219, "4e1ac52fdf550715e8ad8cdbddf1a91d6ce3d6d59fb9b8d44f3290808c9607b6"),
}
# sha256 of json.dumps([[name, shape, part], ...]) of the full-size param_specs
SPECS_DIGEST = {
    "ufm_base": (612, "b855dfb8546dccd66aee79cc58aa643891fca6301f0e5ed7b894ed9adc1c59ae"),
    "ufm_refine": (667, "71cd854f1fb8954790e8ec29439fd655cc84074141b6ac994715658186fb858e"),
}
FLOPS = {("ufm_base", False): 2832414904320.0, ("ufm_base", True): 8491466342400.0,
         ("ufm_refine", False): 3536422685440.0}
# per_forward_bounds at batches 1, 4 and 8: the same for both configurations (one backbone)
BOUNDS = {
    1: {"attn_fwd": 0.5014400564287158, "attn_bwd": 1.2536001410717896, "mlp_fwd": 0.6263720157573307,
        "mlp_bwd": 0.6263720157573307},
    4: {"attn_fwd": 2.0057602257148632, "attn_bwd": 5.0144005642871585, "mlp_fwd": 2.505488063029323,
        "mlp_bwd": 2.505488063029323},
    8: {"attn_fwd": 4.0115204514297265, "attn_bwd": 10.028801128574317, "mlp_fwd": 5.010976126058646,
        "mlp_bwd": 5.010976126058646},
}
WRAPPER = "wrapped_ufm"


def _full(config: str) -> dict:
    with open(os.path.join(ROOT, "benchmark", "configs", f"{config}.json")) as f:
        return json.load(f)


def _arch(config: str):
    conf = _full(config)
    return load(conf).Arch(conf["model"])


# ------------------------------------------------ without the key: as before
@pytest.mark.parametrize("cell", sorted(PARAMS_DIGEST))
def test_make_params_is_the_same_draw(cell):
    from benchmark.harness import inputs

    conf = tiny_config(cell)
    assert "reference" not in conf
    module = load(conf)
    assert module is ufm
    params = inputs.make_params(module.Arch(conf["model"]), SEED, "cpu", conf["weights"])
    h = hashlib.sha256()
    for k, v in params.items():
        h.update(f"{k}|{tuple(v.shape)}|{v.dtype}|".encode())
        h.update(v.contiguous().view(torch.uint8).numpy().tobytes())
    assert (len(params), h.hexdigest()) == PARAMS_DIGEST[cell]


@pytest.mark.parametrize("config", sorted(SPECS_DIGEST))
def test_full_size_specs_are_the_same(config):
    specs = [[k, list(s), p] for k, (s, p) in ufm.param_specs(_arch(config)).items()]
    assert (len(specs), hashlib.sha256(json.dumps(specs).encode()).hexdigest()) == SPECS_DIGEST[config]


@pytest.mark.parametrize("config,train", sorted(FLOPS))
def test_model_flops_are_the_same(config, train):
    assert ys.model_flops_per_pair(_arch(config), train=train) == FLOPS[config, train]


def test_refine_train_flops_stay_unwritten():
    """The reference writes no loss of the refinement: counting UFM-Refine's
    training operations fails, as it did before."""
    with pytest.raises(NotImplementedError):
        ys.model_flops_per_pair(_arch("ufm_refine"), train=True)


@pytest.mark.parametrize("config", ["ufm_base", "ufm_refine"])
@pytest.mark.parametrize("batch", sorted(BOUNDS))
def test_per_forward_bounds_are_the_same(config, batch):
    arch = _arch(config)
    assert arch.encoder_tokens(30, 40) == 1201
    assert ys.per_forward_bounds(arch, batch) == BOUNDS[batch]


# ------------------------------------------- a module named by a configuration
def _module(monkeypatch, name: str = WRAPPER, own_arch: bool = True, **parts):
    """A reference module ``benchmark.reference.<name>`` in ``sys.modules``:
    ``ufm``'s parts, with ``parts`` put in (None: left out)."""
    path = f"benchmark.reference.{name}"
    module = types.ModuleType(path)
    module.Arch = type("Arch", (ufm.Arch,), {"__module__": path}) if own_arch else ufm.Arch
    for k in ("param_specs", "forward", "predict", "Numerics", "FP32", "CONTROL"):
        setattr(module, k, getattr(ufm, k))
    for k, v in parts.items():
        if v is None:
            delattr(module, k)
        else:
            setattr(module, k, v)
    monkeypatch.setitem(sys.modules, path, module)
    return module


def _flow_scaled_predict(scale: float):
    def predict(P, arch, src_u8, tgt_u8, nm=ufm.FP32, raw=None):
        out = ufm.predict(P, arch, src_u8, tgt_u8, nm, raw)
        return {**out, "flow": out["flow"] * scale}

    return predict


@pytest.mark.parametrize("scale,correct", [(1.0, True), (1.5, False)])
def test_predict_is_held_to_the_named_module(monkeypatch, scale, correct):
    module = _module(monkeypatch, predict=_flow_scaled_predict(scale))
    run, result = run_tiny("ufm_refine.predict_b4", reference=WRAPPER)
    assert run.ref is module and type(run.arch) is module.Arch
    assert result["correct"] is correct, run.values


@pytest.mark.parametrize("scale,correct", [(1.0, True), (1.5, False)])
def test_training_and_the_yardstick_reach_the_named_module(monkeypatch, scale, correct):
    calls, drawn = [], []

    def forward(P, arch, img1, img2, nm=ufm.FP32):
        calls.append(img1.device.type)
        out = ufm.forward(P, arch, img1, img2, nm)
        return {**out, "flow": out["flow"] * scale}

    def param_specs(arch):
        drawn.append(type(arch))
        return ufm.param_specs(arch)

    module = _module(monkeypatch, forward=forward, param_specs=param_specs)
    run, result = run_tiny("ufm_base.train_b8", reference=WRAPPER)
    # the weights were drawn over the module's specs; the reference's steps ran its forward
    assert run.ref is module and drawn and set(drawn) == {module.Arch} and calls
    assert result["correct"] is correct, run.values
    calls.clear()
    ys.model_flops_per_pair(run.arch, train=False)
    assert calls == ["meta"]


# ------------------------------------------------------------- refusals
@pytest.mark.parametrize("name", ["no_such_reference", "../ufm", "train"])
def test_a_name_that_is_no_reference_is_refused_before_set_up(monkeypatch, name):
    from benchmark.harness import cells

    def set_up(run):
        raise AssertionError("set-up began")

    monkeypatch.setattr(cells, "_model", set_up)
    with pytest.raises(Refused):
        run_tiny("ufm_base.predict_b1", reference=name)


@pytest.mark.parametrize("parts,missing", [
    (dict(predict=None), "predict"),
    (dict(CONTROL=None, FP32=None), "FP32, CONTROL"),
    (dict(own_arch=False), "not the module's own"),
])
def test_a_module_that_breaks_the_contract_is_refused(monkeypatch, parts, missing):
    _module(monkeypatch, **parts)
    with pytest.raises(Refused, match=missing):
        load(tiny_config("ufm_base.predict_b1", WRAPPER))


def test_an_arch_that_lacks_what_the_yardstick_reads_is_refused(monkeypatch):
    class Arch:
        def __init__(self, cfg):
            self.model_hw, self.compute_dtype, self.enc, self.info = (420, 560), "bfloat16", {}, {}

    Arch.__module__ = f"benchmark.reference.{WRAPPER}"
    _module(monkeypatch, Arch=Arch)
    with pytest.raises(Refused, match="encoder_tokens"):
        load(tiny_config("ufm_base.predict_b1", WRAPPER))


@pytest.mark.parametrize("change,said", [
    (lambda conf: conf.update(reference="no_such_reference"), "no_such_reference"),
    (lambda conf: conf["model"]["encoder_kwargs"].update(num_register_tokens=4), "num_register_tokens"),
])
def test_the_command_refuses_with_code_2_and_no_result(monkeypatch, capsys, change, said):
    from benchmark import run as bench_run

    real = bench_run.load_json

    def load_json(*parts):
        data = real(*parts)
        if parts == ("benchmark/configs/ufm_base.json",):
            change(data)
        return data

    monkeypatch.setattr(bench_run, "load_json", load_json)
    rc = bench_run.main(["--workload", "ufm_base.predict_b1", "--seed", str(SEED), "--seconds", "1"])
    out = capsys.readouterr()
    assert rc == 2 and out.out == "" and said in out.err


# ------------------------------------------------ what ufm.Arch does not model
@pytest.mark.parametrize("group,key,value", [
    ("encoder_kwargs", "num_register_tokens", 4),
    ("encoder_kwargs", "use_cls_token", False),
    ("encoder_kwargs", "qkv_bias", False),
    ("encoder_kwargs", "mlp_act", "gelu_tanh"),
    ("encoder_kwargs", "ffn_layer", "swiglufused"),
    ("encoder_kwargs", "norm_intermediate", False),
    ("encoder_kwargs", "init_values", 1e-5),
    ("encoder_kwargs", "img_size", 518),
    ("info_sharing_kwargs", "num_register_tokens", 4),
    ("info_sharing_kwargs", "qkv_bias", False),
    ("info_sharing_kwargs", "mlp_act", "relu"),
    ("info_sharing_kwargs", "layerscale_init", 1e-5),
    ("info_sharing_kwargs", "use_pos_embed", False),
    ("info_sharing_kwargs", "some_new_option", 1),
])
def test_arch_refuses_what_it_does_not_model(group, key, value):
    model = _full("ufm_base")["model"]
    model[group][key] = value
    with pytest.raises(ValueError, match=key):
        ufm.Arch(model)


def test_arch_refuses_the_published_giant():
    model = _full("ufm_base")["model"]
    model["encoder_str"] = "dinov2_giant"
    with pytest.raises(ValueError, match="SwiGLU"):
        ufm.Arch(model)


def test_arch_takes_no_registers_and_bookkeeping_as_nothing():
    model = _full("ufm_refine")["model"]
    want = vars(ufm.Arch(model))
    model["encoder_kwargs"].update(num_register_tokens=0, name="dinov2", size="large", uses_torch_hub=False,
                                   torch_hub_force_reload=False, pretrained_checkpoint_path=None,
                                   gradient_checkpointing=False, device="cpu", qkv_bias=True, use_cls_token=True,
                                   mlp_act="gelu_exact", ffn_layer="mlp")
    model["info_sharing_kwargs"].update(num_register_tokens=0, name="global_attention", qkv_bias=True)
    assert vars(ufm.Arch(model)) == want
