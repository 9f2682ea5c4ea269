"""UFM on DINOv2 ViT-g/14 with registers, on the CPU at a tiny size.

- The op ``ufm_torch::linear_swiglu_bf16`` (``w12`` with the SwiGLU gate as
  its epilogue): its CPU path is the FFN's plain composition bit for bit;
  ``SwiGLUFFN`` takes the op only where no gradient is recorded.
- A tiny ``ViTEncoder`` with registers and the SwiGLU FFN, a tiny
  ``UniFlowMatchConfidence`` on it (forward, predict through the benchmark
  harness, gradients) against ``benchmark/reference/ufm_vitg_reg.py``, the
  plain PyTorch reference that the benchmark's cell holds the card to, on
  weights from ``benchmark.harness.inputs.make_params``.
- The factory, the presets, the configuration at full width (meta device),
  the CLI's ``--model base-vitg-reg`` and tensor parallelism's refusal.

Tolerances: the port and the reference both run fp32 on the CPU, so only the
order of sums differs (1e-5 relative); the reference with bf16 operands in
the backbone, one precision step below, must fail each of them.
"""

import dataclasses
import json
import os
import sys
import time

import pytest
import torch
import torch.nn.functional as F

from ufm_torch.models import UFMNet, UniFlowMatchConfidence, ufm_base_config, ufm_base_vitg_reg_config, ufm_tiny_config
from ufm_torch.nn import layers
from ufm_torch.nn.encoders import ViTEncoder, ViTEncoderInput, feature_returner_encoder_factory
from ufm_torch.nn.layers import Mlp, SwiGLUFFN, swiglu_hidden_dim
from ufm_torch.ops import library
from ufm_torch.ops import linear_swiglu as ls

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.harness import inputs  # noqa: E402
from benchmark.reference import ufm_vitg_reg as ref  # noqa: E402

# fp32 on both sides: only the order of sums differs
FP32_REL = 1e-5
# the control: the reference with bf16 operands in the backbone
CONTROL = ref.Numerics(backbone="bf16")
SEED = 2**33 + 27


def _tiny_model_config():
    """UFM-Base's topology at a tiny size on a ViT with 2 registers and the
    SwiGLU FFN: embed 96, depth 3, 2 heads, patch 14, 28 x 42 inputs."""
    cfg = ufm_tiny_config(inference_resolution=(42, 28))
    enc_dim, info_dim = 96, cfg.info_sharing_kwargs["dim"]
    heads = {}
    for key in ("feature_head_kwargs", "uncertainty_head_kwargs"):
        kw = json.loads(json.dumps(getattr(cfg, key)))
        kw["dpt_feature"]["input_dims"] = [enc_dim, info_dim, info_dim, info_dim]
        heads[key] = kw
    return dataclasses.replace(
        cfg,
        encoder_kwargs={"embed_dim": enc_dim, "depth": 3, "num_heads": 2, "pretrain_grid_size": 4,
                        "num_register_tokens": 2, "ffn_layer": "swiglufused", "intermediate_layer_idx": [0, 2]},
        info_sharing_kwargs=dict(cfg.info_sharing_kwargs, input_embed_dim=enc_dim),
        **heads,
    )


def _conf():
    with open(os.path.join(ROOT, "benchmark", "configs", "ufm_vitg_reg.json")) as f:
        conf = json.load(f)
    conf["model"] = json.loads(json.dumps(_tiny_model_config().to_dict()))
    return conf


def _model_and_params():
    conf = _conf()
    arch = ref.Arch(conf["model"])
    params = inputs.make_params(arch, SEED, "cpu", conf["weights"])
    model = UniFlowMatchConfidence(**conf["model"], device="cpu")
    model.net.load_state_dict(params, strict=True)
    return model, arch, params


def _images(n=1, h=28, w=42, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, h, w, 3, generator=g), torch.randn(n, h, w, 3, generator=g)


def _rel(got, want):
    return float((got.double() - want.double()).norm() / want.double().norm())


def _bf16(*shape, seed=0, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(*shape, generator=g) * scale).to(torch.bfloat16)


# ---------------------------------------------------------------- the op
def test_op_cpu_path_is_the_composition_bit_for_bit():
    x, w12, b12 = _bf16(3, 5, 32), _bf16(48, 32, seed=1, scale=32**-0.5), _bf16(48, seed=2, scale=0.1)
    y = library.linear_swiglu_bf16(x, w12, b12)
    h1, h2 = F.linear(x, w12, b12).chunk(2, dim=-1)
    composition = (F.silu(h1.float()) * h2.float()).to(torch.bfloat16)
    assert y.shape == (3, 5, 24) and y.dtype == torch.bfloat16
    assert torch.equal(y, composition)
    assert torch.equal(ls.linear_swiglu_reference(x, w12, b12), composition)
    # the control: the gate rounded twice (silu in bf16, then the product) differs
    assert not torch.equal(F.silu(h1) * h2, composition)


def test_op_checks_and_fake_implementation():
    x, w12, b12 = _bf16(4, 16), _bf16(16, 16, seed=1), _bf16(16, seed=2)
    result = torch.library.opcheck(library.linear_swiglu_bf16, (x, w12, b12))
    assert set(result.values()) == {"SUCCESS"}, result
    with pytest.raises(ValueError, match="bfloat16"):
        library.linear_swiglu_bf16(x.float(), w12, b12)
    with pytest.raises(ValueError, match="2H"):
        library.linear_swiglu_bf16(x, w12[:15], b12[:15])
    with pytest.raises(ValueError, match="CUDA"):
        ls.launch(x, w12, b12)


def test_ffn_takes_the_op_only_where_no_gradient_is_recorded(monkeypatch):
    ffn = SwiGLUFFN(32, 4 * 32).to(torch.bfloat16)
    assert ffn.w12.weight.shape == (2 * swiglu_hidden_dim(128), 32) and swiglu_hidden_dim(6144) == 4096
    calls = []
    real = layers.linear_swiglu_bf16
    monkeypatch.setattr(layers, "linear_swiglu_bf16", lambda *a: calls.append(1) or real(*a))
    x = _bf16(2, 7, 32)
    with torch.no_grad():
        fused = ffn(x)
    assert calls == [1]
    trained = ffn(x)  # grad mode, parameters that require grad: the plain composition
    assert calls == [1] and trained.grad_fn is not None
    assert torch.equal(fused, trained.detach())
    trained.float().sum().backward()
    assert ffn.w12.weight.grad is not None and ffn.w3.weight.grad is not None


# ---------------------------------------------------------------- the encoder
def test_tiny_encoder_with_registers_matches_the_reference():
    model, arch, params = _model_and_params()
    enc = model.net.encoder
    assert isinstance(enc, ViTEncoder) and enc.num_register_tokens == 2 and isinstance(enc.blocks[0].mlp, SwiGLUFFN)
    assert arch.encoder_tokens(2, 3) == 2 * 3 + 1 + 2
    images = torch.cat(_images(), dim=0)
    with torch.no_grad():
        got = [o.features for o in enc(ViTEncoderInput(image=images))]
        want = ref.encode(params, arch, images, ref.FP32)
        control = ref.encode(params, arch, images, CONTROL)
    assert [g.shape for g in got] == [w.shape for w in want] == [(2, 2, 3, 96)] * 2
    for g, w, c in zip(got, want, control):
        assert _rel(g, w) < FP32_REL
        assert _rel(c, w) > FP32_REL


def test_registers_reach_the_patches():
    """The registers attend with the patches: moving them moves the patch
    features (a register left out of the sequence would not)."""
    model, _, _ = _model_and_params()
    images = torch.cat(_images(), dim=0)
    enc = model.net.encoder
    with torch.no_grad():
        before = enc(ViTEncoderInput(image=images))[-1].features
        enc.register_tokens.add_(torch.randn(enc.register_tokens.shape, generator=torch.Generator().manual_seed(3)))
        after = enc(ViTEncoderInput(image=images))[-1].features
    assert _rel(after, before) > 1e-3


# ---------------------------------------------------------------- the whole model
def test_tiny_model_matches_the_reference_forward():
    model, arch, params = _model_and_params()
    img1, img2 = _images()
    with torch.no_grad():
        got = model.net(img1, img2)
        want = ref.forward(params, arch, img1, img2)
        control = ref.forward(params, arch, img1, img2, CONTROL)
    keys = ("flow", "flow_cov", "covis_mask", "keypoint_confidence")
    assert all(k in got and k in want for k in keys)
    for k in keys:
        assert got[k].shape == want[k].shape, k
        assert _rel(got[k], want[k]) < FP32_REL, k
    assert max(_rel(control[k], want[k]) for k in keys) > FP32_REL


def test_tiny_model_predict_through_the_harness():
    """The benchmark's own comparison at the tiny size on the CPU: the
    predict path against ``ufm_vitg_reg.predict`` on the harness's weights
    and pairs."""
    from benchmark import run as bench_run

    traffic = {"kind": "closed_loop_predict", "batch": 1, "height": 48, "width": 64, "pool_pairs": 2,
               "sample_calls": 2, "stretch_calls": 2}
    run, result = bench_run.run_cell("ufm_vitg_reg.predict_b1", SEED, 0.2, False, "cpu", time.time(),
                                     config_override=_conf(), traffic_override=traffic)
    assert run.ref is ref and result["correct"] and result["failed"] == 0 and result["attempted"] > 0
    assert set(run.values) == {"flow", "flow_px", "flow_tail", "flow_tail_px", "covariance", "covisibility",
                               "confidence"}
    for name, gap in run.values.items():
        assert gap < 1e-4, (name, gap)  # shares of the control's error, or relative L2 gaps: fp32 both sides


def test_tiny_model_gradients_match_the_reference_autograd():
    """The plain training composition's gradients (fp32) against autograd
    through the reference, for the encoder's new parameters."""
    model, arch, params = _model_and_params()
    img1, img2 = _images()
    g = torch.Generator().manual_seed(5)
    weight = torch.randn(1, 28, 42, 2, generator=g)
    model.net(img1, img2)["flow"].mul(weight).sum().backward()
    names = ["encoder.register_tokens", "encoder.blocks.1.mlp.w12.weight", "encoder.blocks.1.mlp.w12.bias",
             "encoder.blocks.2.mlp.w3.weight", "encoder.blocks.0.attn.qkv.weight"]
    got = dict(model.net.named_parameters())

    def reference_grads(nm):
        leaves = {k: v.clone().requires_grad_(k in names) for k, v in params.items()}
        loss = ref.forward(leaves, arch, img1, img2, nm)["flow"].mul(weight).sum()
        return dict(zip(names, torch.autograd.grad(loss, [leaves[k] for k in names])))

    want, control = reference_grads(ref.FP32), reference_grads(CONTROL)
    for k in names:
        assert _rel(got[k].grad, want[k]) < 1e-4, k  # a gradient sums over more orders than a forward
    assert max(_rel(control[k], want[k]) for k in names) > 1e-4


# ---------------------------------------------------------------- builds and refusals
@pytest.mark.parametrize("where,kwargs", [
    ("encoder", {"ffn_layer": "geglu"}),
    ("encoder", {"num_register_tokens": -1}),
    ("info_sharing", {"num_register_tokens": 4}),
    ("info_sharing", {"ffn_layer": "swiglufused"}),
])
def test_factory_refuses_what_it_does_not_build(where, kwargs):
    cfg = ufm_tiny_config()
    if where == "encoder":
        cfg.encoder_kwargs = dict(cfg.encoder_kwargs, **kwargs)
        with pytest.raises(ValueError, match="ffn_layer|num_register_tokens"):
            UFMNet(cfg)
    else:
        cfg.info_sharing_kwargs = dict(cfg.info_sharing_kwargs, **kwargs)
        with pytest.raises(ValueError, match="load-bearing"):
            UFMNet(cfg)


def test_dinov2_giant_preset_is_the_published_swiglu_vit_g():
    with torch.device("meta"):
        swiglu = feature_returner_encoder_factory("dinov2_giant", num_register_tokens=4)
        gelu = feature_returner_encoder_factory("dinov2_giant", ffn_layer="mlp")
        by_size = feature_returner_encoder_factory("dinov2", size="giant", name="dinov2", num_register_tokens=0)
    assert isinstance(swiglu.blocks[0].mlp, SwiGLUFFN) and isinstance(by_size.blocks[0].mlp, SwiGLUFFN)
    assert isinstance(gelu.blocks[0].mlp, Mlp) and not hasattr(gelu, "register_tokens")
    assert swiglu.register_tokens.shape == (1, 4, 1536)


def test_vitg_reg_config_builds_at_full_width():
    """The configuration at its published widths on the meta device: ViT-g/14
    (40 x 1536, 24 heads of 64, SwiGLU 1536 -> 2 x 4096 -> 1536, 4 registers),
    UFM-Base's info sharing (input 1536 -> 768) and DPT heads (1536 first);
    ViT-L's UFM-Base keeps its GELU MLP's names and no registers."""
    with torch.device("meta"):
        net = UFMNet(ufm_base_vitg_reg_config())
        base = UFMNet(ufm_base_config())
    enc = net.encoder
    assert (len(enc.blocks), enc.embed_dim, enc.blocks[0].attn.num_heads) == (40, 1536, 24)
    assert enc.blocks[0].mlp.w12.weight.shape == (8192, 1536) and enc.blocks[0].mlp.w3.weight.shape == (1536, 4096)
    assert enc.register_tokens.shape == (1, 4, 1536) and enc.taps == (0, 39)
    assert net.info_sharing.input_proj.weight.shape == (768, 1536)
    assert net.head1.feature.proj_0.weight.shape[1] == 1536
    assert round(sum(p.numel() for p in net.parameters()) / 1e6) == 1261
    assert next(enc.parameters()).dtype == torch.bfloat16
    names = {k for k, _ in base.named_parameters()}
    assert "encoder.blocks.0.mlp.fc1.weight" in names and not any("register" in k or "w12" in k for k in names)


def test_cli_offers_the_model():
    from ufm_torch.cli import build_parser

    for command in (["infer", "a.png", "b.png"], ["eval", "dir"], ["export", "out.ufmt"], ["serve"]):
        args = build_parser().parse_args([*command, "--random-init", "--model", "base-vitg-reg"])
        assert args.model == "base-vitg-reg"


def test_tensor_parallelism_refuses_the_swiglu_block():
    from ufm_torch.parallel import sharding

    net = UFMNet(_tiny_model_config())
    with pytest.raises(ValueError, match="SwiGLU"):
        sharding._tp_plan(net, 2)
    plan, _ = sharding._tp_plan(UFMNet(ufm_tiny_config()), 2)  # the GELU blocks keep their rules
    assert "encoder.blocks.0.mlp.fc1" in plan


def test_swiglu_bound_at_the_cell_shape():
    from benchmark.harness.swiglu import linear_swiglu_bound_ms, swiglu_fwd_bound_ms

    ms, by = linear_swiglu_bound_ms(2410, 1536, 4096)
    assert by == "operations" and abs(ms - 2 * 2410 * 1536 * 8192 / 989e12 * 1e3) < 1e-12
    with open(os.path.join(ROOT, "benchmark", "configs", "ufm_vitg_reg.json")) as f:
        arch = ref.Arch(json.load(f)["model"])
    assert arch.encoder_tokens(30, 40) == 1205 and arch.enc["ffn_hidden"] == 4096
    assert abs(swiglu_fwd_bound_ms(arch, 1) - 40 * ms) < 1e-12
