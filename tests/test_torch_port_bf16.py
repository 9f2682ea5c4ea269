"""The port's bf16 path held to the JAX package's bf16 forward.

- **Parity on the CPU.** The tiny topology with ``compute_dtype="bfloat16"``,
  ``seeded_inputs`` and ``UFMNet.init(PRNGKey(7))``: the port's plain bf16
  path against JAX's jitted bf16 forward on every output field, for UFM-Base,
  UFM-Refine (the XLA window path) and UFM-Refine with the UNet. Bar: the
  cross-backend 0.15 of ``tests/test_golden.py:110`` (bf16 reassociation
  across backends). Each case prints and records its largest difference.
- **The head-dim-64 goldens** ``tests/golden/torch_port_bf16_d64_{base,refine}.npz``
  let the card, which has no JAX, hold the port's *kernel* path (the
  attention kernel takes bf16 at d = 64 only) to the JAX package. The
  topology is the tiny one with the encoder and info sharing 128 wide in 2
  heads of d = 64, at 196x140: 141 encoder tokens and 280 info-sharing
  tokens, both past a 128-token tile edge. Each file holds ``config`` (the
  JAX config as JSON), ``input_1`` / ``input_2`` (numpy ``default_rng(64)``
  normals, batch 1), ``params/<a/b/c>`` (the JAX params of
  ``PRNGKey(7)``, fp32) and ``out/<field>`` (JAX's bf16 forward). The
  backbone computes in bf16, so its parameters and the inputs are stored
  rounded to bf16 values (the same forward either way; it halves their
  compressed size); the outputs are the fields the repository's anchors keep
  (``ufm_tpu/utils/anchor.py::ANCHOR_KEYS``), less the 25-channel
  log-softmax, whose size at this resolution the files cannot carry, and less
  the refine model's copies of the base model's fields. The parameters of
  this topology alone take ~2.2 MB compressed, so each file is ~3 MB. Here the
  goldens are checked against a fresh JAX forward and the port's plain path;
  ``chip_smoke.py`` (``bf16_golden``) and ``tests/test_torch_port_gpu.py``
  hold the kernel path to them.

Regenerate the goldens (after an intended numerics change) with
``python tests/test_torch_port_bf16.py``.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ufm_tpu.checkpoint.convert import flatten_params, unflatten_params
from ufm_tpu.models import UFMNet as JNet
from ufm_tpu.models import ufm_tiny_config as jax_tiny_config
from ufm_tpu.utils.anchor import seeded_inputs
from ufm_torch.checkpoint import load_jax_params
from ufm_torch.models import UFMArchConfig, UFMNet, ufm_tiny_config

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
CROSS_BACKEND_ATOL = 0.15  # tests/test_golden.py:110
# a regenerated golden against the committed one: the same jitted CPU forward
GOLDEN_ATOL = 1e-5
UNET = {"use_unet_feature": True, "unet_kwargs": {"out_channels": 8, "features": (8, 16)}}
MODELS = {
    "base": {},
    "refine": {"has_classification_head": True, "refinement_impl": "xla"},
    "refine_unet": {"has_classification_head": True, "refinement_impl": "xla", **UNET},
}

D64_WIDTH, D64_HEADS = 128, 2
D64_RESOLUTION = (196, 140)  # (W, H): a 14 x 10 patch grid
D64_INPUT_SEED = 64
D64_OUT_FIELDS = {
    "base": ("flow", "covis_mask", "keypoint_confidence", "flow_cov"),
    # the uncertainty head's fields are the base golden's (flax draws each
    # module's parameters from its own path, so the two share them)
    "refine": ("flow", "regression_flow", "refinement_residual"),
}


def _max_abs(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))))


@pytest.mark.parametrize("name", list(MODELS))
def test_bf16_plain_path_matches_jax(name, record_property):
    overrides = MODELS[name]
    i1, i2 = seeded_inputs()
    jnet = JNet(jax_tiny_config(compute_dtype="bfloat16", **overrides))
    params = jax.jit(jnet.init)(jax.random.PRNGKey(7), i1, i2)["params"]
    want = jax.jit(jnet.apply)({"params": params}, i1, i2)
    net = UFMNet(ufm_tiny_config(compute_dtype="bfloat16", **overrides))
    load_jax_params(net, flatten_params(params))
    with torch.no_grad():
        got = net(torch.tensor(np.asarray(i1)), torch.tensor(np.asarray(i2)))
    assert set(got) == set(want)
    diffs = {k: _max_abs(got[k].float().numpy(), want[k]) for k in sorted(want)}
    print(f"{name}: largest |port - JAX| per field {diffs}")
    record_property("max_abs_diff", diffs)
    for k, d in diffs.items():
        assert d <= CROSS_BACKEND_ATOL, f"{name}:{k} differs by {d:.4f} > {CROSS_BACKEND_ATOL}"


# ---- the head-dim-64 goldens -----------------------------------------------


def d64_config(variant: str):
    """The JAX config of a d = 64 golden: the tiny topology, 128 wide."""
    cfg = jax_tiny_config(compute_dtype="bfloat16", inference_resolution=D64_RESOLUTION, **MODELS[variant])
    d = D64_WIDTH
    heads = {}
    for field in ("feature_head_kwargs", "uncertainty_head_kwargs"):
        kw = {k: dict(v) for k, v in getattr(cfg, field).items()}
        kw["dpt_feature"]["input_dims"] = (d, d, d, d)
        heads[field] = kw
    return dataclasses.replace(
        cfg,
        encoder_kwargs=dict(cfg.encoder_kwargs, embed_dim=d, num_heads=D64_HEADS),
        info_sharing_kwargs=dict(cfg.info_sharing_kwargs, input_embed_dim=d, dim=d, num_heads=D64_HEADS),
        classification_head_kwargs=dict(cfg.classification_head_kwargs, input_feature_dim=2 * d),
        **heads,
    )


def _bf16_values(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def d64_golden(variant: str):
    """(config, inputs, flat params, outputs) of a d = 64 golden, computed
    now by the JAX package."""
    cfg = d64_config(variant)
    w, h = D64_RESOLUTION
    rng = np.random.default_rng(D64_INPUT_SEED)
    i1, i2 = (_bf16_values(rng.standard_normal((1, h, w, 3)).astype(np.float32)) for _ in range(2))
    net = JNet(cfg)
    flat = flatten_params(jax.jit(net.init)(jax.random.PRNGKey(7), i1, i2)["params"])
    flat = {
        k: _bf16_values(v) if k.split("/")[0] in ("encoder", "info_sharing") else np.asarray(v, np.float32)
        for k, v in flat.items()
    }
    out = jax.jit(net.apply)({"params": unflatten_params(flat)}, i1, i2)
    out = {k: np.asarray(out[k], np.float32) for k in D64_OUT_FIELDS[variant]}
    return cfg, (i1, i2), flat, out


def _golden_path(variant: str) -> str:
    return os.path.join(GOLDEN_DIR, f"torch_port_bf16_d64_{variant}.npz")


def write_d64_golden(variant: str) -> str:
    cfg, (i1, i2), flat, out = d64_golden(variant)
    path = _golden_path(variant)
    np.savez_compressed(
        path,
        config=np.array(json.dumps(cfg.to_dict())),
        input_1=i1,
        input_2=i2,
        **{f"params/{k}": v for k, v in flat.items()},
        **{f"out/{k}": v for k, v in out.items()},
    )
    return path


def _load(variant: str):
    with np.load(_golden_path(variant)) as z:
        files = {k: z[k] for k in z.files}
    cfg = json.loads(str(files.pop("config")))
    params = {k[len("params/"):]: v for k, v in files.items() if k.startswith("params/")}
    out = {k[len("out/"):]: v for k, v in files.items() if k.startswith("out/")}
    return cfg, (files["input_1"], files["input_2"]), params, out


@pytest.mark.parametrize("variant", list(D64_OUT_FIELDS))
def test_d64_golden_equals_fresh_jax_forward(variant):
    """The committed golden is what the JAX package computes today: the same
    config, inputs and parameters, and outputs within 1e-5."""
    cfg, (i1, i2), flat, out = d64_golden(variant)
    g_cfg, (g1, g2), g_params, g_out = _load(variant)
    assert g_cfg == json.loads(json.dumps(cfg.to_dict()))
    assert g_cfg["encoder_kwargs"]["embed_dim"] // g_cfg["encoder_kwargs"]["num_heads"] == 64
    assert g_cfg["info_sharing_kwargs"]["dim"] // g_cfg["info_sharing_kwargs"]["num_heads"] == 64
    np.testing.assert_array_equal(g1, i1)
    np.testing.assert_array_equal(g2, i2)
    assert set(g_params) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(g_params[k], flat[k], err_msg=k)
    assert set(g_out) == set(D64_OUT_FIELDS[variant])
    for k in g_out:
        np.testing.assert_allclose(g_out[k], out[k], atol=GOLDEN_ATOL, rtol=0, err_msg=k)
    assert os.path.getsize(_golden_path(variant)) < 4 * 2**20


@pytest.mark.parametrize("variant", list(D64_OUT_FIELDS))
def test_d64_golden_holds_the_plain_path(variant, record_property):
    """The port's plain bf16 path on the CPU, built from the golden alone (as
    the card builds it), within the cross-backend bar of every stored field."""
    g_cfg, (i1, i2), params, out = _load(variant)
    net = UFMNet(UFMArchConfig.from_dict(g_cfg))
    load_jax_params(net, params)
    with torch.no_grad():
        got = net(torch.from_numpy(i1), torch.from_numpy(i2))
    diffs = {k: _max_abs(got[k].float().numpy(), out[k]) for k in sorted(out)}
    print(f"d64 {variant}: largest |port plain - JAX golden| per field {diffs}")
    record_property("max_abs_diff", diffs)
    for k, d in diffs.items():
        assert d <= CROSS_BACKEND_ATOL, f"{variant}:{k} differs by {d:.4f} > {CROSS_BACKEND_ATOL}"


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    for v in D64_OUT_FIELDS:
        p = write_d64_golden(v)
        print(f"wrote {p} ({os.path.getsize(p)} bytes)")
