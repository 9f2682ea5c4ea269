"""ufm_torch checkpoints on the CPU, against the JAX package and the file
formats' own libraries.

- The port's safetensors reader and writer against the ``safetensors``
  package, both ways, bitwise, on every dtype the port handles.
- The port's flax msgpack reader against ``flax.serialization.msgpack_restore``,
  bitwise (``examples/checkpoints/tiny_real224``, and a tree with bf16, scalar
  and chunked arrays).
- ``from_pretrained("examples/checkpoints/tiny_real224")`` against the JAX
  package's on the three bundled pairs: flow within 2e-4 px (trained weights
  give larger flows than random ones), EPE against the analytic ground truth
  within 1e-3 px of JAX's.
- Saves both ways between the packages (fp32 tiny models, the refine one with
  the UNet's transposed convolutions): outputs within 1e-5.
- Pre-scan ``blocks_N`` msgpack trees, reference-layout torch names (checked
  against the JAX package's reading of the same dict), Lightning checkpoints
  with their prefix and drops, ``model_args`` checkpoints, ``strict``, and
  ``get_parameter_groups`` against JAX's.
"""

import json
import os
import re
import sys

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ufm_tpu.checkpoint.convert import flatten_params as jax_flatten
from ufm_tpu.checkpoint.convert import params_to_torch_state_dict, torch_state_dict_to_params
from ufm_tpu.models import UniFlowMatchClassificationRefinement as JRefine
from ufm_tpu.models import UniFlowMatchConfidence as JBase
from ufm_tpu.models import ufm_tiny_config as jax_tiny_config
from ufm_tpu.utils.example_pairs import ensure_bundled_pairs, load_pair
from ufm_torch.checkpoint import (
    jax_params_to_state_dict,
    load_state_dict_into,
    load_torch_checkpoint_into,
    read_flax_msgpack,
    read_safetensors,
    write_safetensors,
)
from ufm_torch.models import UniFlowMatchClassificationRefinement, UniFlowMatchConfidence, ufm_tiny_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_REAL = os.path.join(ROOT, "examples", "checkpoints", "tiny_real224")
TRAINED_FLOW_ATOL = 2e-4  # px
EPE_ATOL = 1e-3  # px
ROUND_TRIP_ATOL = 1e-5
UNET = {"use_unet_feature": True, "unet_kwargs": {"out_channels": 8, "features": (8, 16)}}
VARIANTS = {
    "base": (JBase, UniFlowMatchConfidence, {}),
    "refine_unet": (JRefine, UniFlowMatchClassificationRefinement, {"has_classification_head": True, **UNET}),
}


def _state(model):
    return {k: v.detach().float().cpu().numpy() for k, v in model.net.state_dict().items()}


def _assert_same_state(a, b):
    sa, sb = _state(a), _state(b)
    assert sa.keys() == sb.keys()
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)


def _pair(rng, h=42, w=56):
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8), rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


def _outputs(model, src, tgt):
    res = model.predict_correspondences_batched(source_image=src, target_image=tgt)
    out = {"flow": res.flow.flow_output, "covisibility": res.covisibility.mask}
    return {k: np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v) for k, v in out.items()}


# ---- file formats -----------------------------------------------------------

ST_DTYPES = [torch.float32, torch.float16, torch.bfloat16, torch.int64, torch.int32, torch.uint8]


def _st_tensors():
    g = torch.Generator().manual_seed(0)
    out = {}
    for i, dt in enumerate(ST_DTYPES):
        base = torch.randn(3, 5, 7, generator=g) * 50
        out[f"t{i}.{dt}".replace("torch.", "")] = base.to(dt)
    out["scalar"] = torch.tensor(3.5)
    out["empty"] = torch.zeros(0, 4)
    out["odd"] = torch.arange(3, dtype=torch.uint8)  # 3 bytes: later tensors stay aligned
    return out


@pytest.mark.parametrize("direction", ["port_writes", "package_writes"])
def test_safetensors_against_the_package(tmp_path, direction):
    from safetensors.torch import load_file, save_file

    tensors = _st_tensors()
    path = str(tmp_path / "x.safetensors")
    if direction == "port_writes":
        write_safetensors(path, tensors, metadata={"format": "pt"})
        back = load_file(path)
    else:
        save_file(tensors, path, metadata={"format": "pt"})
        back = read_safetensors(path)
    assert back.keys() == tensors.keys()
    for k, t in tensors.items():
        assert back[k].dtype == t.dtype and back[k].shape == t.shape, k
        assert torch.equal(back[k].view(-1).view(torch.uint8), t.reshape(-1).view(torch.uint8)), k


def test_msgpack_reader_matches_flax_on_tiny_real224():
    path = os.path.join(TINY_REAL, "params.msgpack")
    got = jax_flatten(read_flax_msgpack(path))
    with open(path, "rb") as f:
        want = jax_flatten(flax.serialization.msgpack_restore(f.read()))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_msgpack_reader_bf16_scalars_and_chunks(tmp_path, monkeypatch):
    """bf16 arrays widen exactly to fp32; numpy scalars and arrays split into
    chunks (flax chunks leaves above MAX_CHUNK_SIZE bytes) come back whole."""
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(0)
    big = rng.standard_normal((7, 11)).astype(np.float32)  # 308 bytes: 5 chunks
    bf = jnp.asarray(rng.standard_normal((4, 3)), dtype=jnp.bfloat16)
    tree = {"a": {"big": big, "bf": np.asarray(bf), "n": np.int32(5)}, "c": np.arange(3, dtype=np.int64)}
    path = tmp_path / "t.msgpack"
    path.write_bytes(flax.serialization.msgpack_serialize(tree))
    got = read_flax_msgpack(str(path))
    want = flax.serialization.msgpack_restore(path.read_bytes())
    np.testing.assert_array_equal(got["a"]["big"], want["a"]["big"])
    assert got["a"]["bf"].dtype == np.float32
    np.testing.assert_array_equal(got["a"]["bf"], np.asarray(want["a"]["bf"], np.float32))
    assert got["a"]["n"] == want["a"]["n"] == 5
    np.testing.assert_array_equal(got["c"], want["c"])


def test_msgpack_needs_the_package_and_never_falls_through(tmp_path, monkeypatch):
    """``params.msgpack`` no longer needs the ``msgpack`` package (the port
    decodes it): with the package blocked it still loads first, ahead of the
    directory's ``model.safetensors``, bitwise what the package reads."""
    model = UniFlowMatchConfidence.from_config(ufm_tiny_config(), device="cpu")
    d = str(tmp_path / "both")
    model.save_pretrained(d)  # config.json + model.safetensors of other (random) weights
    with open(os.path.join(TINY_REAL, "params.msgpack"), "rb") as f:
        raw = f.read()
    (tmp_path / "both" / "params.msgpack").write_bytes(raw)
    want = UniFlowMatchConfidence.from_config(ufm_tiny_config(), device="cpu")
    want.net.load_state_dict(jax_params_to_state_dict(jax_flatten(flax.serialization.msgpack_restore(raw))))
    monkeypatch.setitem(sys.modules, "msgpack", None)
    got = UniFlowMatchConfidence.from_pretrained(d, device="cpu")
    got_sd, want_sd, other_sd = got.net.state_dict(), want.net.state_dict(), model.net.state_dict()
    assert set(got_sd) == set(want_sd)
    assert all(torch.equal(got_sd[k], want_sd[k]) for k in want_sd)
    assert not all(torch.equal(got_sd[k], other_sd[k]) for k in other_sd)


# ---- the trained checkpoint -----------------------------------------------------


@pytest.fixture(scope="module")
def tiny_real(tmp_path_factory):
    pairs = ensure_bundled_pairs(str(tmp_path_factory.mktemp("pairs")))
    return JBase.from_pretrained(TINY_REAL), UniFlowMatchConfidence.from_pretrained(TINY_REAL, device="cpu"), pairs


@pytest.mark.parametrize("pair", ["wide_baseline", "parallax", "noise_scene"])
def test_tiny_real224_matches_jax_on_bundled_pairs(tiny_real, pair):
    jmodel, model, pairs = tiny_real
    assert model.device.type == "cpu" and model.config.compute_dtype == "float32"
    src, tgt, gt = load_pair(pairs, pair)
    want = _outputs(jmodel, src, tgt)
    got = _outputs(model, src, tgt)
    np.testing.assert_allclose(got["flow"], want["flow"], atol=TRAINED_FLOW_ATOL, rtol=0)
    np.testing.assert_allclose(got["covisibility"], want["covisibility"], atol=TRAINED_FLOW_ATOL, rtol=0)
    epe = [float(np.linalg.norm(o["flow"][0].transpose(1, 2, 0) - gt, axis=-1).mean()) for o in (got, want)]
    print(f"{pair}: EPE port {epe[0]:.4f} px, JAX {epe[1]:.4f} px")
    assert abs(epe[0] - epe[1]) <= EPE_ATOL
    assert epe[0] < 2.0  # a trained model, not noise (ROADMAP: 0.90 / 1.05 / 0.91 px)


# ---- saves both ways ----------------------------------------------------------------


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_jax_save_loads_into_the_port(tmp_path, variant):
    jcls, cls, overrides = VARIANTS[variant]
    jmodel = jcls.from_config(jax_tiny_config(**overrides), seed=3)
    d = str(tmp_path / "jax_saved")
    jmodel.save_pretrained(d)
    assert os.listdir(d) and "params.msgpack" in os.listdir(d)
    model = cls.from_pretrained(d, device="cpu")
    src, tgt = _pair(np.random.default_rng(1))
    want, got = _outputs(jmodel, src, tgt), _outputs(model, src, tgt)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=ROUND_TRIP_ATOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_port_save_loads_into_jax(tmp_path, variant):
    jcls, cls, overrides = VARIANTS[variant]
    model = cls.from_config(ufm_tiny_config(**overrides), seed=4, device="cpu")
    d = str(tmp_path / "port_saved")
    model.save_pretrained(d)
    assert sorted(os.listdir(d)) == ["config.json", "model.safetensors"]
    with open(os.path.join(d, "config.json")) as f:
        cfg = json.load(f)
    assert cfg["model_class"] == cls.__name__ and "device" not in cfg
    jmodel = jcls.from_pretrained(d)  # the JAX package reads it through safetensors.numpy
    again = cls.from_pretrained(d, device="cpu")
    _assert_same_state(model, again)
    src, tgt = _pair(np.random.default_rng(2))
    want, got = _outputs(model, src, tgt), _outputs(jmodel, src, tgt)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=ROUND_TRIP_ATOL, rtol=0, err_msg=k)


def test_bf16_model_saves_fp32_and_loads_back_bitwise(tmp_path):
    model = UniFlowMatchConfidence.from_config(ufm_tiny_config(compute_dtype="bfloat16"), seed=5, device="cpu")
    assert model.net.encoder.patch_embed.weight.dtype == torch.bfloat16
    d = str(tmp_path / "bf16")
    model.save_pretrained(d)
    stored = read_safetensors(os.path.join(d, "model.safetensors"))
    assert {t.dtype for t in stored.values()} == {torch.float32}
    again = UniFlowMatchConfidence.from_pretrained(d, device="cpu")
    for (k, a), b in zip(model.net.state_dict().items(), again.net.state_dict().values()):
        assert a.dtype == b.dtype and torch.equal(a, b), k


def test_pre_scan_blocks_tree_loads(tmp_path):
    """A params.msgpack of the pre-scan layout (per-layer ``blocks_N``
    subtrees) loads like the scanned one."""
    jmodel = JBase.from_config(jax_tiny_config(), seed=6)
    d = tmp_path / "old"
    jmodel.save_pretrained(str(d))
    tree = flax.serialization.msgpack_restore((d / "params.msgpack").read_bytes())

    def unroll(node):
        if not isinstance(node, dict):
            return node
        node = {k: unroll(v) for k, v in node.items()}
        if isinstance(node.get("blocks"), dict):
            stacked = node.pop("blocks")
            for i in range(jax.tree.leaves(stacked)[0].shape[0]):
                node[f"blocks_{i}"] = jax.tree.map(lambda x: x[i], stacked)
        return node

    unrolled = unroll(tree)
    assert "blocks_1" in unrolled["encoder"] and "blocks" not in unrolled["encoder"]
    (d / "params.msgpack").write_bytes(flax.serialization.msgpack_serialize(unrolled))
    model = UniFlowMatchConfidence.from_pretrained(str(d), device="cpu")
    want = jax_params_to_state_dict(jax_flatten(jmodel.params))
    for k, v in model.net.state_dict().items():
        assert torch.equal(v, want[k]), k


# ---- torch-layout names -------------------------------------------------------------


def _reference_names(sd):
    """The JAX package's canonical torch names -> the reference's layout
    (the inverse of its ``canonicalize_reference_names``), with the cls
    position folded back into ``pos_embed``."""
    sd = dict(sd)
    sd["encoder.pos_embed"] = np.concatenate([sd.pop("encoder.cls_pos_embed"), sd["encoder.pos_embed"]], axis=1)
    out = {}
    for k, v in sd.items():
        k = re.sub(r"\.blocks_(\d+)\.", r".blocks.\1.", k)
        k = re.sub(r"^encoder\.", "encoder.model.", k)
        k = k.replace("encoder.model.patch_embed.", "encoder.model.patch_embed.proj.")
        for head in ("head1", "uncertainty_head"):
            k = k.replace(f"{head}.feature.", f"{head}.0.0.").replace(f"{head}.processor.", f"{head}.0.1.")
        k = re.sub(r"\.down_(\d+)\.", r".downs.\1.", k)
        k = re.sub(r"\.up_conv_(\d+)\.", lambda m: f".ups.{2 * int(m.group(1)) + 1}.", k)
        k = re.sub(r"\.up_(\d+)\.", lambda m: f".ups.{2 * int(m.group(1))}.", k)
        k = k.replace(".conv1.", ".conv.0.").replace(".conv2.", ".conv.2.").replace(".final.", ".final_conv.")
        out[k] = v
    return out


@pytest.fixture(scope="module")
def refine_unet_pair():
    """A JAX tiny UFM-Refine with the UNet, and its parameters as a torch
    state dict in the reference's names."""
    jmodel = JRefine.from_config(jax_tiny_config(has_classification_head=True, **UNET), seed=8)
    ref_sd = _reference_names(params_to_torch_state_dict(jmodel.params))
    assert any(".ups.1.conv.0." in k for k in ref_sd) and "encoder.model.patch_embed.proj.weight" in ref_sd
    return jmodel, ref_sd


def test_reference_names_load_like_the_jax_package(tmp_path, refine_unet_pair):
    """A ``pytorch_model.bin`` in the reference's names loads into the port
    and gives the parameters the JAX package reads from the same dict."""
    jmodel, ref_sd = refine_unet_pair
    jax_read = jax_flatten(torch_state_dict_to_params(ref_sd))
    for k, v in jax_flatten(jmodel.params).items():
        np.testing.assert_array_equal(jax_read[k], v, err_msg=k)
    d = tmp_path / "hf"
    d.mkdir()
    cfg = json.loads(json.dumps({"model_class": "UniFlowMatchClassificationRefinement", **jmodel.config.to_dict()}))
    cfg["inference_resolution"] = [list(r) for r in jmodel.inference_resolution]
    (d / "config.json").write_text(json.dumps(cfg))
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in ref_sd.items()}, str(d / "pytorch_model.bin"))
    model = UniFlowMatchClassificationRefinement.from_pretrained(str(d), device="cpu")
    want = jax_params_to_state_dict(jax_flatten(jmodel.params))
    for k, v in model.net.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_strict_loading_names_what_is_wrong(refine_unet_pair):
    _, ref_sd = refine_unet_pair
    model = UniFlowMatchClassificationRefinement.from_config(
        ufm_tiny_config(has_classification_head=True, **UNET), device="cpu"
    )
    missing = {k: v for k, v in ref_sd.items() if not k.startswith("unet_feature.final_conv.")}
    with pytest.raises(KeyError, match="unet_feature.final.weight"):
        load_state_dict_into(model, missing)
    with pytest.raises(KeyError, match="extra.weight"):
        load_state_dict_into(model, {**ref_sd, "extra.weight": np.zeros(2, np.float32)})
    wrong = dict(ref_sd, **{"unet_feature.ups.0.weight": np.zeros((2, 2, 2, 2), np.float32)})
    with pytest.raises(ValueError, match="unet_feature.up_0.weight"):
        load_state_dict_into(model, wrong)
    before = model.net.unet_feature.final.weight.detach().clone()
    load_state_dict_into(model, missing, strict=False)  # what is absent keeps its values
    assert torch.equal(model.net.unet_feature.final.weight, before)


def test_lightning_checkpoint_through_the_constructor(tmp_path, refine_unet_pair):
    """``pretrained_backbone_checkpoint_path``: a Lightning checkpoint
    (``model.``-prefixed ``state_dict``, plus the reference's documented
    drops and keys of other modules) loads strictly."""
    jmodel, ref_sd = refine_unet_pair
    state = {f"model.{k}": torch.from_numpy(np.array(v)) for k, v in ref_sd.items()}
    state["model.encoder.model.mask_token"] = torch.zeros(1, 64)
    state["model.feature_matching_proj.weight"] = torch.zeros(3, 3)
    state["loss_fn.scale"] = torch.ones(1)
    path = str(tmp_path / "lightning.ckpt")
    torch.save({"state_dict": state, "epoch": 3}, path)
    cfg = ufm_tiny_config(has_classification_head=True, **UNET).to_dict()
    for k in ("has_uncertainty_head", "has_classification_head"):
        cfg.pop(k)
    model = UniFlowMatchClassificationRefinement(**cfg, pretrained_backbone_checkpoint_path=path, device="cpu")
    want = jax_params_to_state_dict(jax_flatten(jmodel.params))
    for k, v in model.net.state_dict().items():
        assert torch.equal(v, want[k]), k
    state["model.unexpected.bias"] = torch.zeros(1)
    torch.save({"state_dict": state}, path)
    with pytest.raises(KeyError, match="unexpected.bias"):
        load_torch_checkpoint_into(model, path)


def test_model_args_checkpoint(tmp_path):
    """``from_pretrained_ckpt``: ``model_args`` + ``model``; without
    ``strict`` a partial state dict loads over the seeded init, as in JAX."""
    jmodel = JBase.from_config(jax_tiny_config(), seed=9)
    sd = {k: torch.from_numpy(np.array(v)) for k, v in params_to_torch_state_dict(jmodel.params).items()}
    path = str(tmp_path / "ckpt.pt")
    torch.save({"model_args": jmodel.config.to_dict(), "model": sd}, path)
    model = UniFlowMatchConfidence.from_pretrained_ckpt(path, device="cpu")
    want = jax_params_to_state_dict(jax_flatten(jmodel.params))
    for k, v in model.net.state_dict().items():
        assert torch.equal(v, want[k]), k

    partial = {k: v for k, v in sd.items() if not k.startswith("uncertainty_head.")}
    torch.save({"model_args": jmodel.config.to_dict(), "model": partial}, path)
    with pytest.raises(KeyError, match="uncertainty_head"):
        UniFlowMatchConfidence.from_pretrained_ckpt(path, device="cpu")
    loose = UniFlowMatchConfidence.from_pretrained_ckpt(path, strict=False, device="cpu")
    seeded = UniFlowMatchConfidence.from_config(ufm_tiny_config(), seed=0, device="cpu")
    for k, v in loose.net.state_dict().items():
        assert torch.equal(v, (seeded.net.state_dict() if k.startswith("uncertainty_head.") else want)[k]), k
    with pytest.raises(ValueError, match="not found"):
        UniFlowMatchConfidence.from_pretrained_ckpt(str(tmp_path / "missing.pt"), device="cpu")


def test_from_pretrained_refuses_a_missing_directory(tmp_path):
    with pytest.raises(FileNotFoundError, match="local"):
        UniFlowMatchConfidence.from_pretrained(str(tmp_path / "nowhere"), device="cpu")
    (tmp_path / "empty").mkdir()
    (tmp_path / "empty" / "config.json").write_text(json.dumps(ufm_tiny_config().to_dict()))
    with pytest.raises(FileNotFoundError, match="no weights"):
        UniFlowMatchConfidence.from_pretrained(str(tmp_path / "empty"), device="cpu")


# ---- parameter groups -------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["base", "refine", "refine_unet"])
def test_parameter_groups_match_jax(variant):
    overrides = {"base": {}, "refine": {"has_classification_head": True}, "refine_unet": VARIANTS["refine_unet"][2]}[variant]
    jcls, cls = (JBase, UniFlowMatchConfidence) if variant == "base" else (JRefine, UniFlowMatchClassificationRefinement)
    jgroups = jcls.from_config(jax_tiny_config(**overrides)).get_parameter_groups()
    groups = cls.from_config(ufm_tiny_config(**overrides), device="cpu").get_parameter_groups()
    assert list(groups) == list(jgroups)
    names = [n for g in groups.values() for n in g]
    model_names = [n for n, _ in cls.from_config(ufm_tiny_config(**overrides), device="cpu").net.named_parameters()]
    assert sorted(names) == sorted(model_names)  # every parameter in exactly one group
    for key, jtree in jgroups.items():
        # a group is one module's subtree ("output_head" is head1's), or a
        # dict of several top-level entries by name (it then holds its own key)
        if key in jtree:
            flat = jax_flatten(jtree)
        else:
            root = {"output_head": "head1"}.get(key, key)
            flat = {f"{root}/{k}": v for k, v in jax_flatten(jtree).items()}
        assert set(groups[key]) == set(jax_params_to_state_dict(flat)), key
