"""ufm_torch deployment artifacts (``ufm_torch/runtime/export.py``) on the
CPU, held to the JAX package's artifacts (``ufm_tpu/runtime/export.py``).

Each variant (UFM-Base, UFM-Refine; tiny configs, fp32) is built in JAX,
exported by the JAX package, and carried into the port (``load_jax_params``),
which exports it with ``torch.export``. On the same seeded inputs:

- the port's loaded program reproduces the live port network bitwise and the
  JAX artifact at 1e-4, and its graph holds the kernels' ops (one attention
  op a transformer layer, both views sharing one encoder call: encoder depth
  + info-sharing depth; plus one window op for UFM-Refine);
- the fixed shape is enforced, naming the expected shape;
- swapping the stored parameters serves other weights (the JAX model of
  another seed) through the same program;
- half-precision storage (bf16, fp16) halves the stored parameters and stays
  within the JAX test's 5e-2 relative drift of the JAX fp32 artifact; any
  other ``params_dtype`` raises;
- ``ArtifactUFM`` gives the live model's full predict answer bitwise and the
  JAX ``ArtifactUFM``'s at 1e-4, and refuses another batch;
- two exports in one process, then the live model, then an export at a new
  shape (the device-constant caches never keep a tensor of a trace).
"""

import zipfile

import jax
import numpy as np
import pytest
import torch

from ufm_tpu.checkpoint.convert import flatten_params
from ufm_tpu.models import UniFlowMatchClassificationRefinement as JRefine
from ufm_tpu.models import UniFlowMatchConfidence as JBase
from ufm_tpu.models import ufm_tiny_config as jax_tiny_config
from ufm_tpu.runtime import export_model as jax_export_model
from ufm_tpu.runtime import load_artifact_model as jax_load_artifact_model
from ufm_tpu.runtime import load_exported as jax_load_exported
from ufm_torch.checkpoint import load_jax_params
from ufm_torch.checkpoint.io import encode_safetensors
from ufm_torch.models import (
    UniFlowMatchClassificationRefinement,
    UniFlowMatchConfidence,
    ufm_tiny_config,
)
from ufm_torch.ops import library
from ufm_torch.runtime import ARTIFACT_SUFFIX, export_model, load_artifact_model, load_exported

ATOL = 1e-4
HALF_DRIFT = 5e-2  # tests/test_export.py's bound for half-precision storage
VARIANTS = {
    "base": (JBase, UniFlowMatchConfidence, {}),
    "refine": (JRefine, UniFlowMatchClassificationRefinement, {"has_classification_head": True}),
}


def _images(model, batch, seed):
    w, h = model.inference_resolution[0]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((batch, h, w, 3)).astype(np.float32) for _ in range(2)]


def _carried(variant, seed=0):
    jcls, cls, overrides = VARIANTS[variant]
    jmodel = jcls.from_config(jax_tiny_config(**overrides), seed=seed)
    model = cls.from_config(ufm_tiny_config(**overrides), device="cpu")
    load_jax_params(model, flatten_params(jmodel.params))
    return jmodel, model


@pytest.fixture(scope="module", params=list(VARIANTS))
def exported(request, tmp_path_factory):
    """(variant, JAX model, JAX artifact path, port model, port artifact
    path, port manifest) at batch 1."""
    tmp = tmp_path_factory.mktemp(request.param)
    jmodel, model = _carried(request.param)
    jpath, path = str(tmp / "jax.ufmx"), str(tmp / f"port{ARTIFACT_SUFFIX}")
    jax_export_model(jmodel, jpath, batch=1)
    manifest = export_model(model, path, batch=1)
    return request.param, jmodel, jpath, model, path, manifest


def test_export_roundtrip(exported):
    variant, jmodel, jpath, model, path, manifest = exported
    assert manifest["model_class"] == type(model).__name__ and manifest["staged"] is False
    assert manifest["n_params"] == len(list(model.net.parameters()))
    assert manifest["program_bytes"] < manifest["param_bytes"] / 4 + 2**20  # no weights in the program
    art = load_exported(path, device="cpu")
    i1, i2 = _images(model, 1, seed=1)
    got = art(torch.from_numpy(i1), torch.from_numpy(i2))
    with torch.no_grad():
        live = model.net(torch.from_numpy(i1), torch.from_numpy(i2))
    want = jax_load_exported(jpath)(i1, i2)
    assert set(got) == set(live) == set(want)
    for k in want:
        assert torch.equal(got[k], live[k]), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=ATOL, rtol=0, err_msg=f"{variant}:{k}")


def test_exported_graph_holds_the_ops(exported):
    variant, _, _, model, path, manifest = exported
    cfg = model.config
    program = load_exported(path, device="cpu").program
    targets = [n.target for n in program.graph.nodes if n.op == "call_function"]
    layers = cfg.encoder_kwargs["depth"] + cfg.info_sharing_kwargs["depth"]
    assert targets.count(library.flash_attention_fwd) == layers
    assert targets.count(library.window_refinement) == (variant == "refine")
    assert library.flash_attention_bwd not in targets
    # the MLPs' fc1 + GELU is one op node on bf16 only (no gradient is recorded
    # in the trace, so never the standalone GELU op)
    bf16 = cfg.compute_dtype == "bfloat16"
    assert targets.count(library.linear_gelu_bf16) == (layers if bf16 else 0)
    assert targets.count(library.gelu_bf16) == 0
    assert len(manifest["ops"]) == 1 + (variant == "refine") + bf16


def test_export_shape_enforcement(exported):
    _, _, _, model, path, _ = exported
    art = load_exported(path, device="cpu")
    w, h = model.inference_resolution[0]
    i1, i2 = (torch.from_numpy(x) for x in _images(model, 2, seed=2))  # wrong batch
    with pytest.raises(ValueError, match=rf"fixed-shape: expected images \(1, {h}, {w}, 3\)"):
        art(i1, i2)


def test_export_swappable_params(exported, tmp_path):
    """Parameters are call arguments: another model's parameters in the
    artifact's params.safetensors serve through the same program."""
    variant, _, _, _, path, _ = exported
    jmodel2, model2 = _carried(variant, seed=1)
    swapped = str(tmp_path / f"swapped{ARTIFACT_SUFFIX}")
    with zipfile.ZipFile(path) as zin, zipfile.ZipFile(swapped, "w") as zout:
        for name in zin.namelist():
            data = zin.read(name)
            if name == "params.safetensors":
                data = encode_safetensors({k: p.detach() for k, p in model2.net.named_parameters()})
            zout.writestr(name, data)
    i1, i2 = _images(model2, 1, seed=3)
    got = load_exported(swapped, device="cpu")(torch.from_numpy(i1), torch.from_numpy(i2))
    with torch.no_grad():
        live = model2.net(torch.from_numpy(i1), torch.from_numpy(i2))
    assert all(torch.equal(got[k], live[k]) for k in live)
    want = jax.jit(jmodel2.net.apply)({"params": jmodel2.params}, i1, i2)
    np.testing.assert_allclose(got["flow"].numpy(), np.asarray(want["flow"]), atol=ATOL, rtol=0)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_export_half_precision_params(exported, tmp_path, dtype):
    _, _, jpath, model, path, fp32_manifest = exported
    half = str(tmp_path / f"half{ARTIFACT_SUFFIX}")
    manifest = export_model(model, half, batch=1, params_dtype=dtype)
    assert manifest["params_dtype"] == dtype
    assert manifest["stored_param_bytes"] < 0.55 * manifest["param_bytes"]

    def params_entry(p):
        with zipfile.ZipFile(p) as z:
            return z.getinfo("params.safetensors").file_size

    assert params_entry(half) < 0.55 * params_entry(path)
    art = load_exported(half, device="cpu")
    assert [str(t.dtype).replace("torch.", "") for t in art.params.values()] == fp32_manifest["param_dtypes"]
    i1, i2 = _images(model, 1, seed=4)
    got = art(torch.from_numpy(i1), torch.from_numpy(i2))
    want = jax_load_exported(jpath)(i1, i2)
    for k in want:
        w_ = np.asarray(want[k])
        drift = np.abs(got[k].numpy() - w_).max() / (np.abs(w_).max() + 1e-6)
        assert drift < HALF_DRIFT, f"{k}: relative drift {drift:.4f} from {dtype} parameters"


def test_export_params_dtype_validation(tmp_path):
    model = UniFlowMatchConfidence.from_config(ufm_tiny_config(), device="cpu")
    with pytest.raises(ValueError, match="params_dtype"):
        export_model(model, str(tmp_path / f"x{ARTIFACT_SUFFIX}"), params_dtype="int8")


def test_artifact_model_full_predict(exported):
    """The artifact in the predict API (resize, program, unmap) at a
    non-native input size: the live port model's answer bitwise, the JAX
    ArtifactUFM's at 1e-4; another batch is refused."""
    _, _, jpath, model, path, _ = exported
    art = load_artifact_model(path, device="cpu")
    assert art.data_norm_type == model.data_norm_type and art.device == torch.device("cpu")
    rng = np.random.default_rng(5)
    src, tgt = (rng.integers(0, 255, (96, 128, 3), dtype=np.uint8) for _ in range(2))
    got = art.predict_correspondences_batched(src, tgt)
    live = model.predict_correspondences_batched(src, tgt)
    want = jax_load_artifact_model(jpath).predict_correspondences_batched(src, tgt)
    assert torch.equal(got.flow.flow_output, live.flow.flow_output)
    assert torch.equal(got.covisibility.mask, live.covisibility.mask)
    np.testing.assert_allclose(got.flow.flow_output.numpy(), np.asarray(want.flow.flow_output), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.covisibility.mask.numpy(), np.asarray(want.covisibility.mask), atol=ATOL, rtol=0)
    with pytest.raises(ValueError, match="fixed batch 1"):
        art.predict_correspondences_batched(np.stack([src, src]), np.stack([tgt, tgt]))


def test_exports_in_one_process_then_the_live_model(tmp_path):
    """Two exports, the live model against its own earlier output, then an
    export at a new shape: no trace leaves a tensor in a cache."""
    a = UniFlowMatchConfidence.from_config(ufm_tiny_config(), seed=0, device="cpu")
    b = UniFlowMatchConfidence.from_config(ufm_tiny_config(), seed=1, device="cpu")
    i1, i2 = (torch.from_numpy(x) for x in _images(a, 1, seed=6))
    with torch.no_grad():
        before = a.net(i1, i2)
    export_model(a, str(tmp_path / f"a{ARTIFACT_SUFFIX}"))
    export_model(b, str(tmp_path / f"b{ARTIFACT_SUFFIX}"))
    with torch.no_grad():
        after = a.net(i1, i2)
    assert all(torch.equal(before[k], after[k]) for k in before)
    c = UniFlowMatchConfidence.from_config(ufm_tiny_config(inference_resolution=[(42, 56)]), device="cpu")
    export_model(c, str(tmp_path / f"c{ARTIFACT_SUFFIX}"), batch=2)
    art = load_exported(str(tmp_path / f"c{ARTIFACT_SUFFIX}"), device="cpu")
    j1, j2 = (torch.from_numpy(x) for x in _images(c, 2, seed=7))
    with torch.no_grad():
        want = c.net(j1, j2)
    got = art(j1, j2)
    assert all(torch.equal(got[k], want[k]) for k in want)
