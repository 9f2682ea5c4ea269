"""The port's public names against the JAX package's.

- The lazy model exports of ``ufm_tpu/__init__.py``: ``ufm_torch.UniFlowMatch``,
  ``UniFlowMatchConfidence`` and ``UniFlowMatchClassificationRefinement`` load
  on first use, and ``import ufm_torch`` alone imports neither torch nor the
  models.
- ``ufm_torch.models.predict_correspondences_tiled``, ``register_encoder``
  (which the encoder factory consults first), ``resize_nearest_chw`` (bitwise
  the JAX one on odd sizes) and ``MLPFeature.decoded_channels``.
- An AST walk of both packages: every public top-level name of ``ufm_tpu``
  module X exists at the top level of ``ufm_torch`` module X, or is in
  :data:`RENAMED` (its counterpart's name) or in :data:`KEPT_OUT` (with the
  reason). Both tables are checked for stale entries.
"""

import ast
import inspect
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ufm_torch
import ufm_tpu
from ufm_torch.models import tiled as torch_tiled
from ufm_torch.nn import encoders as torch_encoders
from ufm_torch.nn.prediction_heads.mlp_feature import MLPFeature
from ufm_torch.ops import resize_nearest_chw
from ufm_tpu.models import predict_correspondences_tiled as jax_tiled
from ufm_tpu.nn import encoders as jax_encoders
from ufm_tpu.nn.prediction_heads.mlp_feature import MLPFeature as JMLPFeature
from ufm_tpu.ops.resize import resize_nearest_chw as jax_resize_nearest_chw

ROOT = Path(__file__).resolve().parents[1]
LAZY_MODELS = ("UniFlowMatch", "UniFlowMatchConfidence", "UniFlowMatchClassificationRefinement")

# (module, JAX name) -> the port's name for the same thing in the same module
RENAMED = {
    ("ops/gelu.py", "fast_exact_gelu"): "fast_exact_gelu_reference",
    ("cli.py", "launch_demo"): "run_demo",
    ("utils/geometry.py", "get_meshgrid_jnp"): "get_meshgrid_torch",
    ("checkpoint/convert.py", "params_to_torch_state_dict"): "jax_params_to_state_dict",
    ("checkpoint/convert.py", "torch_state_dict_to_params"): "torch_state_dict_to_port",
}

# a module (every name in it) or (module, name) -> why the port has no counterpart
KEPT_OUT = {
    "ops/spmd.py": "TPU-only partitioning rules for the Pallas kernels; a torch kernel on local shards needs none",
    "ops/tpu_caps.py": "the TPU's VMEM capacity and chip kind",
    "ops/window_dots.py": "the Pallas window-dot entry; the port's kernel computes the whole window refinement "
                          "(ufm_torch/ops/window_refinement.py)",
    "utils/anchor.py": "makes goldens with JAX's PRNG, which torch cannot reproduce; the committed goldens are "
                       "the anchor (tests/golden/torch_port_fp32_anchor.npz carries its parameters to the card)",
    "checkpoint/orbax_io.py": "Orbax train states are not planned; checkpoint/train_state.py is the port's format",
    ("cli.py", "HUB_REPOS"): "the port loads local directories only: nothing is downloaded",
    ("checkpoint/convert.py", "unflatten_params"): "the port keeps parameters in modules and flat dicts, never a "
                                                   "nested JAX tree",
    ("nn/layers.py", "scan_transformer_blocks"): "jax.lax.scan over stacked block parameters; the port runs its "
                                                 "blocks as a loop of modules",
    ("ops/flash_attention.py", "fits_vmem_single_pass"): "the TPU kernel's VMEM guard",
    ("runtime/batcher.py", "build_native_library"): "builds native/; the port builds csrc/host through "
                                                    "ops/_build.load_host_library",
    ("utils/profiling.py", "timed"): "a block's host-clock time, read by nothing; the port's spans "
                                     "(profiling.span, read by profiling.spans) time its stages on the host "
                                     "and, by CUDA events, on the card",
}


def _top_level(path: Path, with_imports: bool) -> set:
    """Public names bound at a module's top level: defs, classes and
    assignments (and, with ``with_imports``, imported names)."""
    names = set()
    for node in ast.parse(path.read_text(), filename=str(path)).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(e.id for t in node.targets for e in ast.walk(t) if isinstance(e, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif with_imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0] for a in node.names)
    return {n for n in names if not n.startswith("_")}


def _jax_modules():
    out = {}
    for path in sorted((ROOT / "ufm_tpu").rglob("*.py")):
        names = _top_level(path, with_imports=False)
        if names:
            out[path.relative_to(ROOT / "ufm_tpu").as_posix()] = names
    return out


JAX_MODULES = _jax_modules()


@pytest.mark.parametrize("module", sorted(JAX_MODULES))
def test_every_public_name_has_a_counterpart(module):
    if module in KEPT_OUT:
        return
    port = ROOT / "ufm_torch" / module
    assert port.exists(), f"ufm_torch/{module} is missing and not in KEPT_OUT"
    have = _top_level(port, with_imports=True)
    missing = []
    for name in sorted(JAX_MODULES[module]):
        if (module, name) in KEPT_OUT:
            continue
        if name not in have and RENAMED.get((module, name)) not in have:
            missing.append(name)
    assert not missing, f"ufm_torch/{module} lacks {missing}"


def test_the_exception_tables_name_what_exists():
    for key in KEPT_OUT:
        module, name = key if isinstance(key, tuple) else (key, None)
        assert module in JAX_MODULES, key
        assert name is None or name in JAX_MODULES[module], key
        assert KEPT_OUT[key], key
    for (module, name), port_name in RENAMED.items():
        assert name in JAX_MODULES[module], (module, name)
        assert port_name in _top_level(ROOT / "ufm_torch" / module, with_imports=False), (module, port_name)


# ---- the names held to the JAX package's ------------------------------------


@pytest.mark.parametrize("name", LAZY_MODELS)
def test_lazy_model_exports(name):
    from ufm_torch import models

    assert getattr(ufm_torch, name) is getattr(models, name)
    assert getattr(ufm_tpu, name).__name__ == getattr(ufm_torch, name).__name__ == name


def test_import_ufm_torch_stays_light():
    code = (
        "import sys\n"
        "import ufm_torch\n"
        "print('torch' in sys.modules, 'ufm_torch.models' in sys.modules)\n"
        "ufm_torch.UniFlowMatchConfidence\n"
        "print('ufm_torch.models' in sys.modules)\n"
        "try:\n"
        "    ufm_torch.NoSuchName\n"
        "except AttributeError:\n"
        "    print('AttributeError')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "False", "True", "AttributeError"]


def test_predict_correspondences_tiled_is_exported():
    from ufm_torch.models import predict_correspondences_tiled

    assert predict_correspondences_tiled is torch_tiled.predict_correspondences_tiled
    assert list(inspect.signature(predict_correspondences_tiled).parameters) == list(
        inspect.signature(jax_tiled).parameters
    )


@pytest.mark.parametrize("pkg", [torch_encoders, jax_encoders], ids=["port", "jax"])
def test_register_encoder_is_consulted_first(pkg, monkeypatch):
    monkeypatch.setattr(pkg, "_FACTORIES", {})
    calls = []

    def factory(**kwargs):
        calls.append(kwargs)
        return "built"

    pkg.register_encoder("my_encoder", factory)
    pkg.register_encoder("dinov2_large", factory)  # a registered name wins over a preset
    assert pkg.feature_returner_encoder_factory("my_encoder", depth=3, whatever=1) == "built"
    assert pkg.feature_returner_encoder_factory("dinov2_large") == "built"
    assert calls == [{"depth": 3, "whatever": 1}, {}]


def test_unregistered_names_still_take_the_presets():
    enc = torch_encoders.feature_returner_encoder_factory("dinov2_small", depth=1)
    assert isinstance(enc, torch_encoders.ViTEncoder)


@pytest.mark.parametrize("shape, out", [((2, 3, 7, 9), (5, 13)), ((1, 5, 11), (11, 4)), ((3, 1, 1), (3, 5)),
                                        ((2, 4, 13, 17), (13, 17))])
def test_resize_nearest_chw_matches_jax(shape, out):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = np.asarray(jax_resize_nearest_chw(jnp.asarray(x), out))
    got = resize_nearest_chw(torch.from_numpy(x), out).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("output_dim", [16, 8, 3])
def test_mlp_feature_decoded_channels(output_dim):
    assert MLPFeature(input_feature_dim=24, hidden_dims=(8,), output_dim=output_dim).decoded_channels == output_dim
    assert JMLPFeature(input_feature_dim=24, hidden_dims=(8,), output_dim=output_dim).decoded_channels == output_dim
