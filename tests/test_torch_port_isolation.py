"""The port stands alone: ``ufm_torch`` and the port's scripts
(``chip_smoke.py``, ``profile_torch_port.py``, ``profile_attention_trees.py``,
``profile_window_trees.py``, ``profile_sharded_train.py``, and
``tests/torch_port_ranks.py``, which the multi-process tests start as ranks)
never import JAX, flax or the JAX package, and the port's entry points
refuse to move to the CPU quietly."""

import ast
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "ufm_tpu"}


def _port_files():
    scripts = ("chip_smoke.py", "profile_torch_port.py", "profile_attention_trees.py", "profile_window_trees.py",
               "profile_sharded_train.py")
    return sorted((ROOT / "ufm_torch").rglob("*.py")) + [ROOT / name for name in scripts] + [ROOT / "tests" / "torch_port_ranks.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__" and node.args:
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                yield arg.value.split(".")[0]


def test_no_jax_imports_in_the_port():
    files = _port_files()
    assert len(files) > 20
    bad = {str(p.relative_to(ROOT)): sorted(set(_imported_roots(p)) & FORBIDDEN) for p in files}
    assert not {k: v for k, v in bad.items() if v}


def test_port_imports_with_jax_blocked():
    """Every module of the package imports in a process where jax, flax and
    ufm_tpu cannot be imported."""
    code = (
        "import sys, pkgutil, importlib\n"
        f"for name in {sorted(FORBIDDEN)!r}: sys.modules[name] = None\n"
        "import ufm_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(ufm_torch.__path__, 'ufm_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "print(' '.join(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    mods = set(out.stdout.split())
    assert len(mods) > 15
    assert {
        "ufm_torch.ops.grid_sample",
        "ufm_torch.ops.refinement",
        "ufm_torch.ops.window_refinement",
        "ufm_torch.nn.unet",
        "ufm_torch.nn.prediction_heads.mlp_feature",
        "ufm_torch.training",
        "ufm_torch.training.losses",
        "ufm_torch.training.trainer",
        "ufm_torch.training.loop",
        "ufm_torch.checkpoint.train_state",
        "ufm_torch.checkpoint.io",
        "ufm_torch.eval",
        "ufm_torch.data",
        "ufm_torch.data.pairs",
        "ufm_torch.models.tiled",
        "ufm_torch.models.utils",
        "ufm_torch.utils.flow_io",
        "ufm_torch.utils.example_pairs",
        "ufm_torch.utils.geometry",
        "ufm_torch.utils.profiling",
        "ufm_torch.ops.launches",
        "ufm_torch.runtime",
        "ufm_torch.runtime.batcher",
        "ufm_torch.runtime.server",
        "ufm_torch.runtime.streaming",
        "ufm_torch.runtime.export",
        "ufm_torch.runtime.loader",
        "ufm_torch.ops.library",
        "ufm_torch.ops.cache",
        "ufm_torch.demo",
        "ufm_torch.parallel",
        "ufm_torch.parallel.sharding",
        "ufm_torch.parallel.inference",
        "ufm_torch.nn.prediction_heads.moge_conv",
    } <= mods


def test_importing_ops_and_runtime_starts_no_compiler():
    """Importing ``ufm_torch.ops`` (which registers the kernels' dispatcher
    ops) and ``ufm_torch.runtime`` (and its lazily imported export and loader
    names) starts no process and loads no library: a kernel or host library
    is built at its first use."""
    code = (
        "import subprocess, sys\n"
        "def refuse(*a, **k): raise AssertionError(f'process started: {a}')\n"
        "subprocess.Popen = subprocess.run = refuse\n"
        "import torch, ufm_torch.ops, ufm_torch.runtime\n"
        "from ufm_torch.runtime import export_model, load_artifact_model, NativeImageLoader, iter_decoded_pairs\n"
        "from ufm_torch.ops import _build\n"
        "assert not _build._loaded, _build._loaded\n"
        "assert hasattr(torch.ops.ufm_torch, 'flash_attention_fwd')\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "ok"


def test_port_loads_nothing_from_native():
    """The port builds its own copy of the scheduler (csrc/host) and never
    names the JAX package's native/ directory or its libraries."""
    for path in _port_files():
        text = path.read_text()
        assert "libufm_runtime" not in text and "libufm_loader" not in text, path
        assert not re.search(r"""["'/]native["'/]""", text), path


# not installed on the GPU machine: the port needs none of them for flax
# msgpack checkpoints, PNG or JPEG files (its own codecs), and imports cv2
# only for other image formats
CARD_LACKS = ("msgpack", "safetensors", "cv2", "PIL")


def test_port_imports_without_the_packages_the_card_lacks():
    """Every module imports, and a checkpoint saves and loads
    (``model.safetensors`` by the port's own reader and writer), in a process
    where neither JAX nor msgpack, safetensors, cv2 or PIL can be imported."""
    code = (
        "import sys, pkgutil, importlib, tempfile\n"
        f"for name in {sorted(FORBIDDEN) + list(CARD_LACKS)!r}: sys.modules[name] = None\n"
        "import ufm_torch\n"
        "for m in pkgutil.walk_packages(ufm_torch.__path__, 'ufm_torch.'): importlib.import_module(m.name)\n"
        "import torch\n"
        "from ufm_torch.models import UniFlowMatchConfidence, ufm_tiny_config\n"
        "m = UniFlowMatchConfidence.from_config(ufm_tiny_config(), device='cpu')\n"
        "d = tempfile.mkdtemp()\n"
        "m.save_pretrained(d)\n"
        "n = UniFlowMatchConfidence.from_pretrained(d, device='cpu')\n"
        "assert all(torch.equal(a, b) for a, b in zip(m.net.state_dict().values(), n.net.state_dict().values()))\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "ok"


def test_cli_infer_without_the_packages_the_card_lacks(tmp_path):
    """``python -m ufm_torch.cli infer`` on the bundled parallax pair with the
    trained checkpoint (``params.msgpack``), in a process where JAX,
    msgpack, safetensors, cv2 and PIL cannot be imported: the pairs are
    written and read, the checkpoint decoded and the panels written by the
    port's own codecs. It exits 0 and writes three 540x720 RGB panels."""
    pairs, out_dir = tmp_path / "pairs", tmp_path / "out"
    code = (
        "import sys\n"
        f"for name in {sorted(FORBIDDEN) + list(CARD_LACKS)!r}: sys.modules[name] = None\n"
        "from ufm_torch.utils.example_pairs import ensure_bundled_pairs\n"
        f"ensure_bundled_pairs({str(pairs)!r})\n"
        "from ufm_torch.cli import main\n"
        f"main(['infer', {str(pairs / 'parallax_0.png')!r}, {str(pairs / 'parallax_1.png')!r}, "
        f"'--checkpoint', {str(ROOT / 'examples' / 'checkpoints' / 'tiny_real224')!r}, '--device', 'cpu', "
        f"'-o', {str(out_dir)!r}])\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    from ufm_torch.cli import OUTPUT_FILES
    from ufm_torch.utils.image_io import read_png

    for name in OUTPUT_FILES:
        panel = read_png(str(out_dir / name))
        assert panel.shape == (540, 720, 3) and panel.dtype.name == "uint8", name


def test_jpeg_read_and_infer_without_the_packages_the_card_lacks(tmp_path):
    """A JPEG through ``read_rgb`` (bitwise its committed cv2 decode) and
    ``ufm infer`` on a JPEG pair (the committed 4:2:0 baseline and 4:2:2
    progressive cases, 117x157) in a process where JAX, msgpack,
    safetensors, cv2 and PIL cannot be imported: the port's own decoder
    reads them, and infer writes three 117x157 panels."""
    cases, out_dir = ROOT / "tests" / "golden" / "jpeg_cases", tmp_path / "out"
    src, tgt = cases / "s420_base_rst_opt.jpg", cases / "s422_prog_rst.jpg"
    code = (
        "import sys\n"
        f"for name in {sorted(FORBIDDEN) + list(CARD_LACKS)!r}: sys.modules[name] = None\n"
        "import numpy as np\n"
        "from ufm_torch.utils.image_io import read_rgb\n"
        f"with np.load({str(cases / 'decodes.npz')!r}) as z: want = z['cv2/s420_base_rst_opt.jpg']\n"
        f"assert np.array_equal(read_rgb({str(src)!r}), want)\n"
        "from ufm_torch.cli import main\n"
        f"main(['infer', {str(src)!r}, {str(tgt)!r}, "
        f"'--checkpoint', {str(ROOT / 'examples' / 'checkpoints' / 'tiny_real224')!r}, '--device', 'cpu', "
        f"'-o', {str(out_dir)!r}])\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    from ufm_torch.cli import OUTPUT_FILES
    from ufm_torch.utils.image_io import read_png

    for name in OUTPUT_FILES:
        assert read_png(str(out_dir / name)).shape == (117, 157, 3), name


def test_host_sources_include_no_system_image_header():
    """The host libraries build from the repository alone: no source in
    ``csrc/host`` includes libjpeg's, libpng's or zlib's header."""
    sources = sorted((ROOT / "ufm_torch" / "csrc" / "host").glob("*.*"))
    assert {p.name for p in sources} >= {"ufm_loader.cc", "ufm_runtime.cc", "image_decode.h"}
    for path in sources:
        included = re.findall(r"^\s*#\s*include\s*[<\"]([^>\"]+)[>\"]", path.read_text(), re.M)
        assert not {"jpeglib.h", "png.h", "zlib.h"} & set(included), (path.name, included)


def test_from_config_without_device_needs_cuda(monkeypatch):
    from ufm_torch.models import UniFlowMatchConfidence, ufm_tiny_config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        UniFlowMatchConfidence.from_config(ufm_tiny_config())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        UniFlowMatchConfidence.from_config(ufm_tiny_config(), device="cuda")
    model = UniFlowMatchConfidence.from_config(ufm_tiny_config(), device="cpu")
    assert model.device.type == "cpu"


def test_from_pretrained_without_device_needs_cuda(monkeypatch):
    from ufm_torch.models import UniFlowMatchConfidence

    ckpt = str(ROOT / "examples" / "checkpoints" / "tiny_real224")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        UniFlowMatchConfidence.from_pretrained(ckpt)
    assert UniFlowMatchConfidence.from_pretrained(ckpt, device="cpu").device.type == "cpu"


def test_chip_smoke_fails_without_a_gpu_or_the_package(tmp_path):
    """``chip_smoke.py`` exits non-zero and prints no result where there is no
    CUDA device, and where it stands alone without the package."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the smoke check would run")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    env = dict(os.environ, PYTHONPATH="")
    for script, cwd in ((ROOT / "chip_smoke.py", ROOT), (alone, tmp_path)):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env, capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_package_data_ships_every_source():
    """``pip install`` ships each source the package builds at run time: the
    kernels (``csrc/*.cu``, ``*.cuh``) and the host libraries
    (``csrc/host/*.cc`` and their headers, ``csrc/host/*.h``)."""
    import tomllib

    from ufm_torch.ops import _build

    globs = tomllib.loads((ROOT / "pyproject.toml").read_text())["tool"]["setuptools"]["package-data"]["ufm_torch"]
    shipped = {p for g in globs for p in (ROOT / "ufm_torch").glob(g)}
    needed = {_build.CSRC_DIR / f"{n}.cu" for n in _build.KERNEL_SOURCES}
    needed |= set(_build.CSRC_DIR.glob("*.cuh")) | {_build.CSRC_DIR / "host" / f"{n}.cc" for n in _build.HOST_SOURCES}
    needed |= set((_build.CSRC_DIR / "host").glob("*.h"))
    assert _build.CSRC_DIR / "host" / "image_decode.h" in needed
    assert needed <= shipped, sorted(str(p) for p in needed - shipped)
