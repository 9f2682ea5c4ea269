"""``python -m ufm_torch.cli``: the environment check, infer's refusals for
both models, ``infer`` and ``eval`` on the trained tiny checkpoint
(``examples/checkpoints/tiny_real224``) on the CPU, the golden-image check
(``python -m ufm_torch.models.ufm``) on the tiny topology, ``export`` then
``infer --artifact`` (the same panels as the live checkpoint, byte for
byte), ``serve --artifact`` pinning its lanes to the artifact's batch, and
``demo`` (exits 1 naming ``gradio`` where it is missing; its panels on the
CPU).

A full ``infer --random-init`` builds the flagship model (ViT-L); that is the
GPU's job, so here only the paths that fail before the model are driven with
it.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from ufm_torch import cli

ROOT = Path(__file__).resolve().parents[1]
TINY_REAL = str(ROOT / "examples" / "checkpoints" / "tiny_real224")


def test_cli_test_subcommand():
    out = subprocess.run(
        [sys.executable, "-m", "ufm_torch.cli", "test"], cwd=ROOT, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "+ PyTorch" in out.stdout and "+ ufm_torch model imports" in out.stdout
    assert "completed successfully" in out.stdout


@pytest.mark.parametrize(
    "extra,message",
    [
        (["--checkpoint", "some/dir"], "could not read"),
        ([], "--random-init"),
        (["--random-init"], "could not read"),
        (["--model", "refine", "--random-init"], "could not read"),
    ],
)
def test_infer_refusals(tmp_path, capsys, extra, message):
    missing = str(tmp_path / "missing.png")
    with pytest.raises(SystemExit) as exc:
        cli.main(["infer", missing, missing, "--device", "cpu", *extra])
    assert exc.value.code == 1
    assert message in capsys.readouterr().out


def test_infer_unknown_model(tmp_path, capsys):
    missing = str(tmp_path / "missing.png")
    with pytest.raises(SystemExit) as exc:
        cli.main(["infer", missing, missing, "--model", "bogus", "--random-init"])
    assert exc.value.code == 2
    assert "invalid choice: 'bogus'" in capsys.readouterr().err


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    pytest.importorskip("cv2")
    from ufm_torch.utils.example_pairs import ensure_bundled_pairs

    return Path(ensure_bundled_pairs(str(tmp_path_factory.mktemp("pairs"))))


def test_infer_with_a_checkpoint(pairs, tmp_path, capsys):
    out = tmp_path / "out"
    src, tgt = str(pairs / "parallax_0.png"), str(pairs / "parallax_1.png")
    cli.main(["infer", src, tgt, "--checkpoint", TINY_REAL, "--device", "cpu", "-o", str(out)])
    assert "Running inference on cpu" in capsys.readouterr().out
    assert sorted(p.name for p in out.iterdir()) == sorted(cli.OUTPUT_FILES)


def test_infer_refuses_a_missing_checkpoint(pairs, tmp_path, capsys):
    src = str(pairs / "parallax_0.png")
    with pytest.raises(SystemExit) as exc:
        cli.main(["infer", src, src, "--checkpoint", str(tmp_path / "nowhere"), "--device", "cpu"])
    assert exc.value.code == 1
    out = capsys.readouterr().out
    assert "Error loading model" in out and "local" in out


@pytest.mark.parametrize("tiled", [False, True], ids=["plain", "tiled"])
def test_eval_with_a_checkpoint(pairs, tmp_path, capsys, tiled):
    metrics = tmp_path / "metrics.json"
    args = ["eval", str(pairs), "--checkpoint", TINY_REAL, "--device", "cpu", "-o", str(metrics)]
    cli.main(args + (["--tiled"] if tiled else []))
    assert "pairs: 3 (all flows finite: True)" in capsys.readouterr().out
    agg = json.loads(metrics.read_text())["aggregate"]
    assert agg["num_pairs"] == 3 and np.isfinite(agg["epe"])
    if not tiled:
        assert agg["epe"] < 2.0  # the trained checkpoint: 0.90 / 1.05 / 0.91 px on these pairs


def test_eval_refusals(tmp_path, capsys):
    for args, message in (
        ([str(tmp_path), "--random-init"], "no evaluable pairs"),
        ([str(tmp_path / "nowhere"), "--random-init"], "not a directory"),
        ([str(tmp_path)], "--random-init"),
    ):
        with pytest.raises(SystemExit) as exc:
            cli.main(["eval", *args, "--device", "cpu"])
        assert exc.value.code == 1
        assert message in capsys.readouterr().out


def test_golden_image_check_tiny(pairs, tmp_path, monkeypatch):
    from ufm_torch.models import ufm as ufm_module
    from ufm_torch.utils import example_pairs

    monkeypatch.setattr(example_pairs, "default_pair_dir", lambda: str(pairs))
    out = str(tmp_path / "panel.png")
    assert ufm_module._golden_image_main(["--tiny", "--device", "cpu", "--output", out]) == out
    stats = json.loads(Path(out + ".json").read_text())
    assert stats["pair"] == "wide_baseline" and np.isfinite(stats["epe_mean_px"])
    assert stats["panel_wh"] == [3 * 720, 2 * 540]


def test_export_then_infer_with_the_artifact(pairs, tmp_path, capsys):
    """``export`` of the trained tiny checkpoint, then ``infer --artifact``:
    the same three panels, byte for byte, as ``infer --checkpoint``."""
    artifact = str(tmp_path / "tiny.ufmt")
    cli.main(["export", artifact, "--checkpoint", TINY_REAL, "--device", "cpu"])
    assert "Exported UniFlowMatchConfidence (one program, batch 1, 224x168" in capsys.readouterr().out
    src, tgt = str(pairs / "parallax_0.png"), str(pairs / "parallax_1.png")
    cli.main(["infer", src, tgt, "--artifact", artifact, "--device", "cpu", "-o", str(tmp_path / "art")])
    cli.main(["infer", src, tgt, "--checkpoint", TINY_REAL, "--device", "cpu", "-o", str(tmp_path / "live")])
    for name in cli.OUTPUT_FILES:
        assert (tmp_path / "art" / name).read_bytes() == (tmp_path / "live" / name).read_bytes(), name


@pytest.mark.parametrize(
    "extra,message",
    [([], "--random-init"), (["--random-init", "--batch", "0"], "--batch must be at least 1")],
)
def test_export_refusals(tmp_path, capsys, extra, message):
    with pytest.raises(SystemExit) as exc:
        cli.main(["export", str(tmp_path / "x.ufmt"), "--device", "cpu", *extra])
    assert exc.value.code == 1
    assert message in capsys.readouterr().out


def test_serve_artifact_pins_the_batch(tmp_path, capsys, monkeypatch):
    """An artifact's program is fixed-shape: ``serve --artifact`` runs its
    lanes at the exported batch, whatever ``--max-batch`` says."""
    from ufm_torch.models import UniFlowMatchConfidence, ufm_tiny_config
    from ufm_torch.runtime import export_model, server

    artifact = str(tmp_path / "b2.ufmt")
    export_model(UniFlowMatchConfidence.from_config(ufm_tiny_config(), device="cpu"), artifact, batch=2)
    started = {}

    class FakeServer:
        def __init__(self, model, host, port, max_batch, max_delay_ms):
            started.update(model=model, max_batch=max_batch)
            self.port = port

        def start(self):
            pass

        def serve_forever(self):
            pass

        def close(self):
            pass

    monkeypatch.setattr(server, "UFMServer", FakeServer)
    cli.main(["serve", "--artifact", artifact, "--device", "cpu", "--max-batch", "4", "--port", "0"])
    out = capsys.readouterr().out
    assert "exported at fixed batch 2; using --max-batch 2 (requested 4)" in out
    assert started["max_batch"] == 2 and type(started["model"]).__name__ == "ArtifactUFM"


def test_demo_without_gradio_names_it(capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "gradio", None)  # not installed
    with pytest.raises(SystemExit) as exc:
        cli.main(["demo", "--device", "cpu"])
    assert exc.value.code == 1
    assert "gradio" in capsys.readouterr().out


def test_demo_panels_on_the_cpu(pairs, monkeypatch):
    """The demo's model singleton and panels, without gradio: the panels of
    ``infer`` for the same model and pair."""
    import cv2

    from ufm_torch import demo
    from ufm_torch.utils.viz import correspondence_panels

    monkeypatch.setattr(demo, "model", None)
    monkeypatch.setattr(demo, "_loaded", None)
    assert demo.initialize_model(checkpoint=TINY_REAL, device="cpu")
    src, tgt = (cv2.imread(str(pairs / f"parallax_{i}.png"))[:, :, ::-1].copy() for i in (0, 1))
    panels = demo.process_images(src, tgt)
    res = demo.model.predict_correspondences_batched(src, tgt)
    want = correspondence_panels(src, tgt, res.flow.flow_output[0].permute(1, 2, 0).numpy(),
                                 res.covisibility.mask[0].numpy())
    assert len(panels) == 3 and all(np.array_equal(a, b) for a, b in zip(panels, want))
    assert demo.process_images(None, tgt) == (None, None, None)
