"""``python -m ufm_torch.cli``: the environment check and infer's refusals,
for both models.

A full ``infer --random-init`` builds the flagship model (ViT-L); that is the
GPU's job, so here only the paths that fail before the model are driven.
"""

import subprocess
import sys
from pathlib import Path

import pytest

from ufm_torch import cli

ROOT = Path(__file__).resolve().parents[1]


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
        (["--checkpoint", "some/dir"], "not ported"),
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
