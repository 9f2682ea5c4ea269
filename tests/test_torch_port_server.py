"""The port's HTTP serving daemon on the CPU, over a loopback port.

``ufm_torch.runtime.server.UFMServer`` over a tiny model: ``/healthz``, the
npz round trip (bitwise the model's own predict of the lane's padded batch),
JSON with PNGs, concurrent requests batched in one lane, per-view shape
lanes, the error paths, ``python -m ufm_torch.cli serve``, and the served
flow against the JAX package's ``predict_correspondences_batched`` on the
same weights (carried over with ``load_jax_params``).
"""

import base64
import io
import json
import re
import subprocess
import sys
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax  # noqa: F401 — the JAX package's model below; JAX stays on the CPU
import numpy as np
import pytest

from ufm_tpu.checkpoint.convert import flatten_params, unflatten_params
from ufm_tpu.models import UniFlowMatchConfidence as JModel
from ufm_tpu.models import ufm_tiny_config as jax_tiny_config
from ufm_torch.checkpoint import load_jax_params
from ufm_torch.models import UniFlowMatchConfidence, ufm_tiny_config
from ufm_torch.runtime import UFMServer

ROOT = Path(__file__).resolve().parents[1]
MAX_BATCH = 2


@pytest.fixture(scope="module")
def jax_model_and_flat():
    """The JAX tiny UFM-Base with perturbed weights, and its flat params."""
    jmodel = JModel.from_config(jax_tiny_config(), seed=0)
    rng = np.random.default_rng(11)
    flat = {k: v + rng.normal(0.0, 0.02, v.shape).astype(v.dtype) for k, v in flatten_params(jmodel.params).items()}
    jmodel.params = unflatten_params(flat)
    return jmodel, flat


@pytest.fixture(scope="module")
def server(jax_model_and_flat):
    model = UniFlowMatchConfidence.from_config(ufm_tiny_config(), device="cpu")
    load_jax_params(model, jax_model_and_flat[1])
    srv = UFMServer(model, port=0, max_batch=MAX_BATCH, max_delay_ms=5.0)
    srv.start()
    yield srv
    srv.close()


def _url(server, path):
    return f"http://{server.host}:{server.port}{path}"


def _post(server, body, content_type, path="/v1/predict"):
    req = urllib.request.Request(_url(server, path), data=body, headers={"Content-Type": content_type})
    return urllib.request.urlopen(req, timeout=120)


def _npz(**arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _predict(server, src, tgt):
    with _post(server, _npz(source=src, target=tgt), "application/x-npz") as r:
        assert r.headers["Content-Type"] == "application/x-npz"
        with np.load(io.BytesIO(r.read())) as z:
            return {k: z[k] for k in z.files}


def _images(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, s, dtype=np.uint8) for s in shapes]


def test_healthz(server):
    with urllib.request.urlopen(_url(server, "/healthz"), timeout=30) as r:
        info = json.loads(r.read())
    assert info["status"] == "ok"
    assert info["model_class"] == "UniFlowMatchConfidence"
    assert info["resolution_wh"] == [56, 42]
    assert (info["backend"], info["device_name"]) == ("cpu", "cpu")


def test_npz_round_trip_is_the_models_predict(server):
    """A lone request runs as row 0 of a batch padded to the lane width: the
    response is bitwise that row of the model's own predict."""
    src, tgt = _images(0, (60, 80, 3), (60, 80, 3))
    out = _predict(server, src, tgt)
    assert set(out) == {"flow", "covisibility", "keypoint_confidence"}
    res = server.model.predict_correspondences_batched(np.stack([src] * MAX_BATCH), np.stack([tgt] * MAX_BATCH))
    assert np.array_equal(out["flow"], res.flow.flow_output[0].numpy())
    assert np.array_equal(out["covisibility"], res.covisibility.mask[0].numpy())
    assert np.array_equal(out["keypoint_confidence"], res.keypoint_confidence[0].numpy())


def test_served_flow_matches_the_jax_package(server, jax_model_and_flat):
    """The same weights in the JAX package: its predict of the same pair
    (batch 1) within 1e-4 of the served flow and covisibility."""
    src, tgt = _images(1, (50, 70, 3), (50, 70, 3))
    out = _predict(server, src, tgt)
    want = jax_model_and_flat[0].predict_correspondences_batched(source_image=src, target_image=tgt)
    np.testing.assert_allclose(out["flow"], np.asarray(want.flow.flow_output)[0], atol=1e-4, rtol=0)
    np.testing.assert_allclose(out["covisibility"], np.asarray(want.covisibility.mask)[0], atol=1e-4, rtol=0)


def test_json_png_request(server):
    cv2 = pytest.importorskip("cv2")
    src, tgt = _images(2, (64, 80, 3), (64, 80, 3))
    body = json.dumps({
        key: base64.b64encode(cv2.imencode(".png", cv2.cvtColor(img, cv2.COLOR_RGB2BGR))[1]).decode()
        for key, img in (("source_png_b64", src), ("target_png_b64", tgt))
    }).encode()
    with _post(server, body, "application/json") as r:
        with np.load(io.BytesIO(r.read())) as z:
            flow = z["flow"]
    assert np.array_equal(flow, _predict(server, src, tgt)["flow"])  # PNG is lossless


def test_concurrent_requests_are_batched(server):
    """Same-shape requests in flight together share a lane's batches, and
    each gets its own answer: bitwise the model's predict of that pair among
    other neighbours (a batch of copies of it; in fp32 on the CPU a row does
    not depend on its batch's other rows or its place among them), and within
    1e-5 relative L2 of the pair predicted alone (batch 1, other GEMM shapes)."""
    model = server.model
    shape = (72, 96, 3)
    pairs = [_images(10 + i, shape, shape) for i in range(8)]
    with ThreadPoolExecutor(8) as pool:
        outs = list(pool.map(lambda p: _predict(server, *p), pairs))
    stats = server.stats()["72x96x3x72x96x3"]
    assert stats["dispatched"] == 8 and stats["mean_batch_size"] > 1
    for (src, tgt), out in zip(pairs, outs):
        copies = model.predict_correspondences_batched(np.stack([src] * MAX_BATCH), np.stack([tgt] * MAX_BATCH))
        assert np.array_equal(out["flow"], copies.flow.flow_output[0].numpy())
        assert np.array_equal(out["covisibility"], copies.covisibility.mask[0].numpy())
        alone = model.predict_correspondences_batched(src, tgt)
        for key, want in (("flow", alone.flow.flow_output[0]), ("covisibility", alone.covisibility.mask[0])):
            want = want.numpy()
            assert np.linalg.norm(out[key] - want) <= 1e-5 * np.linalg.norm(want), key


def test_per_view_shape_lanes(server):
    """Source and target of different sizes: each view resizes to the model
    grid on its own; the lane is keyed by the shape pair and the outputs are
    in the source frame."""
    src, tgt = _images(3, (96, 96, 3), (64, 112, 3))
    out = _predict(server, src, tgt)
    assert out["flow"].shape == (2, 96, 96) and out["covisibility"].shape == (96, 96)
    assert np.isfinite(out["flow"]).all()
    assert "96x96x3x64x112x3" in server.stats()


@pytest.mark.parametrize(
    "body,ctype,path,code,message",
    [
        (b"not an npz", "application/x-npz", "/v1/predict", 400, "npz"),
        (_npz(source=np.zeros((8, 8, 3), np.uint8)), "application/x-npz", "/v1/predict", 400, "'target'"),
        (_npz(source=np.zeros((4, 4), np.uint8), target=np.zeros((5, 4, 3), np.uint8)), "application/x-npz",
         "/v1/predict", 400, "HWC"),
        (_npz(source=np.zeros((8, 8, 3), np.float32), target=np.zeros((8, 8, 3), np.float32)), "application/x-npz",
         "/v1/predict", 400, "uint8"),
        (b"{}", "application/json", "/v1/predict", 400, "source_png_b64"),
        (b"", "application/x-npz", "/v1/elsewhere", 404, "unknown path"),
    ],
    ids=["not_npz", "missing_array", "bad_shape", "float_image", "json_missing_key", "unknown_path"],
)
def test_error_paths(server, body, ctype, path, code, message):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, body, ctype, path)
    assert e.value.code == code
    assert message in json.loads(e.value.read())["error"]


def test_unknown_get_path(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(_url(server, "/nothing"), timeout=30)
    assert e.value.code == 404


def test_json_without_cv2_is_a_clear_400(server, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 now raises ImportError
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, b'{"source_png_b64": "", "target_png_b64": ""}', "application/json")
    assert e.value.code == 400
    assert "cv2" in json.loads(e.value.read())["error"]


def test_cli_serve(tmp_path):
    """``python -m ufm_torch.cli serve`` on the trained tiny checkpoint on the
    CPU: it prints its address, answers /healthz and a predict, and stops."""
    cmd = [sys.executable, "-m", "ufm_torch.cli", "serve", "--checkpoint",
           str(ROOT / "examples" / "checkpoints" / "tiny_real224"), "--device", "cpu", "--port", "0", "--max-batch", "2"]
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        line = proc.stdout.readline()
        m = re.search(r"http://127\.0\.0\.1:(\d+)", line)
        assert m, f"no address in {line!r}"
        port = int(m.group(1))
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
            assert json.loads(r.read())["backend"] == "cpu"
        src, tgt = _images(4, (60, 80, 3), (60, 80, 3))
        req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/predict", data=_npz(source=src, target=tgt),
                                     headers={"Content-Type": "application/x-npz"})
        with urllib.request.urlopen(req, timeout=120) as r, np.load(io.BytesIO(r.read())) as z:
            assert z["flow"].shape == (2, 60, 80)
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_cli_serve_refusals(capsys):
    from ufm_torch import cli

    with pytest.raises(SystemExit) as exc:
        cli.main(["serve", "--device", "cpu"])
    assert exc.value.code == 1 and "--random-init" in capsys.readouterr().out
    with pytest.raises(SystemExit) as exc:
        cli.main(["serve", "--random-init", "--max-batch", "0", "--device", "cpu"])
    assert exc.value.code == 1 and "--max-batch" in capsys.readouterr().out
