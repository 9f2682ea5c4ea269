"""ufm_torch tiled inference, evaluation, data and utilities on the CPU,
against the JAX package on the same inputs.

- Tiled stitching with a stub model (a copy of ``tests/test_tiled.py``'s
  ``StubModel`` that answers in torch tensors, here with flow and
  covisibility that vary with the image and tiles that get rejected) equals
  JAX's ``predict_correspondences_tiled`` within 1e-6; the tiny model tiled,
  with the same weights in both packages, within 1e-4.
- ``.flo`` and KITTI files written by one package read by the other, exactly.
- Metrics and ``evaluate_pairs`` aggregates (plain and tiled, pairs with and
  without ground truth) against JAX's (metrics on the same arrays 1e-12;
  model-driven aggregates 1e-4).
- ``train_batches`` arrays (1e-6) and one ``fit`` step on them,
  ``unmap_predicted_pairs`` (1e-5), the geometry functions on seeded inputs
  (1e-6 relative), ``synthetic_pair`` / ``warped_pair_from_image`` bytes,
  ``visualize_flow`` bytes, and the profiling helpers (``sync``, ``span``, ``trace``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

pytest.importorskip("cv2")
import cv2  # noqa: E402

from ufm_tpu import eval as jeval  # noqa: E402
from ufm_tpu.checkpoint.convert import flatten_params  # noqa: E402
from ufm_tpu.data import FlowPairDataset as JDataset  # noqa: E402
from ufm_tpu.data import train_batches as jax_train_batches  # noqa: E402
from ufm_tpu.models import UniFlowMatchConfidence as JModel  # noqa: E402
from ufm_tpu.models import ufm_tiny_config as jax_tiny_config  # noqa: E402
from ufm_tpu.models import tiled as jtiled  # noqa: E402
from ufm_tpu.models.base import UFMFlowFieldOutput as JFlow  # noqa: E402
from ufm_tpu.models.base import UFMMaskFieldOutput as JMask  # noqa: E402
from ufm_tpu.models.base import UFMOutputInterface as JOut  # noqa: E402
from ufm_tpu.utils import example_pairs as jpairs  # noqa: E402
from ufm_tpu.utils import flow_io as jflow_io  # noqa: E402
from ufm_tpu.utils import geometry as jgeo  # noqa: E402
from ufm_tpu.utils.flow_resizing import unmap_predicted_pairs as jax_unmap_pairs  # noqa: E402
from ufm_tpu.utils.viz import visualize_flow as jax_visualize_flow  # noqa: E402
from ufm_torch import eval as peval  # noqa: E402
from ufm_torch.checkpoint import load_jax_params  # noqa: E402
from ufm_torch.data import FlowPairDataset, train_batches  # noqa: E402
from ufm_torch.models import UniFlowMatchConfidence, ufm_tiny_config  # noqa: E402
from ufm_torch.models import tiled as ptiled  # noqa: E402
from ufm_torch.models.base import UFMFlowFieldOutput, UFMMaskFieldOutput, UFMOutputInterface  # noqa: E402
from ufm_torch.models.utils import get_meshgrid  # noqa: E402
from ufm_torch.training import fit  # noqa: E402
from ufm_torch.utils import example_pairs as ppairs  # noqa: E402
from ufm_torch.utils import flow_io as pflow_io  # noqa: E402
from ufm_torch.utils import geometry as pgeo  # noqa: E402
from ufm_torch.utils import profiling  # noqa: E402
from ufm_torch.utils.flow_resizing import unmap_predicted_pairs  # noqa: E402
from ufm_torch.utils.viz import visualize_flow  # noqa: E402

STUB_ATOL = 1e-6
MODEL_ATOL = 1e-4


# ---- tiled inference ------------------------------------------------------------


class StubModel:
    """A model that knows the scene is shifted by (dx, dy): for any (source,
    target) crop it answers the residual shift after the window offset the
    tiler chose, read from the crops' position channels (0: x, 1: y of the
    full frame), plus a term and a covisibility that vary with channel 2, and
    a wrong answer (+60 px) for crops whose centre lies right of ``bad_x``
    (the tiler must reject those tiles). ``torch_outputs`` picks the port's output
    tensors, else the JAX package's arrays."""

    inference_resolution = [(64, 48)]  # (W, H)

    def __init__(self, dx: float, dy: float, torch_outputs: bool, bad_x: float = np.inf):
        self.dx, self.dy, self.torch_outputs, self.bad_x = dx, dy, torch_outputs, bad_x

    def predict_correspondences_batched(self, source_image, target_image, **_):
        src = np.asarray(source_image, dtype=np.float64)
        tgt = np.asarray(target_image, dtype=np.float64)
        if src.ndim == 3:
            src, tgt = src[None], tgt[None]
        b, h, w = src.shape[:3]
        sx, sy = src[..., 0].mean(axis=(1, 2)), src[..., 1].mean(axis=(1, 2))
        tx, ty = tgt[..., 0].mean(axis=(1, 2)), tgt[..., 1].mean(axis=(1, 2))
        wrong = np.where((sx > self.bad_x) & (h < 100), 60.0, 0.0)
        flow = np.zeros((b, 2, h, w), dtype=np.float32)
        flow[:, 0] = (self.dx - (tx - sx) + wrong)[:, None, None] + 0.02 * (src[..., 2] - 128.0)
        flow[:, 1] = (self.dy - (ty - sy))[:, None, None]
        covis = (1.0 / (1.0 + np.exp(-(src[..., 2] - 128.0) / 40.0))).astype(np.float32)
        out = UFMOutputInterface() if self.torch_outputs else JOut()
        if self.torch_outputs:
            out.flow = UFMFlowFieldOutput(flow_output=torch.from_numpy(flow))
            out.covisibility = UFMMaskFieldOutput(mask=torch.from_numpy(covis), logits=None)
        else:
            out.flow = JFlow(flow_output=jnp.asarray(flow))
            out.covisibility = JMask(mask=jnp.asarray(covis), logits=None)
        return out


def _position_image(h, w, seed):
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.zeros((h, w, 3), dtype=np.float32)
    img[..., 0], img[..., 1] = xs, ys
    img[..., 2] = np.random.default_rng(seed).integers(0, 256, (h, w))
    return img


@pytest.mark.parametrize(
    "case",
    [
        dict(shape=(96, 144), overlap=0.5, max_batch=4, bad_x=np.inf),
        dict(shape=(130, 200), overlap=0.33, max_batch=16, bad_x=120.0),
        dict(shape=(40, 60), overlap=0.33, max_batch=16, bad_x=np.inf),  # below the tile: coarse only
    ],
    ids=["shift", "rejections", "small"],
)
def test_tiled_stub_matches_jax(case):
    h, w = case["shape"]
    src, tgt = _position_image(h, w, 1), _position_image(h, w, 2)
    kw = dict(overlap=case["overlap"], max_batch=case["max_batch"])
    want = jtiled.predict_correspondences_tiled(StubModel(7.0, -5.0, False, case["bad_x"]), src, tgt, **kw)
    want_stats = dict(jtiled.last_tile_stats)
    got = ptiled.predict_correspondences_tiled(StubModel(7.0, -5.0, True, case["bad_x"]), src, tgt, **kw)
    assert ptiled.last_tile_stats == want_stats
    for g, wnt in zip(got, want):
        assert g.dtype == wnt.dtype == np.float32 and g.shape == wnt.shape
        np.testing.assert_allclose(g, wnt, atol=STUB_ATOL, rtol=0)
    if case["bad_x"] != np.inf:
        assert want_stats["tiles_rejected"] > 0


@pytest.fixture(scope="module")
def tiny_models():
    """The JAX tiny UFM-Base and the port's with the same weights."""
    jmodel = JModel.from_config(jax_tiny_config(), seed=2)
    model = UniFlowMatchConfidence.from_config(ufm_tiny_config(), device="cpu")
    load_jax_params(model, flatten_params(jmodel.params))
    return jmodel, model


@pytest.mark.parametrize("max_batch", [5, 16])
def test_tiled_tiny_model_matches_jax(tiny_models, max_batch):
    jmodel, model = tiny_models
    src, tgt, _, _ = ppairs.synthetic_pair(h=120, w=160, seed=3, max_disp=6.0)
    want = jtiled.predict_correspondences_tiled(jmodel, src, tgt, max_batch=max_batch)
    want_stats = dict(jtiled.last_tile_stats)
    got = ptiled.predict_correspondences_tiled(model, src, tgt, max_batch=max_batch)
    assert ptiled.last_tile_stats == want_stats and want_stats["tiles"] == 16
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g, wnt, atol=MODEL_ATOL, rtol=0)


# ---- flow files ---------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["flo", "kitti"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_flow_files_cross_read(tmp_path, fmt, writer):
    rng = np.random.default_rng(4)
    flow = (rng.standard_normal((13, 17, 2)) * 20).astype(np.float32)
    valid = rng.random((13, 17)) > 0.3
    w_mod, r_mod = (pflow_io, jflow_io) if writer == "port" else (jflow_io, pflow_io)
    path = str(tmp_path / ("f.flo" if fmt == "flo" else "f.png"))
    if fmt == "flo":
        w_mod.write_flo(path, flow)
        np.testing.assert_array_equal(r_mod.read_flo(path), flow)
        np.testing.assert_array_equal(pflow_io.read_flo(path), jflow_io.read_flo(path))
    else:
        w_mod.write_kitti_flow(path, flow, valid)
        (f_r, v_r), (f_p, v_p) = r_mod.read_kitti_flow(path), pflow_io.read_kitti_flow(path)
        np.testing.assert_array_equal(v_r, valid)
        np.testing.assert_allclose(f_r, flow, atol=1 / 64)  # stored in 1/64 px steps, truncated
        np.testing.assert_array_equal(f_p, jflow_io.read_kitti_flow(path)[0])


# ---- metrics and evaluate_pairs -----------------------------------------------------------


def test_metrics_match_jax():
    rng = np.random.default_rng(5)
    pred, gt = (rng.standard_normal((2, 30, 40, 2)) * 4).astype(np.float32)
    valid = rng.random((30, 40)) > 0.2
    for args in ((pred, gt), (pred, gt, valid)):
        assert peval.flow_metrics(*args) == pytest.approx(jeval.flow_metrics(*args), abs=1e-12)
    p, g = rng.random((2, 30, 40))
    assert peval.covisibility_metrics(p, g) == jeval.covisibility_metrics(p, g)
    bwd = (rng.standard_normal((25, 35, 2)) * 3).astype(np.float32)
    got, gmap = peval.cycle_consistency_metrics(pred, bwd, p, return_map=True)
    want, wmap = jeval.cycle_consistency_metrics(pred, bwd, p, return_map=True)
    assert got == pytest.approx(want, abs=1e-12)
    np.testing.assert_array_equal(gmap, wmap)


def _write_pair(d, name, img0, img1, flow=None):
    cv2.imwrite(str(d / f"{name}_0.png"), cv2.cvtColor(img0, cv2.COLOR_RGB2BGR))
    cv2.imwrite(str(d / f"{name}_1.png"), cv2.cvtColor(img1, cv2.COLOR_RGB2BGR))
    if flow is not None:
        np.save(str(d / f"{name}_flow.npy"), flow)


@pytest.fixture(scope="module")
def pair_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("pairs")
    for i in range(3):
        img0, img1, flow, _ = ppairs.synthetic_pair(h=64, w=96, seed=i, max_disp=5.0)
        _write_pair(d, f"p{i}", img0, img1, flow)
    return d


@pytest.mark.parametrize("tiled", [False, True], ids=["plain", "tiled"])
def test_evaluate_pairs_matches_jax(tiny_models, pair_dir, tmp_path, tiled):
    jmodel, model = tiny_models
    d = tmp_path / "mixed"
    d.mkdir()
    for name in ("p0", "p1"):
        for suffix in ("_0.png", "_1.png", "_flow.npy"):
            (d / f"{name}{suffix}").write_bytes((pair_dir / f"{name}{suffix}").read_bytes())
    img0, img1, _, _ = ppairs.synthetic_pair(h=70, w=90, seed=9, max_disp=4.0)
    _write_pair(d, "nogt", img0, img1)  # scored by cycle consistency
    want = jeval.evaluate_pairs(jmodel, str(d), tiled=tiled, require_gt=False)
    got = peval.evaluate_pairs(model, str(d), tiled=tiled, require_gt=False, out_json=str(tmp_path / "m.json"))
    assert got.keys() == want.keys() and got["num_pairs"] == 3 and got["all_flows_finite"]
    assert "cycle_epe" in got and "epe" in got
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=MODEL_ATOL), k
    assert (tmp_path / "m.json").exists()


# ---- data ----------------------------------------------------------------------------------


def test_train_batches_match_jax_and_feed_fit(pair_dir):
    port = list(train_batches(FlowPairDataset(str(pair_dir)), 2, (42, 56), seed=3, epochs=2, drop_remainder=False))
    ref = list(jax_train_batches(JDataset(str(pair_dir)), 2, (42, 56), seed=3, epochs=2, drop_remainder=False))
    assert len(port) == len(ref) == 4
    for a, b in zip(port, ref):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_allclose(a[k], b[k], atol=1e-6, rtol=0, err_msg=k)
    model = UniFlowMatchConfidence.from_config(ufm_tiny_config(), device="cpu")
    out = fit(model.net, iter(port[:2]), num_steps=2, warmup_steps=0, log_every=0, log_fn=lambda _: None)
    assert out["step"] == 2 and np.isfinite(float(out["metrics"]["total_loss"]))


# ---- utilities ------------------------------------------------------------------------------


def test_unmap_predicted_pairs_matches_jax():
    rng = np.random.default_rng(6)
    pts0 = rng.random((2, 9, 2)).astype(np.float32) * 50
    pts1 = rng.random((2, 9, 2)).astype(np.float32) * 50
    regions = (np.array([0, 42, 3, 53]), np.array([2, 40, 0, 56]), np.array([0, 300.0, 10, 400]), np.array([5, 290.5, 0, 410]))
    got = unmap_predicted_pairs(torch.from_numpy(pts0), torch.from_numpy(pts1), *regions)
    want = jax_unmap_pairs(jnp.asarray(pts0), jnp.asarray(pts1), *regions)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)


def _geometry_inputs():
    rng = np.random.default_rng(7)
    depth = rng.random((12, 16)) * 5 + 0.5
    K = np.array([[20.0, 0, 8.0], [0, 22.0, 6.0], [0, 0, 1]])
    pose0 = np.eye(4)
    pose1 = np.eye(4)
    pose1[:3, :3] = jgeo.quaternion_to_rot_matrix(np.array([0.05, -0.02, 0.01, 1.0]))
    pose1[:3, 3] = [0.1, -0.05, 0.2]
    pts = rng.standard_normal((5, 3)) + np.array([0, 0, 4.0])
    quat = rng.standard_normal((5, 4))
    return dict(depth=depth, K=K, pose0=pose0, pose1=pose1, pts=pts, quat=quat, rng=rng)


GEOMETRY_CASES = {
    "depthmap_to_camera_frame": lambda g, x: g.depthmap_to_camera_frame(x["depth"], x["K"]),
    "depthmap_to_world_frame": lambda g, x: g.depthmap_to_world_frame(x["depth"], x["K"], x["pose1"]),
    "geotrf": lambda g, x: g.geotrf(x["pose1"], x["pts"], norm=False),
    "depthmap_to_pts3d": lambda g, x: g.depthmap_to_pts3d(x["depth"][None], np.full((1, 12, 16), 20.0)),
    "depthmap_to_camera_coordinates": lambda g, x: g.depthmap_to_camera_coordinates(x["depth"], x["K"]),
    "z_depthmap_to_norm_depthmap": lambda g, x: g.z_depthmap_to_norm_depthmap(x["depth"], x["K"]),
    "project_points_to_pixels": lambda g, x: g.project_points_to_pixels(
        g.depthmap_to_camera_frame(x["depth"], x["K"])[0], x["K"]
    ),
    "quaternion_to_rot_matrix": lambda g, x: g.quaternion_to_rot_matrix(x["quat"]),
    "rotate_vector_with_quaternion": lambda g, x: g.rotate_vector_with_quaternion(x["pts"], x["quat"]),
    "flow_from_depth_pair": lambda g, x: g.flow_from_depth_pair(x["depth"], x["K"], x["pose0"], x["K"], x["pose1"]),
    "get_joint_pointcloud_center_scale": lambda g, x: g.get_joint_pointcloud_center_scale(
        g.depthmap_to_camera_frame(x["depth"], x["K"])[0][None], None
    ),
    "find_reciprocal_matches": lambda g, x: g.find_reciprocal_matches(x["pts"], x["pts"][::-1] + 0.01),
}


@pytest.mark.parametrize("name", list(GEOMETRY_CASES))
def test_geometry_matches_jax(name):
    got = GEOMETRY_CASES[name](pgeo, _geometry_inputs())
    want = GEOMETRY_CASES[name](jgeo, _geometry_inputs())
    got, want = (v if isinstance(v, tuple) else (v,) for v in (got, want))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g, np.float64), np.asarray(w, np.float64), rtol=1e-6, atol=0)


def test_meshgrid_on_an_explicit_device():
    grid = get_meshgrid(7, 5, device="cpu")
    assert grid.device.type == "cpu" and grid.dtype == torch.float32
    np.testing.assert_array_equal(grid.numpy(), np.asarray(jgeo.get_meshgrid_jnp(7, 5)))


def test_example_pairs_are_the_same_bytes():
    for seed in (0, 2):
        got = ppairs.synthetic_pair(h=50, w=70, seed=seed, max_disp=6.0)
        want = jpairs.synthetic_pair(h=50, w=70, seed=seed, max_disp=6.0)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    photo = np.random.default_rng(8).integers(0, 256, (80, 90, 3), dtype=np.uint8)
    for g, w in zip(ppairs.warped_pair_from_image(photo, seed=1, max_disp=5.0),
                    jpairs.warped_pair_from_image(photo, seed=1, max_disp=5.0)):
        assert g.tobytes() == w.tobytes()


def test_bundled_pairs_generate_and_load(tmp_path):
    d = ppairs.ensure_bundled_pairs(str(tmp_path / "b"))
    for name in ppairs.PAIR_NAMES:
        src, tgt, flow = ppairs.load_pair(d, name)
        j_src, j_tgt, j_flow = jpairs.load_pair(jpairs.ensure_bundled_pairs(str(tmp_path / "j")), name)
        assert src.tobytes() == j_src.tobytes() and tgt.tobytes() == j_tgt.tobytes()
        np.testing.assert_array_equal(flow, j_flow)


def test_visualize_flow_matches_jax():
    flow = (np.random.default_rng(9).standard_normal((20, 30, 2)) * 5).astype(np.float32)
    assert visualize_flow(flow, 8.0).tobytes() == jax_visualize_flow(flow, 8.0).tobytes()


def test_profiling_helpers_on_the_cpu(tmp_path):
    import json

    x = torch.ones(4)
    profiling.sync({"a": [x, (x, 2)]})  # CPU tensors: nothing to wait for
    with profiling.span("outside"):  # no profile: nothing recorded
        (x * 2).sum()
    with profiling.trace(str(tmp_path / "trace")):
        with profiling.span("block", call=True):
            with profiling.span("block.inner"):
                (x * 3).sum()
    doc = json.loads((tmp_path / "trace" / "trace.json").read_text())
    events = doc["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("cat") == "ufm_torch.span"}
    assert set(spans) == {"block", "block.inner"}
    assert spans["block.inner"]["args"]["parent"] == spans["block"]["args"]["id"]
    # on the profiler's clock: inside the record_function event the span opened
    (kept,) = [e for e in events if e.get("name") == "block" and e.get("cat") != "ufm_torch.span"]
    assert kept["ts"] <= spans["block"]["ts"] + 1e-3
    assert spans["block"]["ts"] + spans["block"]["dur"] <= kept["ts"] + kept["dur"] + 1e-3
    assert "outside" not in {sp.name for sp in profiling.spans()}
    profiling.clear()
