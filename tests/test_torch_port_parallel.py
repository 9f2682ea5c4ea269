"""ufm_torch.parallel on the CPU (gloo ranks), against the JAX package.

- Placement rules: every parameter of the tiny config and of the flagship
  (built on ``meta`` in torch, through ``jax.eval_shape`` in JAX), on meshes
  (2, 2, 2) and (1, 1, 4): the port's placement on ``model`` is JAX's
  ``param_partition_spec`` through convert's names and layouts (a Linear
  weight is (out, in): JAX's output-dim split is ``Shard(0)``). The one
  difference by design: a column-parallel layer's bias is split with its
  output where JAX replicates it.
- Sharded forward (tensor parallelism + FSDP2) on meshes (1, 2, 2),
  (2, 2, 1), (2, 1, 2) at world 4 and (2, 2, 2) at world 8, against JAX's
  unsharded ``net.apply`` at rtol / atol 2e-4 (the bar of
  tests/test_parallel_training.py::test_tp_fsdp_forward_matches_single).
- ``make_sharded_train_step`` against JAX's ``make_train_step`` and the
  port's unsharded step, on a batch whose data shards have different
  ``valid`` counts: the first step's clipped gradient (read from JAX's
  first Adam moment, which is (1 - b1) times ``clip_by_global_norm``'s
  output) at rtol 2e-4 / atol 1e-6, metrics at rtol 1e-4, parameters after 2
  steps within test_torch_port_training.py::test_train_step_matches_jax's
  bar.
- ``make_data_parallel_forward`` against the single forward at 1e-4.
- ``fit(mesh=...)`` resumes a single-device checkpoint, and a single device
  resumes a sharded run's: both end where an uninterrupted run ends.

Parameters are made from a seed with numpy (tests/torch_port_seeded.py).
Ranks are interpreters of their own (tests/torch_port_ranks.py) that import
only torch and ufm_torch; JAX runs here, in the test process.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from torch_port_ranks import Ranks
from torch_port_seeded import net_params
from ufm_tpu.checkpoint.convert import flatten_params
from ufm_tpu.models import UFMNet as JNet
from ufm_tpu.models import ufm_base_config as jax_base_config
from ufm_tpu.models import ufm_tiny_config as jax_tiny_config
from ufm_tpu.parallel import param_partition_spec as jax_partition_spec
from ufm_tpu.training import trainer as jtrainer
from ufm_torch.checkpoint import jax_params_to_state_dict
from ufm_torch.models import UFMNet, UniFlowMatchConfidence, ufm_base_config, ufm_tiny_config
from ufm_torch.parallel import make_data_parallel_forward, make_mesh, param_partition_spec, tree_shardings
from ufm_torch.training import fit, make_optimizer, make_train_step, synthetic_batch

H, W = 42, 56
FORWARD_MESHES = [(1, 2, 2), (2, 2, 1), (2, 1, 2)]
TRAIN_MESHES = [(2, 1, 2)]
LR, STEPS = 1e-3, 2


class _Mesh:
    """The JAX rule function reads only ``mesh.shape``."""

    def __init__(self, shape):
        self.shape = dict(zip(("data", "fsdp", "model"), shape))


def _jax_model_axis(path, shape, mesh_shape):
    spec = tuple(jax_partition_spec(path, shape, _Mesh(mesh_shape)))
    return [i for i, axis in enumerate(spec) if axis == "model"]


def _port_names(path, shape):
    """The port's names of one JAX parameter (a scan-stacked one fans out
    per layer); the conversion reads only the path, rank and layer count."""
    stacked = "blocks" in path.split("/")
    small = (shape[0],) + (1,) * (len(shape) - 1) if stacked else (1,) * len(shape)
    return list(jax_params_to_state_dict({path: np.zeros(small, np.float32)}))


def _rule_pairs(jax_flat_shapes, port_params, mesh_shape):
    """(port name, port placement on model, JAX's placement on model mapped
    to the port's layout)."""
    out = []
    for path, shape in jax_flat_shapes.items():
        dims = _jax_model_axis(path, shape, mesh_shape)
        leaf = path.split("/")[-1]
        stacked = "blocks" in path.split("/")
        for name in _port_names(path, shape):
            got = param_partition_spec(name, tuple(port_params[name].shape), dict(zip(("data", "fsdp", "model"), mesh_shape)))[2]
            if not dims:
                want = Replicate()
            else:
                (d,) = dims
                if stacked:
                    d -= 1  # the layer axis
                if leaf == "kernel" and len(port_params[name].shape) == 2:
                    d = 1 - d  # (in, out) -> (out, in)
                want = Shard(d)
            out.append((name, got, want))
    return out


def _jax_flat_shapes(cfg, hw):
    net = JNet(cfg)
    img = jnp.zeros((1, *hw, 3))
    tree = jax.eval_shape(lambda: net.init(jax.random.PRNGKey(0), img, img))["params"]
    return {"/".join(str(k.key) for k in path): tuple(leaf.shape) for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("mesh_shape", [(2, 2, 2), (1, 1, 4)], ids=["2x2x2", "1x1x4"])
@pytest.mark.parametrize("flagship", [False, True], ids=["tiny", "flagship"])
def test_model_axis_placements_match_jax(flagship, mesh_shape):
    jcfg, tcfg, hw = (jax_base_config(), ufm_base_config(), (420, 560)) if flagship else (jax_tiny_config(), ufm_tiny_config(), (H, W))
    with torch.device("meta"):
        port = dict(UFMNet(tcfg).named_parameters())
    pairs = _rule_pairs(_jax_flat_shapes(jcfg, hw), port, mesh_shape)
    assert {n for n, _, _ in pairs} == set(port)
    column_biases = set()
    for name, got, want in pairs:
        if name.endswith(".bias") and want == Replicate() and got == Shard(0):
            column_biases.add(name)
            continue
        assert got == want, (name, got, want)
    # the only difference: the bias of each column-parallel Linear
    weights = {n[: -len("bias")] + "weight" for n in column_biases}
    assert weights == {n for n, got, _ in pairs if n.endswith(".weight") and got == Shard(0)}
    assert any(got == Shard(1) for _, got, _ in pairs)
    # tree_shardings is the rule over a whole state dict, fsdp on dim 0
    spec = tree_shardings(port, dict(zip(("data", "fsdp", "model"), mesh_shape)))
    assert all(p[0] == Replicate() and p[1] == (Shard(0) if mesh_shape[1] > 1 else Replicate()) for p in spec.values())


# ---- the ranks --------------------------------------------------------------
def _first_step_grads(opt_state):
    """The gradient the first step clipped, from adamw's first moment
    (mu = (1 - b1) g, b1 = 0.9), in the port's names and layouts."""
    flat = {}
    for _, mu in optax.tree_utils.tree_get_all_with_path(opt_state, "mu"):
        leaves = jax.tree_util.tree_flatten_with_path(mu, is_leaf=lambda x: isinstance(x, optax.MaskedNode))[0]
        for path, leaf in leaves:
            if not isinstance(leaf, optax.MaskedNode):
                flat["/".join(str(k.key) for k in path)] = np.asarray(leaf, np.float64) / 0.1
    return {k: v.numpy() for k, v in jax_params_to_state_dict(flat).items()}


@pytest.fixture(scope="module")
def inputs():
    """Parameters (numpy, seeded), images and a batch whose data shards
    have different ``valid`` counts."""
    jnet = JNet(jax_tiny_config())
    params, flat = net_params(jnet, (H, W))
    rng = np.random.default_rng(0)
    batch = {k: v.numpy() for k, v in synthetic_batch(4, H, W, seed=3, device="cpu").items()}
    # supervise the flow at covisible pixels only, the second half of the
    # batch at fewer of them: the data shards' masked counts differ
    valid = batch["gt_covisibility"].copy()
    valid[2:] *= rng.random(valid[2:].shape) > 0.5
    batch["valid"] = valid.astype(np.float32)
    assert valid[:2].sum() != valid[2:].sum()
    return {
        "jnet": jnet, "params": params, "batch": batch,
        "state": {k: v.numpy() for k, v in jax_params_to_state_dict(flat).items()},
        "img1": rng.standard_normal((4, H, W, 3)).astype(np.float32),
        "img2": rng.standard_normal((4, H, W, 3)).astype(np.float32),
    }


@pytest.fixture(scope="module")
def jax_side(inputs):
    jnet, params, batch = inputs["jnet"], inputs["params"], inputs["batch"]
    outputs = {k: np.asarray(v) for k, v in jax.jit(jnet.apply)({"params": params}, inputs["img1"], inputs["img2"]).items()}
    jopt = jtrainer.make_optimizer(params, learning_rate=LR, warmup_steps=0, total_steps=10)
    jstep = jax.jit(jtrainer.make_train_step(jnet.apply, jopt))
    jparams, jstate, jmetrics, grads = params, jopt.init(params), [], None
    for _ in range(STEPS):
        jparams, jstate, m = jstep(jparams, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        jmetrics.append({k: np.asarray(v) for k, v in m.items()})
        grads = grads or _first_step_grads(jstate)
    return {
        "outputs": outputs, "grads": grads, "step_metrics": jmetrics,
        "params": {k: v.numpy() for k, v in jax_params_to_state_dict(flatten_params(jparams)).items()},
    }


def _batches(n):
    for i in range(n):
        yield {k: v.numpy() for k, v in synthetic_batch(2, H, W, seed=10 + i, device="cpu").items()}


def _single_fit(state, batches, ckpt):
    net = UFMNet(ufm_tiny_config())
    net.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    res = fit(net, batches, num_steps=3, learning_rate=LR, checkpoint_dir=ckpt, warmup_steps=0, log_every=0)
    return res["step"], {n: p.detach().numpy() for n, p in net.named_parameters()}


@pytest.fixture(scope="module")
def started(inputs, tmp_path_factory):
    """Both rank groups, started before the JAX side compiles: one of 4
    ranks runs every world-4 task, one of 8 the (2, 2, 2) mesh. The fit
    checkpoints come from and go back to single-device runs here."""
    tmp = tmp_path_factory.mktemp("ranks")
    batches = list(_batches(3))
    _single_fit(inputs["state"], iter(batches[:2]), str(tmp / "single"))  # stops at step 2, saves it
    shutil.copytree(tmp / "single", tmp / "from_single")
    forward = {"state": inputs["state"], "img1": inputs["img1"], "img2": inputs["img2"]}
    train = {"state": inputs["state"], "batch": inputs["batch"], "lr": LR, "steps": STEPS}
    world4 = {
        "kinds": ["sharded_forward", "sharded_train", "sharded_train:bf16", "data_parallel", "sharded_fit"],
        "sharded_forward": dict(forward, meshes=FORWARD_MESHES),
        "sharded_train": dict(train, meshes=TRAIN_MESHES),
        "sharded_train:bf16": dict(train, meshes=[(1, 2, 2)], steps=1, overrides={"compute_dtype": "bfloat16"}),
        "data_parallel": dict(forward, mesh=(4, 1, 1)),
        "sharded_fit": {"mesh": (2, 1, 2), "state": inputs["state"], "lr": LR, "num_steps": 3,
                        "runs": {"resume_single": (str(tmp / "from_single"), batches[2:]),
                                 "to_single": (str(tmp / "sharded"), batches[:2])}},
    }
    world8 = {
        "kinds": ["sharded_forward", "sharded_train"],
        "sharded_forward": dict(forward, meshes=[(2, 2, 2)]),
        "sharded_train": dict(train, meshes=[(2, 2, 2)]),
    }
    return {"4": Ranks(world4, 4, tmp / "world4"), "8": Ranks(world8, 8, tmp / "world8"), "batches": batches, "tmp": tmp}


@pytest.fixture(scope="module")
def world4(started):
    return {"ranks": started["4"].results(), "batches": started["batches"], "tmp": started["tmp"]}


@pytest.fixture(scope="module")
def world8(started):
    return started["8"].results()


def _result(ranks, kind, rank=0):
    res = ranks[rank][kind]
    assert "error" not in res, res.get("error")
    return res


def _forward_result(world4, world8, mesh_shape):
    ranks = world8 if mesh_shape == (2, 2, 2) else world4["ranks"]
    return [_result(ranks, "sharded_forward", r)[mesh_shape] for r in range(len(ranks))]


@pytest.mark.parametrize("mesh_shape", FORWARD_MESHES + [(2, 2, 2)], ids=lambda s: "x".join(map(str, s)))
def test_sharded_forward_matches_jax(started, jax_side, inputs, world4, world8, mesh_shape):
    results = _forward_result(world4, world8, mesh_shape)
    for res in results:  # every rank gathers the whole batch
        assert set(res["outputs"]) == set(jax_side["outputs"])
        for k, want in jax_side["outputs"].items():
            np.testing.assert_allclose(res["outputs"][k], want, rtol=2e-4, atol=2e-4, err_msg=k)
    # the sharded parameters sit on 'model' where the rules put them
    rules = tree_shardings({k: torch.empty(v.shape, device="meta") for k, v in inputs["state"].items()},
                           dict(zip(("data", "fsdp", "model"), mesh_shape)))
    for name, placement in results[0]["model_placements"].items():
        assert placement == str(rules[name][2]), (name, placement, rules[name][2])


@pytest.fixture(scope="module")
def unsharded_step(inputs):
    """The port's single-device step on the same batch."""
    net = UFMNet(ufm_tiny_config())
    net.load_state_dict({k: torch.from_numpy(v) for k, v in inputs["state"].items()})
    opt = make_optimizer(net, learning_rate=LR, warmup_steps=0, total_steps=10)
    step = make_train_step(net, opt)
    batch = {k: torch.from_numpy(v) for k, v in inputs["batch"].items()}
    metrics, grads = [], []
    for _ in range(STEPS):
        metrics.append({k: v.numpy() for k, v in step(batch).items()})
        grads.append({n: p.grad.numpy().copy() for n, p in net.named_parameters()})
    return {"metrics": metrics, "grads": grads, "params": {n: p.detach().numpy() for n, p in net.named_parameters()}}


@pytest.mark.parametrize("mesh_shape", TRAIN_MESHES + [(2, 2, 2)], ids=lambda s: "x".join(map(str, s)))
def test_sharded_train_step_matches_jax(started, jax_side, unsharded_step, world4, world8, mesh_shape):
    ranks = world8 if mesh_shape == (2, 2, 2) else world4["ranks"]
    res = [_result(ranks, "sharded_train", r)[mesh_shape] for r in range(len(ranks))]
    if mesh_shape[0] > 1:  # the data shards' masked counts differ
        assert len({r["local_valid"] for r in res}) > 1
    got = res[0]
    assert set(got["grads"][0]) == set(jax_side["grads"])
    for n, want in jax_side["grads"].items():
        np.testing.assert_allclose(got["grads"][0][n], want, rtol=2e-4, atol=1e-6, err_msg=n)
        np.testing.assert_allclose(got["grads"][0][n], unsharded_step["grads"][0][n], rtol=2e-4, atol=1e-6, err_msg=n)
    for i, jm in enumerate(jax_side["step_metrics"]):
        for k, want in jm.items():
            np.testing.assert_allclose(got["metrics"][i][k], want, rtol=1e-4, atol=1e-6, err_msg=f"step {i}: {k}")
            np.testing.assert_allclose(got["metrics"][i][k], unsharded_step["metrics"][i][k], rtol=1e-4, atol=1e-6)
    for r in res[1:]:  # the metrics are global: the same on every rank
        for k, v in r["metrics"][-1].items():
            np.testing.assert_allclose(v, got["metrics"][-1][k], rtol=1e-6, err_msg=k)
    g0 = jax_side["grads"]
    for n, want in jax_side["params"].items():
        tol = np.where(np.abs(g0[n]) > 1e-6, 2e-2 * LR, STEPS * LR)
        for other in (want, unsharded_step["params"][n]):
            diff = np.abs(got["params"][n] - other)
            assert (diff <= tol).all(), (n, float(diff.max()))


def test_sharded_bf16_step_matches_unsharded(inputs, world4):
    """The flagship's dtype layout (bf16 backbone, fp32 heads: one FSDP group
    per dtype) sharded on (1, 2, 2): fp32 masters sharded like their bf16
    parameters, and the step's metrics and parameters close to the port's
    unsharded bf16 step (bf16 products reduced in another order: 2e-2)."""
    res = _result(world4["ranks"], "sharded_train:bf16")[(1, 2, 2)]
    net = UFMNet(ufm_tiny_config(compute_dtype="bfloat16"))
    net.load_state_dict({k: torch.from_numpy(v) for k, v in inputs["state"].items()})
    opt = make_optimizer(net, learning_rate=LR, warmup_steps=0, total_steps=10)
    batch = {k: torch.from_numpy(v) for k, v in inputs["batch"].items()}
    want = make_train_step(net, opt)(batch)
    assert res["masters"] and all(m == ("DTensor", "torch.float32") for m in res["masters"])
    assert len(res["masters"]) == len(opt.masters())
    for k, v in want.items():
        np.testing.assert_allclose(res["metrics"][0][k], v.numpy(), rtol=2e-2, err_msg=k)
    for n, p in net.named_parameters():
        np.testing.assert_allclose(res["params"][n], p.detach().float().numpy(), rtol=0, atol=3 * LR, err_msg=n)


def test_data_parallel_forward_matches_single(inputs, world4):
    model = UniFlowMatchConfidence.from_config(ufm_tiny_config(), device="cpu")
    model.net.load_state_dict({k: torch.from_numpy(v) for k, v in inputs["state"].items()})
    with torch.no_grad():
        want = model.net(torch.from_numpy(inputs["img1"]), torch.from_numpy(inputs["img2"]))
    for r in range(4):
        got = _result(world4["ranks"], "data_parallel", r)["outputs"]
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v.numpy(), rtol=1e-4, atol=1e-4, err_msg=k)


def test_fit_mesh_checkpoints_resume_either_way(inputs, jax_side, world4):
    """Single device 2 steps -> sharded resumes the 3rd; sharded 2 steps ->
    single device resumes the 3rd; each against 3 uninterrupted steps."""
    batches, tmp = world4["batches"], world4["tmp"]
    res = _result(world4["ranks"], "sharded_fit")
    assert res["resume_single"]["step"] == 3 and res["to_single"]["step"] == 2
    _, want = _single_fit(inputs["state"], iter(batches), None)
    step, from_sharded = _single_fit(inputs["state"], iter(batches[2:]), str(tmp / "sharded"))
    assert step == 3
    g0 = jax_side["grads"]
    for n, w in want.items():
        tol = np.where(np.abs(g0[n]) > 1e-6, 2e-2 * LR, 3 * LR)
        for got in (res["resume_single"]["params"][n], from_sharded[n]):
            diff = np.abs(got - w)
            assert (diff <= tol).all(), (n, float(diff.max()))


def test_mesh_and_shard_refuse_bad_arguments():
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        if torch.cuda.is_available():
            pytest.skip("this host has a GPU")
        make_mesh(2)
    assert param_partition_spec("encoder.blocks.0.attn.qkv.weight", (192, 64), {"model": 2})[2] == Shard(0)
    assert param_partition_spec("encoder.blocks.0.attn.qkv.weight", (192, 64), {"model": 5})[2] == Replicate()
    assert param_partition_spec("encoder.blocks.0.attn.proj.weight", (64, 64), {"model": 2})[2] == Shard(1)
    assert param_partition_spec("head1.feature.proj_0.weight", (8, 64, 1, 1), {"fsdp": 2, "model": 2}) == (
        Replicate(), Shard(0), Replicate())
