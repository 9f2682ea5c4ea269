"""ufm_torch training on the CPU, against the JAX package.

- Optimizer: the port's ``make_optimizer`` against optax's on the tiny
  UFM-Base parameters carried across, fed the same fixed gradients for 5
  steps (warmup 2: both schedule branches; one group's gradient above the
  clip norm, one below). The groups hold the same parameters as optax's
  label tree.
- fp32 masters: a bf16 parameter moves under updates far below its bf16
  spacing, where AdamW on the bf16 value leaves it unchanged.
- Train step: the tiny fp32 UFM-Base and UFM-Refine, JAX parameters carried
  across, against JAX's ``make_train_step`` on the same batch: gradients at
  rtol 2e-4 / atol 1e-6 (tests/test_training_loop.py's bar between two JAX
  gradients), metrics at rtol 1e-4, parameters after 2 steps within two
  hundredths of one step's size (the learning rate) where the gradient is
  not zero.
- ``train_remat``: the same gradients as no remat; an unknown remat policy
  raises (the policies: test_torch_port_remat.py).
- ``fit``: finite metrics, and resume from a saved train state at the right
  step; a mesh that is no ``DeviceMesh`` is refused (the sharded path:
  test_torch_port_parallel.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from ufm_tpu.checkpoint.convert import flatten_params
from ufm_tpu.models import UFMNet as JNet
from ufm_tpu.models import ufm_tiny_config as jax_tiny_config
from ufm_tpu.training import trainer as jtrainer
from ufm_torch.checkpoint import jax_params_to_state_dict, load_jax_params
from ufm_torch.checkpoint.train_state import latest_step, restore_train_state, save_train_state
from ufm_torch.models import UFMNet, UniFlowMatchConfidence, ufm_tiny_config
from ufm_torch.training import fit, make_optimizer, make_train_step, synthetic_batch, ufm_total_loss
from ufm_torch.training.trainer import GROUP_LR_SCALE, group_of, warmup_cosine_decay

H, W = 42, 56
UNET = {"use_unet_feature": True, "unet_kwargs": {"out_channels": 8, "features": (8, 16)}}


def _jax_net_params(**overrides):
    jnet = JNet(jax_tiny_config(**overrides))
    img = jnp.zeros((2, H, W, 3))
    return jnet, jax.jit(jnet.init)(jax.random.PRNGKey(0), img, img)["params"]


def _torch_net(flat, **overrides):
    net = UFMNet(ufm_tiny_config(**overrides))
    load_jax_params(net, flat)
    return net


def _state(flat):
    """Flat JAX arrays -> the port's names and layouts (numpy)."""
    return {k: v.numpy() for k, v in jax_params_to_state_dict(flat).items()}


@pytest.fixture(scope="module")
def base():
    jnet, params = _jax_net_params()
    return jnet, params, flatten_params(params)


def test_schedule_matches_optax():
    """The port's schedule is in float64, optax's in float32: near the end of
    the cosine the float32 rounding of cos reaches ~1e-6 relative."""
    import optax

    for warmup, total in ((2, 10), (0, 7), (5, 6)):
        sched = optax.warmup_cosine_decay_schedule(0.0, 3e-4, warmup, total)
        for n in range(total + 3):
            np.testing.assert_allclose(warmup_cosine_decay(n, 3e-4, warmup, total), float(sched(n)), rtol=1e-5, atol=1e-12)


def test_optimizer_matches_optax(base):
    _, params, flat = base
    lr, steps = 1e-3, 5
    net = _torch_net(flat)
    opt = make_optimizer(net, learning_rate=lr, warmup_steps=2, total_steps=10)

    # the groups hold what optax's label tree gives each label
    labels = {k: jtrainer._GROUP_OF_TOP_KEY.get(k.split("/")[0], "output_head") for k in flat}
    want = {}
    for k, label in labels.items():
        want.setdefault(label, set()).update(jax_params_to_state_dict({k: flat[k]}))
    names = {id(p): n for n, p in net.named_parameters()}
    got = {label: {names[id(p)] for p, _ in pairs} for label, _, pairs in opt.groups}
    assert got == want
    assert {label: scale for label, scale, _ in opt.groups} == {g: GROUP_LR_SCALE[g] for g in want}

    # fixed gradients: the encoder's global norm 5 (clipped), info sharing's
    # 0.3 (not clipped), the heads' their natural size
    rng = np.random.default_rng(0)
    grads = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in flat.items()}
    for label, norm in (("encoder", 5.0), ("info_sharing", 0.3)):
        keys = [k for k in grads if labels[k] == label]
        total = np.sqrt(sum(float(np.sum(grads[k].astype(np.float64) ** 2)) for k in keys))
        for k in keys:
            grads[k] = (grads[k] * (norm / total)).astype(np.float32)
    t_grads = jax_params_to_state_dict(grads)

    jopt = jtrainer.make_optimizer(params, learning_rate=lr, warmup_steps=2, total_steps=10)
    jstate = jopt.init(params)
    jparams = params
    jgrads = jax.tree.map(jnp.asarray, _unflatten(grads))
    jupdate = jax.jit(jopt.update)
    for _ in range(steps):
        updates, jstate = jupdate(jgrads, jstate, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, updates)
        for n, p in net.named_parameters():
            p.grad = t_grads[n].clone()
        opt.step()
        want = _state(flatten_params(jparams))
        for n, p in net.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=0, atol=1e-3 * lr, err_msg=n)


def _unflatten(flat):
    out = {}
    for key, v in flat.items():
        node = out
        *parents, leaf = key.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = v
    return out


def test_fp32_masters_keep_updates_below_bf16_spacing():
    """0.03 has a bf16 spacing of 2^-13 (1.2e-4). 100 Adam steps of about
    1e-5 each move the fp32 master by 1e-3 (8 spacings), and the bf16
    parameter with it; AdamW on the bf16 value itself rounds every step
    away."""
    def module():
        m = nn.Linear(4, 4, bias=False).to(torch.bfloat16)
        with torch.no_grad():
            m.weight.fill_(0.03)
        return m

    with_master, plain = module(), module()
    opt = make_optimizer(with_master, learning_rate=1e-5, weight_decay=0.0, warmup_steps=0, total_steps=10**6)
    assert len(opt.masters()) == 1
    plain_opt = torch.optim.AdamW(plain.parameters(), lr=1e-5, weight_decay=0.0)
    start = with_master.weight.detach().clone()
    for _ in range(100):
        for m in (with_master, plain):
            m.weight.grad = torch.ones_like(m.weight)
        opt.step()
        plain_opt.step()
    master = next(iter(opt.masters().values()))
    np.testing.assert_allclose(master.numpy(), start.float().numpy() - 100 * 1e-5, rtol=1e-5)
    assert with_master.weight.dtype == torch.bfloat16
    assert torch.equal(with_master.weight.detach(), master.to(torch.bfloat16))
    assert (with_master.weight.detach().float() < start.float() - 5e-4).all()
    assert torch.equal(plain.weight.detach(), start)


def test_masters_start_from_a_given_fp32_state(base):
    _, _, flat = base
    net = _torch_net(flat, compute_dtype="bfloat16")
    sd = jax_params_to_state_dict(flat)
    opt = make_optimizer(net, master_params=sd, warmup_steps=0, total_steps=5)
    names = [n for n, p in net.named_parameters()]
    bf16 = [n for n, p in net.named_parameters() if p.dtype == torch.bfloat16]
    assert bf16 and len(opt.masters()) == len(bf16)
    for i, m in opt.masters().items():
        assert m.dtype == torch.float32
        assert torch.equal(m, sd[names[i]])  # the fp32 values, not the bf16 ones


def _batch_np(seed=3, b=2):
    return {k: v.numpy() for k, v in synthetic_batch(b, H, W, seed=seed, device="cpu").items()}


@pytest.mark.parametrize("refine", [False, True], ids=["base", "refine"])
def test_train_step_matches_jax(refine):
    overrides = dict(has_classification_head=True, **UNET) if refine else {}
    jnet, params = _jax_net_params(**overrides)
    flat = flatten_params(params)
    batch = _batch_np()
    if refine:
        # ground truth = JAX's regression flow plus whole-pixel offsets: the
        # refinement loss's class (a rounded offset) is then the same on both
        # sides, where a random flow would put pixels on a half-pixel edge
        reg = np.asarray(jax.jit(jnet.apply)({"params": params}, batch["img1"], batch["img2"])["regression_flow"])
        # (never 0: a zero error sits on the Charbonnier loss's kink, where
        # its gradient follows the two sides' last-bit differences)
        offsets = np.random.default_rng(4).choice([-2.0, -1.0, 1.0, 2.0], reg.shape).astype(np.float32)
        batch["gt_flow"] = reg + offsets
    lr, steps = 1e-3, 2

    def loss_fn(p):
        out = jnet.apply({"params": p}, batch["img1"], batch["img2"])
        return jtrainer.ufm_total_loss(out, {k: jnp.asarray(v) for k, v in batch.items()})

    (_, j_metrics), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    jopt = jtrainer.make_optimizer(params, learning_rate=lr, warmup_steps=0, total_steps=10)
    jstep = jax.jit(jtrainer.make_train_step(jnet.apply, jopt))
    jstate, jparams = jopt.init(params), params

    net = _torch_net(flat, **overrides)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, _ = ufm_total_loss(net(tbatch["img1"], tbatch["img2"]), tbatch)
    loss.backward()
    want = _state(flatten_params(j_grads))
    for n, p in net.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[n], rtol=2e-4, atol=1e-6, err_msg=n)

    opt = make_optimizer(net, learning_rate=lr, warmup_steps=0, total_steps=10)
    step = make_train_step(net, opt)
    for i in range(steps):
        jparams, jstate, jm = jstep(jparams, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tm = step(tbatch)
        assert set(tm) == set(jm)
        if refine:
            assert "refinement_loss" in tm
        for k in jm:
            np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]), rtol=1e-4, atol=1e-6, err_msg=f"step {i}: {k}")
        if i == 0:
            for k in j_metrics:
                np.testing.assert_allclose(tm[k].numpy(), np.asarray(j_metrics[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    # Adam steps by m / (sqrt(v) + 1e-8): where the true gradient is zero
    # (the key bias of a softmax), both sides step by rounding noise over
    # rounding noise, anywhere within the learning rate. Elsewhere the
    # parameters agree to two hundredths of one step (Adam divides by the
    # moments, which magnifies the gradients' rtol 2e-4 where the second
    # step's gradient undoes the first's).
    want = _state(flatten_params(jparams))
    g0 = _state(flatten_params(j_grads))
    for n, p in net.named_parameters():
        tol = np.where(np.abs(g0[n]) > 1e-6, 2e-2 * lr, steps * lr)
        diff = np.abs(p.detach().numpy() - want[n])
        assert (diff <= tol).all(), (n, float(diff.max()), float(np.abs(g0[n])[diff > tol].max()))


@pytest.fixture(scope="module")
def tiny_flat():
    return flatten_params(_jax_net_params()[1])


@pytest.mark.parametrize("mode", [True, "all", "encoder"])
def test_remat_matches_plain_gradients(tiny_flat, mode):
    batch = {k: torch.from_numpy(v) for k, v in _batch_np(seed=5).items()}

    def grads(net):
        loss, _ = ufm_total_loss(net(batch["img1"], batch["img2"]), batch)
        loss.backward()
        return {n: p.grad for n, p in net.named_parameters()}

    g0 = grads(_torch_net(tiny_flat))
    remat_net = _torch_net(tiny_flat, train_remat=mode)
    assert remat_net.encoder.remat and remat_net.info_sharing.remat == (mode != "encoder")
    g1 = grads(remat_net)
    assert set(g0) == set(g1)
    for n in g0:
        np.testing.assert_allclose(g1[n].numpy(), g0[n].numpy(), rtol=2e-4, atol=1e-6, err_msg=n)


def test_remat_policy_and_unknown_modes_raise():
    net = UFMNet(ufm_tiny_config(train_remat=True, train_remat_policy="dots_with_no_batch_dims_saveable"))
    assert net.encoder.remat_policy == net.info_sharing.remat_policy == "dots_with_no_batch_dims_saveable"
    with pytest.raises(ValueError, match="unknown remat policy"):
        UFMNet(ufm_tiny_config(train_remat=True, train_remat_policy="bogus"))
    with pytest.raises(ValueError, match="unknown train_remat"):
        UFMNet(ufm_tiny_config(train_remat="layers"))
    assert not UFMNet(ufm_tiny_config()).encoder.remat


def _batches(n, bs=2):
    for i in range(n):
        yield _batch_np(seed=i, b=bs)


def test_fit_trains_a_bf16_model():
    """fit on the tiny model in bf16 (fp32 masters): finite metrics, and the
    bf16 encoder weights move, at the encoder's learning rate."""
    model = UniFlowMatchConfidence.from_config(ufm_tiny_config(compute_dtype="bfloat16"), device="cpu")
    net = model.net
    before = net.encoder.blocks[0].attn.qkv.weight.detach().clone()
    logs, seen = [], []
    out = fit(net, _batches(6), num_steps=6, learning_rate=3e-4, warmup_steps=0, log_every=3,
              log_fn=logs.append, on_metrics=lambda s, m: seen.append(s))
    assert out["step"] == 6 and seen == [3, 6] and len(logs) == 2
    assert all(np.isfinite(float(v)) for v in out["metrics"].values())
    after = net.encoder.blocks[0].attn.qkv.weight.detach()
    assert after.dtype == torch.bfloat16 and not torch.equal(after, before)
    with pytest.raises(TypeError, match="DeviceMesh"):
        fit(net, _batches(1), num_steps=1, mesh=object())


def test_train_after_predict():
    """The predict API runs under inference mode; the constants it caches
    (resize matrices, position embeddings) must not break a later train
    step in the same process."""
    model = UniFlowMatchConfidence.from_config(ufm_tiny_config(), device="cpu")
    rng = np.random.default_rng(0)
    pair = [rng.integers(0, 256, (H, W, 3), dtype=np.uint8) for _ in range(2)]
    model.predict_correspondences_batched(*pair)
    step = make_train_step(model.net, make_optimizer(model.net, warmup_steps=0, total_steps=5))
    metrics = step({k: torch.from_numpy(v) for k, v in _batch_np(b=1).items()})
    assert torch.isfinite(metrics["total_loss"])


def test_fit_checkpoint_resume(tmp_path, tiny_flat):
    ckpt = str(tmp_path / "ckpt")
    net = _torch_net(tiny_flat)
    out1 = fit(net, _batches(4), num_steps=4, warmup_steps=0, checkpoint_dir=ckpt, checkpoint_every=2, log_every=0)
    assert out1["step"] == 4 and latest_step(ckpt) == 4

    # resume into a fresh net: starts at 4, runs to 6, parameters and the
    # optimizer state come from the checkpoint
    net2 = _torch_net(tiny_flat)
    logs = []
    out2 = fit(net2, _batches(10), num_steps=6, warmup_steps=0, checkpoint_dir=ckpt, checkpoint_every=100,
               log_every=0, log_fn=logs.append)
    assert any("resumed from step 4" in line for line in logs)
    assert out2["step"] == 6 and latest_step(ckpt) == 6
    assert all(np.isfinite(float(v)) for v in out2["metrics"].values())
    assert sorted(int(d) for d in (tmp_path / "ckpt").iterdir() for d in [d.name]) == [2, 4, 6]
    state = restore_train_state(ckpt, 4)
    assert state["step"] == 4 and state["optimizer"]["scheduler"]["last_epoch"] == 4


def test_train_state_round_trip_restores_masters(tmp_path, tiny_flat):
    net = _torch_net(tiny_flat, compute_dtype="bfloat16")
    opt = make_optimizer(net, warmup_steps=0, total_steps=10)
    step = make_train_step(net, opt)
    step({k: torch.from_numpy(v) for k, v in _batch_np().items()})
    save_train_state(str(tmp_path), 1, net, opt)

    net2 = _torch_net(tiny_flat, compute_dtype="bfloat16")
    opt2 = make_optimizer(net2, warmup_steps=0, total_steps=10)
    restore_train_state(str(tmp_path), None, net2, opt2)
    for a, b in zip(net.state_dict().values(), net2.state_dict().values()):
        assert torch.equal(a, b)
    for i, m in opt.masters().items():
        assert torch.equal(m, opt2.masters()[i])
    assert opt2.scheduler.last_epoch == 1
    names = [n for n, _ in net.named_parameters()]
    assert {group_of(names[i]) for i in opt.masters()} == {"encoder", "info_sharing"}
