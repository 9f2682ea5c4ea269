"""The model x entry-point paths of the port on the CPU, against the JAX package.

Tiny configs, JAX parameters (perturbed from a seeded init) carried into the
port with ``load_jax_params``:

- ``UniFlowMatch`` without its uncertainty head
  (``has_uncertainty_head=False``): ``predict_correspondences_batched`` and
  ``forward`` within 1e-4 of JAX's ``UniFlowMatch``, with no covisibility,
  covariance or keypoint confidence on either side; ``ufm_total_loss``'s
  metric names and every parameter's gradient as JAX's
  (``test_torch_port_training``'s bar, rtol 2e-4 / atol 1e-6), and the
  optimizer's groups as JAX's labels. ``UFMServer`` answers it with the
  flow alone.
- UFM-Refine (UNet features) behind ``UFMServer`` at lane width 2: each
  response within 1e-5 of the direct predict of the batch it ran in, at its
  slot, and within 1e-4 of JAX's predict of the pair.
- UFM-Refine through ``stream_predict`` (each batch bitwise the direct
  predict of the same stacked batch) and ``stream_predict_staged`` with the
  network's ``backbone`` as stage 1 and its ``refine_tail`` as stage 2
  (the JAX package's two-program refine inference), within 1e-5 of the
  one-program forward.
- ``ufm export --model refine --random-init --batch 2``: the artifact's raw
  outputs and its predict bitwise the live network's at batch 2 (the
  flagship config is swapped for the tiny one: the CLI builds
  ``ufm_refine_config()``).
- A UFM-Refine step under ``nothing_saveable`` and the ``+attn_out``
  composite: every gradient as the step without remat (rtol 2e-4 /
  atol 1e-6, ``test_torch_port_remat``'s bar), the attention forward run
  again where the policy does not keep it, the window refinement once (it
  lies outside the rematerialised blocks, in both packages).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ufm_tpu.checkpoint.convert import flatten_params, unflatten_params
from ufm_tpu.models import UniFlowMatch as JUniFlowMatch
from ufm_tpu.models import UniFlowMatchClassificationRefinement as JRefine
from ufm_tpu.models import ufm_tiny_config as jax_tiny_config
from ufm_tpu.training import trainer as jtrainer
from ufm_torch import cli
from ufm_torch.checkpoint import jax_params_to_state_dict, load_jax_params
from ufm_torch.models import UniFlowMatch, UniFlowMatchClassificationRefinement, ufm_tiny_config
from ufm_torch.ops.library import flash_attention_fwd, window_refinement
from ufm_torch.runtime import UFMServer, load_artifact_model, stream_predict, stream_predict_staged
from ufm_torch.training import make_optimizer, synthetic_batch, ufm_total_loss

H, W = 42, 56
ATOL = 1e-4
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-6
SERVED_BAR = 1e-5
LANE = 2
LAYERS = 4  # the tiny config: 2 encoder and 2 info-sharing blocks
UNET = {"use_unet_feature": True, "unet_kwargs": {"out_channels": 8, "features": (8, 16)}}
REFINE = dict(has_classification_head=True, **UNET)
FLOW_ONLY = dict(has_uncertainty_head=False)


def _carried(jax_cls, torch_cls, overrides, seed):
    """The JAX model with perturbed weights, and the port's on the CPU with
    the same weights."""
    jmodel = jax_cls.from_config(jax_tiny_config(**overrides), seed=0)
    rng = np.random.default_rng(seed)
    flat = {k: v + rng.normal(0.0, 0.02, v.shape).astype(v.dtype) for k, v in flatten_params(jmodel.params).items()}
    jmodel.params = unflatten_params(flat)
    model = torch_cls.from_config(ufm_tiny_config(**overrides), device="cpu")
    load_jax_params(model, flat)
    return jmodel, model


@pytest.fixture(scope="module")
def flow_only():
    return _carried(JUniFlowMatch, UniFlowMatch, FLOW_ONLY, seed=31)


@pytest.fixture(scope="module")
def refine():
    return _carried(JRefine, UniFlowMatchClassificationRefinement, REFINE, seed=32)


def _close(got, want, name, atol=ATOL):
    got = got.detach().cpu().numpy()
    assert got.shape == np.shape(want), name
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0, err_msg=name)


def _pairs(seed, n, shape=(60, 80, 3)):
    rng = np.random.default_rng(seed)
    return [tuple(rng.integers(0, 256, shape, dtype=np.uint8) for _ in range(2)) for _ in range(n)]


# ---- UniFlowMatch: the variant without the uncertainty head -------------------


def test_flow_only_model_has_no_uncertainty_head(flow_only):
    jmodel, model = flow_only
    assert not model.config.has_uncertainty_head and not hasattr(model.net, "uncertainty_head")
    assert "uncertainty_head" not in jmodel.params
    assert set(model.get_parameter_groups()) == {"encoder", "info_sharing", "output_head"}


@pytest.mark.parametrize("entry", ["predict", "forward"])
def test_flow_only_model_matches_jax(flow_only, entry):
    jmodel, model = flow_only
    if entry == "predict":
        src, tgt = (np.stack(p) for p in zip(*_pairs(33, 2)))  # a batch of 2 pairs
        want = jmodel.predict_correspondences_batched(source_image=src, target_image=tgt)
        got = model.predict_correspondences_batched(source_image=src, target_image=tgt)
    else:
        rng = np.random.default_rng(35)
        views = [{"img": rng.standard_normal((2, 3, H, W)).astype(np.float32)} for _ in range(2)]
        want = jmodel.forward(*views)
        with torch.no_grad():
            got = model.forward(*[{"img": torch.from_numpy(v["img"])} for v in views])
    _close(got.flow.flow_output, want.flow.flow_output, "flow")
    for out in (got, want):
        assert out.covisibility is None and out.keypoint_confidence is None
        assert out.flow.flow_covariance is None and out.classification_refinement is None


def test_flow_only_loss_and_gradients_match_jax(flow_only):
    jmodel, model = flow_only
    batch = {k: v.numpy() for k, v in synthetic_batch(2, H, W, seed=36, device="cpu").items()}

    def loss_fn(p):
        out = jmodel.net.apply({"params": p}, batch["img1"], batch["img2"])
        return jtrainer.ufm_total_loss(out, {k: jnp.asarray(v) for k, v in batch.items()})

    (_, j_metrics), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jmodel.params)
    net = model.net
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, metrics = ufm_total_loss(net(tbatch["img1"], tbatch["img2"]), tbatch)
    loss.backward()
    assert set(metrics) == set(j_metrics) == {"flow_loss", "epe", "total_loss"}
    for k, v in metrics.items():
        np.testing.assert_allclose(v.item(), float(j_metrics[k]), rtol=1e-4, err_msg=k)
    want = {k: v.numpy() for k, v in jax_params_to_state_dict(flatten_params(j_grads)).items()}
    names = dict(net.named_parameters())
    assert set(names) == set(want)
    for n, p in names.items():
        np.testing.assert_allclose(p.grad.numpy(), want[n], rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=n)
    labels = {jtrainer._GROUP_OF_TOP_KEY.get(k, "output_head") for k in jmodel.params}
    assert {label for label, _, _ in make_optimizer(net).groups} == labels
    net.zero_grad(set_to_none=True)


def test_flow_only_model_is_served_without_covisibility(flow_only):
    _, model = flow_only
    (src, tgt), = _pairs(37, 1)
    server = UFMServer(model, port=0, max_batch=LANE)
    try:
        got = server.predict(src, tgt)
    finally:
        server.close()
    direct = model.predict_correspondences_batched(np.stack([src] * LANE), np.stack([tgt] * LANE))
    assert set(got) == {"flow"}
    np.testing.assert_array_equal(got["flow"], direct.flow.flow_output[0].numpy())


def test_server_closed_from_two_threads():
    """``ufm serve`` closes its daemon when ``serve_forever`` returns, and
    another thread's ``close`` makes it return: the second ``close`` must
    find the HTTP server taken, not half closed (it raised AttributeError
    when it ran between the first one's ``shutdown`` and ``server_close``)."""
    server = UFMServer(model=None, port=0)
    server.start()
    httpd, shutdown = server._httpd, server._httpd.shutdown
    served_closed = threading.Event()
    errors = []

    def serve():
        try:
            server.serve_forever()
            server.close()
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)
        finally:
            served_closed.set()

    def shutdown_then_let_the_serving_thread_close():
        shutdown()
        if threading.current_thread() is threading.main_thread():
            assert served_closed.wait(timeout=30)

    httpd.shutdown = shutdown_then_let_the_serving_thread_close
    thread = threading.Thread(target=serve)
    thread.start()
    server.close()
    thread.join(timeout=30)
    assert not thread.is_alive() and not errors and server._httpd is None


# ---- UFM-Refine behind the serving entries -------------------------------------


def test_refine_served_at_lane_width(refine):
    """Two clients send three pairs each; the lane records the batches it
    ran (a short batch is padded by repeating its last pair)."""
    jmodel, model = refine
    pairs = _pairs(38, 6)
    server = UFMServer(model, port=0, max_batch=LANE, max_delay_ms=20.0)
    lane_batches, predict_batch = [], server._predict_batch

    def recording(src, tgt):
        lane_batches.append((src.copy(), tgt.copy()))
        return predict_batch(src, tgt)

    server._predict_batch = recording
    served = [None] * len(pairs)

    def client(k):
        for i in range(k, len(pairs), 2):
            served[i] = server.predict(*pairs[i])

    try:
        threads = [threading.Thread(target=client, args=(k,)) for k in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        server.close()
    assert not any(t.is_alive() for t in threads) and all(r is not None for r in served)
    assert all(len(src) == LANE for src, _ in lane_batches)
    for i, (src, tgt) in enumerate(pairs):
        (batch_src, batch_tgt), slot = next((b, r) for b in lane_batches for r in range(LANE)
                                            if np.array_equal(b[0][r], src) and np.array_equal(b[1][r], tgt))
        direct = model.predict_correspondences_batched(batch_src, batch_tgt)
        _close(torch.from_numpy(served[i]["flow"]), direct.flow.flow_output[slot], "flow vs direct", SERVED_BAR)
        _close(torch.from_numpy(served[i]["covisibility"]), direct.covisibility.mask[slot], "covis vs direct",
               SERVED_BAR)
        want = jmodel.predict_correspondences_batched(source_image=src, target_image=tgt)
        _close(torch.from_numpy(served[i]["flow"]), np.asarray(want.flow.flow_output)[0], "flow vs JAX")
        _close(torch.from_numpy(served[i]["covisibility"]), np.asarray(want.covisibility.mask)[0], "covis vs JAX")


def _refine_stages(net):
    """Stage 1 the backbone, stage 2 the refinement tail, on normalized
    model-resolution images; the intermediates stay tensors."""

    @torch.no_grad()
    def stage1(img1, img2):
        out = net.backbone(img1, img2)
        return img1, img2, out["flow"], out["cls_in_0"], out["cls_in_1"]

    return stage1, torch.no_grad()(net.refine_tail)


@pytest.mark.parametrize("staged", [False, True], ids=["one_program", "staged"])
def test_refine_streamed(refine, staged):
    """Five pairs in lanes of 2, the last batch padded and cut back."""
    _, model = refine
    if staged:
        rng = np.random.default_rng(39)
        pairs = [tuple(rng.standard_normal((H, W, 3)).astype(np.float32) for _ in range(2)) for _ in range(5)]
        outs = list(stream_predict_staged(*_refine_stages(model.net), iter(pairs), batch_size=LANE, device="cpu"))
    else:
        pairs = _pairs(40, 5)
        outs = list(stream_predict(model.predict_correspondences_batched, iter(pairs), batch_size=LANE, device="cpu"))
    batches = [pairs[0:2], pairs[2:4], [pairs[4], pairs[4]]]
    assert len(outs) == len(batches)
    for got, batch in zip(outs, batches):
        src, tgt = (np.stack([p[i] for p in batch]) for i in (0, 1))
        if staged:
            n = 1 if batch is batches[-1] else LANE
            with torch.no_grad():
                want = model.net(torch.from_numpy(src), torch.from_numpy(tgt))
            for k in ("flow", "regression_flow", "refinement_residual", "refinement_log_softmax"):
                assert got[k].shape[0] == n
                _close(got[k], want[k][:n].numpy(), k, SERVED_BAR)
        else:
            n = got.flow.flow_output.shape[0]
            want = model.predict_correspondences_batched(src, tgt)
            assert torch.equal(got.flow.flow_output, want.flow.flow_output[:n])
            assert torch.equal(got.covisibility.mask, want.covisibility.mask[:n])


def test_refine_artifact_at_batch_two_from_the_cli(tmp_path, monkeypatch, capsys):
    import ufm_torch.models as models

    tiny = ufm_tiny_config(**REFINE)
    monkeypatch.setattr(models, "ufm_refine_config", lambda: tiny)
    path = str(tmp_path / "refine_b2.ufmt")
    cli.main(["export", path, "--model", "refine", "--random-init", "--batch", "2", "--device", "cpu"])
    assert "Exported UniFlowMatchClassificationRefinement (one program, batch 2" in capsys.readouterr().out
    art = load_artifact_model(path, device="cpu")
    live = UniFlowMatchClassificationRefinement.from_config(tiny, seed=0, device="cpu")
    g = torch.Generator().manual_seed(41)
    x, y = (torch.randn(2, H, W, 3, generator=g) for _ in range(2))
    with torch.no_grad():
        got, want = art.exported(x, y), live.net(x, y)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    src, tgt = (np.stack(p) for p in zip(*_pairs(42, 2)))
    a, b = art.predict_correspondences_batched(src, tgt), live.predict_correspondences_batched(src, tgt)
    assert torch.equal(a.flow.flow_output, b.flow.flow_output)
    assert torch.equal(a.covisibility.mask, b.covisibility.mask)


# ---- UFM-Refine under the remat policies ---------------------------------------


class _CountOps(TorchDispatchMode):
    """Executions of the attention forward and the window refinement ops (a
    kept output read back by the checkpointing policy is no execution)."""

    def __init__(self):
        super().__init__()
        self.calls = {flash_attention_fwd: 0, window_refinement: 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.calls:
            self.calls[func] += 1
        return func(*args, **(kwargs or {}))


def _refine_grads(state, **remat):
    model = UniFlowMatchClassificationRefinement.from_config(ufm_tiny_config(**REFINE, **remat), device="cpu")
    model.net.load_state_dict(state)
    batch = synthetic_batch(2, H, W, seed=43, device="cpu")
    with _CountOps() as counter:
        loss, _ = ufm_total_loss(model.net(batch["img1"], batch["img2"]), batch)
        loss.backward()
    grads = {n: p.grad for n, p in model.net.named_parameters() if p.grad is not None}
    return grads, (counter.calls[flash_attention_fwd], counter.calls[window_refinement])


@pytest.mark.parametrize("policy, attention_forwards", [("nothing_saveable", 2 * LAYERS),
                                                        ("dots_with_no_batch_dims_and_attn_out_saveable", LAYERS)])
def test_refine_step_under_remat_matches_no_remat(refine, policy, attention_forwards):
    _, model = refine
    state = model.net.state_dict()
    want, plain_calls = _refine_grads(state)
    got, calls = _refine_grads(state, train_remat=True, train_remat_policy=policy)
    assert plain_calls == (LAYERS, 1) and calls == (attention_forwards, 1)
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_allclose(got[n].numpy(), want[n].numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=n)
