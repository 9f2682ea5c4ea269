"""The port's serving runtime on the CPU: the C++ batcher (the port's own
copy, built by the host C++ compiler into build/ufm_torch/), the
continuous-batching ``ServingRuntime`` and the streaming loops.

Mirrors ``tests/test_runtime.py`` for ``ufm_torch.runtime``; the streaming loops run
with ``device="cpu"`` here (the card's pinned copies, copy stream and events
are driven by ``test_stream_predict_on_the_card`` in
``tests/test_torch_port_gpu.py`` and ``chip_smoke.py``'s ``stream`` phase).
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from ufm_torch.models import UniFlowMatchConfidence, ufm_tiny_config
from ufm_torch.ops import _build
from ufm_torch.runtime import NativeBatcher, ServingRuntime, stream_predict, stream_predict_staged


def test_batcher_is_built_from_the_port_copy():
    lib = _build.load_host_library("ufm_runtime")
    path = _build._host_library_path("ufm_runtime")
    assert path.parent == _build.BUILD_DIR and path.exists()
    assert "native" not in str(path) and lib._name == str(path)


def test_batcher_full_batch_release():
    b = NativeBatcher(max_batch=4, max_delay_ms=1000.0)
    for i in range(4):
        b.submit(i)
    assert b.next_batch(timeout_s=0.5) == [0, 1, 2, 3]
    b.close()


def test_batcher_delay_release():
    b = NativeBatcher(max_batch=8, max_delay_ms=30.0)
    b.submit(42)
    t0 = time.perf_counter()
    ids = b.next_batch(timeout_s=2.0)
    waited = time.perf_counter() - t0
    assert ids == [42]
    assert 0.02 <= waited < 1.0, f"delay release took {waited:.3f}s"
    stats = b.stats()
    assert stats["batches"] == 1 and stats["dispatched"] == 1
    b.close()


def test_batcher_timeout_empty_and_shutdown():
    b = NativeBatcher(max_batch=2, max_delay_ms=1.0)
    assert b.next_batch(timeout_s=0.05) == []
    b.submit(7)
    b.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        b.submit(8)
    assert b.next_batch(timeout_s=0.05) == [7]  # drained after shutdown
    assert b.next_batch(timeout_s=0.05) is None
    b.close()


def test_batcher_close_wakes_a_blocked_submitter():
    """A submit waiting on a full queue is woken by close, which frees the
    scheduler only after that call has left it."""
    b = NativeBatcher(max_batch=2, max_delay_ms=1.0, capacity=2)
    b.submit(1)
    b.submit(2)
    errors = []

    def blocked():
        try:
            b.submit(3, timeout_s=10.0)
        except RuntimeError as e:
            errors.append(e)

    t = threading.Thread(target=blocked)
    t.start()
    time.sleep(0.1)
    b.close()
    t.join(timeout=5.0)
    assert not t.is_alive() and len(errors) == 1
    with pytest.raises(RuntimeError, match="shut down"):
        b.next_batch(timeout_s=0.01)


def test_batcher_refuses_bad_parameters():
    with pytest.raises(ValueError, match="max_batch"):
        NativeBatcher(max_batch=0)


def test_serving_runtime_pads_to_the_lane_width():
    calls = []

    def predict(src, tgt):
        calls.append(src.shape[0])
        return [float(src[i].mean() + tgt[i].mean()) for i in range(src.shape[0])]

    rt = ServingRuntime(predict, max_batch=4, max_delay_ms=20.0)
    imgs = [np.full((8, 8, 3), i, dtype=np.float32) for i in range(10)]
    futures = [rt.infer(imgs[i], imgs[i]) for i in range(10)]
    assert [f.result(timeout=5.0) for f in futures] == [2.0 * i for i in range(10)]
    stats = rt.stats()
    assert stats["submitted"] == 10 and stats["dispatched"] == 10
    assert all(c == 4 for c in calls), f"padded static batches expected, got {calls}"
    rt.close()


def test_serving_runtime_concurrent_submitters():
    """More submitting threads than cores, with a short switch interval: every
    request gets its own answer, none is lost or crossed."""

    def predict(src, tgt):
        return [float(src[i, 0, 0, 0]) for i in range(src.shape[0])]

    rt = ServingRuntime(predict, max_batch=8, max_delay_ms=5.0)
    results, errors = {}, []

    def worker(k):
        try:
            img = np.full((4, 4, 3), k, dtype=np.float32)
            results[k] = rt.infer(img, img).result(timeout=10.0)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(k,)) for k in range(48)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30.0)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    assert results == {k: float(k) for k in range(48)}
    assert rt.stats()["mean_batch_size"] > 1
    rt.close()


def test_serving_runtime_hands_errors_to_each_request_and_serves_on():
    def predict(src, tgt):
        if src[0, 0, 0, 0] < 0:
            raise ValueError("bad batch")
        return [float(src[i, 0, 0, 0]) for i in range(src.shape[0])]

    rt = ServingRuntime(predict, max_batch=2, max_delay_ms=1.0)
    bad = np.full((2, 2, 3), -1.0, np.float32)
    with pytest.raises(ValueError, match="bad batch"):
        rt.infer(bad, bad).result(timeout=5.0)
    good = np.full((2, 2, 3), 3.0, np.float32)
    assert rt.infer(good, good).result(timeout=5.0) == 3.0
    rt.close()
    with pytest.raises(RuntimeError, match="shut down"):
        rt.infer(good, good)


def test_stream_predict_order_and_padding():
    def forward(src, tgt):
        return {"mean": src.reshape(src.shape[0], -1).mean(1)}

    pairs = [(np.full((4, 4, 3), i, np.float32), np.zeros((4, 4, 3), np.float32)) for i in range(7)]
    outs = list(stream_predict(forward, pairs, batch_size=3, device="cpu"))
    assert [o["mean"].shape[0] for o in outs] == [3, 3, 1]
    np.testing.assert_allclose(torch.cat([o["mean"] for o in outs]).numpy(), np.arange(7, dtype=np.float32))


def test_stream_predict_staged_matches_monolithic():
    def stage1(src, tgt):
        return src * 2.0, tgt + 1.0

    def stage2(a, b):
        return {"mean": (a + b).reshape(a.shape[0], -1).mean(1)}

    def monolithic(src, tgt):
        return stage2(*stage1(src, tgt))

    pairs = [(np.full((4, 4, 3), i, np.float32), np.full((4, 4, 3), -i, np.float32)) for i in range(7)]
    staged = torch.cat([o["mean"] for o in stream_predict_staged(stage1, stage2, pairs, batch_size=3, device="cpu")])
    mono = torch.cat([o["mean"] for o in stream_predict(monolithic, pairs, batch_size=3, device="cpu")])
    assert torch.equal(staged, mono)
    np.testing.assert_allclose(staged.numpy(), np.arange(7, dtype=np.float32) + 1.0)


def test_stream_predict_raises_the_producers_error():
    def pairs():
        yield np.zeros((2, 2, 3), np.float32), np.zeros((2, 2, 3), np.float32)
        raise OSError("decode failed")

    with pytest.raises(OSError, match="decode failed"):
        list(stream_predict(lambda s, t: s, pairs(), batch_size=2, device="cpu"))


def test_stream_predict_through_the_model():
    """The model's predict as the forward: the outputs (a dataclass of
    tensors) are cut back to the valid pairs and equal per-batch calls."""
    model = UniFlowMatchConfidence.from_config(ufm_tiny_config(), seed=0, device="cpu")
    rng = np.random.default_rng(0)
    pairs = [tuple(rng.integers(0, 256, (42, 56, 3), dtype=np.uint8) for _ in range(2)) for _ in range(5)]
    outs = list(stream_predict(model.predict_correspondences_batched, pairs, batch_size=2, device="cpu"))
    assert [o.flow.flow_output.shape[0] for o in outs] == [2, 2, 1]
    last = model.predict_correspondences_batched(np.stack([pairs[4][0]] * 2), np.stack([pairs[4][1]] * 2))
    assert torch.equal(outs[-1].flow.flow_output, last.flow.flow_output[:1])
    assert torch.equal(outs[-1].covisibility.mask, last.covisibility.mask[:1])
