"""ufm_torch's native image loader (``ufm_torch/runtime/loader.py`` over
``ufm_torch/csrc/host/ufm_loader.cc``) against the JAX package's
(``ufm_tpu/runtime/loader.py`` over ``native/ufm_loader.cc``) on the same
files, on the CPU.

- PNG and JPEG frames bitwise the JAX loader's, at the file's size and
  resized; the committed JPEG (``tests/golden/loader_smooth.jpg``) within the
  JAX test's mean error of 6 of its source and bitwise its committed decode;
- a file that is no image gives (id, None), as in the JAX loader;
- ``iter_decoded_pairs`` yields pairs in submission order, as the JAX one;
- ``close`` while another thread waits in ``poll`` wakes it (it raises) and
  frees the loader only after it left; later calls raise.
"""

import os
import threading
import time

import numpy as np
import pytest

from ufm_tpu.runtime import loader as jax_loader
from ufm_torch.runtime.loader import NativeImageLoader, iter_decoded_pairs

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
JPEG_MEAN_ABS = 6  # tests/test_runtime.py's bar for JPEG on smooth content


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    cv2 = pytest.importorskip("cv2")
    tmp = tmp_path_factory.mktemp("loader")
    rng = np.random.default_rng(0)
    paths, arrays = [], []
    for i in range(3):
        img = rng.integers(0, 255, (32, 40, 3), dtype=np.uint8)
        path = str(tmp / f"img{i}.png")
        cv2.imwrite(path, img[:, :, ::-1])  # BGR on disk: the loaders give RGB
        paths.append(path)
        arrays.append(img)
    return paths, arrays


def _decode(loader_cls, path, out_hw):
    loader = loader_cls(out_hw, num_threads=1)
    try:
        loader.submit(5, path)
        rid, frame = loader.poll()
    finally:
        loader.close()
    assert rid == 5
    return frame


@pytest.mark.parametrize("out_hw", [(32, 40), (16, 20), (45, 50)])
def test_frames_match_the_jax_loader(images, out_hw):
    paths, arrays = images
    for path in (*paths, os.path.join(GOLDEN, "loader_smooth.jpg")):
        got = _decode(NativeImageLoader, path, out_hw)
        assert got.shape == (*out_hw, 3)
        np.testing.assert_array_equal(got, _decode(jax_loader.NativeImageLoader, path, out_hw))
    if out_hw == (32, 40):  # PNG at its own size: lossless
        np.testing.assert_array_equal(_decode(NativeImageLoader, paths[1], out_hw), arrays[1])


def test_committed_jpeg(images):
    with np.load(os.path.join(GOLDEN, "loader_smooth.npz")) as z:
        source, decoded = z["source"], z["decoded"]
    got = _decode(NativeImageLoader, os.path.join(GOLDEN, "loader_smooth.jpg"), source.shape[:2])
    assert np.abs(got.astype(int) - source.astype(int)).mean() < JPEG_MEAN_ABS
    np.testing.assert_array_equal(got, decoded)


def test_decode_error(images, tmp_path):
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not an image")
    loader = NativeImageLoader((8, 8), num_threads=1)
    loader.submit(3, str(bad))
    loader.submit(4, str(tmp_path / "missing.jpg"))
    got = dict(loader.poll() for _ in range(2))
    loader.close()
    assert got == {3: None, 4: None}


def test_iter_decoded_pairs_in_order(images):
    paths, arrays = images
    pairs = [(paths[0], paths[1]), (paths[2], paths[0]), (paths[1], paths[2])]
    got = list(iter_decoded_pairs(pairs, (32, 40), num_threads=3, window=1))
    want = list(jax_loader.iter_decoded_pairs(pairs, (32, 40), num_threads=3, window=1))
    assert len(got) == len(want) == 3
    for (a, b), (c, d) in zip(got, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    np.testing.assert_array_equal(got[1][1], arrays[0])


def test_close_while_another_thread_polls(images):
    loader = NativeImageLoader((8, 8), num_threads=2)
    outcome = []

    def poller():
        try:
            outcome.append(loader.poll(timeout_s=30.0))
        except RuntimeError as e:
            outcome.append(str(e))

    thread = threading.Thread(target=poller)
    thread.start()
    time.sleep(0.2)  # the poller waits inside the loader
    t = time.perf_counter()
    loader.close()
    thread.join(timeout=10)
    assert not thread.is_alive() and time.perf_counter() - t < 5
    assert outcome == ["loader is shut down"]
    with pytest.raises(RuntimeError, match="shut down"):
        loader.submit(1, images[0][0])
    with pytest.raises(RuntimeError, match="shut down"):
        loader.poll(timeout_s=0.1)
    loader.close()  # twice is a no-op


def test_chip_smoke_png_writer_decodes_exactly(images, tmp_path):
    """``chip_smoke.py`` writes its PNG files with zlib alone (the card has no
    image library): the loader decodes them to the arrays written."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(GOLDEN, "..", "..", "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    img = np.random.default_rng(3).integers(0, 256, (37, 53, 3), dtype=np.uint8)
    path = str(tmp_path / "written.png")
    chip_smoke.write_png(path, img)
    np.testing.assert_array_equal(_decode(NativeImageLoader, path, (37, 53)), img)


def test_decoded_pairs_feed_stream_predict(images):
    """``iter_decoded_pairs`` as the producer of ``stream_predict`` (a tiny
    model on the CPU, batches of 2, the last padded): each streamed flow is
    the direct predict of the same decoded frames."""
    import torch

    from ufm_torch.models import UniFlowMatchConfidence, ufm_tiny_config
    from ufm_torch.runtime import stream_predict

    paths, arrays = images
    pairs = [(paths[0], paths[1]), (paths[2], paths[0]), (paths[1], paths[2])]
    model = UniFlowMatchConfidence.from_config(ufm_tiny_config(), device="cpu")
    outs = list(stream_predict(model.predict_correspondences_batched, iter_decoded_pairs(pairs, (32, 40)),
                               batch_size=2, device="cpu"))
    flows = torch.cat([o.flow.flow_output for o in outs])
    assert flows.shape == (3, 2, 32, 40)
    index = {p: a for p, a in zip(paths, arrays)}
    src = np.stack([index[s] for s, _ in pairs] + [index[pairs[-1][0]]])
    tgt = np.stack([index[t] for _, t in pairs] + [index[pairs[-1][1]]])
    want = torch.cat([model.predict_correspondences_batched(src[i:i + 2], tgt[i:i + 2]).flow.flow_output
                      for i in (0, 2)])[:3]
    assert torch.equal(flows, want)
