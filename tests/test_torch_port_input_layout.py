"""Predict inputs staged in their own memory order, on the CPU.

``predict_correspondences_batched`` views a numpy array as it lies in memory
(no host copy) and keys its program on the input's memory order; only an
array torch cannot view (a negative or odd stride) is copied on the host,
and a view that is not dense shares the channel-last program. Here: the
views share the caller's memory; the fallback takes what torch refuses; the
key differs by memory order and by nothing else; a tiny model's outputs are
bitwise the same for every layout of the same images; and the staging
counter reads what each layout takes. The card test
(``tests/test_torch_port_gpu.py::test_captured_input_layouts``) holds the
captured graph to the same.
"""

import itertools

import numpy as np
import pytest
import torch

from ufm_torch.models import UniFlowMatchClassificationRefinement, UniFlowMatchConfidence, ufm_tiny_config
from ufm_torch.models import input_layout
from ufm_torch.models.base import _to_bchw


def _images(seed=0, shape=(2, 60, 80, 3)):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _planar(a):
    """(B, H, W, 3) with the channels outermost in memory (after the batch):
    a transposed view of BCHW memory, as ``tensor.permute(0, 2, 3, 1).numpy()``."""
    return np.ascontiguousarray(a.transpose(0, 3, 1, 2)).transpose(0, 2, 3, 1)


def _bchw(a):
    return np.ascontiguousarray(a.transpose(0, 3, 1, 2))


def _crop(a):
    """A view of ``a``'s values inside a larger array: not dense."""
    b, h, w, c = a.shape
    big = np.zeros((b, h + 4, w + 6, c), dtype=a.dtype)
    big[:, 2:2 + h, 3:3 + w] = a
    return big[:, 2:2 + h, 3:3 + w]


def _reversed(a):
    """``a``'s values through a negative stride (as ``cv2.imread(p)[..., ::-1]``)."""
    return np.ascontiguousarray(a[..., ::-1])[..., ::-1]


def _odd(a):
    """``a``'s values as a field of a packed record: strides no multiple of the item size."""
    rec = np.zeros(a.shape[:-1], dtype=[("pad", "u1"), ("rgb", a.dtype, (a.shape[-1],))])
    rec["rgb"] = a
    return rec["rgb"]


LAYOUTS = {"channel_last": lambda a: a, "planar": _planar, "bchw": _bchw, "crop": _crop, "reversed": _reversed}
# how each layout is staged, and the memory order its program's buffers take
STAGED = {"channel_last": "own_order", "planar": "own_order", "bchw": "own_order", "crop": "gathered",
          "reversed": "host_copy"}
ORDERS = {"channel_last": (0, 2, 3, 1), "planar": (0, 1, 2, 3), "bchw": (0, 1, 2, 3), "crop": (0, 2, 3, 1),
          "reversed": (0, 2, 3, 1)}


@pytest.mark.parametrize("batched", [True, False], ids=["batch", "single"])
@pytest.mark.parametrize("layout", ["channel_last", "planar", "bchw"])
def test_to_bchw_views_the_callers_memory(layout, batched):
    """A numpy array in any dense order is taken without a copy: the tensor
    shares the caller's memory, reads its values and has its order."""
    a = _images(1)
    a = a if batched else a[0]
    x = LAYOUTS[layout](a) if batched else LAYOUTS[layout](a[None])[0]
    t, copied = _to_bchw(x)
    assert not copied
    assert np.shares_memory(t.numpy(), x)
    want = a.transpose(0, 3, 1, 2) if batched else a.transpose(2, 0, 1)[None]
    assert np.array_equal(t.numpy(), want)
    assert input_layout.memory_order(t) == ORDERS[layout]


def test_to_bchw_views_a_crop():
    """A crop view is taken without a copy too; it is not dense."""
    x = _crop(_images(2))
    t, copied = _to_bchw(x)
    assert not copied and np.shares_memory(t.numpy(), x)
    assert input_layout.memory_order(t) is None


@pytest.mark.parametrize("make", [_reversed, lambda a: a[::-1], _odd], ids=["channels_reversed", "batch_reversed",
                                                                            "odd_stride"])
def test_to_bchw_copies_what_torch_cannot_view(make):
    """Negative strides and strides that are no multiple of the item size:
    copied into C order on the host, values kept."""
    a = _images(3)
    x = make(a.astype(np.float32) if make is _odd else a)
    with pytest.raises(ValueError):
        torch.from_numpy(x)
    t, copied = _to_bchw(x)
    assert copied
    assert not np.shares_memory(t.numpy(), x)
    assert np.array_equal(t.numpy(), np.ascontiguousarray(x).transpose(0, 3, 1, 2))
    assert input_layout.memory_order(t) == (0, 2, 3, 1)


def test_to_bchw_passes_tensors_through():
    t = torch.from_numpy(_images(4)).permute(0, 3, 1, 2)
    got, copied = _to_bchw(t)
    assert got is t and not copied


@pytest.mark.parametrize("order", list(itertools.permutations(range(4))))
def test_buffers_take_the_order_asked(order):
    """``empty_in_order`` lays a BCHW shape out in any order, and
    ``memory_order`` reads it back."""
    buf = input_layout.empty_in_order((2, 3, 5, 7), order, torch.uint8)
    assert buf.shape == (2, 3, 5, 7)
    assert input_layout.memory_order(buf) == order


def test_memory_order_of_size_one_dims_and_overlaps():
    """Dims of size 1 come first whatever their strides; overlapping and
    broadcast tensors are not dense."""
    x = torch.empty(1, 5, 7, 3).permute(0, 3, 1, 2)
    assert input_layout.memory_order(x) == (0, 2, 3, 1)
    assert input_layout.memory_order(x.as_strided(x.shape, (999, 1, 21, 3))) == (0, 2, 3, 1)
    assert input_layout.memory_order(torch.empty(3, 1, 1, 1).expand(3, 3, 4, 4)) is None
    assert input_layout.memory_order(torch.empty(64).as_strided((2, 3, 4, 4), (1, 2, 3, 4))) is None


@pytest.fixture(scope="module")
def model():
    return UniFlowMatchConfidence.from_config(ufm_tiny_config(), seed=0, device="cpu")


def _fields(res):
    out = {"flow": res.flow.flow_output, "covisibility": res.covisibility.mask}
    for k, v in (("flow_covariance", res.flow.flow_covariance), ("keypoint_confidence", res.keypoint_confidence)):
        if v is not None:
            out[k] = v
    return out


def test_the_key_differs_by_memory_order_alone(model):
    """Planar and BCHW inputs share one key, which differs from the
    channel-last key in the orders alone; a crop shares the channel-last
    program (its buffers and graph are the same); a mixed pair is a key of
    its own."""
    a, b = _images(5), _images(6)
    model._programs.clear()

    def key_of(src, tgt):
        before = set(model._programs)
        model.predict_correspondences_batched(src, tgt)
        new = set(model._programs) - before
        return new.pop() if new else None

    last = key_of(a, b)
    planar = key_of(_planar(a), _planar(b))
    assert key_of(_bchw(a), _bchw(b)) is None  # planar's program
    assert key_of(_crop(a), _crop(b)) is None  # channel-last's program
    mixed = key_of(_planar(a), b)
    assert len(model._programs) == 3
    differs = [i for i, (x, y) in enumerate(zip(last, planar)) if x != y]
    assert len(last) == len(planar) and len(differs) == 1
    (i,) = differs
    assert last[i] == ((0, 2, 3, 1), (0, 2, 3, 1))
    assert planar[i] == ((0, 1, 2, 3), (0, 1, 2, 3))
    assert mixed[i] == ((0, 1, 2, 3), (0, 2, 3, 1))
    assert [x for j, x in enumerate(mixed) if j != i] == [x for j, x in enumerate(last) if j != i]
    assert model._programs[planar].orders == planar[i]


@pytest.mark.parametrize("refine", [False, True], ids=["base", "refine"])
@pytest.mark.parametrize("layout", ["planar", "bchw", "crop", "reversed"])
def test_every_layout_gives_the_same_outputs_bitwise(layout, refine):
    """A tiny model's eager predict on every layout of the same images (the
    source alone, the target alone, and both) equals the channel-last call
    bit for bit, and the staging counter reads each input's kind."""
    cls = UniFlowMatchClassificationRefinement if refine else UniFlowMatchConfidence
    model = cls.from_config(ufm_tiny_config(has_classification_head=refine), seed=0, device="cpu")
    src, tgt = _images(7), _images(8)
    want = _fields(model.predict_correspondences_batched(src, tgt))
    make, kind = LAYOUTS[layout], STAGED[layout]
    for pair, kinds in (((make(src), tgt), (kind, "own_order")),
                        ((src, make(tgt)), ("own_order", kind)),
                        ((make(src), make(tgt)), (kind, kind))):
        before = input_layout.snapshot()
        got = _fields(model.predict_correspondences_batched(*pair))
        counted = input_layout.since(before)
        assert counted == {k: kinds.count(k) for k in ("own_order", "gathered", "host_copy")}, counted
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), (layout, k)


def test_float_inputs_in_any_order_bitwise(model):
    """Float32 inputs (no uint8 normalize): planar and odd-stride copies of
    the same values give the channel-last outputs bitwise."""
    src, tgt = (_images(s).astype(np.float32) / 255.0 for s in (9, 10))
    want = _fields(model.predict_correspondences_batched(src, tgt, data_norm_type="identity"))
    for make in (_planar, _odd):
        before = input_layout.snapshot()
        got = _fields(model.predict_correspondences_batched(make(src), make(tgt), data_norm_type="identity"))
        kind = "host_copy" if make is _odd else "own_order"
        assert input_layout.since(before)[kind] == 2
        for k in want:
            assert torch.equal(got[k], want[k]), (make.__name__, k)


def test_staging_counts_from_many_threads():
    """The counter loses no count when the server's lanes count at once."""
    import sys
    import threading

    before = input_layout.snapshot()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [input_layout.count(("own_order", "gathered"))
                                                     for _ in range(2000)]) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert input_layout.since(before) == {"own_order": 32000, "gathered": 32000, "host_copy": 0}
