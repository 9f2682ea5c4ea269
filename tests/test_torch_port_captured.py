"""The port's per-key predict programs on the CPU.

``predict_correspondences_batched`` keeps one :class:`PredictProgram` per key
(shapes, dtypes, normalization, scaler generation, kernel choices, TF32
flags, device). On a CPU model the program runs the pipeline eagerly; the
card tests (``tests/test_torch_port_gpu.py``) hold the captured CUDA graph to
it. Here: the program's outputs are bitwise the pipeline written out by
hand; every setting of the key builds its own program; in-place weight
updates reach a program while a move of the parameters' storage drops it;
and a program's per-call body makes no host-to-device constant (which a
CUDA graph capture would refuse or bake in as a dead host pointer).
"""

import numpy as np
import pytest
import torch

from ufm_torch.models import UniFlowMatchClassificationRefinement, UniFlowMatchConfidence, ufm_tiny_config
from ufm_torch.nn.encoders.image_normalizations import IMAGE_NORMALIZATION_DICT
from ufm_torch.ops.resize import resize_hwc
from ufm_torch.utils.flow_resizing import (
    AutomaticShapeSelection,
    ResizeToFixedManipulation,
    unmap_predicted_channels,
    unmap_predicted_flow,
)


@pytest.fixture(scope="module")
def model():
    return UniFlowMatchConfidence.from_config(ufm_tiny_config(), seed=0, device="cpu")


def _pair(seed=0, shape=(2, 60, 80, 3)):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)),
            torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)))


def _by_hand(model, src_u8, tgt_u8):
    """The pipeline of a uint8 BHWC pair written out: normalize, resize to
    the model's 42x56 grid (the closest aspect to 60x80), the network, unmap."""
    norm = IMAGE_NORMALIZATION_DICT[model.data_norm_type]
    mean, std = torch.from_numpy(norm.mean), torch.from_numpy(norm.std)
    (h0, w0), (th, tw) = src_u8.shape[1:3], (42, 56)
    x, y = ((t.float() / 255.0 - mean) / std for t in (src_u8, tgt_u8))
    raw = model.network_apply(resize_hwc(x, (th, tw)), resize_hwc(y, (th, tw)))
    rep, source = np.array([0, th, 0, tw]), np.array([0, h0, 0, w0])
    flow, _ = unmap_predicted_flow(raw["flow"], rep, rep, source, source, (h0, w0), (h0, w0))
    covis, _ = unmap_predicted_channels(raw["covis_mask"][..., None], rep, source, (h0, w0))
    return flow.permute(0, 3, 1, 2), covis[..., 0]


def test_program_gives_the_pipeline_bitwise(model):
    src, tgt = _pair()
    with torch.inference_mode():
        want_flow, want_covis = _by_hand(model, src, tgt)
    for capture in (True, False, True):  # a CPU model runs eagerly either way
        model.capture_graphs = capture
        res = model.predict_correspondences_batched(src, tgt)
        assert torch.equal(res.flow.flow_output, want_flow)
        assert torch.equal(res.covisibility.mask, want_covis)
    key = [k for k in model._programs if k[0] == (2, 3, 60, 80)]
    assert len(key) == 1


def _programs_after(model, src, tgt, **kw):
    model.predict_correspondences_batched(src, tgt, **kw)
    return set(map(id, model._programs.values()))


def test_each_setting_of_the_key_builds_its_own_program():
    model = UniFlowMatchClassificationRefinement.from_config(
        ufm_tiny_config(has_classification_head=True), seed=0, device="cpu")
    src, tgt = _pair(1, (1, 42, 56, 3))
    seen = _programs_after(model, src, tgt)
    assert _programs_after(model, src, tgt) == seen  # the same key: the same program

    def changes(setup=lambda: None, undo=lambda: None, inputs=(src, tgt), **kw):
        nonlocal seen
        setup()
        try:
            now = _programs_after(model, *inputs, **kw)
        finally:
            undo()
        assert len(now - seen) == 1
        seen = now

    prev = torch.backends.cudnn.allow_tf32
    changes(lambda: setattr(torch.backends.cudnn, "allow_tf32", not prev),
            lambda: setattr(torch.backends.cudnn, "allow_tf32", prev))
    prev_mm = torch.backends.cuda.matmul.allow_tf32
    changes(lambda: setattr(torch.backends.cuda.matmul, "allow_tf32", not prev_mm),
            lambda: setattr(torch.backends.cuda.matmul, "allow_tf32", prev_mm))
    changes(lambda: setattr(model, "attention_impl", "torch"), lambda: setattr(model, "attention_impl", None))
    changes(lambda: setattr(model, "refinement_impl", "torch"), lambda: setattr(model, "refinement_impl", None))
    scaler = model.image_scaler
    changes(lambda: setattr(model, "image_scaler", AutomaticShapeSelection(ResizeToFixedManipulation((42, 56)))),
            lambda: setattr(model, "image_scaler", scaler))
    changes()  # the scaler set back is one more assignment: a new generation
    f_src = src.float() / 255.0
    for norm in ("identity", "dinov2"):
        changes(inputs=(f_src, f_src), data_norm_type=norm)


def test_in_place_weights_reach_the_program_and_moves_drop_it():
    model = UniFlowMatchConfidence.from_config(ufm_tiny_config(), seed=0, device="cpu")
    other = UniFlowMatchConfidence.from_config(ufm_tiny_config(), seed=1, device="cpu")
    src, tgt = _pair(2)
    before = model.predict_correspondences_batched(src, tgt).flow.flow_output
    (program,) = model._programs.values()

    model.load_state_dict(other.state_dict())  # in place (copy_): the same storage
    after = model.predict_correspondences_batched(src, tgt).flow.flow_output
    assert list(model._programs.values()) == [program]
    assert not torch.equal(before, after)
    assert torch.equal(after, other.predict_correspondences_batched(src, tgt).flow.flow_output)

    for move in (lambda: model.to("cpu"),
                 lambda: model.load_state_dict(other.state_dict(), assign=True),
                 lambda: model.net.load_state_dict(other.net.state_dict(), assign=True),
                 lambda: model.net.float()):
        move()
        assert torch.equal(model.predict_correspondences_batched(src, tgt).flow.flow_output, after)
        (fresh,) = model._programs.values()
        assert fresh is not program
        program = fresh


@pytest.mark.parametrize("refine", [False, True], ids=["base", "refine"])
def test_no_host_to_device_constant_in_the_per_call_body(monkeypatch, refine):
    """The second call of a key (tensor inputs: nothing to wrap) makes no
    tensor from host data: every constant was made when the program was
    built or is cached per device."""
    cls = UniFlowMatchClassificationRefinement if refine else UniFlowMatchConfidence
    model = cls.from_config(ufm_tiny_config(has_classification_head=refine), seed=0, device="cpu")
    src, tgt = _pair(3, (1, 50, 70, 3))
    first = model.predict_correspondences_batched(src, tgt)
    calls = []
    for name in ("from_numpy", "tensor", "as_tensor"):
        real = getattr(torch, name)

        def counting(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)

        monkeypatch.setattr(torch, name, counting)
    second = model.predict_correspondences_batched(src, tgt)
    monkeypatch.undo()
    assert calls == []
    assert torch.equal(first.flow.flow_output, second.flow.flow_output)
