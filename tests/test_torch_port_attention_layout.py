"""The host-side precondition of the attention kernels' TMA tensor maps.

``tma_layout_error`` is a pure function of shape, strides, base address and
item size, so the CPU can check which views the kernels read in place: the
fused-qkv views of the main path, transposed views, and offset views.
"""

import inspect

import pytest
import torch

from ufm_torch.ops import flash_attention as fa
from ufm_torch.training import synthetic_batch


def _error(t: torch.Tensor, data_ptr=None):
    return fa.tma_layout_error(tuple(t.shape), t.stride(), t.data_ptr() if data_ptr is None else data_ptr,
                               t.element_size())


@pytest.mark.parametrize("which", [0, 1, 2])
def test_fused_qkv_views_are_read_in_place(which):
    """The main path's q, k, v: (B, S, 3, H, D)[:, :, i], S stride 3 H D."""
    qkv = torch.zeros(2, 1201, 3, 16, 64, dtype=torch.bfloat16)
    view = qkv[:, :, which]
    assert not view.is_contiguous()
    assert view.stride() == (1201 * 3 * 16 * 64, 3 * 16 * 64, 64, 1)
    # the base moves by which * H * D * 2 bytes, a multiple of 16
    assert _error(view, data_ptr=4096 + which * 16 * 64 * 2) is None


def test_transposed_head_and_sequence_view_is_read_in_place():
    """A (B, H, S, D) tensor seen as (B, S, H, D): strides out of order,
    each a multiple of 16 bytes."""
    bhsd = torch.zeros(2, 12, 2400, 64, dtype=torch.bfloat16)
    view = bhsd.transpose(1, 2)
    assert _error(view, data_ptr=0) is None


def test_transposed_head_dim_is_refused():
    view = torch.zeros(1, 8, 64, 2, dtype=torch.bfloat16).transpose(2, 3)
    assert "head dim" in _error(view, data_ptr=0)


@pytest.mark.parametrize("offset_bytes,ok", [(0, True), (16, True), (256, True), (2, False), (8, False)])
def test_offset_views_need_a_16_byte_aligned_base(offset_bytes, ok):
    t = torch.zeros(1, 77, 2, 64, dtype=torch.bfloat16)
    err = _error(t, data_ptr=1 << 20 | offset_bytes)
    assert (err is None) == ok
    if not ok:
        assert "aligned" in err


def test_real_offset_view_is_refused():
    flat = torch.zeros(2 * 64 * 5 + 1, dtype=torch.bfloat16)
    view = flat[1:].view(1, 5, 2, 64)  # one element past the storage's start
    assert view.data_ptr() % 16 == (flat.data_ptr() + 2) % 16
    assert (_error(view) is None) == (view.data_ptr() % 16 == 0)


@pytest.mark.parametrize("row", [68, 72, 80, 96])
def test_strides_must_be_multiples_of_16_bytes(row):
    """A padded last dim sliced back to 64: the head stride is row * 2 bytes."""
    view = torch.zeros(1, 10, 3, row, dtype=torch.bfloat16)[..., :64]
    err = _error(view, data_ptr=0)
    assert (err is None) == (row * 2 % 16 == 0)
    if err is not None:
        assert "stride" in err


def test_size_one_dims_have_free_strides():
    """A dimension of size 1 is never stepped: any stride passes (the C side
    replaces it with the packed one)."""
    assert fa.tma_layout_error((1, 7, 1, 64), (3, 64, 5, 1), 0, 2) is None
    assert "S stride" in fa.tma_layout_error((1, 7, 2, 64), (3, 68, 64, 1), 0, 2)


@pytest.mark.parametrize(
    "shape,strides,why",
    [
        ((5, 64), (64, 1), "rank-4"),
        ((2, 9, 2, 64), (0, 128, 64, 1), "B stride"),  # a broadcast batch
        ((2, 9, 2, 64), (1 << 40, 128, 64, 1), "B stride"),  # beyond TMA's 2^40 bytes
        ((1, 1 << 31, 1, 64), (0, 64, 64, 1), "coordinate"),
    ],
)
def test_other_refusals(shape, strides, why):
    assert why in fa.tma_layout_error(shape, strides, 0, 2)


def test_kernel_wrapper_refuses_cpu_tensors_with_the_plain_route():
    x = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="impl='torch'"):
        fa.flash_attention(x, x, x)


def test_synthetic_batch_defaults_to_the_card():
    """Entry points run on the card unless the caller asks for the CPU."""
    assert inspect.signature(synthetic_batch).parameters["device"].default == "cuda"
    batch = synthetic_batch(1, 6, 8, seed=0, device="cpu")
    assert batch["img1"].device.type == "cpu" and batch["gt_flow"].shape == (1, 6, 8, 2)
