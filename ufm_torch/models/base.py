"""Model base: output interfaces + the batched prediction pipeline.

Counterpart of ``ufm_tpu/models/base.py``: the output dataclasses and
``predict_correspondences_batched``. Public tensors follow the reference's
BCHW convention (flow (B, 2, H, W), masks (B, H, W)); inside, maps are
channel-last. The pipeline: normalize (uint8 or float input, both
normalization paths), resize to the model resolution whose aspect is closest
(antialiased), forward, unmap back to the input resolution, rescale the
covariance.

Like the JAX package, which compiles one program per key,
``predict_correspondences_batched`` keeps one :class:`PredictProgram` per key:
the source and target shapes, dtypes and memory orders, the normalization,
the scaler generation (bumped by every assignment to ``image_scaler``), the
model's kernel choices, the TF32 flags (cuDNN and cuBLAS fix their algorithms
when a graph is captured) and the device. A program holds what its key fixes:
the selected manipulation, its region bookkeeping and the device constants. On a
CUDA model the first call of a key runs the pipeline once eagerly on a side
stream (the warm-up, whose answer that call returns) and captures it into a
CUDA graph; later calls copy the inputs into the graph's static buffers,
replay it and return fresh copies of its outputs. Each input is staged in its
own memory order (:mod:`ufm_torch.models.input_layout`): the pinned staging
buffer and the static buffer are laid out as the input is, so both copies are
flat memcpys, and the graph's first op makes the channel-last view that the
normalize reads contiguous on the card (a no-op for channel-last inputs). On a
CPU model, or with ``capture_graphs = False`` (the checks' eager path, as
``jax.disable_jit``), the program runs the pipeline eagerly.

A call names its phases by spans (:mod:`ufm_torch.utils.profiling`, recorded
under a profile): ``predict.call`` > ``predict.prepare`` (input layout,
checks, program lookup), ``predict.staging`` (the staging buffers' wait, the
pinned copy, the host-to-device enqueue), ``predict.launch`` (the replay),
``predict.outputs`` (the clones, the output dataclasses), or a first call's
``predict.capture``. ``predict.pre`` and ``predict.post`` (normalize and
resize; unmap) and the network's stages are spans too: in a captured graph
they are timing events, read per replay under a profile.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ufm_torch.models import input_layout
from ufm_torch.nn.encoders.image_normalizations import IMAGE_NORMALIZATION_DICT
from ufm_torch.ops import launches
from ufm_torch.utils import profiling
from ufm_torch.utils.flow_resizing import (
    AutomaticShapeSelection,
    ResizeToFixedManipulation,
    _identity_regions,
    unmap_predicted_channels,
    unmap_predicted_flow,
)

__all__ = [
    "UFMFlowFieldOutput",
    "UFMMaskFieldOutput",
    "UFMClassificationRefinementOutput",
    "UFMOutputInterface",
    "UniFlowMatchModelsBase",
    "PredictProgram",
]

# cudaStreamCaptureMode of every capture. "thread_local" refuses a call that
# is unsafe during capture (a synchronizing query, a pageable copy) in the
# capturing thread, as "global" does, but lets the server's other threads
# copy their results to the host while one lane captures.
_CAPTURE_ERROR_MODE = "thread_local"


@dataclasses.dataclass
class UFMFlowFieldOutput:
    """Flow field prediction. BCHW."""

    flow_output: torch.Tensor
    flow_covariance: Optional[torch.Tensor] = None
    flow_covariance_inv: Optional[torch.Tensor] = None
    flow_covariance_log_det: Optional[torch.Tensor] = None


@dataclasses.dataclass
class UFMMaskFieldOutput:
    """Mask prediction. (B, H, W)."""

    mask: torch.Tensor
    logits: Optional[torch.Tensor] = None


@dataclasses.dataclass
class UFMClassificationRefinementOutput:
    """Refinement internals (filled by the UFM-Refine variant)."""

    regression_flow_output: torch.Tensor  # (B, 2, H, W)
    residual: torch.Tensor  # (B, 2, H, W)
    log_softmax: torch.Tensor  # (B, H, W, P, P)
    feature_map_0: torch.Tensor
    feature_map_1: torch.Tensor


@dataclasses.dataclass
class UFMOutputInterface:
    """Top-level output."""

    flow: Optional[UFMFlowFieldOutput] = None
    classification_refinement: Optional[UFMClassificationRefinementOutput] = None
    covisibility: Optional[UFMMaskFieldOutput] = None
    keypoint_confidence: Optional[torch.Tensor] = None


def _to_bchw(image) -> Tuple[torch.Tensor, bool]:
    """Accept BCHW/BHWC/CHW/HWC numpy arrays or tensors; return a BCHW tensor
    and whether the host copied the input. A numpy array is viewed as it lies
    in memory, whatever its strides; only one that torch cannot view (a
    negative stride, as ``img[..., ::-1]`` has, or a stride that is no
    multiple of the item size) is copied into C order first."""
    copied = False
    if isinstance(image, torch.Tensor):
        t = image
    else:
        a = np.asarray(image)
        copied = any(s < 0 or s % a.itemsize for s in a.strides)
        t = torch.from_numpy(np.ascontiguousarray(a) if copied else a)
    if t.dim() not in (3, 4):
        raise ValueError(f"image must have 3 or 4 dims, got {t.dim()}")
    if t.dim() == 3:
        t = t[None]
    if t.shape[1] == 3:
        pass
    elif t.shape[-1] == 3:
        t = t.permute(0, 3, 1, 2)
    else:
        raise ValueError("images must have 3 channels in either BCHW or BHWC format")
    return t, copied


class PredictProgram:
    """The predict pipeline of one key: the selected manipulation with its
    regions, the device constants, and on a CUDA model the captured graph
    with its static buffers. Built by ``predict_correspondences_batched``;
    call it with the model and BCHW inputs. ``orders``: the memory order of
    the source's and the target's staging and static buffers
    (:func:`input_layout.memory_order`'s form)."""

    def __init__(self, model, src_shape, tgt_shape, src_dtype, tgt_dtype, data_norm_type, device, orders):
        b0, _, h0, w0 = src_shape
        b1, _, h1, w1 = tgt_shape
        shapes, manipulation = model.image_scaler.select(h0, w0, h1, w1)
        if manipulation is None:
            raise ValueError(f"no manipulation accepts inputs {(h0, w0)}/{(h1, w1)}")
        th0, tw0, th1, tw1 = shapes
        if (th0, tw0) != (th1, tw1):
            raise ValueError("both views must map to one model resolution")
        self.shapes = (tuple(src_shape), tuple(tgt_shape))
        self.dtypes = (src_dtype, tgt_dtype)
        self.orders = tuple(orders)
        self.device = device
        self.manipulation = manipulation
        self.source_hw = ((h0, w0), (h1, w1))
        # the region bookkeeping is host numpy on static shapes: one run of
        # the manipulation on meta tensors gives it without device work
        probe = manipulation(
            torch.empty((b0, h0, w0, 3), device="meta"),
            torch.empty((b1, h1, w1, 3), device="meta"),
            _identity_regions(h0, w0),
            _identity_regions(h1, w1),
            _identity_regions(h0, w0),
            _identity_regions(h1, w1),
        )
        self.regions = probe[2:]  # src source, tgt source, src representation, tgt representation

        # device constants, made once here: a host-to-device copy inside a
        # capture is refused or would capture a dead host pointer
        def const(a) -> torch.Tensor:
            return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(device)

        req = IMAGE_NORMALIZATION_DICT[model.data_norm_type]
        self.uint8 = src_dtype == torch.uint8
        self.mean, self.std = const(req.mean), const(req.std)
        self.prev = None
        if not self.uint8 and data_norm_type != model.data_norm_type:
            prev = IMAGE_NORMALIZATION_DICT[data_norm_type]
            self.prev = (const(prev.mean), const(prev.std))
        w_ratio, h_ratio = w0 / tw0, h0 / th0
        self.cov_scale = const([w_ratio**2, h_ratio**2, w_ratio * h_ratio])

        # the captured graph: made by the first captured call
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.static_in: Tuple[torch.Tensor, ...] = ()
        self.staging: Tuple[torch.Tensor, ...] = ()
        self.static_out: Dict[str, torch.Tensor] = {}
        self.launches: Dict[str, int] = {}  # kernel launches one replay makes, by kernel name
        self.stages: Optional[profiling.GraphStages] = None  # the stage timing events in the graph
        self._h2d_done: Optional[torch.cuda.Event] = None

    # ---- the eager pipeline -------------------------------------------------
    def run(self, model, src_bchw: torch.Tensor, tgt_bchw: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The pipeline, op by op, on inputs on the program's device, in any
        memory order: the channel-last views are made contiguous first, so
        every later op sees the same tensors whatever the order."""
        with profiling.span("predict.pre"):
            src = src_bchw.permute(0, 2, 3, 1).contiguous()
            tgt = tgt_bchw.permute(0, 2, 3, 1).contiguous()
            if self.uint8:
                src = (src.float() / 255.0 - self.mean) / self.std
                tgt = (tgt.float() / 255.0 - self.mean) / self.std
            elif self.prev is not None:
                prev_mean, prev_std = self.prev
                src = src * (prev_std / self.std) + (prev_mean - self.mean) / self.std
                tgt = tgt * (prev_std / self.std) + (prev_mean - self.mean) / self.std

            # the selected manipulation to the model grid (its regions are the probe's)
            src_s, tgt_s = self.manipulation(src, tgt, *(_identity_regions(*hw) for hw in self.source_hw * 2))[:2]
        raw = model.network_apply(src_s, tgt_s)
        with profiling.span("predict.post"):
            return self._unmap(raw)

    def _unmap(self, raw: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The network's outputs back at the input resolution, BCHW."""
        (h0, w0), (h1, w1) = self.source_hw
        src_region_source, tgt_region_source, src_region_repr, tgt_region_repr = self.regions

        out: Dict[str, torch.Tensor] = {}
        flow_unmapped, _ = unmap_predicted_flow(
            raw["flow"], src_region_repr, tgt_region_repr, src_region_source, tgt_region_source, (h0, w0), (h1, w1)
        )
        out["flow"] = flow_unmapped.permute(0, 3, 1, 2)

        if "flow_cov" in raw:
            cov_unmapped, _ = unmap_predicted_channels(raw["flow_cov"], src_region_repr, src_region_source, (h0, w0))
            out["flow_covariance"] = (cov_unmapped * self.cov_scale).permute(0, 3, 1, 2)

        if "covis_mask" in raw:
            covis_unmapped, _ = unmap_predicted_channels(
                raw["covis_mask"][..., None], src_region_repr, src_region_source, (h0, w0)
            )
            out["covisibility"] = covis_unmapped[..., 0]

        if "keypoint_confidence" in raw:
            conf_unmapped, _ = unmap_predicted_channels(
                raw["keypoint_confidence"][..., None], src_region_repr, src_region_source, (h0, w0)
            )
            out["keypoint_confidence"] = conf_unmapped[..., 0]
        return out

    # ---- the captured graph -------------------------------------------------
    def _load(self, src: torch.Tensor, tgt: torch.Tensor) -> None:
        """Copy the inputs into the static buffers, host tensors through the
        pinned staging buffers (asynchronously: the copy waits for nothing
        on the host)."""
        self._h2d_done.synchronize()  # the staging buffers are free again
        for static, staging, x in zip(self.static_in, self.staging, (src, tgt)):
            if x.is_cuda:
                static.copy_(x)
            else:
                staging.copy_(x)
                static.copy_(staging, non_blocking=True)
        self._h2d_done.record()

    def _capture(self, model, src: torch.Tensor, tgt: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Warm up on a side stream (its answer is this call's), then capture
        the pipeline into a graph in the model's pool. The static and staging
        buffers are BCHW views of memory in the program's orders."""
        dev = self.device
        layouts = tuple(zip(self.shapes, self.orders, self.dtypes))
        self.static_in = tuple(input_layout.empty_in_order(*a, device=dev) for a in layouts)
        self.staging = tuple(input_layout.empty_in_order(*a, pin_memory=True) for a in layouts)
        self._h2d_done = torch.cuda.Event()
        self._load(src, tgt)

        stream = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            warm = self.run(model, *self.static_in)  # fills the cached constants, sets kernel attributes
        stream.wait_stream(side)
        for t in warm.values():  # made on the side stream, read on this one
            t.record_stream(stream)

        if model._graph_pool is None:
            model._graph_pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        before = launches.snapshot()
        try:
            # the pipeline's spans record timing events into the graph
            with profiling.capturing() as stages, torch.cuda.graph(
                graph, pool=model._graph_pool, capture_error_mode=_CAPTURE_ERROR_MODE
            ):
                static_out = self.run(model, *self.static_in)
        finally:
            # the wrappers counted launches that did not run: take them back
            self.launches = launches.since(before)
            launches.add({name: -d for name, d in self.launches.items()})
        self.graph, self.static_out, self.stages = graph, static_out, stages
        return warm

    def __call__(self, model, src_bchw: torch.Tensor, tgt_bchw: torch.Tensor, capture: bool) -> Dict[str, torch.Tensor]:
        """The pipeline's outputs for one batch: fresh tensors on the
        program's device. ``capture``: through the captured graph (CUDA);
        otherwise eagerly."""
        if not capture:
            return self.run(model, src_bchw.to(self.device), tgt_bchw.to(self.device))
        with model._predict_lock, torch.cuda.device(self.device):  # the server's lanes call from several threads
            stream = torch.cuda.current_stream(self.device)
            if model._replay_done is None:
                model._replay_done = torch.cuda.Event()
            stream.wait_event(model._replay_done)  # graphs of one pool never overlap
            if self.graph is None:
                with profiling.span("predict.capture"):
                    out = self._capture(model, src_bchw, tgt_bchw)
            else:
                with profiling.span("predict.staging"):
                    self._load(src_bchw, tgt_bchw)
                with profiling.span("predict.launch", graph=self.stages):
                    self.graph.replay()
                    self.stages.replays += 1
                launches.add(self.launches)
                with profiling.span("predict.outputs"):
                    out = {k: v.clone() for k, v in self.static_out.items()}
            model._replay_done.record(stream)
        return out


class UniFlowMatchModelsBase:
    """Prediction API shared by the model variants.

    Subclasses provide ``network_apply(img1_bhwc, img2_bhwc) -> dict`` (the
    network on normalized channel-last inputs), ``data_norm_type`` and
    ``device``; they may add to a program's key (:meth:`_program_key`) and
    say when the parameters' storage moved (:meth:`_storage_generation`).

    ``capture_graphs`` (default ``True``): a CUDA model replays one captured
    graph per key; ``False`` runs the pipeline eagerly (for checks).
    """

    def __init__(self, inference_resolution: Optional[Union[List[Tuple[int, int]], Tuple[int, int]]] = None):
        if inference_resolution is None:
            inference_resolution = [(560, 420)]
        if isinstance(inference_resolution[0], int):
            inference_resolution = [tuple(inference_resolution)]
        # (W, H) tuples, the reference convention
        self.inference_resolution = [tuple(r) for r in inference_resolution]
        self.image_scaler = AutomaticShapeSelection(
            *[ResizeToFixedManipulation((r[1], r[0])) for r in self.inference_resolution],
            strategy="closest_aspect",
        )
        self.capture_graphs = True
        self._programs: Dict[tuple, PredictProgram] = {}
        self._programs_generation = None
        self._predict_lock = threading.Lock()
        self._graph_pool = None  # one memory pool for every graph of the model
        self._replay_done: Optional[torch.cuda.Event] = None

    # ``image_scaler`` is settable public API (crop / composite chains replace
    # it); a program must never serve a previous scaler. ``id()`` of the
    # scaler is unsafe as a key (a collected predecessor's id can be reused),
    # so assignment bumps a generation that the key carries instead.
    @property
    def image_scaler(self):
        return self._image_scaler

    @image_scaler.setter
    def image_scaler(self, value) -> None:
        self._image_scaler = value
        self._scaler_generation = getattr(self, "_scaler_generation", -1) + 1

    # ---- subclass interface -------------------------------------------------
    @property
    def data_norm_type(self) -> str:
        raise NotImplementedError

    @property
    def device(self) -> torch.device:
        raise NotImplementedError

    def network_apply(self, img1_bhwc: torch.Tensor, img2_bhwc: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Run the network on normalized channel-last inputs; returns the raw
        output dict (see models/network.py)."""
        raise NotImplementedError

    def _program_key(self) -> tuple:
        """The subclass's settings a program depends on."""
        return ()

    def _storage_generation(self) -> int:
        """A count that changes whenever the parameters' storage moves (a
        captured graph holds their addresses): every program is dropped then."""
        return 0

    # ---- public API ---------------------------------------------------------
    def predict_correspondences_batched(
        self,
        source_image,
        target_image,
        data_norm_type: Optional[str] = None,
    ) -> UFMOutputInterface:
        """Predict dense correspondences between source and target images.

        Accepts numpy arrays or tensors shaped BCHW/BHWC/CHW/HWC, dtype uint8
        or float32 (float inputs must state their ``data_norm_type``). Returns
        fresh tensors on the model's device: flow (B, 2, H, W) in source-image
        pixel space plus covisibility (B, H, W).

        An input in any memory order (channel-last, channel-planar, a
        transposed view) is taken without a host copy: it is staged in its own
        order. Only a numpy array torch cannot view (a negative stride, as
        ``img[..., ::-1]`` has, or one that is no multiple of the item size)
        is copied on the host first; a view that is not dense (a crop) is
        gathered once, by the staging copy. Each memory order at a shape gets
        its own program, so on the card a caller that alternates layouts
        keeps one captured graph and one set of static buffers for each.
        """
        with profiling.span("predict.call", call=True):
            with profiling.span("predict.prepare"):
                src, src_copied = _to_bchw(source_image)
                tgt, tgt_copied = _to_bchw(target_image)

                if src.dtype == torch.float32:
                    if data_norm_type is None:
                        raise ValueError("data_norm_type must be provided for float32 images")
                    if data_norm_type not in IMAGE_NORMALIZATION_DICT:
                        raise ValueError(f"data_norm_type must be one of {list(IMAGE_NORMALIZATION_DICT)}")
                elif src.dtype == torch.uint8:
                    data_norm_type = None
                else:
                    raise ValueError("images must be uint8 or float32")

                device = self.device
                orders = (input_layout.memory_order(src), input_layout.memory_order(tgt))
                program = self._program(src, tgt, orders, data_norm_type, device)
                input_layout.count("host_copy" if copied else "own_order" if order else "gathered"
                                   for copied, order in zip((src_copied, tgt_copied), orders))
            with torch.inference_mode():
                raw = program(self, src, tgt, capture=self.capture_graphs and device.type == "cuda")

            with profiling.span("predict.outputs"):
                result = UFMOutputInterface()
                result.flow = UFMFlowFieldOutput(flow_output=raw["flow"])
                if "flow_covariance" in raw:
                    result.flow.flow_covariance = raw["flow_covariance"]
                if "covisibility" in raw:
                    result.covisibility = UFMMaskFieldOutput(mask=raw["covisibility"], logits=None)
                if "keypoint_confidence" in raw:
                    result.keypoint_confidence = raw["keypoint_confidence"]
            return result

    def _program(self, src: torch.Tensor, tgt: torch.Tensor, orders, data_norm_type: Optional[str],
                 device) -> PredictProgram:
        """The program of the inputs' key; ``orders``: their memory orders
        (``None``: not dense, staged channel-last)."""
        orders = tuple(order or input_layout.CHANNEL_LAST for order in orders)
        key = (
            tuple(src.shape),
            tuple(tgt.shape),
            src.dtype,
            tgt.dtype,
            orders,
            data_norm_type,
            self._scaler_generation,
            *self._program_key(),
            torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision(),
            device,
        )
        with self._predict_lock:
            generation = self._storage_generation()
            if generation != self._programs_generation:
                self._programs = {}
                self._programs_generation = generation
            program = self._programs.get(key)
            if program is None:
                program = PredictProgram(self, src.shape, tgt.shape, src.dtype, tgt.dtype, data_norm_type, device,
                                         orders)
                self._programs[key] = program
        return program
