"""Deployment artifacts: the network as a ``torch.export`` program
(counterpart of ``ufm_tpu/runtime/export.py``).

An artifact is one file (suffix :data:`ARTIFACT_SUFFIX`), a zip of:

    manifest.json       model class, config, batch, resolution, versions
    program.pt2         ``torch.export.save`` of the network forward
    params.safetensors  the parameters (the port's own safetensors writer)

The program is fixed-shape: it takes the parameters and two normalized
float32 ``(batch, H, W, 3)`` images at the model's resolution and returns
the raw output dict of ``UFMNet.forward``. Parameters are call arguments,
not constants (the program is traced through ``torch.func.functional_call``
with them as inputs), so the program file stays megabytes and swapping
``params.safetensors`` serves other weights through the same program. The
kernels are dispatcher ops (:mod:`ufm_torch.ops.library`), so the graph holds
the ops, and the device the program runs on picks each one's
implementation: an artifact exported on the CPU launches the Hopper kernels
once :func:`load_exported` has moved it to the card. UFM-Refine is one
program: the JAX package's staged backbone / tail split was a TPU compiler
workaround.

:func:`load_artifact_model` wraps a loaded program in the full predict API
(:class:`ArtifactUFM`, built lazily so that importing ``ufm_torch.runtime``
imports no model code).
"""

from __future__ import annotations

import io
import json
import zipfile
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn as nn

import ufm_torch
from ufm_torch.checkpoint.io import decode_safetensors, encode_safetensors
from ufm_torch.ops import library

__all__ = [
    "export_model",
    "load_exported",
    "load_artifact_model",
    "ExportedUFM",
    "ArtifactUFM",
    "ARTIFACT_SUFFIX",
]

ARTIFACT_SUFFIX = ".ufmt"
_ARTIFACT_VERSION = 1
_MANIFEST, _PROGRAM, _PARAMS = "manifest.json", "program.pt2", "params.safetensors"
_HALF = {"bfloat16": torch.bfloat16, "float16": torch.float16}


class _Forward(nn.Module):
    """``net``'s forward with its parameters as call arguments. The network
    is held outside the module tree, so the export lifts no state of it."""

    def __init__(self, net: nn.Module):
        super().__init__()
        self._net = [net]

    def forward(self, params: Dict[str, torch.Tensor], img1: torch.Tensor, img2: torch.Tensor):
        return torch.func.functional_call(self._net[0], params, (img1, img2))


def export_model(model, path: str, batch: int = 1, params_dtype: Optional[str] = None) -> Dict[str, Any]:
    """Write ``model``'s network forward, traced on the model's device at
    ``batch`` and its first inference resolution, to an artifact at ``path``.

    ``params_dtype``: ``None`` stores each parameter in its own dtype (the
    program's answers are the live model's); ``"bfloat16"`` / ``"float16"``
    store floating parameters in half precision, cast back on load (the
    program is unchanged, only the weights round-trip). Returns the
    manifest."""
    if params_dtype is not None and params_dtype not in _HALF:
        raise ValueError(f"params_dtype must be None, 'bfloat16' or 'float16', got {params_dtype!r}")
    if batch < 1:
        raise ValueError(f"batch must be at least 1, got {batch}")
    net = model.net
    w, h = model.inference_resolution[0]
    params = {name: p.detach() for name, p in net.named_parameters()}
    # two tensors: an input passed twice would be traced as one
    images = tuple(torch.zeros((batch, h, w, 3), device=model.device) for _ in range(2))
    with torch.no_grad():
        program = torch.export.export(_Forward(net), (params, *images), strict=False)
    program.example_inputs = None  # they hold the parameters: the program file must not
    buf = io.BytesIO()
    torch.export.save(program, buf)
    program_bytes = buf.getvalue()

    stored = {
        name: p.to(_HALF[params_dtype]) if params_dtype is not None and p.is_floating_point() else p
        for name, p in params.items()
    }
    manifest = {
        "artifact_version": _ARTIFACT_VERSION,
        "model_class": type(model).__name__,
        "config": model.config.to_dict(),
        "staged": False,
        "staged_note": "one program for every variant: the staged backbone / tail split was a TPU workaround",
        "batch": batch,
        "resolution_wh": [w, h],
        "data_norm_type": model.data_norm_type,
        "param_names": list(params),
        "param_dtypes": [str(p.dtype).replace("torch.", "") for p in params.values()],
        "n_params": len(params),
        "param_bytes": sum(p.numel() * p.element_size() for p in params.values()),
        "stored_param_bytes": sum(t.numel() * t.element_size() for t in stored.values()),
        "program_bytes": len(program_bytes),
        "params_dtype": params_dtype,
        "devices": [str(model.device)],
        "ops": sorted({str(n.target) for n in program.graph.nodes if n.target in library.OPS}),
        "torch_version": torch.__version__,
        "ufm_torch_version": ufm_torch.__version__,
    }
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_STORED) as z:
        z.writestr(_MANIFEST, json.dumps(manifest, indent=1))
        z.writestr(_PROGRAM, program_bytes)
        z.writestr(_PARAMS, encode_safetensors(stored))
    return manifest


class ExportedUFM:
    """A loaded artifact: the raw network forward at a fixed shape.

    ``__call__(img1, img2)`` takes normalized float32 ``(batch, H, W, 3)``
    images on the artifact's device and returns the raw output dict of
    ``UFMNet.forward``. ``params`` are the program's parameter arguments."""

    def __init__(self, manifest: Dict[str, Any], program, params: Dict[str, torch.Tensor], device: torch.device):
        self.manifest = manifest
        self.program = program
        self.params = params
        self.device = device
        self._run = program.module()

    @property
    def batch(self) -> int:
        return int(self.manifest["batch"])

    @property
    def resolution_wh(self) -> Tuple[int, int]:
        w, h = self.manifest["resolution_wh"]
        return int(w), int(h)

    def __call__(self, img1: torch.Tensor, img2: torch.Tensor) -> Dict[str, torch.Tensor]:
        w, h = self.resolution_wh
        expect = (self.batch, h, w, 3)
        if tuple(img1.shape) != expect or tuple(img2.shape) != expect:
            raise ValueError(
                f"exported program is fixed-shape: expected images {expect}, "
                f"got {tuple(img1.shape)} / {tuple(img2.shape)}"
            )
        return self._run(self.params, img1, img2)


def load_exported(path: str, device: Union[None, str, torch.device] = None) -> ExportedUFM:
    """Load an artifact written by :func:`export_model` onto ``device``
    (default: the GPU). A program exported on another device is moved
    (``torch.export.passes.move_to_device_pass``); the parameters are cast
    back to their dtypes."""
    from torch.export.passes import move_to_device_pass

    from ufm_torch.models.ufm import resolve_device

    dev = resolve_device(device)
    with zipfile.ZipFile(path) as z:
        manifest = json.loads(z.read(_MANIFEST))
        if manifest.get("artifact_version") != _ARTIFACT_VERSION:
            raise ValueError(
                f"unsupported artifact version {manifest.get('artifact_version')!r} "
                f"(this build reads version {_ARTIFACT_VERSION})"
            )
        program = torch.export.load(io.BytesIO(z.read(_PROGRAM)))
        stored = decode_safetensors(z.read(_PARAMS))
    if not _same_device(torch.device(manifest["devices"][0]), dev):
        program = move_to_device_pass(program, dev)
    dtypes = dict(zip(manifest["param_names"], manifest["param_dtypes"]))
    params = {name: stored[name].to(device=dev, dtype=getattr(torch, dtypes[name])) for name in manifest["param_names"]}
    return ExportedUFM(manifest, program, params, dev)


def _same_device(a: torch.device, b: torch.device) -> bool:
    """Whether ``a`` and ``b`` name one device (``cuda`` is ``cuda:0``)."""
    return a.type == b.type and (a.index or 0) == (b.index or 0)


_ARTIFACT_MODEL_CLS = None


def _artifact_model_cls():
    """``ArtifactUFM``, built on first use: its base class is the model
    package's."""
    global _ARTIFACT_MODEL_CLS
    if _ARTIFACT_MODEL_CLS is not None:
        return _ARTIFACT_MODEL_CLS

    from ufm_torch.models.base import UniFlowMatchModelsBase, _to_bchw

    class ArtifactUFM(UniFlowMatchModelsBase):
        """An artifact in the full predict API: ``predict_correspondences_batched``
        normalizes, resizes to the artifact's resolution, runs the program,
        unmaps and rescales the covariance, as the live model does (on the
        card through one captured predict program per key). Inputs must have
        the artifact's batch; any resolution is taken."""

        def __init__(self, exported: ExportedUFM):
            super().__init__(inference_resolution=[exported.resolution_wh])
            self.exported = exported
            self.manifest = exported.manifest

        @property
        def data_norm_type(self) -> str:
            return self.manifest["data_norm_type"]

        @property
        def device(self) -> torch.device:
            return self.exported.device

        def network_apply(self, img1_bhwc: torch.Tensor, img2_bhwc: torch.Tensor) -> Dict[str, torch.Tensor]:
            return self.exported(img1_bhwc, img2_bhwc)

        def predict_correspondences_batched(self, source_image, target_image, data_norm_type=None):
            b = _to_bchw(source_image)[0].shape[0]
            if b != self.exported.batch:
                raise ValueError(
                    f"artifact was exported at fixed batch {self.exported.batch}; "
                    f"got batch {b} (re-export with --batch {b})"
                )
            return super().predict_correspondences_batched(source_image, target_image, data_norm_type=data_norm_type)

    _ARTIFACT_MODEL_CLS = ArtifactUFM
    return ArtifactUFM


def __getattr__(name: str):
    if name == "ArtifactUFM":
        return _artifact_model_cls()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def load_artifact_model(path: str, device: Union[None, str, torch.device] = None):
    """Load an artifact as an :class:`ArtifactUFM` on ``device`` (default:
    the GPU)."""
    return _artifact_model_cls()(load_exported(path, device))
