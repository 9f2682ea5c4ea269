"""JAX (flax) parameters -> the port's ``state_dict``.

The port's module tree uses the JAX package's names, so the conversion is a
fixed set of rules on flat ``"a/b/c"`` parameter paths (the port keeps its own
copy of the layout rules of ``ufm_tpu/checkpoint/convert.py``):

- ``kernel`` -> ``weight``: Dense kernels (in, out) are transposed to
  ``Linear``'s (out, in); Conv kernels HWIO become OIHW; the ``ConvTranspose``
  kernels (the DPT head's ``resize_0`` / ``resize_1``, the UNet's ``up_<i>``)
  are HWIO *with a spatial flip* and become ``ConvTranspose2d``'s
  (in, out, H, W). The parent name must match exactly: the UNet's
  ``up_conv_<i>`` is a regular DoubleConv;
- LayerNorm ``scale`` -> ``weight``;
- the transformer stacks store ``blocks/...`` with a leading layer axis;
  each layer becomes ``blocks.<i>...`` of an ``nn.ModuleList``;
- everything else (``bias``, ``gamma``, ``pos_embed``, ``cls_token``,
  ``cls_pos_embed``, ``view_embed``) keeps its name and layout.

Parameters arrive as numpy arrays: the port never imports JAX.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping

import numpy as np
import torch
import torch.nn as nn

__all__ = ["jax_params_to_state_dict", "load_jax_params", "flatten_params"]

_TRANSPOSED_CONV = re.compile(r"resize_[01]|up_\d+")


def flatten_params(params: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested params mapping -> {"a/b/c": array}."""
    flat: Dict[str, np.ndarray] = {}
    for k, v in params.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(flatten_params(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def _leaf(parts: List[str], arr: np.ndarray) -> Dict[str, torch.Tensor]:
    leaf = parts[-1]
    parent = parts[-2] if len(parts) >= 2 else ""
    if leaf == "kernel":
        if arr.ndim == 2:
            arr = arr.T
        elif arr.ndim == 4 and _TRANSPOSED_CONV.fullmatch(parent):
            arr = arr[::-1, ::-1].transpose(2, 3, 0, 1)
        elif arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        else:
            raise ValueError(f"unexpected kernel rank {arr.ndim} at {'/'.join(parts)}")
        parts = parts[:-1] + ["weight"]
    elif leaf == "scale":
        parts = parts[:-1] + ["weight"]
    if arr.dtype.kind != "f" or arr.dtype.itemsize < 4:  # e.g. bfloat16 arrays
        arr = arr.astype(np.float32)
    return {".".join(parts): torch.from_numpy(np.array(arr))}  # a writable copy


def jax_params_to_state_dict(flat_params: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Convert flat flax parameter paths to the port's state_dict (CPU
    tensors)."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in flat_params.items():
        parts = key.split("/")
        arr = np.asarray(value)
        if "blocks" in parts:
            i = parts.index("blocks")
            for layer in range(arr.shape[0]):
                out.update(_leaf(parts[: i + 1] + [str(layer)] + parts[i + 1 :], arr[layer]))
        else:
            out.update(_leaf(parts, arr))
    return out


def load_jax_params(model: nn.Module, params: Mapping[str, Any]) -> None:
    """Load JAX parameters (flat ``"a/b/c"`` paths or a nested mapping, as
    numpy arrays) into ``model``: a ``UniFlowMatch`` (its network), a
    ``UFMNet`` or any of its submodules. Strict: every parameter must match."""
    if not all(isinstance(v, np.ndarray) for v in params.values()):
        params = flatten_params(params)
    target = getattr(model, "net", model)
    target.load_state_dict(jax_params_to_state_dict(params), strict=True)
