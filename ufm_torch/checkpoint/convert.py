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

Torch-layout state dicts (the reference's names, or the canonical names the
JAX package exports and reads, ``ufm_tpu/checkpoint/convert.py``) need names
only: :func:`torch_state_dict_to_port` rewrites reference names and the JAX
package's ``blocks_N`` into the port's (:func:`canonicalize_reference_names`)
and splits a DINOv2 ``pos_embed`` that carries the cls position.
:func:`modify_state_dict` is the reference's key surgery (drops and renames
by substring), which Lightning checkpoints get. Flax trees saved before
the scan-over-layers layout (per-layer ``blocks_N`` subtrees) are stacked by
:func:`migrate_unrolled_blocks` before :func:`load_jax_params`.

Parameters arrive as numpy arrays: the port never imports JAX.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

__all__ = [
    "jax_params_to_state_dict",
    "load_jax_params",
    "flatten_params",
    "modify_state_dict",
    "canonicalize_reference_names",
    "torch_state_dict_to_port",
    "migrate_unrolled_blocks",
]

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


def modify_state_dict(original_state_dict: Mapping[str, Any], mappings: Mapping[str, Optional[str]]) -> Dict[str, Any]:
    """Key surgery: ``{old_substr: new_substr_or_None}``, None drops the key.
    The first matching rule wins (the reference's semantics)."""
    out = {}
    for k, v in original_state_dict.items():
        new_key, skip = k, False
        for old, new in mappings.items():
            if old in k:
                if new is None:
                    skip = True
                else:
                    new_key = k.replace(old, new)
                break
        if not skip:
            out[new_key] = v
    return out


# Renames from the reference's torch names, and from the JAX package's
# canonical export, to the port's module tree:
# - the encoder wraps a timm / DINOv2 model as ``encoder.model.*``;
# - reference heads are Sequential(Sequential(DPTFeature, DPTProcessor),
#   AdaptorMap): ``head1.0.0.*`` / ``head1.0.1.*``;
# - the JAX package names transformer layers ``blocks_N``, the port (like
#   the reference) ``blocks.N``;
# - torch PatchEmbed has an inner ``.proj`` conv, the port's is the conv;
# - the reference UNet's DoubleConv wraps its convs in a Sequential ``conv``
#   (indices 0 / 2; 1 / 3 are ReLUs), and its output conv is ``final_conv``.
_REFERENCE_NAME_RULES: Tuple[Tuple[str, str], ...] = (
    (r"^encoder\.model\.", "encoder."),
    (r"^head1\.0\.0\.", "head1.feature."),
    (r"^head1\.0\.1\.", "head1.processor."),
    (r"^uncertainty_head\.0\.0\.", "uncertainty_head.feature."),
    (r"^uncertainty_head\.0\.1\.", "uncertainty_head.processor."),
    (r"\.blocks_(\d+)\.", r".blocks.\1."),
    (r"\.patch_embed\.proj\.", ".patch_embed."),
    (r"\.downs\.(\d+)\.", r".down_\1."),
    (r"\.conv\.0\.", ".conv1."),
    (r"\.conv\.2\.", ".conv2."),
    (r"\.final_conv\.", ".final."),
)


def _unet_up(m: "re.Match") -> str:
    # the reference UNet interleaves ConvTranspose and DoubleConv in one list:
    # ups.{2k} -> up_{k}, ups.{2k+1} -> up_conv_{k}
    i = int(m.group(1))
    return f".up_{i // 2}." if i % 2 == 0 else f".up_conv_{i // 2}."


def canonicalize_reference_names(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """Rewrite reference-layout and JAX-canonical torch keys into the port's
    names; the port's own names pass through unchanged."""
    out = {}
    for k, v in state_dict.items():
        for pat, rep in _REFERENCE_NAME_RULES:
            k = re.sub(pat, rep, k)
        out[re.sub(r"\.ups\.(\d+)\.", _unet_up, k)] = v
    return out


def _split_cls_pos_embed(sd: Dict[str, Any]) -> Dict[str, Any]:
    """DINOv2 checkpoints store one (1, 1 + G^2, C) ``pos_embed`` holding the
    cls position; the port keeps the (1, G^2, C) grid and ``cls_pos_embed``
    apart."""
    key = "encoder.pos_embed"
    pe = sd.get(key)
    if pe is not None and pe.ndim == 3:
        n = pe.shape[1]
        g, g1 = int(round(n**0.5)), int(round((n - 1) ** 0.5))
        if g * g != n and g1 * g1 == n - 1:
            sd = dict(sd)
            sd["encoder.cls_pos_embed"] = pe[:, :1]
            sd[key] = pe[:, 1:]
    return sd


def _as_tensor(v: Any) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))


def torch_state_dict_to_port(state_dict: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A torch-layout state dict (tensors or numpy arrays; reference names,
    the JAX package's canonical names or the port's) -> the port's
    ``UFMNet`` names. Layouts are torch's already: only names change."""
    sd = {k: _as_tensor(v) for k, v in state_dict.items()}
    return _split_cls_pos_embed(canonicalize_reference_names(sd))


def _stack_trees(trees: List[Any]) -> Any:
    if isinstance(trees[0], Mapping):
        return {k: _stack_trees([t[k] for t in trees]) for k in trees[0]}
    return np.stack([np.asarray(t) for t in trees])


def migrate_unrolled_blocks(tree: Any) -> Any:
    """A flax params tree saved before the scan-over-layers layout (per-layer
    ``blocks_N`` subtrees) -> the scanned layout (one ``blocks`` subtree with
    a leading layer axis), in numpy. Scanned trees pass through unchanged."""
    if not isinstance(tree, Mapping):
        return tree
    tree = {k: migrate_unrolled_blocks(v) for k, v in tree.items()}
    layer_keys = sorted((k for k in tree if re.fullmatch(r"blocks_\d+", k)), key=lambda s: int(s.split("_")[1]))
    if layer_keys and "blocks" not in tree:
        tree["blocks"] = _stack_trees([tree.pop(k) for k in layer_keys])
    return tree
