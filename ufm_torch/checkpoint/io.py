"""Checkpoint I/O: ``save_pretrained`` / ``load_pretrained`` and torch
checkpoints (counterpart of ``ufm_tpu/checkpoint/io.py``, local directories
only: nothing is downloaded).

A saved directory holds:

- ``config.json``: ``{"model_class": ..., **constructor kwargs}`` (the JAX
  package's schema; the device is not part of it);
- ``model.safetensors``: every parameter of the network in fp32, under the
  torch names that ``ufm_tpu/checkpoint/convert.py::torch_state_dict_to_params``
  reads (the port's ``UFMNet`` names, ``blocks.N`` per layer). fp32 is exact
  for the bf16-stored backbone, and it is what ``safetensors.numpy`` reads.

``load_pretrained`` takes the weights in the JAX package's order:

1. ``params.msgpack``, the JAX package's native format (a flax msgpack
   tree), decoded by the port's own msgpack reader (no ``msgpack`` package
   needed), flax's array extension included, through :func:`load_jax_params`;
2. ``model.safetensors``, read by the port's own reader (no ``safetensors``
   package needed);
3. ``pytorch_model.bin`` (``torch.load``).

Torch-layout weights may carry the reference's names or the JAX package's
canonical ones (:func:`ufm_torch.checkpoint.convert.torch_state_dict_to_port`).
Each tensor is cast to its parameter's dtype and device.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch

from ufm_torch.checkpoint.convert import (
    load_jax_params,
    migrate_unrolled_blocks,
    modify_state_dict,
    torch_state_dict_to_port,
)

__all__ = [
    "save_pretrained",
    "load_pretrained",
    "load_pretrained_ckpt",
    "load_torch_checkpoint_into",
    "load_state_dict_into",
    "read_safetensors",
    "write_safetensors",
    "encode_safetensors",
    "decode_safetensors",
    "read_flax_msgpack",
    "msgpack_decode",
]

CONFIG_NAME = "config.json"
PARAMS_NAME = "params.msgpack"
SAFETENSORS_NAME = "model.safetensors"
BIN_NAME = "pytorch_model.bin"

# The reference's documented drops for Lightning training checkpoints.
_REFERENCE_DROPS = {"feature_matching_proj": None, "encoder.model.mask_token": None}

# ---- safetensors ------------------------------------------------------------
# An 8-byte little-endian header length, a JSON header
# {name: {"dtype", "shape", "data_offsets": [begin, end]}} (offsets into the
# data that follows; an optional "__metadata__" entry of strings), then the
# raw little-endian bytes.
_ST_DTYPES = {
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "U8": torch.uint8,
}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}


def encode_safetensors(tensors: Mapping[str, torch.Tensor], metadata: Optional[Dict[str, str]] = None) -> bytes:
    """``tensors`` (any device; dtypes F32, F16, BF16, I64, I32, U8) as the
    bytes of a safetensors file. Larger items first, so every tensor starts
    aligned to its item size."""
    order = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header: Dict[str, Any] = {"__metadata__": dict(metadata)} if metadata else {}
    blobs, offset = [], 0
    for name in order:
        t = tensors[name].detach()
        if t.dtype not in _ST_NAMES:
            raise ValueError(f"safetensors: {name} has unsupported dtype {t.dtype}")
        raw = t.to("cpu").contiguous().reshape(-1).view(torch.uint8).numpy()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape), "data_offsets": [offset, offset + raw.size]}
        blobs.append(raw)
        offset += raw.size
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    return b"".join([len(head).to_bytes(8, "little"), head, *(memoryview(raw) for raw in blobs)])


def decode_safetensors(data: bytes) -> Dict[str, torch.Tensor]:
    """The tensors of a safetensors file's bytes, as CPU tensors of their
    stored dtypes."""
    n = int.from_bytes(data[:8], "little")
    header = json.loads(data[8 : 8 + n])
    body = bytearray(data[8 + n :])
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _ST_DTYPES:
            raise ValueError(f"safetensors: {name} has unsupported dtype {info['dtype']}")
        dtype = _ST_DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        count = (end - begin) // torch.empty((), dtype=dtype).element_size()
        t = torch.frombuffer(body, dtype=dtype, count=count, offset=begin) if count else torch.empty(0, dtype=dtype)
        out[name] = t.reshape(info["shape"]).clone()
    return out


def write_safetensors(path: str, tensors: Mapping[str, torch.Tensor], metadata: Optional[Dict[str, str]] = None) -> None:
    """Write ``tensors`` as a safetensors file (:func:`encode_safetensors`)."""
    with open(path, "wb") as f:
        f.write(encode_safetensors(tensors, metadata))


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Read a safetensors file into CPU tensors of their stored dtypes."""
    with open(path, "rb") as f:
        return decode_safetensors(f.read())


# ---- flax msgpack -------------------------------------------------------------
# flax.serialization packs an array as msgpack ExtType 1 (a numpy scalar as 3) whose
# payload is msgpack (shape, dtype name, C-order bytes); arrays above 2^30
# bytes are split into {"__msgpack_chunked_array__", "shape", "chunks"} dicts.
# The port decodes the subset of msgpack flax writes itself (no ``msgpack``
# package): nil, bools, ints, floats, strings, binaries, arrays, maps and ext.

_FLAX_NDARRAY, _FLAX_NPSCALAR = 1, 3


class _MsgpackDecoder:
    """One msgpack document in ``buf`` -> Python objects (maps -> dicts,
    arrays -> lists, str -> str, bin -> bytes); ext values go to ``ext``
    (code, payload)."""

    _FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
              0xCA: ">f", 0xCB: ">d"}

    def __init__(self, buf: bytes, ext):
        self.buf = memoryview(buf)
        self.pos = 0
        self.ext = ext

    def _take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError(f"truncated msgpack data: {n} bytes wanted at offset {self.pos} of {len(self.buf)}")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def decode(self) -> Any:
        value = self._value()
        if self.pos != len(self.buf):
            raise ValueError(f"{len(self.buf) - self.pos} bytes of trailing data after the msgpack document")
        return value

    def _value(self) -> Any:
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        if b in self._FIXED:
            return self._unpack(self._FIXED[b])
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self._take(self._unpack(">" + "BHI"[b - 0xC4])))
        if b in (0xD9, 0xDA, 0xDB):
            return self._str(self._unpack(">" + "BHI"[b - 0xD9]))
        if b in (0xDC, 0xDD):
            return self._array(self._unpack(">" + "HI"[b - 0xDC]))
        if b in (0xDE, 0xDF):
            return self._map(self._unpack(">" + "HI"[b - 0xDE]))
        if b in (0xC7, 0xC8, 0xC9):
            n = self._unpack(">" + "BHI"[b - 0xC7])
            return self._ext(n)
        if 0xD4 <= b <= 0xD8:
            return self._ext(1 << (b - 0xD4))
        raise ValueError(f"byte 0x{b:02x} at offset {self.pos - 1} is not a msgpack type flax writes")

    def _str(self, n: int) -> str:
        return str(self._take(n), "utf-8")

    def _array(self, n: int) -> list:
        return [self._value() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self._value()
            out[key] = self._value()
        return out

    def _ext(self, n: int) -> Any:
        code = self._unpack(">b")
        return self.ext(code, bytes(self._take(n)))


def _no_ext(code: int, data: bytes):
    raise ValueError(f"msgpack ext type {code} inside a flax array payload")


def msgpack_decode(buf: bytes, ext=_no_ext) -> Any:
    """Decode one msgpack document (the subset flax writes); ext values are
    passed to ``ext(code, payload)``."""
    return _MsgpackDecoder(buf, ext).decode()


def _flax_array(payload: bytes) -> np.ndarray:
    shape, dtype_name, buf = msgpack_decode(payload)
    name = dtype_name.decode() if isinstance(dtype_name, bytes) else dtype_name
    if name == "bfloat16":  # numpy has no bfloat16: widen it exactly to fp32
        return torch.frombuffer(bytearray(buf), dtype=torch.bfloat16).float().numpy().reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)


def _flax_ext(code: int, data: bytes):
    if code == _FLAX_NDARRAY:
        return _flax_array(data)
    if code == _FLAX_NPSCALAR:
        return _flax_array(data)[()]
    raise ValueError(f"msgpack ext type {code} is not a flax array (1) or numpy scalar (3)")


def _unchunk(node: Any) -> Any:
    if not isinstance(node, dict):
        return node
    if "__msgpack_chunked_array__" in node:
        shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
        chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in node.items()}


def read_flax_msgpack(path: str) -> Dict[str, Any]:
    """A flax msgpack file (``flax.serialization.to_bytes``) -> a nested dict
    of numpy arrays (bf16 arrays widened to fp32), decoded by the port
    (:func:`msgpack_decode`: no ``msgpack`` package needed)."""
    with open(path, "rb") as f:
        tree = msgpack_decode(f.read(), _flax_ext)
    return _unchunk(tree)


# ---- save / load --------------------------------------------------------------


def _json_default(o):
    if isinstance(o, (np.integer, np.floating)):
        return o.item()
    raise TypeError(f"not JSON-serializable: {type(o)}")


def _constructor_kwargs(model) -> Dict[str, Any]:
    cfg = model.config.to_dict()
    cfg["inference_resolution"] = [list(r) for r in model.inference_resolution]
    return cfg


def save_pretrained(model, save_directory: str) -> None:
    """Write ``config.json`` and ``model.safetensors`` (every parameter in
    fp32) into ``save_directory``."""
    os.makedirs(save_directory, exist_ok=True)
    payload = {"model_class": type(model).__name__, **_constructor_kwargs(model)}
    with open(os.path.join(save_directory, CONFIG_NAME), "w") as f:
        json.dump(payload, f, indent=2, default=_json_default)
    state = {k: v.float() for k, v in model.net.state_dict().items()}
    write_safetensors(os.path.join(save_directory, SAFETENSORS_NAME), state, metadata={"format": "pt"})


def _strip_non_constructor_keys(config: Mapping[str, Any]) -> Dict[str, Any]:
    config = dict(config)
    config.pop("model_class", None)
    # HF-style extras the reference's mixin writes
    for k in ("_name_or_path", "transformers_version", "architectures", "torch_dtype"):
        config.pop(k, None)
    return config


def _build_from_config(cls, config: Mapping[str, Any], device: Union[None, str, torch.device]):
    cfg = _strip_non_constructor_keys(config)
    for internal in ("has_uncertainty_head", "has_classification_head"):
        cfg.pop(internal, None)
    return cls(**cfg, device=device)


def load_pretrained(cls, path: str, device: Union[None, str, torch.device] = None):
    """Build ``cls`` from a local directory (``config.json`` plus weights) on
    ``device`` (default: the GPU)."""
    if not os.path.isdir(path):
        raise FileNotFoundError(
            f"'{path}' is not a local directory: ufm_torch loads local checkpoints only "
            "(download the repository on a connected machine and pass its path)"
        )
    with open(os.path.join(path, CONFIG_NAME)) as f:
        config = json.load(f)
    model = _build_from_config(cls, config, device)

    params_path = os.path.join(path, PARAMS_NAME)
    if os.path.exists(params_path):
        # checkpoints saved before the scan-over-layers layout load too
        load_jax_params(model, migrate_unrolled_blocks(read_flax_msgpack(params_path)))
        return model
    st_path = os.path.join(path, SAFETENSORS_NAME)
    if os.path.exists(st_path):
        load_state_dict_into(model, read_safetensors(st_path))
        return model
    bin_path = os.path.join(path, BIN_NAME)
    if os.path.exists(bin_path):
        load_state_dict_into(model, torch.load(bin_path, map_location="cpu", weights_only=True))
        return model
    raise FileNotFoundError(f"no weights found in {path} ({PARAMS_NAME}, {SAFETENSORS_NAME}, {BIN_NAME})")


def load_pretrained_ckpt(cls, path: str, strict: bool = True, device: Union[None, str, torch.device] = None):
    """A torch checkpoint with embedded ``model_args`` (the constructor
    kwargs) and ``model`` (the state dict). It is unpickled: load trusted
    files only."""
    if not os.path.isfile(path):
        raise ValueError(f"Pretrained model {path} not found.")
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    model = _build_from_config(cls, ckpt["model_args"], device)
    if not strict:  # parameters the checkpoint lacks keep the seeded init
        model.init_params()
    load_state_dict_into(model, ckpt["model"], strict=strict)
    return model


def load_torch_checkpoint_into(model, path: str) -> None:
    """The constructor's ``pretrained_checkpoint_path``: a Lightning
    checkpoint (``state_dict`` with ``model.`` prefixes) loads strictly after
    the prefix is stripped and the reference's documented keys are dropped;
    any other (``model``) loads what it holds."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if "state_dict" in ckpt:
        sd = {k[6:]: v for k, v in ckpt["state_dict"].items() if k.startswith("model.")}
        load_state_dict_into(model, modify_state_dict(sd, _REFERENCE_DROPS), strict=True)
    else:
        load_state_dict_into(model, ckpt["model"], strict=False)


@torch.no_grad()
def load_state_dict_into(model, state_dict: Mapping[str, Any], strict: bool = True) -> None:
    """Copy a torch-layout state dict into ``model``'s network (a model or a
    ``UFMNet``), each tensor cast to its parameter's dtype and device. With
    ``strict`` a missing or unexpected key raises ``KeyError``; a shape
    mismatch always raises ``ValueError`` naming the parameter."""
    loaded = torch_state_dict_to_port(state_dict)
    target = getattr(model, "net", model).state_dict()
    missing = [k for k in target if k not in loaded]
    unexpected = [k for k in loaded if k not in target]
    if strict and (missing or unexpected):
        raise KeyError(f"state dict mismatch: missing {missing[:5]}, unexpected {unexpected[:5]}")
    for name, t in target.items():
        if name not in loaded:
            continue
        v = loaded[name]
        if tuple(v.shape) != tuple(t.shape):
            raise ValueError(f"shape mismatch at {name}: checkpoint {tuple(v.shape)} vs model {tuple(t.shape)}")
        t.copy_(v.to(dtype=t.dtype))
