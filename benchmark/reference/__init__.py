"""The plain PyTorch references that decide ``correct``; none imports anything of the system under test.

A configuration file (``benchmark/configs/<name>.json``) names its reference
by a top-level ``"reference": "<module>"``: the module
``benchmark/reference/<module>.py``. Without the key it is ``ufm``
(:data:`DEFAULT`). :func:`load` returns the module, and refuses (raises
:class:`Refused`) an unknown name or a module that lacks any part of the
contract below, before anything is built.

The contract. A reference module provides:

- ``Arch(model_cfg)``: the sizes of one configuration, read from the
  configuration file's ``model`` dict, refusing (``ValueError``) a key it
  does not model. A class the module defines itself (a module that shares
  ``ufm``'s reading subclasses ``ufm.Arch``): the harness finds a run's
  module by the class of its arch (:func:`module_of`). An instance carries
  what the harness and the yardstick read:

  - ``model_hw``: the model's (height, width);
  - ``compute_dtype``: ``"bfloat16"``, ``"float16"`` or ``"float32"``, the
    type the backbone's parameters are served in;
  - ``enc``: the encoder's ``patch_size``, ``embed_dim``, ``depth``,
    ``num_heads`` and ``mlp_ratio``;
  - ``info``: the info sharing's ``dim``, ``depth``, ``num_heads`` and
    ``mlp_ratio``;
  - ``encoder_tokens(hp, wp)``: the encoder's tokens for an image of
    ``hp x wp`` patches;
  - where ``forward`` returns ``regression_flow`` (a window refinement):
    ``patch``, the window's width, and ``cls_head["output_dim"]``, the
    refinement features' channels.

- ``param_specs(arch)``: every parameter, ``name -> (shape, part)``, named as
  the system's network names it and in the order of the one draw
  (``harness/inputs.py``); ``part`` is ``"backbone"`` (held in
  ``compute_dtype``) or ``"heads"`` (held in float32).
- ``forward(P, arch, img1, img2, nm=FP32)``: the network on two normalised
  (B, H, W, 3) views at ``model_hw``, a dict of outputs named as the
  system's network names them (what ``reference/train.py``'s loss reads).
- ``predict(P, arch, src_u8, tgt_u8, nm=FP32, raw=None)``: the predict
  pipeline on two (B, H0, W0, 3) uint8 batches: ``flow`` (B, 2, H0, W0) and,
  as present, ``flow_covariance``, ``covisibility`` and
  ``keypoint_confidence``; ``raw``, when given, receives ``forward``'s
  outputs.
- ``Numerics``, how products are computed; ``FP32``, float32 throughout (the
  reference, run with TF32 off); ``CONTROL``, one precision step below what
  its configurations state (the control that the comparison must fail).

A module for a new architecture may import the pieces of ``ufm`` that it
shares (``share``, ``dpt``, ``adapt``, ``unet``, ``window_refine``, ...); it
never edits them.
"""

from __future__ import annotations

import importlib
import re
import sys
from types import ModuleType

__all__ = ["DEFAULT", "Refused", "load", "module_of"]

DEFAULT = "ufm"
_NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]{0,63}$")
_MODULE_PARTS = ("Arch", "param_specs", "forward", "predict", "Numerics", "FP32", "CONTROL")
_ARCH_PARTS = ("model_hw", "compute_dtype", "enc", "info", "encoder_tokens")


class Refused(ValueError):
    """A configuration's reference is unknown or breaks the contract."""


def load(config: dict) -> ModuleType:
    """The reference module that ``config`` (a configuration file's dict)
    names, checked against the contract on its own ``model``."""
    name = config.get("reference", DEFAULT)
    if not isinstance(name, str) or not _NAME.match(name):
        raise Refused(f"reference {name!r} is not a module name")
    path = f"{__name__}.{name}"
    try:
        module = importlib.import_module(path)
    except ModuleNotFoundError as exc:
        if exc.name != path:
            raise
        raise Refused(f"no reference module benchmark/reference/{name}.py") from None
    missing = [k for k in _MODULE_PARTS if not hasattr(module, k)]
    if missing:
        raise Refused(f"reference {name!r} lacks {', '.join(missing)}")
    if sys.modules.get(module.Arch.__module__) is not module:
        raise Refused(f"reference {name!r}: Arch is {module.Arch.__module__}'s class, not the module's own")
    try:
        arch = module.Arch(config["model"])
    except ValueError as exc:
        raise Refused(f"reference {name!r} does not model this configuration: {exc}") from None
    missing = [k for k in _ARCH_PARTS if not hasattr(arch, k)]
    if missing:
        raise Refused(f"reference {name!r}: its Arch lacks {', '.join(missing)}")
    return module


def module_of(arch) -> ModuleType:
    """The reference module whose ``Arch`` built ``arch``."""
    return sys.modules[type(arch).__module__]
