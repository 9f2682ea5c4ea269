"""Training checkpoints: save and resume a train state with ``torch.save``.

Counterpart of ``ufm_tpu/checkpoint/orbax_io.py``. A train state is the
network's ``state_dict``, the optimizer's (AdamW moments, schedule position
and fp32 master weights) and the step. Each saved step is one directory
``<directory>/<step>/`` holding ``train_state.pt``, written to a temporary
file first and renamed, so a directory without that file is no checkpoint.
The newest ``max_to_keep`` steps are kept.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, List, Optional

import torch
import torch.nn as nn

__all__ = ["save_train_state", "restore_train_state", "latest_step"]

_FILE = "train_state.pt"


def _steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(
        int(name)
        for name in os.listdir(directory)
        if name.isdigit() and os.path.isfile(os.path.join(directory, name, _FILE))
    )


def save_train_state(
    directory: str,
    step: int,
    net: nn.Module,
    optimizer: Any = None,
    max_to_keep: int = 3,
) -> str:
    """Save ``net``'s parameters and ``optimizer``'s state (anything with a
    ``state_dict()``) at ``step`` under ``directory``; drop the oldest steps
    beyond ``max_to_keep``. Returns the file written."""
    step_dir = os.path.join(os.path.abspath(directory), str(int(step)))
    os.makedirs(step_dir, exist_ok=True)
    state = {"step": int(step), "model": net.state_dict()}
    if optimizer is not None:
        state["optimizer"] = optimizer.state_dict()
    path = os.path.join(step_dir, _FILE)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    for old in _steps(directory)[:-max_to_keep]:
        shutil.rmtree(os.path.join(os.path.abspath(directory), str(old)))
    return path


def latest_step(directory: str) -> Optional[int]:
    """The newest saved step under ``directory``, or None."""
    steps = _steps(os.path.abspath(directory))
    return steps[-1] if steps else None


def restore_train_state(
    directory: str,
    step: Optional[int] = None,
    net: Optional[nn.Module] = None,
    optimizer: Any = None,
) -> Dict[str, Any]:
    """Load the train state of ``step`` (default: the newest) and, when given,
    load it into ``net`` (strict) and ``optimizer``. Tensors land on the
    device of the net's parameters (the CPU without a net). Returns the
    state."""
    directory = os.path.abspath(directory)
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    device = next(net.parameters()).device if net is not None else torch.device("cpu")
    state = torch.load(os.path.join(directory, str(int(step)), _FILE), map_location=device, weights_only=True)
    if net is not None:
        net.load_state_dict(state["model"], strict=True)
    if optimizer is not None:
        optimizer.load_state_dict(state["optimizer"])
    return state
