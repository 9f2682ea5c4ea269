"""Training checkpoints: save and resume a train state with ``torch.save``.

Counterpart of ``ufm_tpu/checkpoint/orbax_io.py``. A train state is the
network's ``state_dict``, the optimizer's (AdamW moments, schedule position
and fp32 master weights) and the step. Each saved step is one directory
``<directory>/<step>/`` holding ``train_state.pt``, written to a temporary
file first and renamed, so a directory without that file is no checkpoint.
The newest ``max_to_keep`` steps are kept.

A sharded net (:func:`ufm_torch.parallel.shard_params`, parameters and
optimizer states as DTensors) saves the same file: every rank gathers the
whole state in the unsharded layout and rank 0 writes it. Restoring into a
sharded net lays each tensor out like the rank's own shard. So a sharded run
resumes a single-device checkpoint, and the reverse.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist
import torch.nn as nn
from torch.distributed.tensor import DTensor

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


def _is_sharded(net: nn.Module) -> bool:
    return any(isinstance(p, DTensor) for p in net.parameters())


def _map_state(net: nn.Module, optimizer: Any, model: Dict[str, Any], opt: Optional[Dict[str, Any]],
               fn: Callable[[torch.Tensor, str, Optional[torch.Tensor]], torch.Tensor]):
    """Apply ``fn(tensor, parameter name, the optimizer's tensor of that
    parameter or None)`` to every tensor of a train state, in the same order
    on every rank: the model's entries, then each optimizer index's moments
    and master (the ``MasterWeightAdamW`` layout; scalars such as AdamW's
    step count are left alone)."""
    model = {k: fn(v, k, None) for k, v in model.items()}
    if opt is None:
        return model, None
    names = {id(p): n for n, p in net.named_parameters()}
    pairs = [pair for _, _, group in optimizer.groups for pair in group]
    stepped = [p if m is None else m for p, m in pairs]
    opt = dict(opt, adamw=dict(opt["adamw"]))
    opt["adamw"]["state"] = {
        i: {k: fn(v, names[id(pairs[i][0])], stepped[i]) if torch.is_tensor(v) and v.dim() > 0 else v
            for k, v in st.items()}
        for i, st in opt["adamw"]["state"].items()
    }
    opt["masters"] = {i: fn(m, names[id(pairs[i][0])], pairs[i][1]) for i, m in opt["masters"].items()}
    return model, opt


def save_train_state(
    directory: str,
    step: int,
    net: nn.Module,
    optimizer: Any = None,
    max_to_keep: int = 3,
) -> str:
    """Save ``net``'s parameters and ``optimizer``'s state (anything with a
    ``state_dict()``) at ``step`` under ``directory``; drop the oldest steps
    beyond ``max_to_keep``. Returns the file written. For a sharded net every
    rank calls this; rank 0 writes the gathered state."""
    step_dir = os.path.join(os.path.abspath(directory), str(int(step)))
    path = os.path.join(step_dir, _FILE)
    model = net.state_dict()
    opt = optimizer.state_dict() if optimizer is not None else None
    sharded = _is_sharded(net)
    if sharded:
        from ufm_torch.parallel.sharding import qkv_permutations, unshard

        perms = qkv_permutations(net)
        model, opt = _map_state(net, optimizer, model, opt, lambda t, name, _: unshard(t, perms.get(name)))
    if not sharded or dist.get_rank() == 0:
        os.makedirs(step_dir, exist_ok=True)
        state = {"step": int(step), "model": model}
        if opt is not None:
            state["optimizer"] = opt
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(state, tmp)
        os.replace(tmp, path)
        for old in _steps(directory)[:-max_to_keep]:
            shutil.rmtree(os.path.join(os.path.abspath(directory), str(old)))
    if sharded:
        dist.barrier()  # the file exists on every rank's return
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
    device of the net's parameters (the CPU without a net), and into a
    sharded net as each rank's shards. Returns the state."""
    directory = os.path.abspath(directory)
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    device = next(net.parameters()).device if net is not None else torch.device("cpu")
    state = torch.load(os.path.join(directory, str(int(step)), _FILE), map_location=device, weights_only=True)
    if net is not None and _is_sharded(net):
        from ufm_torch.parallel.sharding import qkv_permutations, reshard

        perms = qkv_permutations(net)
        own = net.state_dict()
        if set(own) != set(state["model"]):
            raise KeyError(f"train state and net differ in {sorted(set(own) ^ set(state['model']))}")
        model, opt = _map_state(
            net, optimizer, state["model"], state.get("optimizer") if optimizer is not None else None,
            lambda t, name, like: reshard(t, own[name] if like is None else like, perms.get(name)),
        )
        net.load_state_dict(model, strict=True)
        if optimizer is not None:
            optimizer.load_state_dict(opt)
        return state
    if net is not None:
        net.load_state_dict(state["model"], strict=True)
    if optimizer is not None:
        optimizer.load_state_dict(state["optimizer"])
    return state
