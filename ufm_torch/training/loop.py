"""Training loop: batches -> train steps -> checkpoints (counterpart of
``ufm_tpu/training/loop.py``).

The network holds its parameters, so :func:`fit` takes the ``UFMNet`` and
trains it in place (with ``mesh``, sharded in place over the mesh: every
rank runs ``fit`` on the same batches, and each takes its shard). Checkpoints
(parameters, optimizer state with the fp32 master weights, step) go through
:mod:`ufm_torch.checkpoint.train_state`, in one format with or without a
mesh, and training resumes from the newest one.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterable, Mapping, Optional

import torch
import torch.distributed as dist
import torch.nn as nn

from ufm_torch.checkpoint.train_state import latest_step, restore_train_state, save_train_state
from ufm_torch.training.trainer import make_optimizer, make_sharded_train_step, make_train_step

__all__ = ["fit"]


def fit(
    net: nn.Module,
    batches: Iterable[Mapping[str, Any]],
    num_steps: int,
    learning_rate: float = 1e-4,
    mesh=None,
    loss_weights: Optional[Dict[str, float]] = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 1000,
    log_every: int = 50,
    log_fn: Callable[[str], None] = print,
    warmup_steps: int = 100,
    on_metrics: Optional[Callable[[int, Dict[str, float]], None]] = None,
) -> Dict[str, Any]:
    """Train ``net`` (a ``UFMNet``) for ``num_steps`` over ``batches`` (dicts
    of numpy arrays or tensors, moved to the net's device).

    With ``mesh`` (a ``("data", "fsdp", "model")`` device mesh,
    :func:`ufm_torch.parallel.make_mesh`) the step is
    :func:`make_sharded_train_step`'s: every rank calls ``fit`` with the
    same global batches, and only rank 0 logs and calls ``on_metrics``.

    Returns {"net" (sharded with a mesh), "optimizer", "step", "metrics": the
    last step's, as tensors}. With ``checkpoint_dir``, resumes from the
    newest saved step and saves every ``checkpoint_every`` steps and at the
    end. ``on_metrics(step, metrics)`` is called at every ``log_every``
    boundary with the step's float metrics; it synchronises the host, like
    logging."""
    opt_kwargs = {"learning_rate": learning_rate, "warmup_steps": warmup_steps, "total_steps": num_steps}
    if mesh is not None:
        step_fn, net, optimizer, place = make_sharded_train_step(net, mesh, loss_weights, **opt_kwargs)
        main = dist.get_rank() == 0
    else:
        optimizer = make_optimizer(net, **opt_kwargs)
        step_fn = make_train_step(net, optimizer, loss_weights)
        device = next(net.parameters()).device
        main = True

        def place(batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
            return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}

    def log(line: str) -> None:
        if main:
            log_fn(line)

    done = 0
    if checkpoint_dir:
        last = latest_step(checkpoint_dir)
        if last is not None:
            restore_train_state(checkpoint_dir, last, net, optimizer)
            done = last
            log(f"resumed from step {last}")

    metrics: Dict[str, torch.Tensor] = {}
    it = iter(batches)
    t0 = time.time()
    start = done
    for step in range(start, num_steps):
        try:
            batch = next(it)
        except StopIteration:
            log(f"data exhausted at step {step}")
            break
        metrics = step_fn(place(batch))
        done = step + 1

        if log_every and done % log_every == 0:
            vals = {k: float(v) for k, v in metrics.items()}
            rate = (done - start) / (time.time() - t0)
            log(f"step {done}/{num_steps} {vals} ({rate:.2f} steps/s)")
            if on_metrics is not None and main:
                on_metrics(done, vals)

        if checkpoint_dir and done % checkpoint_every == 0:
            save_train_state(checkpoint_dir, done, net, optimizer)

    if checkpoint_dir:
        save_train_state(checkpoint_dir, done, net, optimizer)

    return {"net": net, "optimizer": optimizer, "step": done, "metrics": metrics}
