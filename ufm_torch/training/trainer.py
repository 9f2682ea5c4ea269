"""Optimizer and train step for the UFM family (counterpart of
``ufm_tpu/training/trainer.py``).

- :func:`make_optimizer`: AdamW with one parameter group per label of the
  reference's parameter groups (encoder / info_sharing / output_head / ...),
  each with its learning-rate scale on a warmup-cosine schedule and its own
  gradient clip at global norm 1.0: the arithmetic of the JAX package's
  ``optax.multi_transform`` of ``chain(clip_by_global_norm(1.0), adamw(...))``.
- fp32 master weights. The port stores the backbone's parameters in bf16
  (the compute dtype); the JAX package stores every parameter in fp32 and
  casts at each use. An AdamW step moves an encoder weight by about 1e-5
  (learning rate 0.1 x 1e-4) where a bf16 weight of ~0.03 has a spacing of
  1.2e-4, so updates applied to the bf16 values would all round away. The
  optimizer therefore keeps an fp32 master of every parameter that is not
  fp32, steps AdamW on the masters and writes them back, rounded to nearest
  even, into the bf16 parameters the forward uses. This is the JAX
  package's arithmetic: the forward sees the same rounded weights, and a
  bf16 weight gradient cast to fp32 is what flax's cast gives in the VJP.
- :func:`make_train_step`: forward, :func:`ufm_total_loss`, backward, step.
- :func:`make_sharded_train_step`: the same step over a ``("data", "fsdp",
  "model")`` device mesh (:mod:`ufm_torch.parallel`): tensor parallelism on
  ``model``, FSDP2 on ``("data", "fsdp")``, the batch split on ``data``, the
  loss's masked means over the global batch, each group clipped at its
  global norm over every shard. The masters and AdamW's moments are sharded
  like their parameters; the optimizer and its state format are the
  single-device ones.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
from torch.distributed.tensor import DTensor

from ufm_torch.training.losses import ufm_total_loss
from ufm_torch.utils import profiling

__all__ = [
    "make_optimizer",
    "make_train_step",
    "make_sharded_train_step",
    "synthetic_batch",
    "warmup_cosine_decay",
    "group_of",
    "MasterWeightAdamW",
    "GROUP_LR_SCALE",
]

# top-level child of UFMNet -> parameter group (the port's copy of
# ufm_tpu/training/trainer.py::_GROUP_OF_TOP_KEY); anything else is "output_head"
_GROUP_OF_TOP_KEY = {
    "encoder": "encoder",
    "info_sharing": "info_sharing",
    "head1": "output_head",
    "uncertainty_head": "uncertainty_head",
    "classification_head": "classification_head",
    "unet_feature": "unet_feature",
    "conv1": "unet_feature",
    "conv2": "unet_feature",
    "classification_bias": "classification_head",
}

# learning-rate scale of each group, in the JAX package's order
GROUP_LR_SCALE = {
    "encoder": 0.1,
    "info_sharing": 1.0,
    "output_head": 1.0,
    "uncertainty_head": 1.0,
    "classification_head": 1.0,
    "unet_feature": 1.0,
}

# each group's gradient is clipped at this global norm
MAX_GRAD_NORM = 1.0


def group_of(param_name: str) -> str:
    """The parameter group of a ``UFMNet`` parameter name."""
    return _GROUP_OF_TOP_KEY.get(param_name.split(".")[0], "output_head")


def warmup_cosine_decay(step: int, peak_value: float, warmup_steps: int, total_steps: int) -> float:
    """``optax.warmup_cosine_decay_schedule(0, peak_value, warmup_steps,
    total_steps)`` at ``step``: linear from 0 to the peak over the warmup
    steps, then a cosine to 0 at ``total_steps``."""
    if step < warmup_steps:
        return peak_value * min(max(step, 0), warmup_steps) / warmup_steps
    decay_steps = total_steps - warmup_steps
    count = min(step - warmup_steps, decay_steps)
    return peak_value * 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))


def _global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """The L2 norm of ``grads`` as one vector. Sharded (DTensor) gradients
    add their local shards' squares, summed over the mesh dims on which they
    are split; gradients of one layout share one reduction."""
    if not any(isinstance(g, DTensor) for g in grads):
        return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    layouts: Dict[tuple, List[torch.Tensor]] = {}
    for g in grads:
        if isinstance(g, DTensor):
            if any(pl.is_partial() for pl in g.placements):
                raise ValueError(f"a gradient with partial placements {g.placements}")
            split = tuple(i for i, pl in enumerate(g.placements) if pl.is_shard())
            layouts.setdefault((g.device_mesh, split), []).append(g.to_local())
        else:
            layouts.setdefault((None, ()), []).append(g)
    squares = []
    for (mesh, split), local in layouts.items():
        sq = torch.stack(torch._foreach_norm(local)).square().sum()
        for dim in split:
            dist.all_reduce(sq, group=mesh.get_group(dim))
        squares.append(sq)
    return torch.stack(squares).sum().sqrt()


class MasterWeightAdamW:
    """Per-group AdamW with per-group gradient clipping and fp32 masters.

    ``groups`` is a list of (label, lr scale, [(parameter, master or None)]).
    A parameter with a master is stepped through it: the master's grad is the
    parameter's grad in fp32, AdamW updates the master, and the master is
    copied back into the parameter. A parameter without one (an fp32
    parameter) is stepped in place. Sharded parameters (DTensors) have
    masters with their layout; AdamW is elementwise, so each rank steps its
    shards, and only the clip's norm needs the other ranks.
    """

    def __init__(
        self,
        groups: List[Tuple[str, float, List[Tuple[nn.Parameter, Optional[torch.Tensor]]]]],
        schedule: Callable[[int], float],
        weight_decay: float,
    ):
        self.groups = groups
        param_groups = [
            {"params": [p if m is None else m for p, m in pairs], "lr": 1.0, "label": label}
            for label, _, pairs in groups
        ]
        # optax's adamw defaults: b1 0.9, b2 0.999, eps 1e-8, decay on every parameter
        self.adamw = torch.optim.AdamW(param_groups, lr=1.0, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
        # lr = 1.0 x schedule(step) x scale: the first update uses schedule(0),
        # like optax's count
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.adamw, [lambda n, s=scale: schedule(n) * s for _, scale, _ in groups]
        )
        self.device = next((p.device for _, _, pairs in groups for p, _ in pairs), None)  # the step's span times it

    def zero_grad(self) -> None:
        for _, _, pairs in self.groups:
            for p, m in pairs:
                p.grad = None
                if m is not None:
                    m.grad = None

    @torch.no_grad()
    def step(self) -> None:
        """Clip each group at global norm :data:`MAX_GRAD_NORM`, step AdamW and
        the schedule, write the masters back. A parameter that got no
        gradient counts as a zero gradient (as under ``jax.grad``). No host
        synchronisation. Span ``train.optimizer``, device-timed."""
        with profiling.span("train.optimizer", device=self.device):
            for _, _, pairs in self.groups:
                grads = []
                for p, m in pairs:
                    g = p.grad if p.grad is not None else torch.zeros_like(p)
                    if m is not None:
                        m.grad = g.float()
                        g = m.grad
                    else:
                        p.grad = g
                    grads.append(g)
                norm = _global_norm(grads)
                # optax's clip_by_global_norm: unchanged below the limit, else
                # times max / norm (no epsilon)
                local = [g.to_local() if isinstance(g, DTensor) else g for g in grads]
                torch._foreach_mul_(local, torch.where(norm < MAX_GRAD_NORM, 1.0, MAX_GRAD_NORM / norm))
            self.adamw.step()
            self.scheduler.step()
            for _, _, pairs in self.groups:
                for p, m in pairs:
                    if m is not None:
                        p.copy_(m)

    def masters(self) -> Dict[int, torch.Tensor]:
        return {i: m for i, (_, m) in enumerate(pair for _, _, pairs in self.groups for pair in pairs) if m is not None}

    def state_dict(self) -> Dict[str, object]:
        return {
            "adamw": self.adamw.state_dict(),
            "scheduler": self.scheduler.state_dict(),
            "masters": self.masters(),
        }

    @torch.no_grad()
    def load_state_dict(self, state: Mapping[str, object]) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.scheduler.load_state_dict(state["scheduler"])
        mine = self.masters()
        if set(mine) != set(state["masters"]):
            raise ValueError("optimizer state has other master weights than this optimizer")
        for i, m in mine.items():
            m.copy_(state["masters"][i])


def make_optimizer(
    net: nn.Module,
    learning_rate: float = 1e-4,
    group_lr_scale: Optional[Dict[str, float]] = None,
    weight_decay: float = 0.05,
    warmup_steps: int = 100,
    total_steps: int = 10000,
    master_params: Optional[Mapping[str, torch.Tensor]] = None,
) -> MasterWeightAdamW:
    """AdamW over ``net``'s parameters (a ``UFMNet``) with a warmup-cosine
    schedule and per-group learning-rate scales (:data:`GROUP_LR_SCALE`,
    updated by ``group_lr_scale``). Every parameter that is not fp32 gets an
    fp32 master, taken from ``master_params`` (an fp32 state dict, e.g.
    ``jax_params_to_state_dict(...)``, in the unsharded layout) when given,
    else from the parameter. On a sharded net the masters are laid out like
    their parameters."""
    from ufm_torch.parallel.sharding import qkv_permutations, reshard

    if total_steps <= warmup_steps:
        raise ValueError(f"total_steps ({total_steps}) must exceed warmup_steps ({warmup_steps})")
    scales = dict(GROUP_LR_SCALE)
    if group_lr_scale:
        scales.update(group_lr_scale)
    members: Dict[str, List[Tuple[nn.Parameter, Optional[torch.Tensor]]]] = {g: [] for g in scales}
    perms = qkv_permutations(net)
    for name, p in net.named_parameters():
        if not p.requires_grad:
            continue
        master = None
        if p.dtype != torch.float32 and master_params is None:
            master = p.detach().to(dtype=torch.float32, copy=True)
        elif p.dtype != torch.float32:
            master = reshard(master_params[name].detach(), p, perms.get(name), dtype=torch.float32)
        members.setdefault(group_of(name), []).append((p, master))
    groups = [(g, scales[g], pairs) for g, pairs in members.items() if pairs]
    return MasterWeightAdamW(
        groups, lambda n: warmup_cosine_decay(n, learning_rate, warmup_steps, total_steps), weight_decay
    )


def make_train_step(
    net: nn.Module,
    optimizer: MasterWeightAdamW,
    loss_weights: Optional[Dict[str, float]] = None,
) -> Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]:
    """One train step on ``batch`` (``img1``, ``img2``, ``gt_flow``,
    ``gt_covisibility``, optional ``valid``, on the net's device): zero the
    grads, forward, :func:`ufm_total_loss`, backward, clip, AdamW, schedule.
    Returns the step's metrics as detached device tensors (reading one
    synchronises the host; the step itself does not). Spans: ``train.step``
    > ``train.forward``, ``train.loss``, ``train.backward`` (device-timed)
    and the optimizer's ``train.optimizer``."""

    def step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        with profiling.span("train.step", call=True):
            optimizer.zero_grad()
            loss, metrics = _forward_loss(net, batch, loss_weights)
            with profiling.span("train.backward", device=loss.device):
                loss.backward()
            optimizer.step()
            return {k: v.detach() for k, v in metrics.items()}

    return step


def _forward_loss(net: nn.Module, batch: Dict[str, torch.Tensor], loss_weights, group=None):
    """The forward and :func:`ufm_total_loss`, each in its device-timed span."""
    device = batch["img1"].device
    with profiling.span("train.forward", device=device):
        out = net(batch["img1"], batch["img2"])
    with profiling.span("train.loss", device=device):
        return ufm_total_loss(out, batch, loss_weights, group=group)


def make_sharded_train_step(
    net: nn.Module,
    mesh,
    loss_weights: Optional[Dict[str, float]] = None,
    master_params: Optional[Mapping[str, torch.Tensor]] = None,
    **optimizer_kwargs,
):
    """Mesh-sharded train step (the counterpart of the JAX package's
    ``make_sharded_train_step``). Shards ``net`` (a ``UFMNet`` on this
    rank's device; every rank holds the same parameters) in place over
    ``mesh`` (:func:`ufm_torch.parallel.make_mesh`) and builds the optimizer
    over the sharded parameters (:func:`make_optimizer`'s keyword arguments).

    Returns ``(step, sharded_net, optimizer, place_batch)``:
    ``place_batch(batch)`` takes the global batch (every rank holds all of
    it, tensors or numpy arrays) to this rank's device and shard of it on
    ``data``, and ``step(placed)`` runs one step and returns the global
    metrics, the same on every rank, as detached device tensors."""
    from ufm_torch.parallel.sharding import shard_batch, shard_params

    device = next(net.parameters()).device
    _, net = shard_params(net, mesh)
    optimizer = make_optimizer(net, master_params=master_params, **optimizer_kwargs)
    data_group, data_n = mesh.get_group("data"), mesh.size(0)

    def place_batch(batch: Mapping[str, object]) -> Dict[str, torch.Tensor]:
        return {k: shard_batch(torch.as_tensor(v).to(device), mesh) for k, v in batch.items()}

    def step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        with profiling.span("train.step", call=True):
            optimizer.zero_grad()
            loss, metrics = _forward_loss(net, batch, loss_weights, group=data_group)
            # FSDP averages the gradients over the data x fsdp ranks, and the
            # ranks of one data index hold the same batch shard: times the data
            # size, the average is the sum of the shares, the global gradient
            with profiling.span("train.backward", device=loss.device):
                (loss * data_n).backward()
            optimizer.step()
            return {k: v.detach() for k, v in metrics.items()}

    return step, net, optimizer, place_batch


def synthetic_batch(
    batch_size: int, height: int, width: int, seed: int = 0, device="cuda"
) -> Dict[str, torch.Tensor]:
    """Random-but-consistent batch for smoke tests, made by a seeded
    ``torch.Generator`` on ``device`` (the card unless the caller asks for
    the CPU, like the package's other entry points; its values differ from
    the JAX package's ``synthetic_batch``)."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device)

    return {
        "img1": normal(batch_size, height, width, 3),
        "img2": normal(batch_size, height, width, 3),
        "gt_flow": normal(batch_size, height, width, 2) * 4.0,
        "gt_covisibility": (torch.rand((batch_size, height, width), generator=gen, device=device) > 0.3).float(),
    }
