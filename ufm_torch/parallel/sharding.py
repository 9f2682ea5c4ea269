"""Device-mesh sharding of the UFM family over ``torch.distributed``
(counterpart of ``ufm_tpu/parallel/sharding.py``).

The mesh has the JAX package's axes ``("data", "fsdp", "model")``:

- the batch is split on ``data`` (the ranks of one data index see the same
  batch shard, as in the JAX package, where ``fsdp`` shards parameters);
- tensor parallelism (``torch.distributed.tensor.parallel``) on ``model``:
  the Megatron pairing of the JAX rules, qkv and the MLP's fc1 (and the
  patch MLP's ``fc<i>``) column-parallel, the attention's proj and the MLP's
  fc2 row-parallel, with the collectives DTensor inserts;
- FSDP2 (``fully_shard``) on ``("data", "fsdp")`` as HSDP: parameters and
  gradients sharded on ``fsdp``, replicated (gradients all-reduced) on
  ``data``.

Layouts against the JAX package: an ``nn.Linear`` weight is (out, in) where
a flax kernel is (in, out), so column-parallel is ``Shard(0)`` and
row-parallel ``Shard(1)``; a conv is OIHW where flax's is HWIO; the JAX
package's scan-stacked (layers, in, out) kernels are separate blocks here.
A column-parallel layer's bias is ``Shard(0)`` on ``model`` (its output is
sharded); the JAX package replicates it and XLA reshards the add. FSDP2
shards dim 0 of every parameter of a group (padding an uneven last shard),
where the JAX package picks the output dim or replicates small parameters:
on ``fsdp`` the layouts differ, never the values.

The fused qkv projection is sharded by heads within each of q, k and v: a
contiguous ``Shard(0)`` of the (3C, C) weight would give one rank all of q
and part of k. :func:`shard_params` permutes the qkv rows (weight and bias)
so that rank r's contiguous shard holds [q_r; k_r; v_r], its heads' rows of
each, and each rank runs attention on its own heads from strided views of
its local projection. The permutation is kept on the ``Attention`` module
(``tp_qkv_perm``); :func:`unshard` undoes it and :func:`reshard` applies it,
so gathered parameters and optimizer states are in the unsharded layout.
When the head count does not divide the ``model`` size, qkv is still
column-parallel (as in the JAX rule) but without the permutation, and its
output is gathered before the attention.

A block with the SwiGLU FFN (``mlp.w12`` / ``mlp.w3``, which the JAX package
has no rule for) is refused on a ``model`` axis above 1: a contiguous
column split of ``w12`` would give one rank all of ``x1`` and none of ``x2``.
FSDP and data parallelism shard it as any block.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn as nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.fsdp import MixedPrecisionPolicy, fully_shard
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard, distribute_tensor
from torch.distributed.tensor.parallel import ColwiseParallel, RowwiseParallel, parallelize_module

from ufm_torch.nn.layers import Attention, Mlp, SwiGLUFFN, TransformerBlock

__all__ = [
    "MESH_AXES",
    "make_mesh",
    "param_partition_spec",
    "tree_shardings",
    "shard_params",
    "batch_sharding",
    "shard_batch",
    "qkv_permutations",
    "unshard",
    "reshard",
]

MESH_AXES = ("data", "fsdp", "model")

MeshLike = Union[DeviceMesh, Mapping[str, int]]

# the JAX rules on the port's names: column-parallel (output dim on 'model'):
# qkv, the MLP's fc1 and the patch MLP's fc<i>; row-parallel (input dim on
# 'model'): the attention's proj and the MLP's fc2, checked FIRST (fc\d*
# would otherwise claim mlp.fc2)
_COL_PARALLEL = re.compile(r"(attn\.qkv|mlp\.fc1|fc\d*)\.weight$")
_ROW_PARALLEL = re.compile(r"(attn\.proj|mlp\.fc2)\.weight$")


def make_mesh(
    n_devices: Optional[int] = None,
    data: Optional[int] = None,
    fsdp: int = 1,
    model: int = 1,
    device_type: str = "cuda",
) -> DeviceMesh:
    """A ``("data", "fsdp", "model")`` device mesh over the default process
    group (initialised here from ``torchrun``'s environment if it is not
    yet: NCCL on the card, gloo for ``device_type="cpu"``).

    With only ``n_devices`` (default: the world size) given, everything goes
    to the data axis. On the card each rank takes the GPU of its rank on the
    host; ``device_type="cpu"`` is used only when the caller asks for it."""
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh(device_type='cuda') needs a CUDA device; pass device_type='cpu' for the CPU")
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo")
    if device_type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    if n_devices is None:
        n_devices = dist.get_world_size()
    if data is None:
        data = n_devices // (fsdp * model)
    if data * fsdp * model != n_devices or n_devices != dist.get_world_size():
        raise ValueError(
            f"mesh {data}x{fsdp}x{model} != {n_devices} devices (world size {dist.get_world_size()})"
        )
    return init_device_mesh(device_type, (data, fsdp, model), mesh_dim_names=MESH_AXES)


def _sizes(mesh: MeshLike) -> Dict[str, int]:
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return {axis: int(mesh.get(axis, 1)) for axis in MESH_AXES}


def _model_placement(name: str, shape: Tuple[int, ...], model_n: int) -> Placement:
    if model_n > 1 and len(shape) == 2:
        if _ROW_PARALLEL.search(name) and shape[1] % model_n == 0:
            return Shard(1)
        if _COL_PARALLEL.search(name) and shape[0] % model_n == 0:
            return Shard(0)
    if model_n > 1 and len(shape) == 1 and name.endswith(".bias"):
        # the bias of a column-parallel layer is split with its output (this
        # reads a row-parallel name as row-parallel: no config of the repo
        # has a row-parallel layer whose input dim does not divide)
        weight = name[: -len("bias")] + "weight"
        if not _ROW_PARALLEL.search(weight) and _COL_PARALLEL.search(weight) and shape[0] % model_n == 0:
            return Shard(0)
    return Replicate()


def param_partition_spec(name: str, shape: Tuple[int, ...], mesh: MeshLike) -> Tuple[Placement, Placement, Placement]:
    """Placements of one parameter on ``("data", "fsdp", "model")``, by its
    ``state_dict`` name and shape. ``mesh`` is a ``DeviceMesh`` or a mapping
    of axis sizes (``{"data": 2, "fsdp": 2, "model": 2}``)."""
    sizes = _sizes(mesh)
    fsdp = Shard(0) if sizes["fsdp"] > 1 else Replicate()
    return (Replicate(), fsdp, _model_placement(name, tuple(shape), sizes["model"]))


def tree_shardings(tree: Mapping[str, torch.Tensor], mesh: MeshLike) -> Dict[str, Tuple[Placement, ...]]:
    """Placements for every entry of a flat ``{name: tensor}`` mapping (a
    ``state_dict``, or tensors on the ``meta`` device)."""
    return {name: param_partition_spec(name, tuple(t.shape), mesh) for name, t in tree.items()}


def batch_sharding(mesh: MeshLike, ndim: int = 1) -> Tuple[Placement, Placement, Placement]:
    """Batch tensors split dim 0 on ``data`` and replicate elsewhere (``ndim``
    is accepted for the JAX package's signature; any rank >= 1 splits dim 0)."""
    if ndim < 1:
        raise ValueError("a batch tensor has a batch dim")
    return (Shard(0), Replicate(), Replicate())


def shard_batch(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's part of a global batch tensor (every rank holds the whole
    batch, as a host array is given to the JAX package's ``device_put``)."""
    data_n = mesh.size(0)
    if x.shape[0] % data_n:
        raise ValueError(f"batch {x.shape[0]} must divide data axis {data_n}")
    return distribute_tensor(x, mesh, batch_sharding(mesh, x.ndim), src_data_rank=None).to_local()


def _qkv_permutation(dim: int, model_n: int) -> torch.Tensor:
    """Rows of a (3C, C) qkv weight so that shard r of a contiguous split in
    ``model_n`` holds [q_r; k_r; v_r]."""
    per = dim // model_n
    return torch.cat([torch.arange(part * dim + r * per, part * dim + (r + 1) * per)
                      for r in range(model_n) for part in range(3)])


def _tp_plan(net: nn.Module, model_n: int) -> Tuple[Dict[str, object], Dict[str, Attention]]:
    """Tensor-parallel styles of the Linear layers the rules shard, and the
    attention modules whose heads are split. A column-parallel layer keeps
    its output split only into its Megatron partner (qkv -> proj when the
    heads divide, fc1 -> fc2); elsewhere its output is gathered, since the
    next layer takes a whole input."""
    kind = {}  # Linear name -> 0 (column-parallel) or 1 (row-parallel)
    partner, attention = {}, {}
    for name, mod in net.named_modules():
        if isinstance(mod, SwiGLUFFN):
            raise ValueError(f"{name}: tensor parallelism has no rule for the SwiGLU FFN (its w12 halves would "
                             f"split apart on a model axis of {model_n}); shard it on data / fsdp only")
        if isinstance(mod, nn.Linear):
            pl = _model_placement(f"{name}.weight", tuple(mod.weight.shape), model_n)
            if pl.is_shard():
                kind[name] = pl.dim
        elif isinstance(mod, Attention) and mod.num_heads % model_n == 0:
            partner[f"{name}.qkv"] = f"{name}.proj"
            attention[f"{name}.qkv"] = mod
        elif isinstance(mod, Mlp):
            partner[f"{name}.fc1"] = f"{name}.fc2"
    split = {col: row for col, row in partner.items() if kind.get(col) == 0 and kind.get(row) == 1}
    plan: Dict[str, object] = {}
    for name, dim in kind.items():
        if dim == 0:
            plan[name] = ColwiseParallel() if name in split else ColwiseParallel(output_layouts=Replicate())
        else:
            plan[name] = RowwiseParallel() if name in split.values() else RowwiseParallel(input_layouts=Replicate())
    return plan, {name: mod for name, mod in attention.items() if name in split}


@torch.no_grad()
def _permute_qkv(attn: Attention, model_n: int) -> None:
    """Reorder the qkv rows so that rank r's contiguous shard holds its heads'
    rows of q, k and v; the permutation stays on the module."""
    perm = _qkv_permutation(attn.qkv.weight.shape[1], model_n).to(attn.qkv.weight.device)
    for t in (attn.qkv.weight, attn.qkv.bias):
        if t is not None:
            t.copy_(t[perm])
    attn.tp_qkv_perm = perm


def _fsdp_units(net: nn.Module):
    """Modules to wrap with ``fully_shard``, innermost first: every
    transformer block, then every direct child of ``net`` that holds
    parameters, then ``net`` itself. FSDP2 needs one dtype in a group; the
    port's backbone is bf16 and its heads fp32, and each unit is one of
    them."""
    blocks = [m for m in net.modules() if isinstance(m, TransformerBlock)]
    children = [m for m in net.children() if any(True for _ in m.parameters())]
    return blocks + children + [net]


def shard_params(net: nn.Module, mesh: DeviceMesh) -> Tuple[Dict[str, Tuple[Placement, ...]], nn.Module]:
    """Shard ``net`` (a ``UFMNet`` on this rank's device) over ``mesh`` in
    place: tensor parallelism on ``model`` (when its size is above 1), then
    FSDP2 on ``("data", "fsdp")``. Returns (the rules' placements by
    parameter name, ``net``). Every rank must hold the same parameters."""
    if not isinstance(mesh, DeviceMesh) or tuple(mesh.mesh_dim_names or ()) != MESH_AXES:
        raise TypeError(f"expected a DeviceMesh with axes {MESH_AXES} (ufm_torch.parallel.make_mesh), got {mesh!r}")
    shardings = tree_shardings(dict(net.named_parameters()), mesh)
    model_n = mesh.size(2)
    if model_n > 1:
        plan, split_heads = _tp_plan(net, model_n)
        for attn in split_heads.values():
            _permute_qkv(attn, model_n)
        parallelize_module(net, mesh["model"], plan)
    # each unit's own parameters (not an inner unit's), checked before any
    # fully_shard replaces parameters by their sharded versions
    units, seen = _fsdp_units(net), set()
    for unit in units:
        own = [p for p in unit.parameters() if id(p) not in seen]
        dtypes = {p.dtype for p in own}
        if len(dtypes) > 1:
            raise ValueError(f"{type(unit).__name__} holds parameters of several dtypes {dtypes}: FSDP needs one a group")
        seen.update(id(p) for p in own)
    dp_mesh = mesh["data", "fsdp"]
    for unit in units:
        # Gradients are reduced in fp32 and cast back to the parameter's
        # dtype. Only the blocks, which take and return tensors, free their
        # gathered parameters after the forward: FSDP gathers them again in
        # the backward from a hook on the outputs, and the other units return
        # dataclasses (encoder and head outputs), whose tensors some torch
        # releases do not hook. Those keep their parameters gathered until
        # the backward's end, where FSDP reduces their gradients.
        fully_shard(unit, mesh=dp_mesh, reshard_after_forward=isinstance(unit, TransformerBlock),
                    mp_policy=MixedPrecisionPolicy(reduce_dtype=torch.float32))
    return shardings, net


def qkv_permutations(net: nn.Module) -> Dict[str, torch.Tensor]:
    """``{parameter name: row permutation}`` of the qkv projections that
    :func:`shard_params` sharded by heads (empty for an unsharded net)."""
    out = {}
    for name, mod in net.named_modules():
        perm = getattr(mod, "tp_qkv_perm", None)
        if perm is not None:
            for leaf in ("weight", "bias"):
                if getattr(mod.qkv, leaf, None) is not None:
                    out[f"{name}.qkv.{leaf}"] = perm
    return out


def unshard(t: torch.Tensor, perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The whole tensor, in the unsharded layout, of a sharded (DTensor)
    parameter or optimizer state (``perm``: its qkv row permutation, if any);
    a collective, so every rank calls it in the same order. Any other tensor
    is returned as it is."""
    if not isinstance(t, DTensor):
        return t
    t = t.full_tensor()
    return t if perm is None else t[torch.argsort(perm.to(t.device))]


def reshard(
    full: torch.Tensor, like: torch.Tensor, perm: Optional[torch.Tensor] = None, dtype: Optional[torch.dtype] = None
) -> torch.Tensor:
    """A copy of ``full`` (the unsharded layout, present on every rank) laid
    out like ``like``: on its device, in ``dtype`` (default: its dtype), and
    with its mesh, placements and qkv row permutation ``perm`` when it is a
    DTensor (no communication)."""
    full = full.to(device=like.device, dtype=dtype or like.dtype, copy=True)
    if not isinstance(like, DTensor):
        return full
    if perm is not None:
        full = full[perm.to(full.device)]
    return distribute_tensor(full, like.device_mesh, like.placements, src_data_rank=None)
