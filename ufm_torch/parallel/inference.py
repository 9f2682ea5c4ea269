"""Data-parallel batched inference over a device mesh (counterpart of
``ufm_tpu/parallel/inference.py``).

The model fits on one card, so throughput scales by splitting the pair batch
over the mesh's ``data`` axis: parameters replicated (broadcast once from
rank 0), each rank runs the forward on its shard, and
the raw outputs are gathered back into the whole batch, the same on every
rank. No collective runs inside the forward.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch
import torch.distributed as dist

from ufm_torch.parallel.sharding import shard_batch

__all__ = ["make_data_parallel_forward"]


def make_data_parallel_forward(model, mesh) -> Callable[[Any, Any], Dict[str, torch.Tensor]]:
    """Return ``forward(src_bhwc, tgt_bhwc) -> raw output dict`` running
    data-parallel over ``mesh`` (:func:`ufm_torch.parallel.make_mesh`). The
    inputs are the whole batch on every rank (normalized float images,
    tensors or numpy arrays); the batch must divide the ``data`` size.

    ``model`` is a UniFlowMatch wrapper on this rank's device; its parameters
    are replicated from rank 0 once, here."""
    net = model.net
    device = model.device
    data_group = mesh.get_group("data")
    with torch.no_grad():
        for t in list(net.parameters()) + list(net.buffers()):
            dist.broadcast(t.data, src=0)

    def gather(t: torch.Tensor) -> torch.Tensor:
        parts = [torch.empty_like(t) for _ in range(mesh.size(0))]
        dist.all_gather(parts, t.contiguous(), group=data_group)
        return torch.cat(parts)

    @torch.no_grad()
    def run(src, tgt) -> Dict[str, torch.Tensor]:
        src, tgt = (shard_batch(torch.as_tensor(x, dtype=torch.float32).to(device), mesh) for x in (src, tgt))
        out = net(src, tgt)
        return {k: gather(v) for k, v in out.items()}

    return run
