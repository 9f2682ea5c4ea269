"""Device-mesh parallelism of the UFM family over ``torch.distributed`` (the
JAX package's ``ufm_tpu.parallel``): sharding rules, tensor parallelism and
FSDP2 for training, data-parallel inference."""

from ufm_torch.parallel.sharding import (
    batch_sharding,
    make_mesh,
    param_partition_spec,
    shard_params,
    tree_shardings,
)
from ufm_torch.parallel.inference import make_data_parallel_forward

__all__ = [
    "batch_sharding",
    "make_mesh",
    "param_partition_spec",
    "shard_params",
    "tree_shardings",
    "make_data_parallel_forward",
]
