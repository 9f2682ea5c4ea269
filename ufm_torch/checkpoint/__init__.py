"""Checkpoints: the JAX package's parameters, torch state dicts and saved
directories carried into the port."""

from ufm_torch.checkpoint.convert import (
    canonicalize_reference_names,
    flatten_params,
    jax_params_to_state_dict,
    load_jax_params,
    migrate_unrolled_blocks,
    modify_state_dict,
    torch_state_dict_to_port,
)
from ufm_torch.checkpoint.io import (
    load_pretrained,
    load_pretrained_ckpt,
    load_state_dict_into,
    load_torch_checkpoint_into,
    read_flax_msgpack,
    read_safetensors,
    save_pretrained,
    write_safetensors,
)

__all__ = [
    "canonicalize_reference_names",
    "flatten_params",
    "jax_params_to_state_dict",
    "load_jax_params",
    "load_pretrained",
    "load_pretrained_ckpt",
    "load_state_dict_into",
    "load_torch_checkpoint_into",
    "migrate_unrolled_blocks",
    "modify_state_dict",
    "read_flax_msgpack",
    "read_safetensors",
    "save_pretrained",
    "torch_state_dict_to_port",
    "write_safetensors",
]
