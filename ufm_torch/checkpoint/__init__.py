"""Checkpoints: carrying the JAX package's parameters into the port."""

from ufm_torch.checkpoint.convert import jax_params_to_state_dict, load_jax_params

__all__ = ["jax_params_to_state_dict", "load_jax_params"]
