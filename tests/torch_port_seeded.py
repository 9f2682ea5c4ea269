"""Seeded numpy parameters for the JAX package's networks in the port's
tests: the tree's shapes come from ``jax.eval_shape`` (nothing is compiled)
and its values from ``numpy.random.default_rng(seed)``; LayerNorm scales
are ones. The same tree goes to ``net.apply`` and, through
``ufm_torch.checkpoint.load_jax_params``, into the port."""

import jax
import jax.numpy as jnp
import numpy as np

from ufm_tpu.checkpoint.convert import flatten_params


def numpy_params(module, *example_inputs, seed: int = 0, std: float = 0.02):
    """A nested params dict for ``module`` (a flax module) called on
    ``example_inputs``: normal(0, ``std``) values, ones for ``scale``."""
    tree = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *example_inputs))["params"]
    rng = np.random.default_rng(seed)

    def make(path, leaf):
        if path[-1].key == "scale":
            return np.ones(leaf.shape, np.float32)
        return (std * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(make, tree)


def net_params(jnet, hw, seed: int = 0):
    """(nested params, flat ``"a/b/c"`` numpy arrays) of a UFMNet at ``hw``."""
    img = jnp.zeros((1, *hw, 3))
    params = numpy_params(jnet, img, img, seed=seed)
    return params, flatten_params(params)
