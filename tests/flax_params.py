"""Flax parameter trees made from a numpy seed, without a compile.

`jax.eval_shape` gives the tree's structure; the leaves are filled from
numpy: kernels uniform with scale 1/sqrt(fan_in), biases, LayerNorm scales
and the log std away from their init values, so that carrying each of them
across is checked.  A jitted flax `init` costs seconds of CPU time a model.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def random_flax_params(module, obs_dim: int, seed: int) -> dict:
    """numpy float32 leaves in the tree `module.init` would make."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, obs_dim), jnp.float32))

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            scale = 1.0 / np.sqrt(leaf.shape[0])
            return rng.uniform(-scale, scale, leaf.shape).astype(np.float32)
        base = 1.0 if "scale" in name else 0.0
        return (base + 0.1 * rng.normal(size=leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)
