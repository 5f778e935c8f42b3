"""Helpers shared by the tests that hold spotter_tpu_torch against spotter_tpu.

Flax params for a parity run come from a numpy seed rather than from
`module.init`: the shapes from `jax.eval_shape` (a trace, no compile), the
values drawn so every leaf is exercised — kernels scaled by 1/sqrt(fan_in),
non-zero biases, and non-identity frozen-BN statistics, so a mix-up of
mean/var or scale/bias in the weight carry-over cannot pass unseen.
"""

import jax
import numpy as np


def random_flax_params(module, *init_args, seed: int = 0) -> dict:
    """Nested dict of numpy arrays shaped like `module.init(key, *init_args)["params"]`."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *init_args)["params"]
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            value = rng.standard_normal(shape) / np.sqrt(fan_in)
        elif name == "var":
            value = rng.uniform(0.5, 1.5, shape)
        elif name == "scale":
            value = rng.uniform(0.8, 1.2, shape)
        elif name in ("bias", "mean"):
            value = 0.1 * rng.standard_normal(shape)
        else:
            value = rng.standard_normal(shape)
        return value.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)
