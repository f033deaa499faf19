"""Helpers shared by the PyTorch port's parity tests (``test_torch_*.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

# The suite runs in several worker processes at once, and every worker
# imports this module while it collects. torch's default of one intra-op
# thread per core in each worker oversubscribes the cores several times
# over (measured: the port's tests took 4x as long under four workers).
torch.set_num_threads(2)


def randomized_variables(model, x, seed):
    """Initialize a flax ST-GCN on ``x[:1]`` and redraw, from a numpy seed,
    every BatchNorm scale, running mean and running variance and every
    bias, so that eval-mode BatchNorm and the bias paths do real work.
    Returns the variables as nested dicts of numpy arrays."""
    variables = jax.device_get(
        model.init(jax.random.key(0), jnp.asarray(x[:1]))
    )
    rng = np.random.default_rng(seed)

    def redraw(path, leaf):
        name = path[-1].key
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name in ("mean", "bias"):
            return rng.normal(0.0, 0.1, leaf.shape).astype(np.float32)
        return np.asarray(leaf, np.float32)

    return jax.tree_util.tree_map_with_path(redraw, variables)
