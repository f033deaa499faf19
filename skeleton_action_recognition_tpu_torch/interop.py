"""Weight bridge from the JAX package's flax variables to the port's modules.

The port's module and parameter names follow the flax tree, so the bridge
only renames leaves and transposes layouts:

* a Dense ``kernel (C_in, C_out)`` becomes a Linear ``weight (C_out, C_in)``;
* a Conv ``kernel`` in HWIO becomes a Conv2d ``weight`` in OIHW;
* BatchNorm ``scale`` becomes ``weight``; ``batch_stats`` ``mean``/``var``
  become ``running_mean``/``running_var``.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

_LEAF_NAMES = {
    "kernel": "weight",
    "scale": "weight",
    "mean": "running_mean",
    "var": "running_var",
}


def flax_to_state_dict(variables: Mapping) -> dict[str, torch.Tensor]:
    """``{'params': ..., 'batch_stats': ...}`` as nested dicts of numpy
    arrays -> the port's ``state_dict`` (float32 CPU tensors)."""
    state = {}

    def walk(tree, prefix):
        for key, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, prefix + (key,))
                continue
            arr = np.asarray(value, np.float32)
            if key == "kernel":
                arr = arr.T if arr.ndim == 2 else arr.transpose(3, 2, 0, 1)
            name = ".".join(prefix + (_LEAF_NAMES.get(key, key),))
            state[name] = torch.tensor(arr)

    for collection in ("params", "batch_stats"):
        walk(variables.get(collection, {}), ())
    return state
