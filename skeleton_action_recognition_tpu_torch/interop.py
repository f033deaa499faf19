"""Weight bridge between the JAX package's flax variables and the port's
modules, both ways.

The port's module and parameter names follow the flax tree, so the bridge
only renames leaves and transposes layouts:

* a Dense ``kernel (C_in, C_out)`` is a Linear ``weight (C_out, C_in)``;
* a Conv ``kernel`` in HWIO is a Conv2d ``weight`` in OIHW;
* BatchNorm ``scale`` is ``weight``; ``batch_stats`` ``mean``/``var`` are
  ``running_mean``/``running_var``;
* every other leaf keeps its name and shape: the trainable adjacency
  ``params['adjacency_matrix']``, and the spectrogram model's scalar
  ``radar_lambda``, ``(3,)`` ``radar_loc`` and trainable STFT bases
  ``stft_cos``/``stft_sin``.
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


def state_dict_to_flax(state: Mapping[str, torch.Tensor]) -> dict:
    """The port's ``state_dict`` -> ``{'params': ..., 'batch_stats': ...}``
    as nested dicts of float32 numpy arrays, the inverse of
    :func:`flax_to_state_dict`, so that the JAX package can evaluate
    weights trained in the port. A ``weight`` of rank 1 is a BatchNorm
    scale, of rank 2 a Dense kernel, of rank 4 a Conv kernel."""
    variables: dict = {"params": {}, "batch_stats": {}}
    for name, tensor in state.items():
        *path, leaf = name.split(".")
        arr = tensor.detach().cpu().float().numpy()
        collection = "params"
        if leaf == "weight":
            if arr.ndim == 1:
                leaf = "scale"
            else:
                leaf = "kernel"
                arr = arr.T if arr.ndim == 2 else arr.transpose(2, 3, 1, 0)
        elif leaf in ("running_mean", "running_var"):
            collection, leaf = "batch_stats", leaf.removeprefix("running_")
        node = variables[collection]
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = arr.copy()  # C order; a 0-d leaf stays 0-d
    return {k: v for k, v in variables.items() if v}
