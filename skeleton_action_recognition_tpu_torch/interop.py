"""Weight bridge between the JAX package's flax variables and the port's
modules, both ways.

The port's module and parameter names follow the flax tree, so the bridge
only renames leaves and transposes layouts:

* a Dense ``kernel (C_in, C_out)`` is a Linear ``weight (C_out, C_in)``;
* a Conv ``kernel`` in HWIO is a Conv2d ``weight`` in OIHW;
* BatchNorm ``scale`` is ``weight``; ``batch_stats`` ``mean``/``var`` are
  ``running_mean``/``running_var``;
* a flax ``OptimizedLSTMCell`` (input kernels ``ii/if/ig/io``, no bias;
  recurrent kernels ``hi/hf/hg/ho`` with biases) is a one-layer
  ``nn.LSTM`` of the same name: ``weight_ih_l0`` and ``weight_hh_l0`` stack
  the transposed kernels in gate order i, f, g, o, ``bias_hh_l0`` the
  biases, and ``bias_ih_l0`` is 0 (torch's two biases are summed back into
  flax's one on the way out);
* every other leaf keeps its name and shape: the trainable adjacency
  ``adjacency_matrix`` (shared ``(K, V, V)`` or per-timestep ``(K, T, V,
  V)``), GIN's scalar ``epsilon``, the projections' ``(C, J)`` ``centers``
  and ``variance``, GPool's ``(C * T, 1)`` ``projection_vector``, and the
  spectrogram model's scalar ``radar_lambda``, ``(3,)`` ``radar_loc`` and
  trainable STFT bases ``stft_cos``/``stft_sin``.
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch

_LEAF_NAMES = {
    "kernel": "weight",
    "scale": "weight",
    "mean": "running_mean",
    "var": "running_var",
}


_GATES = "ifgo"  # torch's gate order, flax's i/f/g/o names
_LSTM_LEAF = re.compile(r"(?:weight|bias)_(?:ih|hh)_l0")


def _is_lstm_cell(tree: Mapping) -> bool:
    return all(f"{s}{g}" in tree for s in "ih" for g in _GATES)


def lstm_cell_to_torch(cell: Mapping) -> dict[str, torch.Tensor]:
    """A flax ``OptimizedLSTMCell``'s params -> a one-layer ``nn.LSTM``'s
    ``weight_ih_l0``, ``weight_hh_l0``, ``bias_ih_l0`` (zeros) and
    ``bias_hh_l0``."""
    def stack(side, leaf):
        return np.concatenate([
            np.asarray(cell[f"{side}{g}"][leaf], np.float32).T
            if leaf == "kernel" else
            np.asarray(cell[f"{side}{g}"][leaf], np.float32)
            for g in _GATES
        ])

    bias = stack("h", "bias")
    return {
        "weight_ih_l0": torch.tensor(stack("i", "kernel")),
        "weight_hh_l0": torch.tensor(stack("h", "kernel")),
        "bias_ih_l0": torch.zeros(bias.shape),
        "bias_hh_l0": torch.tensor(bias),
    }


def lstm_cell_from_torch(leaves: Mapping[str, np.ndarray]) -> dict:
    """The inverse of :func:`lstm_cell_to_torch`: a one-layer ``nn.LSTM``'s
    four leaves (numpy) -> the flax cell's params; the cell's ``h*`` biases
    are torch's ``bias_ih_l0 + bias_hh_l0``."""
    w_ih = np.split(leaves["weight_ih_l0"], 4)
    w_hh = np.split(leaves["weight_hh_l0"], 4)
    bias = np.split(leaves["bias_ih_l0"] + leaves["bias_hh_l0"], 4)
    cell = {}
    for gate, wi, wh, b in zip(_GATES, w_ih, w_hh, bias):
        cell[f"i{gate}"] = {"kernel": wi.T.copy()}
        cell[f"h{gate}"] = {"kernel": wh.T.copy(), "bias": b.copy()}
    return cell


def flax_to_state_dict(variables: Mapping) -> dict[str, torch.Tensor]:
    """``{'params': ..., 'batch_stats': ...}`` as nested dicts of numpy
    arrays -> the port's ``state_dict`` (float32 CPU tensors)."""
    state = {}

    def walk(tree, prefix):
        if _is_lstm_cell(tree):
            for name, t in lstm_cell_to_torch(tree).items():
                state[".".join(prefix + (name,))] = t
            return
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
    scale, of rank 2 a Dense kernel, of rank 4 a Conv kernel; an
    ``nn.LSTM``'s ``weight_ih_l0``, ``weight_hh_l0``, ``bias_ih_l0`` and
    ``bias_hh_l0`` become one flax ``OptimizedLSTMCell``
    (:func:`lstm_cell_from_torch`). Every other leaf keeps its name and
    shape (the adjacency, ``epsilon``, ``centers``, ``variance``,
    ``projection_vector``, the spectrogram model's radar and STFT
    parameters)."""
    variables: dict = {"params": {}, "batch_stats": {}}
    cells: dict = {}
    for name, tensor in state.items():
        *path, leaf = name.split(".")
        arr = tensor.detach().cpu().float().numpy()
        collection = "params"
        if _LSTM_LEAF.fullmatch(leaf):
            cells.setdefault(tuple(path), {})[leaf] = arr
            continue
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
    for path, leaves in cells.items():
        node = variables["params"]
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = lstm_cell_from_torch(leaves)
    return {k: v for k, v in variables.items() if v}
