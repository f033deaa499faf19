"""LSTM temporal frame sampler.

Counterpart of ``skeleton_action_recognition_tpu/models/lstm_sampler.py``:
stacked LSTMs score each timestep, the ``top_k`` highest-scoring frames are
gathered (highest first, as ``lax.top_k`` and ``torch.topk`` both order
them), and each is weighted by its score. No model uses it, as in JAX.

Each flax ``OptimizedLSTMCell_i`` is one single-layer ``nn.LSTM`` of that
name (gates i, f, g, o; zero initial state; no forget-gate bias offset);
``interop`` converts the two layouts.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from skeleton_action_recognition_tpu_torch.models.layers import lecun_normal_


def _lstm(in_features: int, units: int, generator=None) -> nn.LSTM:
    """An ``nn.LSTM`` drawn as flax's cell: ``lecun_normal`` input kernels
    and orthogonal recurrent kernels, gate by gate, and zero biases."""
    lstm = nn.LSTM(in_features, units, batch_first=True)
    with torch.no_grad():
        for gate in range(4):
            rows = slice(gate * units, (gate + 1) * units)
            lecun_normal_(lstm.weight_ih_l0[rows], in_features, generator)
            nn.init.orthogonal_(lstm.weight_hh_l0[rows], generator=generator)
        lstm.bias_ih_l0.zero_()
        lstm.bias_hh_l0.zero_()
    return lstm


class TemporalSampler(nn.Module):
    """``(N, T, V, C)`` -> ``(N, top_k, V, C)``: LSTMs of ``num_hidden``
    units over the frames' ``V * C`` features, then a one-unit LSTM whose
    output is each frame's score."""

    def __init__(self, in_features: int, num_hidden: Sequence[int],
                 top_k: int = 200, generator=None):
        super().__init__()
        self.top_k = top_k
        self.depth = len(num_hidden) + 1
        for i, units in enumerate(tuple(num_hidden) + (1,)):
            self.add_module(f"OptimizedLSTMCell_{i}",
                            _lstm(in_features, units, generator))
            in_features = units

    def scores(self, x):
        """Each frame's score, ``(N, T)``, for ``x`` ``(N, T, V, C)``."""
        n, t, v, c = x.shape
        h = x.reshape(n, t, v * c)
        for i in range(self.depth):
            h, _ = getattr(self, f"OptimizedLSTMCell_{i}")(h)
        return h[..., 0]

    def forward(self, x):
        n, t, v, c = x.shape
        values, indices = torch.topk(self.scores(x), self.top_k, dim=-1)
        gathered = torch.gather(
            x, 1, indices[:, :, None, None].expand(n, self.top_k, v, c))
        return gathered * values[:, :, None, None]
