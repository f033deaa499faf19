"""Loss functions.

Counterpart of ``skeleton_action_recognition_tpu/train/losses.py``: softmax
cross-entropy against one-hot labels, summed over the batch and divided by
the global batch size, with the Keras L2 penalty over conv and dense
weights behind ``l2_weight`` (0 by default, as the reference trainer
declares the penalty but never adds it).
"""

from __future__ import annotations

import torch

from skeleton_action_recognition_tpu_torch.models.layers import (
    l2_regularization,
)


def softmax_cross_entropy(logits, labels_onehot):
    """Per-sample CE, from a float32 log-softmax."""
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    return -(labels_onehot * log_probs).sum(-1)


def total_loss(logits, labels_onehot, model, global_batch_size,
               l2_weight=0.0, world_size=1):
    """Summed CE / global batch (+ ``l2_weight`` times the L2 penalty over
    ``model``'s Linear and Conv2d weights).

    In data parallelism each of ``world_size`` ranks sums the CE of its
    rows over the global batch size and the ranks' gradients are summed,
    so each rank carries ``1 / world_size`` of the penalty: the summed
    gradient then holds it once."""
    ce = softmax_cross_entropy(logits, labels_onehot).sum() * (
        1.0 / global_batch_size
    )
    if l2_weight:
        l2 = l2_regularization(model, l2_weight)
        ce = ce + (l2 if world_size == 1 else l2 / world_size)
    return ce
