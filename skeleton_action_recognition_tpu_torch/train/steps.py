"""Train and eval steps of the GNN and spectrogram trainers.

Counterpart of ``skeleton_action_recognition_tpu/train/steps.py``
(``make_train_step``, ``make_eval_step``, ``mask_gradients_by_name``,
``make_radar_train_step``). The JAX steps are pure functions of a train
state; here a step closes over the model and optimizer and updates them in
place. The adjacency freeze of the reference trainer (parameters named
``adjacency_matrix`` take no update until ``epoch > freeze_graph_until``)
zeroes those gradients under a runtime flag, as in the JAX package. The
spectrogram trainer's staged unfreeze of the radar parameters turns their
``requires_grad`` off instead, so that autograd records none of their
backward, as ``stop_gradient`` lets XLA drop it.

Under a profiler each train step's phases are spans
(:func:`..tracing.span`): ``train.forward`` (the model and the loss),
``train.backward`` (``zero_grad`` and ``loss.backward()``),
``train.allreduce`` (with ``dp``), ``train.optimizer`` (the adjacency
freeze and ``optimizer.step()``) and ``train.metrics``.
"""

from __future__ import annotations

import torch

from skeleton_action_recognition_tpu_torch.tracing import span
from skeleton_action_recognition_tpu_torch.train.losses import total_loss


def mask_gradients_by_name(model, needle: str, enabled) -> None:
    """Zero the gradients of ``model``'s parameters whose name contains
    ``needle`` unless ``enabled``.

    Uses ``where``, not multiplication, so that an inf or nan gradient
    becomes 0 and not nan. A masked gradient is zeros, never None, so the
    optimizer treats the parameter exactly as the JAX ``tf_sgd`` treats a
    zero gradient."""
    for name, p in model.named_parameters():
        if needle not in name:
            continue
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        on = torch.as_tensor(bool(enabled), device=g.device)
        p.grad = torch.where(on, g, torch.zeros_like(g))


def _backward(model, optimizer, loss, dp) -> None:
    """The gradients of ``loss`` (spans ``train.backward`` and, with a
    ``dp``, ``train.allreduce``: their sum over the ranks)."""
    with span("train.backward"):
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
    if dp is not None:
        with span("train.allreduce"):
            dp.all_reduce_gradients(model)


def make_train_step(
    model, optimizer, global_batch_size: int, l2_weight: float = 0.0,
    freeze_name: str = "adjacency_matrix", dp=None,
):
    """Build ``step(x, y_onehot, train_adj) -> metrics``: one optimizer step
    of ``model`` in training mode on a batch. ``metrics`` holds device
    scalars (loss, top-1 and top-5 correct counts, count), so that a caller
    can fetch them after many steps without stalling the device each
    step.

    With a :class:`..parallel.sharding.DataParallel` ``dp``, ``x`` and
    ``y`` are this rank's rows of a global batch of ``global_batch_size``:
    the gradients are summed over the ranks before the adjacency freeze
    and the update, and the metrics are the global batch's sums."""
    world_size = 1 if dp is None else dp.world_size

    def step(x, y, train_adj):
        model.train()
        with span("train.forward"):
            logits = model(x)
            loss = total_loss(logits, y, model, global_batch_size,
                              l2_weight, world_size)
        _backward(model, optimizer, loss, dp)
        with span("train.optimizer"):
            mask_gradients_by_name(model, freeze_name, train_adj)
            optimizer.step()
        with span("train.metrics"):
            with torch.no_grad():
                labels = y.argmax(-1)
                top1 = (logits.argmax(-1) == labels).sum()
                top5_preds = logits.topk(min(5, logits.shape[-1]), dim=-1)[1]
                top5 = (top5_preds == labels[:, None]).any(-1).sum()
            metrics = {
                "loss": loss.detach(),
                "correct": top1,
                "correct_top5": top5,
                "count": torch.tensor(x.shape[0], dtype=torch.int32),
            }
            return metrics if dp is None else dp.sum_metrics(metrics)

    return step


def make_eval_step(model):
    """``step(x) -> softmax probabilities`` of ``model`` in eval mode."""

    def step(x):
        model.eval()
        with torch.no_grad():
            return torch.softmax(model(x).float(), dim=-1)

    return step


def make_radar_train_step(model, optimizer, global_batch_size: int,
                          train_lambda: bool = False,
                          train_loc: bool = False, dp=None):
    """Build ``step(x, y_onehot) -> metrics`` for the spectrogram model:
    the mean cross-entropy ``sum(-log_softmax(logits) . y) /
    global_batch_size`` (torch ``CrossEntropyLoss``), one step of
    ``optimizer`` (a :class:`..optim.RadarOptimizer`), and the metrics
    ``loss``, ``correct`` and ``count`` as device scalars.

    Parameters named ``radar_lambda`` (``radar_loc``) train only with
    ``train_lambda`` (``train_loc``). The step sets their
    ``requires_grad`` on every call, so that steps of two phases may share
    a model: a frozen parameter gets no gradient and no update, and when
    both are frozen no radar or STFT backward runs at all. ``dp`` as in
    :func:`make_train_step`."""

    def step(x, y):
        model.train()
        for name, p in model.named_parameters():
            if "radar_lambda" in name:
                p.requires_grad_(train_lambda)
            elif "radar_loc" in name:
                p.requires_grad_(train_loc)
        with span("train.forward"):
            logits = model(x).float()
            loss = (-(torch.log_softmax(logits, -1) * y).sum()
                    / global_batch_size)
        _backward(model, optimizer, loss, dp)
        with span("train.optimizer"):
            optimizer.step()
        with span("train.metrics"):
            with torch.no_grad():
                correct = (logits.argmax(-1) == y.argmax(-1)).sum()
            metrics = {
                "loss": loss.detach(),
                "correct": correct,
                "count": torch.tensor(x.shape[0], dtype=torch.int32),
            }
            return metrics if dp is None else dp.sum_metrics(metrics)

    return step
