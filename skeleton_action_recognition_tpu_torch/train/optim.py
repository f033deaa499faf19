"""SGD with Keras-2 semantics, the GNN trainer's optimizer.

Counterpart of ``skeleton_action_recognition_tpu/train/optim.py::tf_sgd``.
"""

from __future__ import annotations

import torch


class TFSGD(torch.optim.Optimizer):
    """``tf.keras.optimizers.SGD`` (Keras 2), written out by hand.

    Keras folds the learning rate into the velocity when it accumulates::

        v   <- momentum * v - lr(t) * g
        p   += momentum * v - lr(t) * g        (nesterov)
        p   += v                               (plain momentum)

    with ``lr`` taken at the step count before it is incremented.
    ``torch.optim.SGD(nesterov=True)`` keeps an lr-free velocity and scales
    it by the current lr, which differs from this rule after every schedule
    boundary, so it is not used.

    ``learning_rate`` is a float or a function of the step count (e.g.
    :func:`..schedules.piecewise_constant`). The count lives in the first
    parameter group, so it is saved and restored with ``state_dict``. A
    parameter without a gradient is skipped; a zero gradient (a masked one)
    still decays its velocity, as in the JAX package.
    """

    def __init__(self, params, learning_rate, momentum: float = 0.9,
                 nesterov: bool = True):
        super().__init__(
            params, dict(momentum=momentum, nesterov=nesterov, count=0)
        )
        self.learning_rate = learning_rate

    def current_lr(self) -> float:
        count = self.param_groups[0]["count"]
        if callable(self.learning_rate):
            return self.learning_rate(count)
        return self.learning_rate

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        lr = self.current_lr()
        for group in self.param_groups:
            m = group["momentum"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if "velocity" not in state:
                    state["velocity"] = torch.zeros_like(p)
                v = state["velocity"]
                v.copy_(m * v - lr * g)
                p.add_(m * v - lr * g if group["nesterov"] else v)
            group["count"] += 1
        return loss
