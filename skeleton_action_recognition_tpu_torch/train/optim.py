"""The trainers' optimizers.

Counterpart of ``skeleton_action_recognition_tpu/train/optim.py``:
:class:`TFSGD` (``tf_sgd``, SGD with Keras-2 semantics) for the GNN
trainer, and :class:`RadarOptimizer` (``make_radar_optimizer`` over
``optax.adam`` and ``radar_physics_transform``) for the spectrogram
trainer.

Why the radar's physics parameters get their own rule: the raw loss
gradient of the wavelength ``radar_lambda`` carries a ``4 pi d / lambda^2``
factor (~5e7 at 5e-4 m) on every time-edge term and routinely overflows
float32, and Adam, being scale-invariant, would move a 5e-4 m wavelength by
the learning rate (up to 0.1) in one step. So ``radar_lambda`` and
``radar_loc`` move along the sanitized gradient direction by a step
proportional to their own magnitude (:func:`physics_update`).
"""

from __future__ import annotations

import torch

_F32_BIG = 3e38  # finite stand-in for an inf gradient entry
# optax.adam's defaults, the spectrogram trainer's
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


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

    Each operation of the rule runs once over all the parameters with a
    gradient (``torch._foreach_*``: a few kernels, not one a parameter),
    each element rounded as the per-parameter expressions round it.

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
            params = [p for p in group["params"] if p.grad is not None]
            if params:
                vs = []
                for p in params:
                    state = self.state[p]
                    if "velocity" not in state:
                        state["velocity"] = torch.zeros_like(p)
                    vs.append(state["velocity"])
                # the rule above, one multi-tensor kernel an operation
                lr_g = torch._foreach_mul([p.grad for p in params], lr)
                torch._foreach_mul_(vs, m)
                torch._foreach_sub_(vs, lr_g)
                if group["nesterov"]:
                    update = torch._foreach_mul(vs, m)
                    torch._foreach_sub_(update, lr_g)
                    torch._foreach_add_(params, update)
                else:
                    torch._foreach_add_(params, vs)
            group["count"] += 1
        return loss


def sanitized_direction(g: torch.Tensor) -> torch.Tensor:
    """Unit-norm direction of ``g``: nan entries drop to 0, inf entries
    keep their sign (the usual overflow is one saturated accumulator, and
    the direction survives it); zero for an all-zero gradient."""
    g = torch.where(torch.isnan(g), 0.0, g)
    g = torch.clamp(g, -_F32_BIG, _F32_BIG)
    m = g.abs().max()
    scaled = torch.where(m > 0, g / torch.where(m > 0, m, 1.0), 0.0)
    norm = torch.sqrt((scaled * scaled).sum())
    return torch.where(norm > 0, scaled / torch.where(norm > 0, norm, 1.0),
                       0.0)


def physics_update(g, p, count, rel_step: float, floor: float,
                   step_decay: float):
    """``radar_physics_transform``'s update of parameter ``p`` with
    gradient ``g`` after ``count`` active steps (a float32 0-d tensor):

        update = -rel_step * step_decay^count * max(max|p|, floor)
                 * sanitized_direction(g)

    and the new count, one more only where the sanitized direction is not
    zero (an all-nan or all-zero gradient moves nothing and spends no
    decay). With ``floor = 0`` a positive scalar never crosses zero; a
    parameter that starts at zero needs ``floor > 0`` to move. Everything
    stays on ``p``'s device."""
    scale = rel_step * torch.clamp(p.abs().max(), min=floor)
    if step_decay != 1.0:
        scale = scale * torch.pow(step_decay, count)
    update = (-scale * sanitized_direction(g)).to(p.dtype)
    clean = torch.nan_to_num(g, nan=0.0, posinf=1.0, neginf=-1.0)
    return update, count + (clean != 0).any().to(count.dtype)


def radar_param_label(name: str) -> str:
    """The partition of the parameter ``name``: ``radar_lambda``,
    ``radar_loc`` or ``backbone``."""
    for label in ("radar_lambda", "radar_loc"):
        if label in name:
            return label
    return "backbone"


class RadarOptimizer(torch.optim.Optimizer):
    """The spectrogram trainer's optimizer: Adam (optax's, ``b1`` 0.9,
    ``b2`` 0.999, ``eps`` 1e-8 outside the square root) on the backbone at
    ``learning_rate`` (a float, or a function of the step count taken
    before its increment, as ``optax.adam(schedule)`` takes it), and
    :func:`physics_update` on ``radar_lambda`` (``lambda_rel_step``, floor
    0, ``lambda_step_decay``) and ``radar_loc`` (``loc_step`` meters up to
    1 m, then relative: floor 1).

    ``named_parameters`` is ``model.named_parameters()``: the partition is
    by name. A parameter whose gradient is None (frozen: ``requires_grad``
    off) is skipped, so it neither moves nor counts a step; a zero
    gradient moves a physics parameter by zero and counts no step either.
    The Adam moments, the step count and each physics parameter's active
    count are in ``state_dict``."""

    def __init__(self, named_parameters, learning_rate,
                 lambda_rel_step: float = 1e-2, loc_step: float = 1e-2,
                 lambda_step_decay: float = 1.0):
        parts = {"backbone": [], "radar_lambda": [], "radar_loc": []}
        for name, p in named_parameters:
            parts[radar_param_label(name)].append(p)
        physics = {
            "radar_lambda": dict(rel_step=lambda_rel_step, floor=0.0,
                                 step_decay=lambda_step_decay),
            "radar_loc": dict(rel_step=loc_step, floor=1.0, step_decay=1.0),
        }
        groups = [dict(params=parts["backbone"], label="backbone", count=0)]
        groups += [dict(params=parts[k], label=k, **v)
                   for k, v in physics.items()]
        super().__init__([g for g in groups if g["params"]], {})
        self.learning_rate = learning_rate

    def current_lr(self) -> float:
        count = next(g["count"] for g in self.param_groups
                     if g["label"] == "backbone")
        if callable(self.learning_rate):
            return self.learning_rate(count)
        return self.learning_rate

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if group["label"] == "backbone":
                self._adam(group, params)
                continue
            for p in params:
                state = self.state[p]
                if "count" not in state:
                    state["count"] = torch.zeros((), device=p.device)
                update, state["count"] = physics_update(
                    p.grad, p, state["count"], group["rel_step"],
                    group["floor"], group["step_decay"],
                )
                p.add_(update)
        return loss

    def _adam(self, group, params):
        lr = self.current_lr()
        b1, b2 = ADAM_B1, ADAM_B2
        group["count"] += 1
        if not params:
            return
        for p in params:
            if "mu" not in self.state[p]:
                self.state[p]["mu"] = torch.zeros_like(p)
                self.state[p]["nu"] = torch.zeros_like(p)
        grads = [p.grad for p in params]
        mus = [self.state[p]["mu"] for p in params]
        nus = [self.state[p]["nu"] for p in params]
        t = group["count"]
        torch._foreach_mul_(mus, b1)
        torch._foreach_add_(mus, grads, alpha=1.0 - b1)
        torch._foreach_mul_(nus, b2)
        torch._foreach_addcmul_(nus, grads, grads, value=1.0 - b2)
        denom = torch._foreach_div(nus, 1.0 - b2**t)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, ADAM_EPS)
        update = torch._foreach_div(mus, 1.0 - b1**t)
        torch._foreach_div_(update, denom)
        torch._foreach_add_(params, update, alpha=-lr)
