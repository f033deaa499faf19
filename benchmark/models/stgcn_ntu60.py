"""The port's ST-GCN (``stgcn_ntu60``) as the cells run it, from the
benchmark's seeded weights: a training step as ``main_gnn`` builds it, and
a ``Predictor``. The reference gets the same weights
(``reference/stgcn_ntu60.py``)."""

from __future__ import annotations

import torch

from harness import inputs, manifest

REFERENCE = manifest.module("reference", "stgcn_ntu60")
DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def make_weights(config, seed, device) -> dict:
    return inputs.seeded_weights(REFERENCE.parameter_spec(config), seed,
                                 device)


def make_clips(config, n, g, device):
    return inputs.skeleton_clips(n, config["frames"], config["joints"],
                                 config["bodies"], g, device)


def model(config, params, weights, device):
    """The port's ``models.stgcn.Model`` on the cell's route, holding
    ``weights``."""
    from skeleton_action_recognition_tpu_torch.models import stgcn

    m = stgcn.Model(
        num_classes=config["num_classes"], dtype=DTYPES[params["dtype"]],
        fused_sgcn=params.get("fused_sgcn", False),
        fused_sgcn_min_channels=params.get("fused_sgcn_min_channels", 0),
        remat=params.get("remat", True),
        fused_tconv=params.get("fused_tconv", False),
        sgcn_stats=params.get("sgcn_stats", False), device=device,
    )
    m.load_state_dict(weights, strict=True)
    return m


def build_train(config, params, weights, device):
    """``(model, optimizer, step)``: ``step(x, y)`` is one call of
    ``train.steps.make_train_step``'s step with the adjacency frozen,
    under ``train.optim.TFSGD`` (Nesterov) at the cell's rate."""
    from skeleton_action_recognition_tpu_torch.train import optim, steps

    m = model(config, params, weights, device)
    opt = optim.TFSGD(m.parameters(), params["lr"],
                      momentum=params["momentum"], nesterov=True)
    step = steps.make_train_step(m, opt, params["batch"],
                                 params.get("l2_weight", 0.0))
    return m, opt, lambda x, y: step(x, y, False)


def first_gradients(model_, optimizer, params) -> dict:
    """Each leaf's first gradient as the optimizer got it, on the host,
    from its state after one step: TFSGD's velocity is ``-lr g`` then
    (zeros for a leaf the step left without state)."""
    state = optimizer.state
    return {name: (-state[p]["velocity"] / params["lr"]).float().cpu()
            if "velocity" in state.get(p, {}) else torch.zeros(p.shape)
            for name, p in model_.named_parameters()}


def build_predictor(config, params, weights, device):
    """``serving.Predictor`` over the stock model holding ``weights``:
    ``fused`` the folded route (``quantize`` as the cell says)."""
    from skeleton_action_recognition_tpu_torch.serving import Predictor

    m = model(config, {"dtype": "float32", "remat": False}, weights, device)
    return Predictor(m, max_batch=params["request"], device=device,
                     fused=params.get("fused", False),
                     quantize=params.get("quantize"))


def step_flops(config, params) -> int:
    """A training step's model operations (the reference's count)."""
    return REFERENCE.flops(config, params["batch"], True)


def request_flops(config, params) -> int:
    """A request's forward operations (the reference's count of the stock
    model, whatever the route folds)."""
    return REFERENCE.flops(config, params["request"], False)


def op_shapes(config, params) -> dict:
    """The kernels' work in one training step, by op: a dict of shape
    records per launch that the work counts (``counts/``) take."""
    nm = params["batch"] * config["bodies"]
    t, shapes = config["frames"], {"sgcn": [], "tconv": []}
    for c_in, c, stride, _ in REFERENCE.blocks(config):
        if params.get("fused_sgcn") and c >= params.get(
                "fused_sgcn_min_channels", 0):
            shapes["sgcn"].append(dict(rows=nm * t * config["joints"],
                                       c_in=c_in, c_out=c,
                                       dtype=params["dtype"]))
        t = -(-t // stride)
        if params.get("fused_tconv") and stride == 1:
            shapes["tconv"].append(dict(rows=nm * t * config["joints"], c=c,
                                        dtype=params["dtype"]))
    return shapes
