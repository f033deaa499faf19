"""The port's CTR-GCN (``ctrgcn_ntu60``) as the cells run it, from the
benchmark's seeded weights: a training step as ``main_gnn --model ctrgcn``
builds it. The reference gets the same weights
(``reference/ctrgcn_ntu60.py``), whose names are the published modules'
and the port's alike.

``params["fault"] = "no_refinement"`` plants the mechanism's own fault in
the program: each block's topology is ``PA`` alone, ``alpha * Q`` left
out (a run with it must not be correct)."""

from __future__ import annotations

import torch

from harness import inputs, manifest

REFERENCE = manifest.module("reference", "ctrgcn_ntu60")
DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def make_weights(config, seed, device) -> dict:
    """The seeded weights of the reference's ``parameter_spec``; each
    ``PA`` the spatial stack, as published."""
    spec = REFERENCE.parameter_spec(config)
    out = inputs.seeded_weights(
        {k: v for k, v in spec.items() if v[1] != "adjacency"}, seed, device)
    a = torch.from_numpy(REFERENCE.spatial_adjacency()).to(device)
    return {k: a.clone() if kind == "adjacency" else out[k]
            for k, (_, kind) in spec.items()}


def make_clips(config, n, g, device):
    return inputs.skeleton_clips(n, config["frames"], config["joints"],
                                 config["bodies"], g, device)


def drop_refinement(model_) -> None:
    """Every block's topology ``PA`` alone (the fault ``no_refinement``)."""
    from skeleton_action_recognition_tpu_torch.models import ctrgcn

    for mod in model_.modules():
        if isinstance(mod, ctrgcn.UnitGCN):
            def topology(x, mod=mod):
                n, v = x.shape[0], x.shape[-1]
                return mod.PA[None, :, None].expand(
                    n, -1, mod.out_channels, v, v).contiguous()

            mod.topology = topology


def model(config, params, weights, device):
    """The port's ``models.ctrgcn.Model`` on the cell's route, holding
    ``weights``."""
    from skeleton_action_recognition_tpu_torch.models import ctrgcn

    m = ctrgcn.Model(num_classes=config["num_classes"],
                     dtype=DTYPES[params["dtype"]],
                     remat=params.get("remat", True), device=device)
    m.load_state_dict(weights, strict=True)
    if params.get("fault") == "no_refinement":
        drop_refinement(m)
    return m


def build_train(config, params, weights, device):
    """``(model, optimizer, step)``: ``step(x, y)`` is one call of
    ``train.steps.make_train_step``'s step under ``train.optim.TFSGD``
    (Nesterov) at the cell's rate, the L2 penalty at ``l2_weight``."""
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


def step_flops(config, params) -> int:
    """A training step's model operations (the reference's count)."""
    return REFERENCE.flops(config, params["batch"], True)


def op_shapes(config, params) -> dict:
    """The kernels' work in one training step, by op: one ``ctrgc``
    record a block (``counts/ctrgc.py``), at the frames the block's graph
    conv sees (its input's: the stride is in the temporal conv after)."""
    nm = params["batch"] * config["bodies"]
    t, shapes = config["frames"], {"ctrgc": []}
    for _, c, stride, _ in REFERENCE.blocks(config):
        shapes["ctrgc"].append(dict(n=nm, k=config["subsets"], c=c, t=t,
                                    v=config["joints"], act=params["dtype"],
                                    dtype="float32"))
        t = -(-t // stride)
    return shapes
