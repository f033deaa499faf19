"""Plain reference of ST-GCN for NTU RGB+D 60 (Yan, Xiong & Lin, AAAI 2018,
arXiv:1801.07455), as the configuration ``stgcn_ntu60`` states it.

Plain PyTorch in float32 with TF32 off: no kernel, no fold, nothing of the
program. Its parameters are named as the weights that the benchmark makes
(``parameter_spec``). The forward, the loss, autograd's gradients and the
trainer's SGD (Keras 2's Nesterov rule) are written here from the paper
and the configuration:

* a BatchNorm over the ``V * C`` input features, then ten blocks, each a
  spatial graph conv (a 1x1 conv into ``K * C_out`` channels contracted
  with the ``(K, V, V)`` spatial-partition stack), BatchNorm, ReLU, a
  9-tap temporal conv (SAME padding, stride 2 entering the 128- and
  256-wide stages), BatchNorm, a residual (identity, or a strided 1x1
  conv and BatchNorm where the width or stride changes; none in the first
  block) and ReLU;
* the mean over frames and joints, the mean over the two bodies and a
  dense head of 60 logits;
* BatchNorm (epsilon 1e-3, momentum 0.99) normalizes with the batch's
  biased statistics in training and with the running ones in eval.

``control`` names a lower precision (``compare.rounding``) that the
reference then rounds to where the configuration's compute type rounds:
each block's input, the spatial and temporal weights and outputs and the
BatchNorm output fed to the temporal conv.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from harness.compare import full_f32, rounding

NUM_JOINTS = 25
IN_CHANNELS = 3
K_PARTS = 3
TAPS = 9
BN_EPSILON = 1e-3
# 1-indexed (child, parent) bones of the NTU RGB+D skeleton
INWARD = [
    (1, 2), (2, 21), (3, 21), (4, 3), (5, 21), (6, 5), (7, 6),
    (8, 7), (9, 21), (10, 9), (11, 10), (12, 11), (13, 1),
    (14, 13), (15, 14), (16, 15), (17, 1), (18, 17), (19, 18),
    (20, 19), (22, 23), (23, 8), (24, 25), (25, 12),
]


def blocks(config):
    """``(c_in, filters, stride, residual)`` of each block."""
    plan, c = [], IN_CHANNELS
    for filters, stride, residual in config["blocks"]:
        plan.append((c, filters, stride, residual))
        c = filters
    return plan


def spatial_adjacency() -> np.ndarray:
    """``(3, V, V)`` ``[I, In, Out]``: ``A[k, src, dst]`` routes a source
    joint into a destination, the inward and outward stacks divided by
    each destination column's in-degree (the paper's spatial
    partitioning)."""
    v = NUM_JOINTS
    inward = np.zeros((v, v))
    for child, parent in INWARD:
        inward[parent - 1, child - 1] = 1.0  # row: destination
    outward = inward.T.copy()

    def normalize(m):
        deg = m.sum(0)
        return m / np.where(deg > 0, deg, 1.0)[None, :]

    return np.stack([np.eye(v), normalize(inward), normalize(outward)])


def parameter_spec(config) -> dict:
    """``{name: (shape, kind)}`` of every parameter and statistic, kinds
    ``conv`` (weights, fan-out variance scaling), ``bias``, ``bn_scale``,
    ``bn_bias``, ``bn_mean`` and ``bn_var``."""
    spec = {}

    def bn(prefix, c):
        for leaf, kind in (("weight", "bn_scale"), ("bias", "bn_bias"),
                           ("running_mean", "bn_mean"),
                           ("running_var", "bn_var")):
            spec[f"{prefix}.{leaf}"] = ((c,), kind)

    bn("backbone.data_bn.BatchNorm_0", NUM_JOINTS * IN_CHANNELS)
    for i, (c_in, c, stride, residual) in enumerate(blocks(config)):
        p = f"backbone.block_{i}"
        if residual and (c_in != c or stride != 1):
            spec[f"{p}.residual_conv.weight"] = ((c, c_in, 1, 1), "conv")
            spec[f"{p}.residual_conv.bias"] = ((c,), "bias")
            bn(f"{p}.residual_bn", c)
        spec[f"{p}.sgcn.Dense_0.weight"] = ((K_PARTS * c, c_in), "conv")
        spec[f"{p}.sgcn.Dense_0.bias"] = ((K_PARTS * c,), "bias")
        bn(f"{p}.tgcn.BatchNorm_0", c)
        spec[f"{p}.tgcn.Conv_0.weight"] = ((c, c, TAPS, 1), "conv")
        spec[f"{p}.tgcn.Conv_0.bias"] = ((c,), "bias")
        bn(f"{p}.tgcn.BatchNorm_1", c)
    last = config["blocks"][-1][0]
    spec["backbone.logits.weight"] = ((config["num_classes"], last), "conv")
    spec["backbone.logits.bias"] = ((config["num_classes"],), "bias")
    return spec


def trainable(spec) -> list:
    return [k for k, (_, kind) in spec.items()
            if kind not in ("bn_mean", "bn_var")]


def batch_norm(x, w, prefix, train, stats=None):
    """BatchNorm over the last axis; in training the batch's biased
    statistics (``stats``, when given, collects them)."""
    if train:
        axes = tuple(range(x.ndim - 1))
        mean = x.mean(axes)
        var = x.var(axes, unbiased=False)
        if stats is not None:
            stats[f"{prefix}.running_mean"] = mean.detach()
            stats[f"{prefix}.running_var"] = var.detach()
    else:
        mean, var = w[f"{prefix}.running_mean"], w[f"{prefix}.running_var"]
    scale = torch.rsqrt(var + BN_EPSILON) * w[f"{prefix}.weight"]
    return (x - mean) * scale + w[f"{prefix}.bias"]


def temporal_conv(x, weight, bias, stride):
    """``(kt, 1)`` conv over T of channels-last ``x (N, T, V, C)``, SAME
    padding (the smaller half before)."""
    t, kt = x.shape[1], weight.shape[2]
    total = max((-(-t // stride) - 1) * stride + kt - t, 0)
    x = F.pad(x, (0, 0, 0, 0, total // 2, total - total // 2))
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, stride=(stride, 1))
    return y.permute(0, 2, 3, 1)


def block(x, w, a, i, spec_block, train, rnd, stats):
    c_in, c, stride, residual = spec_block
    p = f"backbone.block_{i}"
    x = rnd(x)
    if not residual:
        res = 0.0
    elif c_in != c or stride != 1:
        res = batch_norm(
            temporal_conv(x, rnd(w[f"{p}.residual_conv.weight"]),
                          w[f"{p}.residual_conv.bias"], stride),
            w, f"{p}.residual_bn", train, stats)
    else:
        res = x
    z = F.linear(x, rnd(w[f"{p}.sgcn.Dense_0.weight"]),
                 w[f"{p}.sgcn.Dense_0.bias"])
    z = z.reshape(z.shape[:-1] + (K_PARTS, c))
    h = rnd(torch.einsum("ntvko,kvw->ntwo", z, a))
    h = rnd(torch.relu(batch_norm(h, w, f"{p}.tgcn.BatchNorm_0", train,
                                  stats)))
    h = rnd(temporal_conv(h, rnd(w[f"{p}.tgcn.Conv_0.weight"]),
                          w[f"{p}.tgcn.Conv_0.bias"], stride))
    h = batch_norm(h, w, f"{p}.tgcn.BatchNorm_1", train, stats)
    return torch.relu(h + res)


def forward(config, w, x, train, control=None, remat=False, stats=None):
    """Logits ``(N, classes)`` of clips ``x (N, 3, T, V, M)``. ``remat``
    recomputes each block in the backward pass (memory only: the same
    arithmetic)."""
    rnd = rounding(control)
    a = torch.as_tensor(spatial_adjacency(), dtype=x.dtype, device=x.device)
    n, c, t, v, m = x.shape
    x = x.permute(0, 4, 2, 3, 1).reshape(n * m, t, v * c)
    x = batch_norm(x, w, "backbone.data_bn.BatchNorm_0", train, stats)
    x = x.reshape(n * m, t, v, c)
    for i, spec_block in enumerate(blocks(config)):
        if remat:
            x = checkpoint(block, x, w, a, i, spec_block, train, rnd, None,
                           use_reentrant=False)
        else:
            x = block(x, w, a, i, spec_block, train, rnd, stats)
    x = x.mean(dim=(1, 2)).reshape(n, m, -1).mean(dim=1)
    return F.linear(x, w["backbone.logits.weight"], w["backbone.logits.bias"])


def cross_entropy(logits, y_onehot):
    """The summed softmax cross-entropy over the batch size."""
    return -(torch.log_softmax(logits, -1) * y_onehot).sum() / len(logits)


def train_readings(config, params, weights, batches, control=None):
    """Follow the program's first ``len(batches)`` SGD steps (Keras 2's
    Nesterov rule: ``v = m v - lr g``; ``p += m v - lr g``) from
    ``weights``: each step's loss, the first gradient per leaf (on the
    host) and its norm, and the norm of each leaf's change after the last
    step."""
    spec = parameter_spec(config)
    names = trainable(spec)
    device = batches[0][0].device
    with full_f32():
        w = {k: v.to(device, torch.float32).clone() for k, v in
             weights.items()}
        start = {k: w[k].clone() for k in names}
        velocity = {k: torch.zeros_like(w[k]) for k in names}
        lr, momentum = params["lr"], params["momentum"]
        losses, grads = [], None
        for x, y in batches:
            for k in names:
                w[k].requires_grad_(True)
            loss = cross_entropy(forward(config, w, x, True, control,
                                         remat=True), y)
            g = torch.autograd.grad(loss, [w[k] for k in names])
            losses.append(loss.item())
            if grads is None:
                grads = {k: gi.detach().cpu() for k, gi in zip(names, g)}
            with torch.no_grad():
                for k, gi in zip(names, g):
                    w[k] = w[k].detach()
                    velocity[k] = momentum * velocity[k] - lr * gi
                    w[k] += momentum * velocity[k] - lr * gi
            del g, loss
        deltas = {k: (w[k] - start[k]).norm().item() for k in names}
    return {"losses": losses, "grad_tensors": grads,
            "grads": {k: v.norm().item() for k, v in grads.items()},
            "deltas": deltas}


def calibrate_statistics(config, weights, x):
    """``weights`` with every BatchNorm's running statistics set to the
    batch statistics of the clips ``x`` (the reference's own forward), so
    that eval-mode BatchNorm normalizes what it sees."""
    stats = {}
    with torch.no_grad(), full_f32():
        w = {k: v.float() for k, v in weights.items()}
        forward(config, w, x, True, stats=stats)
    out = dict(weights)
    out.update(stats)
    return out


def probabilities(config, weights, x, control=None, rows=64):
    """Eval-mode class probabilities of clips ``x``, ``rows`` clips at a
    time."""
    with torch.no_grad(), full_f32():
        w = {k: v.float() for k, v in weights.items()}
        return torch.cat([
            torch.softmax(forward(config, w, x[i:i + rows], False, control),
                          -1)
            for i in range(0, len(x), rows)])


def flops(config, batch, train):
    """Operations of one training step (forward and backward) or one
    forward of ``batch`` clips, counted by ``FlopCounterMode`` on the meta
    device over this reference, with no recomputation."""
    from torch.utils.flop_counter import FlopCounterMode

    spec = parameter_spec(config)
    meta = torch.device("meta")
    w = {k: torch.empty(shape, device=meta, requires_grad=kind in (
        "conv", "bias", "bn_scale", "bn_bias")) for k, (shape, kind) in
        spec.items()}
    x = torch.empty((batch, IN_CHANNELS, config["frames"], NUM_JOINTS,
                     config["bodies"]), device=meta)
    with FlopCounterMode(display=False) as counter:
        logits = forward(config, w, x, train)
        if train:
            logits.sum().backward()
    return counter.get_total_flops()
