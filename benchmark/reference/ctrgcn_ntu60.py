"""Plain reference of CTR-GCN for NTU RGB+D 60 (Chen et al., ICCV 2021,
arXiv:2107.12213), as the configuration ``ctrgcn_ntu60`` states it.

Plain PyTorch in float32 with TF32 off: no kernel, nothing of the program.
It follows the published ``model/ctrgcn.py`` (github.com/Uason-Chen/
CTR-GCN) module by module, as functions of a dict of weights named as the
published modules name them (``parameter_spec``):

* ``data_bn``, a BatchNorm over the ``M * V * C`` features of ``(N, M V C,
  T)``;
* ten ``TCN_GCN_unit``\\ s ``l1`` ... ``l10``, each ``relu(tcn1(gcn1(x)) +
  residual(x))``:

  - ``gcn1`` (``unit_gcn``, adaptive): for each subset ``k`` of the
    spatial stack ``[I, norm(In), norm(Out)]`` held as the learnable
    ``PA``, ``CTRGC``: ``x1 = mean_T(conv1(x))``, ``x2 = mean_T(conv2(x))``,
    ``S = conv4(tanh(x1[..., :, None] - x2[..., None, :])) * alpha + PA_k``,
    ``z_k = einsum("ncuv,nctv->nctu", S, conv3(x))``; then ``relu(bn(sum_k
    z_k) + down(x))``, ``down`` a 1x1 conv and BatchNorm where the width
    changes, else the identity;
  - ``tcn1`` (``MultiScale_TemporalConv``, ``residual=False``): four
    branches of ``C / 4`` channels, concatenated: 1x1, BN, ReLU and a
    5-tap conv (dilation 1, then 2; padding ``(5 + 4 (d - 1) - 1) // 2``;
    the block's stride) and BN; 1x1, BN, ReLU, max-pool (3, 1) (stride,
    padding 1) and BN; a strided 1x1 and BN;
  - ``residual``: none in ``l1``, the identity where the width and stride
    are kept, else ``unit_tcn`` (a strided 1x1 conv and BatchNorm);

* the mean over ``T V``, then over the bodies, and ``fc``.

BatchNorm normalizes with the batch's biased statistics in training and the
running ones in eval, epsilon 1e-5. Departures from the published code: the
weights are seeded (``alpha`` away from its published 0, which would hide
the refinement from every comparison); dropout is 0, as the NTU-60 recipe
has it; the trainer's weight decay is the program's L2 penalty on the conv
and dense weights (``l2_weight * sum w^2``, so a gradient of ``2 l2_weight
w``), where the published recipe decays every parameter.

``control`` names a lower precision (``compare.rounding``) that the
reference then rounds to where the configuration's compute type rounds:
each block's input, every conv's weight and output, every BatchNorm's
output and the aggregation's output (not the refined topology, which the
program keeps in float32).
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
TEMPORAL_KERNEL = 5
DILATIONS = (1, 2)
BN_EPSILON = 1e-5
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


def relation_channels(config, c_in):
    """The published ``rel_channels``: 8 for the 3-channel input, else
    ``c_in // 8``."""
    return (config["relation_small"] if c_in in (3, 9)
            else c_in // config["relation_reduction"])


def spatial_adjacency() -> np.ndarray:
    """The published ``graph.ntu_rgb_d.Graph("spatial").A``: ``(3, V, V)``
    ``[I, In, Out]`` with ``A[dst, src] = 1`` per directed edge (``In``:
    child to parent), each column divided by its sum."""
    v = NUM_JOINTS
    inward = np.zeros((v, v))
    for child, parent in INWARD:
        inward[parent - 1, child - 1] = 1.0
    outward = inward.T.copy()

    def normalize(m):
        deg = m.sum(0)
        return m / np.where(deg > 0, deg, 1.0)[None, :]

    return np.stack([np.eye(v), normalize(inward),
                     normalize(outward)]).astype(np.float32)


def parameter_spec(config) -> dict:
    """``{name: (shape, kind)}`` of every parameter and statistic, kinds
    ``conv`` (weights, fan-out variance scaling), ``bias``, ``bn_scale``,
    ``bn_bias``, ``bn_mean``, ``bn_var`` and ``adjacency`` (``PA``, made
    from the stack by the model builder); ``alpha`` is ``bn_scale``, so
    that it is drawn uniformly in [0.5, 1.5]."""
    spec = {}

    def conv(prefix, c_out, c_in, taps=1):
        spec[f"{prefix}.weight"] = ((c_out, c_in, taps, 1), "conv")
        spec[f"{prefix}.bias"] = ((c_out,), "bias")

    def bn(prefix, c):
        for leaf, kind in (("weight", "bn_scale"), ("bias", "bn_bias"),
                           ("running_mean", "bn_mean"),
                           ("running_var", "bn_var")):
            spec[f"{prefix}.{leaf}"] = ((c,), kind)

    bn("data_bn", config["bodies"] * NUM_JOINTS * IN_CHANNELS)
    for i, (c_in, c, stride, residual) in enumerate(blocks(config)):
        p = f"l{i + 1}"
        g = f"{p}.gcn1"
        spec[f"{g}.PA"] = ((K_PARTS, NUM_JOINTS, NUM_JOINTS), "adjacency")
        spec[f"{g}.alpha"] = ((1,), "bn_scale")
        rel = relation_channels(config, c_in)
        for k in range(K_PARTS):
            conv(f"{g}.convs.{k}.conv1", rel, c_in)
            conv(f"{g}.convs.{k}.conv2", rel, c_in)
            conv(f"{g}.convs.{k}.conv3", c, c_in)
            conv(f"{g}.convs.{k}.conv4", c, rel)
        if c_in != c:
            conv(f"{g}.down.0", c, c_in)
            bn(f"{g}.down.1", c)
        bn(f"{g}.bn", c)
        t = f"{p}.tcn1.branches"
        bc = c // (len(DILATIONS) + 2)
        for j, _ in enumerate(DILATIONS):
            conv(f"{t}.{j}.0", bc, c)
            bn(f"{t}.{j}.1", bc)
            conv(f"{t}.{j}.3.conv", bc, bc, TEMPORAL_KERNEL)
            bn(f"{t}.{j}.3.bn", bc)
        j = len(DILATIONS)
        conv(f"{t}.{j}.0", bc, c)
        bn(f"{t}.{j}.1", bc)
        bn(f"{t}.{j}.4", bc)
        conv(f"{t}.{j + 1}.0", bc, c)
        bn(f"{t}.{j + 1}.1", bc)
        if residual and (c_in != c or stride != 1):
            conv(f"{p}.residual.conv", c, c_in)
            bn(f"{p}.residual.bn", c)
    last = config["blocks"][-1][0]
    spec["fc.weight"] = ((config["num_classes"], last), "conv")
    spec["fc.bias"] = ((config["num_classes"],), "bias")
    return spec


def trainable(spec) -> list:
    return [k for k, (_, kind) in spec.items()
            if kind not in ("bn_mean", "bn_var")]


def decayed(spec) -> list:
    """The leaves the trainer's L2 penalty covers: conv and dense
    weights."""
    return [k for k, (_, kind) in spec.items() if kind == "conv"]


def batch_norm(x, w, prefix, train, stats=None):
    """BatchNorm over axis 1 of ``x``; in training the batch's biased
    statistics (``stats``, when given, collects them)."""
    shape = (1, -1) + (1,) * (x.ndim - 2)
    if train:
        axes = (0,) + tuple(range(2, x.ndim))
        mean = x.mean(axes)
        var = x.var(axes, unbiased=False)
        if stats is not None:
            stats[f"{prefix}.running_mean"] = mean.detach()
            stats[f"{prefix}.running_var"] = var.detach()
    else:
        mean, var = w[f"{prefix}.running_mean"], w[f"{prefix}.running_var"]
    scale = torch.rsqrt(var + BN_EPSILON) * w[f"{prefix}.weight"]
    return ((x - mean.reshape(shape)) * scale.reshape(shape)
            + w[f"{prefix}.bias"].reshape(shape))


def conv(x, w, prefix, rnd, stride=1, dilation=1):
    """The published ``nn.Conv2d`` of kernel ``(kt, 1)`` with padding
    ``(kt + (kt - 1) (dilation - 1) - 1) // 2``."""
    weight = w[f"{prefix}.weight"]
    kt = weight.shape[2]
    pad = (kt + (kt - 1) * (dilation - 1) - 1) // 2
    return rnd(F.conv2d(x, rnd(weight), w[f"{prefix}.bias"],
                        stride=(stride, 1), padding=(pad, 0),
                        dilation=(dilation, 1)))


def ctrgc(x, w, prefix, a, alpha, rnd):
    """One subset's ``CTRGC(x, A, alpha)``."""
    x1 = conv(x, w, f"{prefix}.conv1", rnd).mean(-2)
    x2 = conv(x, w, f"{prefix}.conv2", rnd).mean(-2)
    x3 = conv(x, w, f"{prefix}.conv3", rnd)
    x1 = torch.tanh(x1.unsqueeze(-1) - x2.unsqueeze(-2))
    x1 = conv(x1, w, f"{prefix}.conv4", rnd) * alpha + a[None, None]
    return torch.einsum("ncuv,nctv->nctu", x1, x3)


def unit_gcn(x, w, prefix, c_in, c, train, rnd, stats):
    y = None
    for k in range(K_PARTS):
        z = ctrgc(x, w, f"{prefix}.convs.{k}", w[f"{prefix}.PA"][k],
                  w[f"{prefix}.alpha"], rnd)
        y = z if y is None else y + z
    y = rnd(batch_norm(rnd(y), w, f"{prefix}.bn", train, stats))
    if c_in != c:
        down = rnd(batch_norm(conv(x, w, f"{prefix}.down.0", rnd), w,
                              f"{prefix}.down.1", train, stats))
    else:
        down = x
    return torch.relu(y + down)


def multiscale_tcn(x, w, prefix, stride, train, rnd, stats):
    def bn(h, name):
        return rnd(batch_norm(h, w, f"{prefix}.{name}", train, stats))

    outs = []
    for j, dilation in enumerate(DILATIONS):
        h = torch.relu(bn(conv(x, w, f"{prefix}.{j}.0", rnd), f"{j}.1"))
        h = conv(h, w, f"{prefix}.{j}.3.conv", rnd, stride, dilation)
        outs.append(bn(h, f"{j}.3.bn"))
    j = len(DILATIONS)
    h = torch.relu(bn(conv(x, w, f"{prefix}.{j}.0", rnd), f"{j}.1"))
    h = F.max_pool2d(h, (3, 1), (stride, 1), (1, 0))
    outs.append(bn(h, f"{j}.4"))
    h = conv(x, w, f"{prefix}.{j + 1}.0", rnd, stride)
    outs.append(bn(h, f"{j + 1}.1"))
    return torch.cat(outs, dim=1)


def block(x, w, i, spec_block, train, rnd, stats):
    c_in, c, stride, residual = spec_block
    p = f"l{i + 1}"
    x = rnd(x)
    y = unit_gcn(x, w, f"{p}.gcn1", c_in, c, train, rnd, stats)
    y = multiscale_tcn(y, w, f"{p}.tcn1.branches", stride, train, rnd, stats)
    if not residual:
        res = 0.0
    elif c_in != c or stride != 1:
        res = rnd(batch_norm(conv(x, w, f"{p}.residual.conv", rnd, stride),
                             w, f"{p}.residual.bn", train, stats))
    else:
        res = x
    return torch.relu(y + res)


def forward(config, w, x, train, control=None, remat=False, stats=None):
    """Logits ``(N, classes)`` of clips ``x (N, 3, T, V, M)``. ``remat``
    recomputes each block in the backward pass (memory only: the same
    arithmetic)."""
    rnd = rounding(control)
    n, c, t, v, m = x.shape
    x = x.permute(0, 4, 3, 1, 2).reshape(n, m * v * c, t)
    x = batch_norm(x, w, "data_bn", train, stats)
    x = x.view(n, m, v, c, t).permute(0, 1, 3, 4, 2).reshape(n * m, c, t, v)
    for i, spec_block in enumerate(blocks(config)):
        if remat:
            x = checkpoint(block, x, w, i, spec_block, train, rnd, None,
                           use_reentrant=False)
        else:
            x = block(x, w, i, spec_block, train, rnd, stats)
    x = x.reshape(n, m, x.shape[1], -1).mean(3).mean(1)
    return F.linear(x, w["fc.weight"], w["fc.bias"])


def cross_entropy(logits, y_onehot):
    """The summed softmax cross-entropy over the batch size."""
    return -(torch.log_softmax(logits, -1) * y_onehot).sum() / len(logits)


def train_readings(config, params, weights, batches, control=None):
    """Follow the program's first ``len(batches)`` SGD steps (Keras 2's
    Nesterov rule: ``v = m v - lr g``; ``p += m v - lr g``) from
    ``weights``, the loss holding ``params["l2_weight"]`` times the sum of
    the squared conv and dense weights: each step's loss, the first
    gradient per leaf (on the host) and its norm, and the norm of each
    leaf's change after the last step."""
    spec = parameter_spec(config)
    names, decay = trainable(spec), decayed(spec)
    l2_weight = params.get("l2_weight", 0.0)
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
                                         remat=params.get("remat", False)),
                                 y)
            if l2_weight:
                loss = loss + l2_weight * sum(w[k].square().sum()
                                              for k in decay)
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


def flops(config, batch, train):
    """Operations of one training step (forward and backward) or one
    forward of ``batch`` clips, counted by ``FlopCounterMode`` on the meta
    device over this reference, with no recomputation."""
    from torch.utils.flop_counter import FlopCounterMode

    spec = parameter_spec(config)
    meta = torch.device("meta")
    w = {k: torch.empty(shape, device=meta, requires_grad=kind not in (
        "bn_mean", "bn_var")) for k, (shape, kind) in spec.items()}
    x = torch.empty((batch, IN_CHANNELS, config["frames"], NUM_JOINTS,
                     config["bodies"]), device=meta)
    with FlopCounterMode(display=False) as counter:
        logits = forward(config, w, x, train)
        if train:
            logits.sum().backward()
    return counter.get_total_flops()
