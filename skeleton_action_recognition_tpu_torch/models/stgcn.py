"""ST-GCN: spatio-temporal graph convolutional network.

Counterpart of ``skeleton_action_recognition_tpu/models/stgcn.py``: a data
BatchNorm over the flattened ``(V * C)`` features, 10 blocks (64 x4,
128 x3 with stride 2 first, 256 x3 with stride 2 first), each a spatial
graph conv, a BN -> ReLU -> ``[9, 1]`` temporal conv -> BN and a residual,
then pooling, the mean over bodies and a dense logits head. Activations are
channels-last ``(N*M, T, V, C)``. Module and parameter names follow the flax
tree, so :func:`..interop.flax_to_state_dict` maps a JAX checkpoint's
variables one to one. ``model.train()`` selects the flax ``train=True``
path (batch statistics); ``model.eval()`` the running statistics.

Two training options replace the temporal chain's eager BatchNorm passes
with CUDA kernels, as in the JAX model: ``sgcn_stats`` takes BN1's batch
statistics from the fused spatial conv's epilogue
(:class:`StatsTemporalConv`), and ``fused_tconv`` runs BN1's normalize, the
ReLU, the temporal conv and BN2's statistics in one kernel on the stride-1
blocks, and BN2's normalize, the residual and the block's ReLU in another
(:class:`FusedTemporalConv`). Both keep ``TemporalConv``'s state
dict. In a process group every batch statistic, the kernels' sums
included, is taken over the global batch
(:func:`..parallel.distributed.global_means`).
"""

from __future__ import annotations

import functools

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import (
    checkpoint,
    create_selective_checkpoint_contexts,
)

from skeleton_action_recognition_tpu_torch.graphs.ntu_rgb_d import (
    NUM_JOINTS,
    spatial_adjacency,
)
from skeleton_action_recognition_tpu_torch.models.gcn import GraphConvTD
from skeleton_action_recognition_tpu_torch.models.layers import (
    BatchNorm,
    frozen_stats,
    init_layer,
)
from skeleton_action_recognition_tpu_torch.ops.tconv import (
    TAPS,
    affine_relu_tconv,
    block_tail,
)
from skeleton_action_recognition_tpu_torch.parallel.distributed import (
    global_means,
)

IN_CHANNELS = 3  # x, y, z of each joint
# (filters, temporal stride, residual) per block
BLOCK_PLAN = (
    (64, 1, False),
    (64, 1, True),
    (64, 1, True),
    (64, 1, True),
    (128, 2, True),
    (128, 1, True),
    (128, 1, True),
    (256, 2, True),
    (256, 1, True),
    (256, 1, True),
)


# what the remat policies keep of a block's forward for its backward:
# "full" its inputs alone, "dots" also the outputs of the matrix products
# that F.linear and einsum lower to (jax.checkpoint_policies.checkpoint_dots
# keeps dot_general's). Convolutions, BatchNorm, ReLU and the CUDA kernels
# (launched outside the dispatcher) are recomputed under both.
REMAT_POLICIES = ("full", "dots")
SAVED_PRODUCTS = (
    torch.ops.aten.mm.default,
    torch.ops.aten.addmm.default,
    torch.ops.aten.bmm.default,
)


def _same_padding(size: int, kernel: int, stride: int):
    """flax/XLA ``padding="SAME"``: the smaller half before. For 9 taps at
    stride 2 on even T that is 3 before and 4 after, which no symmetric
    ``nn.Conv2d`` padding gives."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def temporal_conv(conv: nn.Conv2d, x, dtype=None):
    """Apply ``conv`` (kernel ``(kt, 1)``, stride ``(s, 1)``, no padding of
    its own) over T of channels-last ``x (N, T, V, C)`` with SAME padding,
    computing in ``dtype`` (None: ``x``'s)."""
    return same_conv(x, conv.weight, conv.bias, conv.stride[0], dtype)


def same_conv(x, weight, bias, stride: int, dtype=None):
    """The ``(kt, 1)`` conv ``weight`` (``(C_out, C_in, kt, 1)``; ``bias``
    or None) at stride ``(stride, 1)`` over T of channels-last ``x (N, T,
    V, C)`` with SAME padding, computing in ``dtype`` (None: ``x``'s)."""
    before, after = _same_padding(x.shape[1], weight.shape[2], stride)
    cd = dtype or x.dtype
    x = F.pad(x.to(cd), (0, 0, 0, 0, before, after))
    y = F.conv2d(
        x.permute(0, 3, 1, 2), weight.to(cd),
        None if bias is None else bias.to(cd), stride=(stride, 1),
    )
    return y.permute(0, 2, 3, 1)


def _conv(in_channels, filters, kernel_size, stride, generator):
    return init_layer(
        nn.Conv2d(
            in_channels, filters, (kernel_size, 1), stride=(stride, 1)
        ),
        generator,
    )


class TemporalConv(nn.Module):
    """BN -> ReLU -> Conv[kt, 1] (stride t, SAME) -> BN."""

    def __init__(
        self, in_channels: int, filters: int, kernel_size: int = 9,
        stride: int = 1, dtype=None, generator=None,
    ):
        super().__init__()
        self.dtype = dtype
        self.BatchNorm_0 = BatchNorm(in_channels, dtype)
        self.Conv_0 = _conv(
            in_channels, filters, kernel_size, stride, generator
        )
        self.BatchNorm_1 = BatchNorm(filters, dtype)

    def forward(self, x):
        x = torch.relu(self.BatchNorm_0(x))
        x = temporal_conv(self.Conv_0, x, self.dtype)
        return self.BatchNorm_1(x)


class FusedTemporalConv(nn.Module):
    """:class:`TemporalConv` at stride 1 whose training-mode chain runs
    through the fused kernels (:func:`..ops.tconv.affine_relu_tconv`):
    BN1's normalize, folded into a per-channel affine from the batch's
    statistics, the ReLU, the 9-tap conv and BN2's batch statistics in one
    pass; the JAX package's ``FusedTemporalConv``. It also ends the block:
    ``forward(x, res)`` returns ``relu(BN2(conv) + res)`` (``res=None``:
    no residual), in training through :func:`..ops.tconv.block_tail`'s
    kernels. Its numerics follow the JAX module and block: BN1's variance
    is ``E[x^2] - E[x]^2`` without a clamp at 0, and the output is float32
    in both modes, whatever ``dtype``. In eval the chain is the plain
    folded affine, ReLU and conv (no kernel). The parameters are
    :class:`TemporalConv`'s."""

    def __init__(
        self, in_channels: int, filters: int, kernel_size: int = TAPS,
        dtype=None, generator=None,
    ):
        super().__init__()
        if in_channels != filters or kernel_size != TAPS:
            raise ValueError(
                f"the fused chain takes C -> C channels over {TAPS} taps, "
                f"got {in_channels} -> {filters} over {kernel_size}"
            )
        self.dtype = dtype
        self.BatchNorm_0 = BatchNorm(in_channels, dtype)
        self.Conv_0 = _conv(in_channels, filters, kernel_size, 1, generator)
        self.BatchNorm_1 = BatchNorm(filters, dtype)

    def forward(self, x, res=None):
        bn0, conv, bn1 = self.BatchNorm_0, self.Conv_0, self.BatchNorm_1
        cd = self.dtype or x.dtype
        if not self.training:
            scale1, shift1 = bn0.folded_affine(bn0.running_mean,
                                               bn0.running_var)
            h = torch.relu(x.float() * scale1 + shift1).to(cd)
            half = TAPS // 2
            h = F.pad(h, (0, 0, 0, 0, half, half))
            y = F.conv2d(h.permute(0, 3, 1, 2), conv.weight.to(cd))
            u = y.permute(0, 2, 3, 1).float() + conv.bias
            scale2, shift2 = bn1.folded_affine(bn1.running_mean,
                                               bn1.running_var)
            y = u * scale2 + shift2
            return torch.relu(y if res is None else y + res)
        xf = x.float()
        axes = (0, 1, 2)
        mean, sq = global_means(xf.mean(axes), (xf * xf).mean(axes),
                                count=xf.numel() // xf.shape[-1])
        var = sq - mean * mean
        scale1, shift1 = bn0.folded_affine(mean, var)
        u, s2, ss2 = affine_relu_tconv(
            x.to(cd).contiguous(), scale1, shift1, conv.weight, conv.bias
        )
        n = u.numel() // u.shape[-1]
        mean2, sq2 = global_means(s2 / n, ss2 / n, count=n)
        var2 = sq2 - mean2 * mean2
        bn0.update_running(mean, var)
        bn1.update_running(mean2, var2)
        scale2, shift2 = bn1.folded_affine(mean2, var2)
        return block_tail(u, scale2, shift2,
                          None if res is None else res.contiguous())


class StatsTemporalConv(nn.Module):
    """:class:`TemporalConv` fed BN1's batch statistics, the f32 sums
    ``s`` and ``ss`` of its input and of its square per channel, by the
    spatial conv's epilogue (:func:`..ops.sgcn.fused_graph_conv_stats`),
    instead of reading the activation again; the JAX package's
    ``StatsTemporalConv``. BN1's variance is clamped at 0, as
    :class:`..layers.BatchNorm` does. In eval it uses the running
    statistics and takes no sums. The parameters are
    :class:`TemporalConv`'s."""

    def __init__(
        self, in_channels: int, filters: int, kernel_size: int = TAPS,
        stride: int = 1, dtype=None, generator=None,
    ):
        super().__init__()
        self.dtype = dtype
        self.BatchNorm_0 = BatchNorm(in_channels, dtype)
        self.Conv_0 = _conv(
            in_channels, filters, kernel_size, stride, generator
        )
        self.BatchNorm_1 = BatchNorm(filters, dtype)

    def forward(self, x, s=None, ss=None):
        bn0 = self.BatchNorm_0
        if self.training:
            n = x.numel() // x.shape[-1]
            mean, sq = global_means(s / n, ss / n, count=n)
            var = torch.clamp(sq - mean * mean, min=0.0)
            bn0.update_running(mean, var)
        else:
            mean, var = bn0.running_mean, bn0.running_var
        scale1, shift1 = bn0.folded_affine(mean, var)
        h = torch.relu(x.float() * scale1 + shift1).to(self.dtype or x.dtype)
        return self.BatchNorm_1(temporal_conv(self.Conv_0, h, self.dtype))


class STConvBlock(nn.Module):
    """Spatial conv + temporal conv + residual. The residual is absent
    (``residual=False``), the identity when the block's input channels and
    stride match its output, and otherwise a strided 1x1 conv + BN.

    ``sgcn_factory(in_channels, filters, generator)`` builds the spatial
    module (the JAX block's ``sgcn_factory``; ST-GIN's
    :class:`..gcn.GraphIsoConvTD`); by default it is
    :class:`..gcn.GraphConvTD` with the block's ``dtype`` and fused
    options. The temporal conv takes the spatial module's
    ``out_channels``, which for ST-GIN is half the block's width.

    The temporal chain, as the JAX block routes it: with ``sgcn_stats`` and
    a fused default spatial conv, :class:`StatsTemporalConv` (at either
    stride; it takes precedence over ``fused_tconv``); else with
    ``fused_tconv`` at stride 1, :class:`FusedTemporalConv`, which takes
    the residual and applies the block's ReLU itself; else
    :class:`TemporalConv`."""

    def __init__(
        self, in_channels: int, filters: int, stride: int = 1,
        residual: bool = True, dtype=None, fused_sgcn: bool = False,
        fused_tconv: bool = False, sgcn_stats: bool = False,
        sgcn_factory=None, generator=None,
    ):
        super().__init__()
        self.dtype = dtype
        self.residual = residual
        self.project = residual and (
            in_channels != filters or stride != 1
        )
        if self.project:
            self.residual_conv = _conv(
                in_channels, filters, 1, stride, generator
            )
            self.residual_bn = BatchNorm(filters, dtype)
        self.use_stats = sgcn_stats and fused_sgcn and sgcn_factory is None
        if sgcn_factory is None:
            self.sgcn = GraphConvTD(
                in_channels, filters, dtype=dtype, fused=fused_sgcn,
                emit_stats=self.use_stats, generator=generator,
            )
        else:
            self.sgcn = sgcn_factory(in_channels, filters, generator)
        spatial = self.sgcn.out_channels
        if self.use_stats:
            self.tgcn = StatsTemporalConv(
                spatial, filters, stride=stride, dtype=dtype,
                generator=generator,
            )
        elif fused_tconv and stride == 1:
            self.tgcn = FusedTemporalConv(
                spatial, filters, dtype=dtype, generator=generator,
            )
        else:
            self.tgcn = TemporalConv(
                spatial, filters, stride=stride, dtype=dtype,
                generator=generator,
            )

    def forward(self, x, a):
        if not self.residual:
            res = 0.0
        elif self.project:
            res = self.residual_bn(
                temporal_conv(self.residual_conv, x, self.dtype)
            )
        else:
            res = x
        x = self.sgcn(x, a)
        if isinstance(self.tgcn, FusedTemporalConv):
            return self.tgcn(x, res if self.residual else None)
        # in training a stats-emitting spatial conv gives (out, s, ss)
        x = self.tgcn(*x) if self.use_stats and self.training else self.tgcn(x)
        return torch.relu(x + res)


class DataBatchNorm(nn.Module):
    """BatchNorm over the flattened ``(V * C)`` features, ``(V, C)``
    row-major: stats per (joint, channel)."""

    def __init__(self, features: int, dtype=None):
        super().__init__()
        self.BatchNorm_0 = BatchNorm(features, dtype)

    def forward(self, x):
        nm, t, v, c = x.shape
        return self.BatchNorm_0(x.reshape(nm, t, v * c)).reshape(
            nm, t, v, c
        )


def reshape_skeleton_input(x):
    """``(N, C, T, V, M)`` -> per-body channels-last ``(N*M, T, V, C)``."""
    n, c, t, v, m = x.shape
    x = x.permute(0, 4, 2, 3, 1)  # N, M, T, V, C
    return x.reshape(n * m, t, v, c), n, m


def register_adjacency(module: nn.Module, a, trainable: bool) -> None:
    """Give ``module`` the float32 numpy stack ``a`` as its adjacency: the
    parameter ``adjacency_matrix`` (the flax ``params['adjacency_matrix']``,
    which the trainer's freeze looks for) when ``trainable``, else a
    constant buffer, which is not in the state dict, as it is not among the
    JAX model's params."""
    a = torch.from_numpy(a)
    if trainable:
        module.adjacency_matrix = nn.Parameter(a)
    else:
        module.register_buffer("adjacency", a, persistent=False)


def adjacency(module: nn.Module):
    """The adjacency :func:`register_adjacency` gave ``module``."""
    a = getattr(module, "adjacency_matrix", None)
    return module.adjacency if a is None else a


def check_remat_policy(policy: str) -> str:
    """``policy`` if it is one of ``REMAT_POLICIES``, else ``ValueError``
    (the JAX model takes any other name as "full")."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy must be one of {REMAT_POLICIES}, "
                         f"got {policy!r}")
    return policy


def remat_block(block: nn.Module, x, a=None, policy: str = "full"):
    """``block(x, a)`` (``block(x)`` for ``a`` None: CTR-GCN's blocks, whose
    topology is their own) under ``torch.utils.checkpoint``: its activations are
    dropped after the forward and recomputed in the backward (flax
    ``nn.remat``). ``policy`` "full" keeps the block's inputs alone; "dots"
    (``jax.checkpoint_policies.checkpoint_dots``) also keeps the outputs of
    ``SAVED_PRODUCTS``, through a selective-checkpoint context, so that the
    backward recomputes no matrix product. The recompute leaves the
    BatchNorm running statistics as the first run set them, as flax
    does."""
    first = [True]

    def run(x, a):
        with frozen_stats(block, frozen=not first[0]):
            first[0] = False
            return block(x) if a is None else block(x, a)

    options = {}
    if check_remat_policy(policy) == "dots":
        options["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, list(SAVED_PRODUCTS))
    return checkpoint(run, x, a, use_reentrant=False, **options)


class STGCNBackbone(nn.Module):
    """data-BN + the 10 blocks of ``BLOCK_PLAN`` + pooling/logits head, shared
    by the ST-GCN family: ``sgcn_factory`` builds each block's spatial
    module (see :class:`STConvBlock`), and ``extra_block_factory(
    in_channels, generator)`` returns ``(name, module)``, a module run as
    ``x = module(x, a)`` after block ``extra_block_index`` and registered
    under ``name`` (ST-PGCN's ``projection``). With ``remat``, each
    :class:`STConvBlock`, and not the extra block, is rematerialized when
    gradients are taken, as in JAX, under ``remat_policy`` (see
    :func:`remat_block`). ``sgcn_stats`` applies to the blocks whose
    spatial conv is fused; ``fused_tconv`` to the stride-1 blocks."""

    def __init__(
        self, num_classes: int = 60, dtype=None, fused_sgcn: bool = False,
        fused_sgcn_min_channels: int = 0, remat: bool = True,
        fused_tconv: bool = False, sgcn_stats: bool = False,
        sgcn_factory=None, extra_block_index=-1,
        extra_block_factory=None, generator=None, remat_policy: str = "full",
    ):
        super().__init__()
        self.remat = remat
        self.remat_policy = check_remat_policy(remat_policy)
        self.extra_block_index = extra_block_index
        self.extra_block_name = None
        self.data_bn = DataBatchNorm(NUM_JOINTS * IN_CHANNELS, dtype)
        c = IN_CHANNELS
        for i, (filters, stride, residual) in enumerate(BLOCK_PLAN):
            self.add_module(f"block_{i}", STConvBlock(
                c, filters, stride=stride, residual=residual, dtype=dtype,
                fused_sgcn=fused_sgcn and filters >= fused_sgcn_min_channels,
                fused_tconv=fused_tconv, sgcn_stats=sgcn_stats,
                sgcn_factory=sgcn_factory, generator=generator,
            ))
            c = filters
            if i == extra_block_index and extra_block_factory is not None:
                self.extra_block_name, extra = extra_block_factory(
                    c, generator)
                self.add_module(self.extra_block_name, extra)
        self.logits = init_layer(nn.Linear(c, num_classes), generator)

    def forward(self, x, a):
        x, n, m = reshape_skeleton_input(x)
        x = self.data_bn(x)
        remat = self.remat and torch.is_grad_enabled()
        for i in range(len(BLOCK_PLAN)):
            block = getattr(self, f"block_{i}")
            x = (remat_block(block, x, a, self.remat_policy) if remat
                 else block(x, a))
            if i == self.extra_block_index and self.extra_block_name:
                x = getattr(self, self.extra_block_name)(x, a)
        # pool in f32: a bf16 sum over T*V ~ 7.5k terms loses mantissa
        x = x.float().mean(dim=(1, 2))
        x = x.reshape(n, m, -1).mean(dim=1)  # mean over bodies
        return self.logits(x)


class Model(nn.Module):
    """ST-GCN model: ``(N, 3, T, V, M)`` -> ``(N, num_classes)`` logits.

    ``dtype`` (None or ``torch.bfloat16``) is the compute type of the
    blocks; parameters, pooling and logits stay float32. ``fused_sgcn``
    routes the spatial conv of every block with at least
    ``fused_sgcn_min_channels`` filters through the CUDA kernels.
    ``remat`` (default on, as in the JAX model) recomputes each block in
    the backward pass, keeping its inputs alone (``remat_policy="full"``)
    or its matrix products' outputs too (``"dots"``; another name raises).
    ``sgcn_stats`` (with ``fused_sgcn``) feeds BN1's batch statistics from
    the spatial kernel's epilogue, and ``fused_tconv`` runs the stride-1
    blocks' temporal chain through the fused kernels, both in training
    only (:class:`STConvBlock`).
    ``trainable_adjacency`` makes the spatial-partition stack a parameter,
    ``adjacency_matrix`` (the flax ``params['adjacency_matrix']``); the
    fused kernels take it as a constant, so the two exclude each other.
    Weights are drawn from ``generator`` on the CPU and moved to
    ``device``.
    """

    def __init__(
        self, num_classes: int = 60, dtype=None, fused_sgcn: bool = False,
        fused_sgcn_min_channels: int = 0, remat: bool = True,
        trainable_adjacency: bool = False, fused_tconv: bool = False,
        sgcn_stats: bool = False, device=None, generator=None,
        remat_policy: str = "full",
    ):
        super().__init__()
        if fused_sgcn and trainable_adjacency:
            raise ValueError(
                "fused_sgcn takes the adjacency as a constant; it is "
                "incompatible with trainable_adjacency"
            )
        self.backbone = STGCNBackbone(
            num_classes, dtype=dtype, fused_sgcn=fused_sgcn,
            fused_sgcn_min_channels=fused_sgcn_min_channels, remat=remat,
            fused_tconv=fused_tconv, sgcn_stats=sgcn_stats,
            generator=generator, remat_policy=remat_policy,
        )
        register_adjacency(self, spatial_adjacency(), trainable_adjacency)
        self.to(device)

    def forward(self, x):
        return self.backbone(x, adjacency(self))
