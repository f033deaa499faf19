"""The port's ST-GIN, ST-PGCN and ST-PGCN-P against the JAX models through
the weight bridge: parameter coverage, eval logits, train-mode logits and
batch statistics, gradients of the loss, and bfloat16."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skeleton_action_recognition_tpu.models import (
    layers as jax_layers,
    stgin as jax_stgin,
    stpgcn as jax_stpgcn,
    stpgcnp as jax_stpgcnp,
)
from skeleton_action_recognition_tpu_torch import graphs, interop
from skeleton_action_recognition_tpu_torch.models import (
    layers,
    stgin,
    stpgcn,
    stpgcnp,
)
from torch_parity_helpers import redrawn

# (JAX module, port module, the JAX model's options)
MODELS = {
    "stgin": (jax_stgin, stgin, {"remat": False}),
    "stpgcn": (jax_stpgcn, stpgcn, {"remat": False}),
    "stpgcnp": (jax_stpgcnp, stpgcnp, {}),
}
# (params, batch statistics) of the full-width NTU-60 models, as the JAX
# models' init counts them
COUNTS = {
    "stgin": (1_778_172, 13_590),
    "stpgcn": (3_088_338, 6_550),
    "stpgcnp": (4_243_858, 7_062),
}
CLASSES = 6
# f32 on the CPU, sums in other orders through 8-10 blocks: measured eval
# logits within 3e-7 (ST-GIN, ST-PGCN) and 2e-6 (ST-PGCN-P, its pools made
# soft by `_soften_pools`) of their scale
EVAL_TOL = 1e-5
# train-mode forward and backward, held against the JAX model evaluated in
# float64 (jax.enable_x64; its pooling rounds to float32 once, 6e-8).
# Measured: logits 1.4e-6, batch statistics 3e-6 of their scales
TRAIN_TOL = 1e-5
STATS_TOL = 2e-5
# A float32 run flips the few ReLUs whose input is within rounding of 0:
# moving the port's input by 1e-7 relative moves single gradient tensors by
# up to 1.8e-2 in norm (3.9e-2 in their largest element), and JAX's own
# float32 gradients are as far from its float64 ones. So each gradient is
# held in norm, relative to the larger of its own norm and a tenth of the
# largest in the same top-level module of the model (a bias before a
# training-mode BatchNorm has a gradient the normalization cancels; and
# ST-PGCN-P's pools, which normalize over their centers, scale its trunk's
# gradients down by ~1e-3, so each of its blocks, pools and convs is held
# to its own scale); a wiring fault moves it by order 1
GRAD_TOL = 5e-2
# ST-PGCN-P's pools at these draws: the mean entropy of each point's
# assignment q over the J centers lies at least this far from both 0 (every
# point on one center: the logits would not depend on the trunk) and ln J
# (q uniform: z would keep only the signs of the channel means)
POOL_ENTROPY_MARGIN = 0.5
# bfloat16 through 10 blocks, rounded at other places: measured 1.1e-3
# (ST-GIN) and 1.6e-3 (ST-PGCN) of the logits' scale
BF16_TOL = 1e-2


def _batch(seed, t=16):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 3, t, 25, 2)).astype(np.float32)
    y = np.eye(CLASSES, dtype=np.float32)[rng.integers(0, CLASSES, 2)]
    return x, y


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _soften_pools(variables):
    """ST-PGCN-P's variables with ``gconv_0`` (kernel and redrawn bias) at
    a tenth and ``pool_0``'s centers at 4x. At a fresh draw, ``gconv_0``'s
    output reaches ``pool_1`` at ~25x unit scale, so every point lands on
    one center, and ``pool_0``'s centers sit so close together that its q
    is nearly uniform: then the train-mode logits do not depend on the
    trunk. At these draws both pools' q are soft (see
    ``POOL_ENTROPY_MARGIN``)."""
    params = variables["params"]
    dense = params["gconv_0"]["Dense_0"]
    for leaf in ("kernel", "bias"):
        dense[leaf] = (dense[leaf] * np.float32(0.1)).astype(np.float32)
    proj = params["pool_0"]["SoftProjection_0"]
    proj["centers"] = (proj["centers"] * np.float32(4.0)).astype(np.float32)
    return variables


def _bridged(name, seed, **options):
    """The port's model drawn from ``seed``, its BatchNorm statistics and
    biases redrawn (ST-PGCN-P's pools softened, :func:`_soften_pools`), and
    the same variables as flax's: the JAX model is never initialized (that
    takes seconds a model)."""
    port = MODELS[name][1].Model(
        num_classes=CLASSES, generator=torch.Generator().manual_seed(seed),
        **options)
    variables = redrawn(interop.state_dict_to_flax(port.state_dict()),
                        seed + 1)
    if name == "stpgcnp":
        variables = _soften_pools(variables)
    port.load_state_dict(interop.flax_to_state_dict(variables))
    return port, variables


def _pool_entropies(port):
    """Hooks that record, for each projection pool of ``port``, the mean
    entropy of its points' assignments q, and the ``ln J`` it is held
    against."""
    seen = {}
    for name, module in port.named_children():
        if name.startswith("pool_"):
            module.SoftProjection_0.register_forward_hook(
                lambda m, args, out, name=name: seen.__setitem__(name, (
                    float(-(out[0] * out[0].clamp_min(1e-30).log()).detach().sum(
                        -1).mean()), math.log(out[0].shape[-1]))))
    return seen


def _jax_loss(model, variables, x, y):
    def loss(params):
        logits, mutated = model.apply(
            {**variables, "params": params}, x, True,
            mutable=["batch_stats"])
        ce = -jnp.mean(jnp.sum(jax.nn.log_softmax(logits) * y, -1))
        return ce, (logits, mutated["batch_stats"])

    return jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])


@pytest.fixture(scope="module", params=list(MODELS))
def pair(request):
    """One model's JAX and port runs from one set of bridged variables
    (random BatchNorm statistics and biases): eval logits in float32, and
    a train-mode forward and backward of the cross-entropy, JAX's in
    float64."""
    name = request.param
    jax_mod, _, options = MODELS[name]
    x, y = _batch(1)
    model = jax_mod.Model(num_classes=CLASSES, **options)
    port, variables = _bridged(name, 2)

    jax_eval = np.asarray(jax.jit(model.apply, static_argnums=2)(
        variables, jnp.asarray(x), False))
    with jax.enable_x64(True):
        (_, (jax_train, jax_stats)), jax_grads = _jax_loss(
            model, jax.tree_util.tree_map(np.float64, variables),
            jnp.asarray(x, jnp.float64), jnp.asarray(y, jnp.float64))
        jax_train, jax_stats, jax_grads = jax.device_get(
            (jax_train, jax_stats, jax_grads))

    with torch.no_grad():
        port_eval = port.eval()(torch.from_numpy(x)).numpy()
    port.train()
    entropies = _pool_entropies(port)
    logits = port(torch.from_numpy(x))
    assert len(entropies) == (2 if name == "stpgcnp" else 0)
    for pool, (h, most) in entropies.items():
        assert POOL_ENTROPY_MARGIN < h < most - POOL_ENTROPY_MARGIN, (
            pool, h, most)
    loss = -(torch.log_softmax(logits, -1) * torch.from_numpy(y)).sum(
        -1).mean()
    loss.backward()
    return {
        "name": name, "variables": variables, "port": port,
        "eval": (jax_eval, port_eval),
        "train": (np.asarray(jax_train), logits.detach().numpy()),
        "stats": (interop.flax_to_state_dict({"batch_stats": jax_stats}),
                  port.state_dict()),
        "grads": (interop.flax_to_state_dict({"params": jax_grads}),
                  {k: p.grad for k, p in port.named_parameters()}),
    }


@pytest.mark.parametrize("name", list(MODELS))
def test_bridge_covers_every_parameter(name):
    """Full width, 60 classes: every leaf of the JAX tree has the port's
    name and shape, with the JAX models' counts."""
    jax_mod, port_mod, options = MODELS[name]
    x = np.zeros((1, 3, 8, 25, 2), np.float32)
    variables = jax.device_get(jax.eval_shape(
        lambda: jax_mod.Model(num_classes=60, **options).init(
            jax.random.key(0), jnp.asarray(x))))
    state = interop.flax_to_state_dict(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), variables))
    port = port_mod.Model(num_classes=60)
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: tuple(v.shape) for k, v in port.state_dict().items()}
    n_params, n_stats = COUNTS[name]
    assert sum(p.numel() for p in port.parameters()) == n_params == sum(
        leaf.size for leaf in jax.tree_util.tree_leaves(variables["params"]))
    assert sum(v.numel() for k, v in port.state_dict().items()
               if "running_" in k) == n_stats


def test_eval_logits_match_jax(pair):
    want, got = pair["eval"]
    assert got.shape == (2, CLASSES) and np.abs(want).max() > 0.1
    assert _rel(got, want) < EVAL_TOL


def test_train_logits_and_batch_stats_match_jax(pair):
    want, got = pair["train"]
    assert _rel(got, want) < TRAIN_TOL
    stats, state = pair["stats"]
    assert stats and set(stats) <= set(state)
    for name, w in stats.items():
        assert _rel(state[name].numpy(), w.numpy()) < STATS_TOL, name


def test_gradients_match_jax(pair):
    want, got = pair["grads"]
    assert set(want) == set(got)
    floor = {}
    for name, w in want.items():
        top = name.split(".")[0]
        floor[top] = max(floor.get(top, 0.0), 0.1 * float(w.norm()))
    for name, w in want.items():
        scale = max(float(w.norm()), floor[name.split(".")[0]])
        err = float((got[name].double() - w.double()).norm())
        assert err < GRAD_TOL * scale, (name, err / scale)


def test_l2_penalty_matches_jax(pair):
    """The penalty skips the plain parameters (``epsilon``, ``centers``,
    ``variance``), as JAX's skips every leaf not named ``kernel``."""
    np.testing.assert_allclose(
        layers.l2_regularization(pair["port"]).item(),
        float(jax_layers.l2_regularization(pair["variables"]["params"])),
        rtol=1e-5)


def _logits_and_block_dtypes(model, variables, x):
    """JAX's eval logits and the dtype of each block's (and the
    projection's) output."""
    logits, inter = jax.jit(lambda v, x: model.apply(
        v, x, False, capture_intermediates=True,
        mutable=["intermediates"]))(variables, x)
    backbone = inter["intermediates"]["backbone"]
    return np.asarray(logits), {
        name: out["__call__"][0][0].dtype.name
        for name, out in backbone.items()
        if name.startswith(("block_", "projection"))}


@pytest.mark.parametrize("name", ["stgin", "stpgcn"])
def test_bf16_tracks_jax_bf16(name):
    """``dtype=bfloat16``: logits within BF16_TOL of JAX's, and each
    block's output in JAX's type: ST-GIN's GIN layers compute in float32
    and its temporal convs in bfloat16; ST-PGCN's projection output is
    float32, and so is every block output after it that adds an identity
    residual to it."""
    jax_mod, port_mod, options = MODELS[name]
    x, _ = _batch(3)
    _, variables = _bridged(name, 4)
    model = jax_mod.Model(num_classes=CLASSES, dtype=jnp.bfloat16, **options)
    want, want_dtypes = _logits_and_block_dtypes(model, variables,
                                                 jnp.asarray(x))

    port = port_mod.Model(num_classes=CLASSES, dtype=torch.bfloat16).eval()
    port.load_state_dict(interop.flax_to_state_dict(variables))
    got_dtypes = {}
    for child, module in port.backbone.named_children():
        if child.startswith(("block_", "projection")):
            module.register_forward_hook(
                lambda m, args, out, child=child: got_dtypes.__setitem__(
                    child, str(out.dtype).removeprefix("torch.")))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert got_dtypes == want_dtypes
    if name == "stpgcn":
        assert want_dtypes["projection"] == "float32"
    assert _rel(got.numpy(), want) < BF16_TOL


@pytest.mark.parametrize("name", list(MODELS))
def test_trainable_adjacency_is_bridged(name):
    """``trainable_adjacency``: the stack is ``params['adjacency_matrix']``
    in both trees, both ways, with a gradient in the port."""
    jax_mod, _, options = MODELS[name]
    x, _ = _batch(5, t=8)
    port, variables = _bridged(name, 6, trainable_adjacency=True)
    shapes = jax.eval_shape(lambda: jax_mod.Model(
        num_classes=CLASSES, trainable_adjacency=True, **options).init(
            jax.random.key(0), jnp.asarray(x)))
    assert jax.tree_util.tree_structure(shapes) == (
        jax.tree_util.tree_structure(variables))
    np.testing.assert_array_equal(
        variables["params"]["adjacency_matrix"], {
            "stgin": graphs.Graph("spatial").A[:2],
        }.get(name, graphs.spatial_adjacency()).astype(np.float32))
    port.train()
    (port(torch.from_numpy(x)) * torch.from_numpy(
        np.random.default_rng(7).normal(size=(2, CLASSES)).astype(
            np.float32))).sum().backward()
    assert float(port.adjacency_matrix.grad.abs().max()) > 0
