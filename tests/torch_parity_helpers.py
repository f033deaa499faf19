"""Helpers shared by the PyTorch port's parity tests (``test_torch_*.py``)."""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from skeleton_action_recognition_tpu.train.train_state import (
    create_train_state,
)
from skeleton_action_recognition_tpu_torch import interop

# The suite runs in several worker processes at once, and every worker
# imports this module while it collects. torch's default of one intra-op
# thread per core in each worker oversubscribes the cores several times
# over (measured: the port's tests took 4x as long under four workers).
torch.set_num_threads(2)


def randomized_variables(model, x, seed):
    """Initialize a flax ST-GCN on ``x[:1]`` and redraw, from a numpy seed,
    every BatchNorm scale, running mean and running variance and every
    bias, so that eval-mode BatchNorm and the bias paths do real work.
    Returns the variables as nested dicts of numpy arrays."""
    return redrawn(jax.device_get(
        model.init(jax.random.key(0), jnp.asarray(x[:1]))
    ), seed)


def redrawn(variables, seed):
    """``variables`` with every BatchNorm scale, running mean and running
    variance and every bias redrawn from ``seed``, as
    :func:`randomized_variables` does."""
    rng = np.random.default_rng(seed)

    def redraw(path, leaf):
        name = path[-1].key
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name in ("mean", "bias"):
            return rng.normal(0.0, 0.1, leaf.shape).astype(np.float32)
        return np.asarray(leaf, np.float32)

    return jax.tree_util.tree_map_with_path(redraw, variables)


def cotangent(shape, seed):
    """A seeded normal cotangent of ``shape``, float32."""
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def layer_parity(flax_module, port, variables, inputs, train, seed=0,
                 pick=lambda out: out):
    """Run ``flax_module.apply(variables, *inputs, train)`` and the port's
    module ``port(*inputs)`` (its state loaded from ``variables`` through
    the bridge) on the numpy ``inputs``, and take both gradients of
    ``sum(pick(out) * ct)`` for one seeded cotangent ``ct``.

    Returns a dict of ``(jax, port)`` numpy pairs: ``out``, ``inputs`` (the
    inputs' gradients), and dicts keyed by the port's state-dict names:
    ``params`` (the parameters' gradients) and, in training,
    ``batch_stats`` (the running statistics after the call)."""
    from skeleton_action_recognition_tpu_torch import interop

    mutable = ["batch_stats"] if train else False
    shape = jax.eval_shape(
        lambda: pick(_unpack(flax_module.apply(
            variables, *map(jnp.asarray, inputs), train, mutable=mutable),
            train)[0]))
    ct = cotangent(shape.shape, seed)

    def loss(params, *xs):
        out, stats = _unpack(flax_module.apply(
            {**variables, "params": params}, *xs, train, mutable=mutable),
            train)
        return jnp.sum(pick(out).astype(jnp.float32) * ct), (out, stats)

    (_, (jax_out, jax_stats)), jax_grads = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(1 + len(inputs))), has_aux=True
    ))(variables["params"], *map(jnp.asarray, inputs))

    port.load_state_dict(interop.flax_to_state_dict(variables))
    port.train(train)
    xs = [torch.tensor(x, requires_grad=True) for x in inputs]
    out = port(*xs)
    (pick(out).float() * torch.from_numpy(ct)).sum().backward()

    def numpy_tree(tree):
        return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))

    want = interop.flax_to_state_dict({"params": numpy_tree(jax_grads[0])})
    result = {
        "out": (np.asarray(pick(jax_out), np.float32),
                pick(out).detach().float().numpy()),
        # an input the module does not use has no gradient: zeros in JAX
        "inputs": [(np.asarray(g), np.zeros_like(g) if x.grad is None
                    else x.grad.numpy())
                   for g, x in zip(jax_grads[1:], xs)],
        "params": {name: (want[name].numpy(), np.zeros(p.shape, np.float32)
                          if p.grad is None else p.grad.numpy())
                   for name, p in port.named_parameters()},
    }
    assert set(want) == set(result["params"])
    if train:
        stats = interop.flax_to_state_dict(
            {"batch_stats": numpy_tree(jax_stats.get("batch_stats", {}))})
        got = port.state_dict()
        result["batch_stats"] = {
            name: (w.numpy(), got[name].numpy()) for name, w in stats.items()
        }
    return result


def _unpack(applied, train):
    return applied if train else (applied, {})


def assert_parity(result, out_tol, grad_tol, stats_tol=1e-5):
    """``result`` of :func:`layer_parity` within absolute tolerances, each
    relative to the largest magnitude of the JAX side it bounds. A
    parameter's gradient is held relative to at least a tenth of the
    largest parameter gradient: a bias followed by a training-mode
    BatchNorm has a gradient that the normalization cancels, rounding
    noise of ~1e-7 of the largest gradient in both frameworks."""
    def close(pair, tol, what, floor=1e-30):
        want, got = pair
        assert got.shape == want.shape, what
        scale = max(float(np.abs(want).max()), floor)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                                   err_msg=what)

    close(result["out"], out_tol, "out")
    for i, pair in enumerate(result["inputs"]):
        close(pair, grad_tol, f"input {i} gradient")
    floor = 0.1 * max(float(np.abs(w).max())
                       for w, _ in result["params"].values())
    for name, pair in result["params"].items():
        close(pair, grad_tol, f"{name} gradient", floor)
    for name, pair in result.get("batch_stats", {}).items():
        close(pair, stats_tol, name)


WORKER = pathlib.Path(__file__).with_name("test_torch_parallel_worker.py")


class Ranks:
    """``job`` running on ``world`` gloo ranks in the background (the test
    computes its reference meanwhile); :meth:`wait` returns each rank's
    results."""

    def __init__(self, tmp_path, job, world=2):
        job_file = tmp_path / "job.pt"
        torch.save(job, job_file)
        env = {k: v for k, v in os.environ.items()
               if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                            "MASTER_PORT")}
        env["OMP_NUM_THREADS"] = "2"
        self.outs = [tmp_path / f"rank{r}.pt" for r in range(world)]
        self.procs = [
            subprocess.Popen(
                [sys.executable, str(WORKER), str(r), str(world),
                 str(tmp_path / "rendezvous"), str(job_file), str(out)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            )
            for r, out in enumerate(self.outs)
        ]

    def wait(self, timeout=240):
        try:
            logs = [p.communicate(timeout=timeout)[0].decode()
                    for p in self.procs]
        finally:
            for p in self.procs:
                p.kill()
        for p, log in zip(self.procs, logs):
            assert p.returncode == 0, log[-3000:]
        return [torch.load(out, weights_only=False) for out in self.outs]


def jax_init(model, x, tx):
    """``create_train_state``'s state from key 0, and its variables as the
    port's state dict."""
    state = create_train_state(model, jax.random.key(0), jnp.asarray(x[:1]),
                               tx)
    return state, interop.flax_to_state_dict(jax.device_get(
        {"params": state.params, "batch_stats": state.batch_stats}))


def jax_one_device(state, x, y, step_fn, *flags):
    """JAX's loss and state dict after one step on the whole batch."""
    state, m = jax.jit(step_fn, static_argnums=tuple(
        range(3, 3 + len(flags))))(state, jnp.asarray(x), jnp.asarray(y),
                                   *flags)
    after = interop.flax_to_state_dict(jax.device_get(
        {"params": state.params, "batch_stats": state.batch_stats}))
    return float(m["loss"]), after


def assert_ranks_equal(results):
    """Every rank ends with the same parameters and statistics, bit for
    bit, and reports the same (global) metrics."""
    first = results[0]
    for other in results[1:]:
        assert other["metrics"] == first["metrics"]
        for name, t in first["state"].items():
            assert torch.equal(other["state"][name], t), name


def assert_state_close(got, want, atol, rtol=0.0):
    assert got.keys() == want.keys()
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=rtol,
                                   atol=atol, err_msg=name)
