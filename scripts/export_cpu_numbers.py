"""CPU-side numbers of the port's folded serving predictors
(``models/export.py``), which their tolerances and the refusals rest on.

    PYTHONPATH=.:tests python scripts/export_cpu_numbers.py parity
    PYTHONPATH=.:tests python scripts/export_cpu_numbers.py non_stock

* ``parity``: ``tests/test_torch_export.py``'s set-up (the full-width
  NTU-60 ST-GCN, seeded variables, 2 clips of 16 frames): for each route
  (f32, bf16, W8, W8A8) the port's logits against the JAX package's same
  route and against the port's stock eval forward, max |diff| / max |JAX|
  (resp. |stock|), and each fold's host seconds on this machine;
* ``non_stock``: what the JAX package's folded predictor does with a model
  it was not written for: ST-PGCN (its tree holds a ``projection`` the fold
  does not read) and an ST-GCN with a trainable adjacency scaled by 1.5
  (the fold reads the constant graph): whether it raises, and its logits
  against the JAX model's own eval forward, max |diff| / max |model|.

CPU only, and needs jax (the JAX package and the test helpers).
"""

from __future__ import annotations

import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from skeleton_action_recognition_tpu.models import export as jax_export
from skeleton_action_recognition_tpu.models import stgcn as jax_stgcn
from skeleton_action_recognition_tpu.models import stpgcn as jax_stpgcn
from skeleton_action_recognition_tpu_torch import interop
from skeleton_action_recognition_tpu_torch.models import export, stgcn
from torch_parity_helpers import randomized_variables


def clips(n=2, t=16):
    return np.random.default_rng(0).normal(size=(n, 3, t, 25, 2)).astype(
        np.float32)


def rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def parity():
    x = clips()
    variables = randomized_variables(jax_stgcn.Model(num_classes=60), x,
                                     seed=1)
    model = stgcn.Model(num_classes=60)
    model.load_state_dict(interop.flax_to_state_dict(variables))
    model.eval()
    with torch.no_grad():
        stock = model(torch.from_numpy(x)).numpy()
    params, stats = variables["params"], variables["batch_stats"]
    routes = {
        "f32": (lambda: export.fused_stgcn_predictor(model, torch.float32,
                                                     "cpu"),
                lambda: jax_export.FusedSTGCNPredictor(params, stats,
                                                       jnp.float32)),
        "bf16": (lambda: export.fused_stgcn_predictor(model, device="cpu"),
                 lambda: jax_export.FusedSTGCNPredictor(params, stats)),
        "w8": (lambda: export.quantized_stgcn_predictor(model, "cpu"),
               lambda: jax_export.QuantizedSTGCNPredictor(params, stats)),
        "w8a8": (lambda: export.int8_stgcn_predictor(model, "cpu"),
                 lambda: jax_export.Int8STGCNPredictor(params, stats)),
    }
    for route, (port_build, jax_build) in routes.items():
        start = time.perf_counter()
        port = port_build()
        fold_s = time.perf_counter() - start
        got = port(x).numpy()
        want = np.asarray(jax_build()(jnp.asarray(x)))
        print(f"{route}: port vs JAX {rel(got, want):.3g}, port vs stock "
              f"{rel(got, stock):.3g}, JAX vs stock {rel(want, stock):.3g}, "
              f"argmax equal {bool((got.argmax(-1) == want.argmax(-1)).all())}"
              f", fold {fold_s:.2f} s")
        del port


def non_stock():
    x = jnp.asarray(clips())
    cases = {"stpgcn": (jax_stpgcn.Model(num_classes=60), None),
             "trainable_adjacency": (
                 jax_stgcn.Model(num_classes=60, trainable_adjacency=True),
                 1.5)}
    for name, (model, scale) in cases.items():
        variables = randomized_variables(model, np.asarray(x), seed=1)
        if scale is not None:
            variables["params"]["adjacency_matrix"] = np.asarray(
                variables["params"]["adjacency_matrix"]) * scale
        want = np.asarray(model.apply(variables, x, train=False))
        try:
            folded = jax_export.fused_stgcn_predictor(
                variables["params"], variables["batch_stats"],
                dtype=jnp.float32, jit=False)
            got = np.asarray(folded(x))
        except Exception as err:  # report whatever the fold raises
            print(f"{name}: the JAX fold raises {type(err).__name__}: {err}")
            continue
        print(f"{name}: the JAX fold raises nothing; its logits against the "
              f"model's {rel(got, want):.3g} of scale")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    {"parity": parity, "non_stock": non_stock}[sys.argv[1]]()
