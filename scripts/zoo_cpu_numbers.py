"""CPU-side numbers of the port's GNN zoo (ST-GIN, ST-PGCN, ST-PGCN-P, the
debug ST-GCN), which the zoo's tolerances and predictions rest on.

    PYTHONPATH=.:tests python scripts/zoo_cpu_numbers.py flops
    PYTHONPATH=.:tests python scripts/zoo_cpu_numbers.py sensitivity
    PYTHONPATH=.:tests python scripts/zoo_cpu_numbers.py chaos
    PYTHONPATH=.:tests python scripts/zoo_cpu_numbers.py lr [--jax]
    PYTHONPATH=.:tests python scripts/zoo_cpu_numbers.py projection

* ``flops``: matmul and convolution operations a clip (T=300, 2 bodies,
  remat off), forward and forward + backward, by
  ``torch.utils.flop_counter``, for ST-GCN and the zoo;
* ``sensitivity``: how far the full-width models' logits (2 seeded clips,
  weights and BatchNorm statistics as ``chip_smoke.py`` seeds them) move,
  relative to their scale, when the input moves by 1e-7 relative, eval
  and train mode: the float32 rounding any other summation order (the
  card's) adds;
* ``chaos``: the same for the gradients of ``tests/test_torch_zoo.py``'s
  loss at its shape and draws, by tensor (largest element and norm,
  relative to the larger of the tensor's and a tenth of the largest in its
  top-level module, as the test holds them);
* ``lr``: ST-PGCN-P's losses over 5 Keras-SGD steps from a fresh seeded
  init at B=2, T=300, lr 0.1, 0.01 and 1e-3; with ``--jax`` the JAX
  model's too at 0.01, from the same weights (needs the JAX package);
* ``projection``: ``SoftProjection``'s q, z and a_proj, the port's and
  JAX's, against the float64 oracle of ``tests/test_torch_projection.py``
  and against each other, over four seeds (max |diff| / max |oracle|).

CPU only; ``chaos``, ``lr --jax`` and ``projection`` need jax (the test
helpers).
"""

from __future__ import annotations

import copy
import sys

import numpy as np
import torch

import chip_smoke
from skeleton_action_recognition_tpu_torch.models import model_class
from skeleton_action_recognition_tpu_torch.train import steps as steps_lib
from skeleton_action_recognition_tpu_torch.train.optim import TFSGD

ZOO = ("stgin", "stpgcn", "stpgcnp", "experimental")


def _moved(x, eps, seed=5):
    noise = np.random.default_rng(seed).normal(size=x.shape)
    return x * (1 + eps * torch.from_numpy(noise.astype(np.float32)))


def flops():
    from torch.utils.flop_counter import FlopCounterMode

    for name in ("stgcn",) + ZOO:
        options = ({"remat": False} if name in ("stgcn", "stgin", "stpgcn")
                   else {})
        model = model_class(name)(num_classes=60, **options).train()
        with FlopCounterMode(display=False) as counter:
            out = model(torch.randn(1, 3, 300, 25, 2))
            forward = counter.get_total_flops()
            out.sum().backward()
        print(f"{name}: {forward / 1e9:.1f} GFLOP a clip forward, "
              f"{counter.get_total_flops() / 1e9:.1f} forward + backward")


def sensitivity():
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 3, 300, 25, 2)).astype(np.float32))
    for name in ZOO:
        model = chip_smoke.zoo_model(name)
        for mode in ("eval", "train"):
            outs = []
            for eps in (0.0, 1e-7, -1e-7):
                m = copy.deepcopy(model).train(mode == "train")
                with torch.no_grad():
                    outs.append(m(_moved(x, eps)))
            moved = max(float((o - outs[0]).abs().max()
                              / outs[0].abs().max()) for o in outs[1:])
            print(f"{name} {mode}: logits move by {moved:.2e} of scale")


def chaos():
    import test_torch_zoo as zoo

    x, y = zoo._batch(1)
    for name in zoo.MODELS:
        port, _ = zoo._bridged(name, 2)
        grads = []
        for eps in (0.0, 1e-7, -1e-7, 3e-7, 1e-6):
            port.zero_grad()
            logits = port.train()(_moved(torch.from_numpy(x), eps, seed=9))
            (-(torch.log_softmax(logits, -1) * torch.from_numpy(y)).sum(-1)
             .mean()).backward()
            grads.append({k: p.grad.clone()
                          for k, p in port.named_parameters()})
        base = grads[0]
        for norm, what in ((lambda t: t.abs().max(), "largest element"),
                           (torch.linalg.vector_norm, "norm")):
            floor = {}  # a tenth of the largest in each top-level module
            for k, g in base.items():
                top = k.split(".")[0]
                floor[top] = max(floor.get(top, 0.0), 0.1 * float(norm(g)))
            worst = max(
                (float(norm(g[k] - base[k])) / max(float(norm(base[k])),
                                                   floor[k.split(".")[0]]),
                 k)
                for g in grads[1:] for k in g)
            print(f"{name} gradients, {what}: up to {worst[0]:.2e} ({worst[1]})")


def lr(with_jax):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 3, 300, 25, 2)).astype(np.float32)
    y = np.eye(60, dtype=np.float32)[rng.integers(0, 60, 2)]
    for rate in (0.1, 0.01, 1e-3):
        model = model_class("stpgcnp")(
            num_classes=60, generator=torch.Generator().manual_seed(0))
        if rate == 0.01:
            state = copy.deepcopy(model.state_dict())
        step = steps_lib.make_train_step(model, TFSGD(model.parameters(),
                                                      rate), 2)
        losses = [step(torch.from_numpy(x), torch.from_numpy(y), False)
                  ["loss"].item() for _ in range(5)]
        print(f"port lr {rate}: losses {losses}")
    if with_jax:
        import jax
        import jax.numpy as jnp

        from skeleton_action_recognition_tpu.models import stpgcnp
        from skeleton_action_recognition_tpu.train import make_train_step
        from skeleton_action_recognition_tpu.train.optim import tf_sgd
        from skeleton_action_recognition_tpu.train.train_state import (
            TrainState,
        )
        from skeleton_action_recognition_tpu_torch import interop

        variables = interop.state_dict_to_flax(state)
        train = TrainState.create(
            apply_fn=stpgcnp.Model(num_classes=60).apply,
            params=variables["params"],
            batch_stats=variables["batch_stats"],
            tx=tf_sgd(0.01, 0.9, nesterov=True))
        jax_step = jax.jit(make_train_step(global_batch_size=2),
                           static_argnums=3)
        losses = []
        for _ in range(5):
            train, metrics = jax_step(train, jnp.asarray(x), jnp.asarray(y),
                                      False)
            losses.append(float(metrics["loss"]))
        print(f"JAX lr 0.01: losses {losses}")


def projection():
    import jax.numpy as jnp

    import test_torch_projection as proj

    for seed in range(4):
        x = proj._points(2 * seed)
        flax_layer, variables, port = proj._soft_projection(x, 2 * seed + 1)
        params = variables["params"]
        want = proj.oracle(x, params["centers"], params["variance"])
        jax_out = dict(zip(("q", "z", "a_proj"),
                           flax_layer.apply(variables, jnp.asarray(x))))
        with torch.no_grad():
            port_out = dict(zip(("q", "z", "a_proj"),
                                port(torch.from_numpy(x))))
        for stage, w in want.items():
            got, ref = port_out[stage].numpy(), np.asarray(jax_out[stage])
            print(f"seed {seed} {stage}: port {proj._rel_err(got, w):.1e}, "
                  f"JAX {proj._rel_err(ref, w):.1e} from float64; "
                  f"port from JAX {proj._rel_err(got, ref):.1e}")


if __name__ == "__main__":
    torch.set_num_threads(4)
    mode = sys.argv[1] if len(sys.argv) > 1 else ""
    if mode == "flops":
        flops()
    elif mode == "sensitivity":
        sensitivity()
    elif mode == "chaos":
        chaos()
    elif mode == "lr":
        lr("--jax" in sys.argv[2:])
    elif mode == "projection":
        projection()
    else:
        raise SystemExit(__doc__)
