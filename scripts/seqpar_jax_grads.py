"""The JAX package's sequence-parallel radar return differentiated on
meshes of 1, 2, 4 and 8 virtual CPU devices, against its single-device
``radar_return_upsampled``: the ratio of the gradients' norms and their
relative distance, for the joints, the location and the wavelength.

``shard_map`` runs there with ``check_vma=False``, and the JAX package's
own test of the op checks only its forward; this is the check of its
backward the port's ``radar_return_sharded`` is held beside
(``tests/test_torch_seqpar_radar.py``). CPU only:

    python scripts/seqpar_jax_grads.py
"""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from skeleton_action_recognition_tpu import parallel  # noqa: E402
from skeleton_action_recognition_tpu.ops import (  # noqa: E402
    radar_return_sharded,
    radar_return_upsampled,
)
from skeleton_action_recognition_tpu.ops.resample import (  # noqa: E402
    pad_frames_operator,
)


def main():
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(2, 3, 30, 25, 2)).astype(np.float32)
                    * 0.3)
    w = jnp.asarray(pad_frames_operator(30, 20))
    loc = jnp.asarray([0.1, -0.2, 0.3], jnp.float32)
    lam = jnp.asarray(10.0)
    gre, gim = (jnp.asarray(rng.normal(size=(2, 600)).astype(np.float32))
                for _ in range(2))

    def loss(fn):
        def f(x, loc, lam):
            re, im = fn(x, loc, lam)
            return jnp.sum(re * gre + im * gim)
        return jax.jit(jax.grad(f, (0, 1, 2)))

    want = loss(lambda *a: radar_return_upsampled(a[0], w, *a[1:]))(
        x, loc, lam)
    for devices in (1, 2, 4, 8):
        mesh = parallel.create_mesh(devices=jax.devices()[:devices])
        got = loss(lambda *a: radar_return_sharded(a[0], w, *a[1:], mesh))(
            x, loc, lam)
        for name, g, r in zip(("x", "loc", "lambda"), got, want):
            print(f"devices {devices} {name}: norm ratio "
                  f"{float(jnp.linalg.norm(g) / jnp.linalg.norm(r)):.9f}, "
                  f"relative distance "
                  f"{float(jnp.linalg.norm(g - r) / jnp.linalg.norm(r)):.3e}")


if __name__ == "__main__":
    main()
