"""Seeded weights and inputs, made on the device in a few large calls.

Weights follow a reference's ``parameter_spec``: ``conv`` weights normal
with variance 2 / fan-out (fan-out: the output channels times the kernel's
taps), ``fan_in`` weights normal with variance 1 / fan-in, every ``bias``,
BatchNorm shift and running mean normal with standard deviation 0.1,
BatchNorm scales and running variances uniform in [0.5, 1.5], ``zero``
leaves zero and ``const_<key>`` leaves the configuration's ``<key>``.
Clips are skeleton trajectories about ``DISTANCE_M`` from the origin (the
radar's place): each body a random walk, each joint a fixed offset from it
and a swing of its own; a share of the clips has no second body (all
zero), as many NTU clips do.
"""

from __future__ import annotations

import math

import torch

NORMAL_STD = {"bias": 0.1, "bn_bias": 0.1, "bn_mean": 0.1}
UNIFORM = ("bn_scale", "bn_var")
# seed offsets of the generators, so that weights and inputs draw from
# streams of their own
WEIGHT_STREAM, DATA_STREAM = 0, 1
# the clips' motion (meters, hertz at NTU's 30 frames a second)
DISTANCE_M, BODY_STEP_M, SPREAD_M = 0.5, 0.01, 0.1
SWING_M, SWING_HZ, FPS = (0.05, 0.2), (0.5, 3.0), 30.0
SINGLE_BODY_SHARE = 0.25


def generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 4 + stream) % (2**63))
    return g


def seeded_weights(spec: dict, seed: int, device, config=None) -> dict:
    """``{name: float32 tensor}`` for ``spec`` (``{name: (shape, kind)}``)
    from ``seed``: one normal and one uniform draw, split."""
    g = generator(seed, WEIGHT_STREAM, device)
    consts = {k: torch.tensor(config[kind[len("const_"):]],
                              dtype=torch.float32, device=device)
              for k, (_, kind) in spec.items() if kind.startswith("const_")}
    spec = {k: v for k, v in spec.items() if k not in consts}
    sizes = {k: math.prod(shape) for k, (shape, _) in spec.items()}
    normal_n = sum(n for k, n in sizes.items() if spec[k][1] not in UNIFORM)
    uniform_n = sum(n for k, n in sizes.items() if spec[k][1] in UNIFORM)
    normal = torch.randn(normal_n, generator=g, device=device)
    uniform = torch.rand(uniform_n, generator=g, device=device)
    out, i, j = {}, 0, 0
    for k, (shape, kind) in spec.items():
        n = sizes[k]
        if kind in UNIFORM:
            out[k] = (uniform[j:j + n] + 0.5).reshape(shape)
            j += n
            continue
        if kind == "conv":
            fan_out = shape[0] * math.prod(shape[2:])
            std = math.sqrt(2.0 / fan_out)
        elif kind == "fan_in":
            std = math.sqrt(1.0 / math.prod(shape[1:]))
        elif kind == "zero":
            std = 0.0
        else:
            std = NORMAL_STD[kind]
        out[k] = (normal[i:i + n] * std).reshape(shape)
        i += n
    return {**consts, **out}


def skeleton_clips(n: int, frames: int, joints: int, bodies: int,
                   g: torch.Generator, device):
    """``(n, 3, frames, joints, bodies)`` float32 trajectories in meters:
    each body a random walk of ``BODY_STEP_M`` a frame about
    ``DISTANCE_M`` from the origin, each joint a fixed offset from it
    (``SPREAD_M``) and a swing of its own on each axis, of an amplitude
    and a frequency drawn uniformly from ``SWING_M`` and ``SWING_HZ``
    (limbs that move at up to a few meters a second, whose micro-Doppler
    fills most of the spectrogram's band)."""
    shape = (n, 3, 1, joints, bodies)
    walk = torch.randn(n, 3, frames, 1, bodies, generator=g, device=device)
    offset = torch.randn(shape, generator=g, device=device)
    amp = torch.rand(shape, generator=g, device=device)
    hz = torch.rand((n, 1, 1, joints, bodies), generator=g, device=device)
    phase = torch.rand(shape, generator=g, device=device)
    single = torch.rand(n, generator=g, device=device) < SINGLE_BODY_SHARE
    t = torch.arange(frames, device=device, dtype=torch.float32)[
        None, None, :, None, None] / FPS
    amp = SWING_M[0] + (SWING_M[1] - SWING_M[0]) * amp
    hz = SWING_HZ[0] + (SWING_HZ[1] - SWING_HZ[0]) * hz
    x = (BODY_STEP_M * walk.cumsum(2) + SPREAD_M * offset
         + amp * torch.sin(2.0 * math.pi * (hz * t + phase)))
    x[:, 2] += DISTANCE_M
    if bodies > 1:
        x[single, ..., 1:] = 0.0
    return x.contiguous()


def one_hot_labels(n: int, classes: int, g: torch.Generator, device):
    labels = torch.randint(0, classes, (n,), generator=g, device=device)
    return torch.nn.functional.one_hot(labels, classes).float()
