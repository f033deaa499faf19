#!/usr/bin/env python3
"""On-GPU smoke check of the PyTorch port (``skeleton_action_recognition_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It imports no jax. Each phase prints one JSON line; a failed check raises,
so the exit code is not 0.

1. ``env``: the card, its power limit, torch and CUDA versions. Without a
   CUDA device the script stops here (it never falls back to the CPU).
2. ``build``: compiles the ten ``csrc/*.cu`` sources (sgcn, radar,
   radar_dense, stft and tconv, forward and backward) for ``sm_90a`` from
   the checkout, one ``nvcc`` each, at once (seconds, and the compiler's
   register and shared-memory reports).
3. ``kernel``: the CUDA spatial graph-conv kernel against its plain PyTorch
   version at the six (T, C_in, C_out) shapes of the ten ST-GCN blocks, at
   NM=128 (64 clips x 2 bodies), in f32 and bf16: error and CUDA-event
   times of both.
4. ``kernel_bwd``: the backward kernel against its plain version at the
   six shapes, NM=256 (the 128-clip training batch), f32 and bf16: the
   relative error of dx, dW and db, two launches bit for bit, CUDA-event
   times of both.
   ``kernel_stats``: kernel #2 (the spatial conv with the BatchNorm
   statistics epilogue) against its plain version at the six shapes,
   NM=256, f32 and bf16: the errors of out and of the sums, two launches
   bit for bit, CUDA-event times.
   ``tconv_kernel``: kernels #4/#5 (the fused temporal chain, forward and
   backward) against their plain versions at the three stride-1 shapes,
   NM=256, f32 and bf16, with a positive shift: the error of every
   output, two launches of each bit for bit, CUDA-event times of kernel,
   plain version and cuDNN's conv alone.
5. ``slice``: the full-width NTU-60 ST-GCN (T=300) from seeded random
   weights and BatchNorm statistics, behind ``Predictor(max_batch=64)``.
   Requests of 1, 7 and 64 clips: every row finite and summing to 1, ten
   kernel launches per request, agreement with the same weights unfused;
   models with the training options ``sgcn_stats`` and ``fused_tconv``
   answer the 64-clip request as the fused-only model, through the same
   ten launches.
6. ``latency``: the 64-clip request, fused and unfused, in f32 and bf16,
   timed in turns on the host clock (the predictor returns numpy, so each
   request ends synchronized).
7. ``train``: training steps of the full-width ST-GCN at the JAX bench's
   shape (B=128, T=300, remat off) in four configurations, timed in turns
   (10 steps after 3 warm-up, each ending synchronized), in bf16 and in
   f32 with TF32 off (B=128 if it fits, else 64 or 32): unfused, the
   spatial conv fused on every block, and that with ``sgcn_stats`` or
   with ``fused_tconv``. Step time, clips/s, peak memory; the loss finite
   and falling; each step's launches exactly ``STEP_LAUNCHES``. Then
   profiler traces of 3 bf16 steps, fused and fused_tconv: device time by
   kernel name and the device's idle share.
8. ``cli``: ``cli.main_gnn.main`` on a seeded synthetic TFRecord set
   (T=300, 60 classes, 48 training and 16 test clips, written with the
   port's writer), ``--fused-sgcn --fused-sgcn-min-channels 0``, default
   remat, 2 epochs and then ``--resume`` for a third: the checkpoints, the
   resumed epoch, finite losses and accuracies, and launch counts equal to
   the prediction (20 forward and 10 backward a train step with remat, 10
   forward an eval batch). Also the TFRecord decode rate of this host.

9. ``radar_kernel``: the spline radar kernels (#6 forward, #7 backward)
   against their plain versions at the spectrogram trainer's shape (16
   clips, T=300 upsampled 250x to 75,000 samples, 24 edges x 2 bodies),
   seeded skeleton-like clips with one empty body, at lambda = 5e-4 and at
   a damped lambda = 10: the error of each output, two backward launches
   bit for bit, CUDA-event times of kernel and plain.
   ``radar_dense_kernel``: the dense-operator radar kernels (#8 forward, #9
   backward) against their plain versions on the same clips (the operator
   ``pad_frames_operator(300, 250)`` padded to 512-row tiles), at both
   lambdas, TF32 off: the error of each output, two backward launches bit
   for bit, the dense route against the spline route, CUDA-event times of
   kernel, plain and the operator products alone (``torch.matmul``). Then
   ``radar_dense_path``: ``radar_return_fused`` forward and backward
   through autograd to x, loc and lambda, as the JAX package's
   ``scripts/bench_spec_decompose.py`` drives it: one launch of each
   kernel, finite gradients, and the times of forward and forward +
   backward beside the spline route's.
10. ``stft_kernel``: the STFT log-magnitude kernels (#10, #11) against their
    plain versions on that radar return (16 x 75,000 samples, n_fft 256,
    hop 16: 4,688 frames), the same readings.
11. ``spec_train``: training steps of the full-width spectrogram model
    (ResNet-18, 64 filters, 256 x 256 images, 60 classes) at B=16, f32,
    TF32 off, through the kernels and through the plain routes
    (``use_pallas=False, use_pallas_stft=False``), radar frozen and then
    unfrozen (lambda and loc), timed in turns (10 steps after 3 warm-up,
    each ending synchronized): step time, clips/s, peak memory, the loss
    finite (and falling while frozen), exactly 1 + 1 forward launches a
    step and 1 + 1 backward launches a step unfrozen, none frozen. Then a
    profiler trace of 3 unfrozen kernel steps.
12. ``spec_cli``: ``cli.main_spectrogram.main`` on a seeded synthetic
    ``.npy`` + pickled-label set (T=300, 60 classes, 48 training and 20
    validation clips, B=16, kernels on), 2 epochs with lambda and loc
    unfrozen after epoch 0, then ``--resume`` for a third: the checkpoints,
    the resumed epoch, lambda frozen through epoch 0 and moving after,
    finite metrics, and launch counts equal to the prediction.

Then the kernels line (``sgcn_fwd`` ``ms``/``plain_ms``: f32 time of the
ten spatial convs of one 64-clip request; ``sgcn_bwd`` and
``sgcn_fwd_stats``: f32 time of the ten blocks' calls at NM=256;
``tconv_*``: f32 time of the eight stride-1 blocks' calls at NM=256, with
cuDNN's conv alone as ``library_ms``; ``radar_*``/``stft_*``: one call at
16 clips, lambda = 5e-4, with the operator products alone as the dense
radar kernels' ``library_ms``; ``bound_ms``: the least time of the same
work at the card's published f32 peak and memory rate; ``launches``: the
counts of the ``cli`` run for ``sgcn_fwd``/``sgcn_bwd``, of the
``spec_cli`` run for the spline radar and STFT kernels, of
``radar_dense_path`` for the dense radar kernels and of the ``train``
phase's timed steps for the others, each main path counted from 0), the
card's name and power limit as ``nvidia-smi`` prints them, and the result
line.
"""

from __future__ import annotations

import json
import os
import platform
import statistics
import subprocess
import tempfile
import time
from concurrent import futures

import pickle

import numpy as np
import torch
import torch.nn.functional as F

from skeleton_action_recognition_tpu_torch.cli import main_gnn, main_spectrogram
from skeleton_action_recognition_tpu_torch.data import tfrecord
from skeleton_action_recognition_tpu_torch.data.pipeline import (
    TFRecordDataset,
)
from skeleton_action_recognition_tpu_torch.graphs.ntu_rgb_d import (
    spatial_adjacency,
)
from skeleton_action_recognition_tpu_torch.models import layers
from skeleton_action_recognition_tpu_torch.models import spectrogram
from skeleton_action_recognition_tpu_torch.models.stgcn import Model
from skeleton_action_recognition_tpu_torch.ops import (
    build,
    radar,
    resample,
    sgcn,
    stft,
    stft_logmag,
    tconv,
)
from skeleton_action_recognition_tpu_torch.serving import Predictor
from skeleton_action_recognition_tpu_torch.train.optim import (
    TFSGD,
    RadarOptimizer,
)
from skeleton_action_recognition_tpu_torch.train.steps import (
    make_radar_train_step,
    make_train_step,
)

SEED = 0
NM = 128  # 64 clips x 2 bodies
T = 300
# (T, C_in, C_out) of the blocks' spatial convs, and how many blocks have it
BLOCK_SHAPES = [
    ((300, 3, 64), 1), ((300, 64, 64), 3), ((300, 64, 128), 1),
    ((150, 128, 128), 2), ((150, 128, 256), 1), ((75, 256, 256), 2),
]
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# kernel vs plain, max |diff| / max |plain|. f32: both sum in f32, in other
# orders. bf16: both round z and the output to bf16 (8 significant bits)
# once, from sums in other orders, so an element may differ by a bf16 ulp.
KERNEL_REL_TOL = {"f32": 1e-5, "bf16": 2e-2}
# fused vs unfused model probabilities, max abs diff. f32: the kernel's
# summation order moves logits by ~1e-6. bf16: each block rounds to bf16
# several times, and the two paths round z at other places, so differences
# of a few bf16 ulps (2^-8 relative) carry through ten blocks.
PROB_ATOL = {"f32": 1e-4, "bf16": 5e-2}
REQUESTS = (1, 7, 64)
SOURCES = ("sgcn_fwd.cu", "sgcn_bwd.cu", "radar_fwd.cu", "radar_bwd.cu",
           "stft_fwd.cu", "stft_bwd.cu", "tconv_fwd.cu", "tconv_bwd.cu",
           "radar_dense_fwd.cu", "radar_dense_bwd.cu")
SGCN_SOURCE = "skeleton_action_recognition_tpu_torch/csrc/sgcn_fwd.cu"
SGCN_REPLACES = "skeleton_action_recognition_tpu/ops/pallas/sgcn.py:90"
SGCN_BWD_SOURCE = "skeleton_action_recognition_tpu_torch/csrc/sgcn_bwd.cu"
SGCN_BWD_REPLACES = "skeleton_action_recognition_tpu/ops/pallas/sgcn.py:172"
TRAIN_NM = 256  # the 128-clip training batch x 2 bodies
# backward kernel vs plain, max |diff| / max |plain| of (dx, dW, db). f32:
# dx sums at most 3 * 256 terms and dW/db up to 1.9 M rows, in other orders
# (f32 rounding grows with the sum's length; 1e-4 leaves 20x the measured
# ~5e-6). bf16: both round dz to bf16 from f32 sums of a few terms and dx
# once from f32 sums taken in other orders, so an element of dx may differ
# by a bf16 ulp; dW and db leave in f32.
BWD_REL_TOL = {"f32": (1e-5, 1e-4, 1e-4), "bf16": (2e-2, 1e-4, 1e-4)}
TRAIN_BATCH = 128
# the training configurations timed in turns (remat off, the spatial conv
# fused on every block or on none), and the kernel launches of one step
TRAIN_CONFIGS = {
    "unfused": {},
    "fused": dict(fused_sgcn=True),
    "sgcn_stats": dict(fused_sgcn=True, sgcn_stats=True),
    "fused_tconv": dict(fused_sgcn=True, fused_tconv=True),
}
STEP_LAUNCHES = {
    "unfused": {},
    "fused": {"sgcn_fwd": 10, "sgcn_bwd": 10},
    "sgcn_stats": {"sgcn_fwd_stats": 10, "sgcn_bwd": 10},
    "fused_tconv": {"sgcn_fwd": 10, "sgcn_bwd": 10, "tconv_fwd": 8,
                    "tconv_bwd": 8},
}
TRAIN_KERNELS = ("sgcn_fwd", "sgcn_fwd_stats", "sgcn_bwd", "tconv_fwd",
                 "tconv_bwd")
# models served in eval beside the fused-only one: the training options
EVAL_OPTIONS = {
    "sgcn_stats+fused_tconv": dict(sgcn_stats=True, fused_tconv=True),
    "fused_tconv": dict(fused_tconv=True),
}
# 10 timed steps: their min and max lie within 0.7% of the median on the
# ST-GCN configurations, and the loss falls over 13
TRAIN_STEPS, TRAIN_WARMUP = 10, 3
PROFILE_STEPS = 3
CLI_CLIPS = {"train": 48, "val": 16}
CLI_BATCH = 16
# the spectrogram path: the JAX bench's SPEC_BATCH, T=300 upsampled 250x
SPEC_BATCH, SPEC_T, SPEC_UP = 16, 300, 250
SPEC_CLI_CLIPS = {"train": 48, "val": 20}  # the last eval batch is partial
LAMBDAS = (5e-4, 10.0)  # the model's wavelength, and a damped one
# kernel vs plain, max |diff| / max |plain| of each output. At lambda =
# 5e-4 the phase is ~1e4 rad and the cubic is evaluated in other orders,
# which moves it by ~1e-3 rad: 2e-3 for the return, 1e-2 for its
# cotangents (the JAX package's Pallas-vs-XLA tolerances). At lambda = 10
# both agree to f32 rounding of sums over up to 57.6 M terms: 1e-4.
RADAR_TOL = {5e-4: (2e-3, 1e-2), 10.0: (1e-4, 1e-4)}
# STFT kernel vs plain on normal signals: log|S| to 5e-4 absolute (f32
# sums of 256 terms, the error growing as 1/|S| at the smallest bins,
# tests/test_torch_stft.py), its (re, im) cotangent to 2e-3 of the largest
# (the 1/|S| of the smallest of 16 x 4,688 x 256 bins: 9.0e-4 measured).
# On the radar return, |S| + eps to 1e-5 of its largest (f32 sums of 256
# terms in other orders: 7.3e-7 measured).
STFT_ATOL, STFT_GRAD_TOL, STFT_MAG_TOL = 5e-4, 2e-3, 1e-5
SPEC_LR = 1e-4  # the JAX bench's Adam rate
# kernel #2's sums, |error| / sum |terms| per channel: against the f64 sums
# of the kernel's own output, f32 sums of 1.9 M rows in other orders; against
# the plain version's sums, the same in f32, and in bf16 up to two bf16 ulps
# (each output element may be an ulp away from the plain one)
STATS_OWN_TOL = 1e-5
STATS_PLAIN_TOL = {"f32": 1e-5, "bf16": 1e-2}
# (T, C) of the stride-1 blocks' fused temporal chains, and how many blocks
# have it
TCONV_SHAPES = [((300, 64), 4), ((150, 128), 2), ((75, 256), 2)]
# kernels #4/#5 vs plain, max |diff| / max |plain| of u and g_s: f32 sums of
# 9 * C products in other orders; bf16 results rounded once from them (a
# bf16 ulp). dscale, dshift, dW, dbias: f32 sums of 1.9 M rows of the same
# rounded operands in other orders.
TCONV_OUT_TOL = {"f32": 1e-5, "bf16": 2e-2}
TCONV_GRAD_TOL = 1e-4
# The card's published peaks (NVIDIA H100 SXM data sheet, dense): FLOP/s of
# f32 on the CUDA cores (TF32 off) and of bf16 on the tensor cores, and the
# device memory's bytes/s. A kernel's bound is the larger of its operations
# over the peak of their type and its bytes (inputs read once, outputs
# written once) over the memory rate.
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12}
PEAK_BYTES = 3.35e12
# operations of one (sample, edge-body) pair of the radar kernels, counted
# from csrc/radar_math.cuh and the spline evaluation around it (one per add,
# multiply, division, square root, sine or cosine): the forward's six
# endpoint cubics (48) and the scatter math and sum (56); the backward
# recomputes those and adds the cotangent chain (94) and the contraction
# with the tile's monomials (52)
RADAR_FWD_OPS, RADAR_BWD_OPS = 104, 244
# the dense kernels' operations of a pair beyond their contractions (which
# are counted apart): the scatter math and sum, and the recomputed scatter
# math and cotangent chain (the spline counts without the cubics and the
# monomial contraction)
DENSE_FWD_OPS, DENSE_BWD_OPS = RADAR_FWD_OPS - 48, RADAR_BWD_OPS - 48 - 52
# the dense route (#8) against the spline route (#6), max |diff| / max
# |spline| of the return. At lambda = 10 both agree to f32 rounding (the
# spline is an exact factorization of the dense operator): 1e-4. At lambda
# = 5e-4 the positions are 300-term sums on one side and 4-term cubics on
# the other, rounded apart by ~1e-7 m, which the phase factor (2.5e4
# rad/m) turns into ~2.5e-3 rad (1.9e-3 of the return's scale on an
# H100): 1e-2, the JAX package's Pallas-vs-XLA tolerance for the radar's
# gradients, which are as far from f32-exact.
ROUTE_TOL = {5e-4: 1e-2, 10.0: RADAR_TOL[10.0][0]}
KERNEL_REPLACES = {
    "radar_fwd": "skeleton_action_recognition_tpu/ops/pallas/radar.py:524",
    "radar_bwd": "skeleton_action_recognition_tpu/ops/pallas/radar.py:555",
    "radar_dense_fwd": "skeleton_action_recognition_tpu/ops/pallas/radar.py:108",
    "radar_dense_bwd": "skeleton_action_recognition_tpu/ops/pallas/radar.py:289",
    "stft_fwd": "skeleton_action_recognition_tpu/ops/pallas/stft.py:119",
    "stft_bwd": "skeleton_action_recognition_tpu/ops/pallas/stft.py:161",
    "sgcn_fwd_stats": "skeleton_action_recognition_tpu/ops/pallas/sgcn.py:121",
    "tconv_fwd": "skeleton_action_recognition_tpu/ops/pallas/tconv.py:138",
    "tconv_bwd": "skeleton_action_recognition_tpu/ops/pallas/tconv.py:185",
}
KERNEL_SOURCES = {
    "sgcn_fwd_stats": "skeleton_action_recognition_tpu_torch/csrc/sgcn_fwd.cu",
}


def emit(phase, **record):
    print(json.dumps({"phase": phase, **record}), flush=True)


def check(ok, message):
    if not ok:
        raise RuntimeError(message)


def nvidia_smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(flops, n_bytes, dtype):
    """``(ms, "operations" or "bytes")``: the least time the card could
    take for work of ``flops`` operations of ``dtype`` moving ``n_bytes``."""
    ops_s, bytes_s = flops / PEAK_FLOPS[dtype], n_bytes / PEAK_BYTES
    return 1e3 * max(ops_s, bytes_s), (
        "operations" if ops_s >= bytes_s else "bytes")


class Totals:
    """A kernels-line entry summed over the calls of one main-path unit
    (the blocks of a step or request): times, bounds, the largest error.
    ``bound_by`` is the kind that gives most of the summed bound."""

    def __init__(self, library=False):
        self.ms = self.plain_ms = self.max_abs_err = 0.0
        self.library_ms = 0.0 if library else None
        self.by = {"operations": 0.0, "bytes": 0.0}

    def add(self, times, err, bound_ms, bound_by, calls=1):
        self.ms += calls * times["ms"]
        self.plain_ms += calls * times["plain_ms"]
        if self.library_ms is not None:
            self.library_ms += calls * times["library_ms"]
        self.max_abs_err = max(self.max_abs_err, err)
        self.by[bound_by] += calls * bound_ms

    def entry(self):
        return {
            "max_abs_err": self.max_abs_err, "ms": self.ms,
            "plain_ms": self.plain_ms,
            "bound_ms": self.by["operations"] + self.by["bytes"],
            "bound_by": max(self.by, key=self.by.get),
            "library_ms": self.library_ms,
        }


def sgcn_flops(frames, c_in, c_out, a, backward=False):
    """Operations of the spatial graph conv over ``frames`` frames: the 1x1
    conv into 3 C_out channels and the contraction with the adjacency
    ``a``, a multiply-add a channel for each of its nonzeros (the kernels
    loop over those alone); the backward does the conv's two products (dx,
    dW) and the contraction once."""
    conv = frames * 25 * 2 * c_in * 3 * c_out
    adjacency = frames * 2 * int(torch.count_nonzero(a)) * c_out
    return (2 * conv if backward else conv) + adjacency


def tconv_flops(rows, c, backward=False):
    """Operations of the fused temporal chain over ``rows`` (clip, frame,
    joint) rows: the 9-tap conv (the backward: its input and weight
    gradients), and the affine, ReLU, bias and statistics around it."""
    conv = rows * 2 * 9 * c * c
    return (2 * conv if backward else conv) + rows * c * 8


def tf32_off():
    """f32 references: TF32 off in cuBLAS and cuDNN (``main_gnn``'s
    default ``--precision`` turns both on for the whole process)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def phase_env():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing was run")
    tf32_off()
    emit(
        "env", nvidia_smi=nvidia_smi_line(), torch=torch.__version__,
        cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(),
    )


def phase_build():
    """Both sources at once, one nvcc each."""
    start = time.perf_counter()
    with futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        list(pool.map(build.load_library, SOURCES))
    seconds = time.perf_counter() - start
    for source in SOURCES:
        log = build.library_path(source).with_suffix(".log")
        emit(
            "build", source=source, seconds=seconds,
            ptxas=log.read_text().strip().splitlines(),
        )


def phase_kernel(device):
    a = torch.from_numpy(spatial_adjacency()).to(device)
    g = torch.Generator(device=device).manual_seed(SEED)
    totals = Totals()
    for name, dtype in DTYPES.items():
        for (t, c_in, c_out), blocks in BLOCK_SHAPES:
            x = torch.randn(NM, t, 25, c_in, generator=g, device=device)
            x = x.to(dtype)
            w = torch.randn(3 * c_out, c_in, generator=g, device=device)
            w *= (2.0 / c_in) ** 0.5
            b = 0.1 * torch.randn(3 * c_out, generator=g, device=device)
            out = sgcn.fused_graph_conv(x, w, b, a)
            torch.cuda.synchronize()
            ref = sgcn.graph_conv_reference(x, w, b, a)
            abs_err = (out.float() - ref.float()).abs().max().item()
            rel_err = abs_err / ref.float().abs().max().item()
            ms = cuda_ms(lambda: sgcn.fused_graph_conv(x, w, b, a))
            plain_ms = cuda_ms(lambda: sgcn.graph_conv_reference(x, w, b, a))
            bound_ms, bound_by = bound(
                sgcn_flops(NM * t, c_in, c_out, a), nbytes(x, w, b, a, out),
                name)
            emit(
                "kernel", dtype=name, nm=NM, t=t, c_in=c_in, c_out=c_out,
                max_abs_err=abs_err, rel_err=rel_err,
                rel_tol=KERNEL_REL_TOL[name], ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by,
            )
            check(
                rel_err <= KERNEL_REL_TOL[name],
                f"sgcn kernel disagrees at {name} {(t, c_in, c_out)}: "
                f"rel err {rel_err}",
            )
            if name == "f32":
                totals.add({"ms": ms, "plain_ms": plain_ms}, abs_err,
                           bound_ms, bound_by, blocks)
            del x, out, ref
    return totals.entry()


def phase_kernel_bwd(device):
    a = torch.from_numpy(spatial_adjacency()).to(device)
    g = torch.Generator(device=device).manual_seed(SEED + 1)
    totals = Totals()
    for name, dtype in DTYPES.items():
        for (t, c_in, c_out), blocks in BLOCK_SHAPES:
            x = torch.randn(TRAIN_NM, t, 25, c_in, generator=g, device=device)
            x = x.to(dtype)
            w = torch.randn(3 * c_out, c_in, generator=g, device=device)
            w *= (2.0 / c_in) ** 0.5
            gout = torch.randn(
                TRAIN_NM, t, 25, c_out, generator=g, device=device
            ).to(dtype)
            got = sgcn.fused_graph_conv_backward(x, w, a, gout)
            again = sgcn.fused_graph_conv_backward(x, w, a, gout)
            torch.cuda.synchronize()
            bit_identical = all(
                torch.equal(p, q) for p, q in zip(got, again)
            )
            want = sgcn.graph_conv_backward_reference(x, w, a, gout)
            abs_err = [
                (p.float() - q.float()).abs().max().item()
                for p, q in zip(got, want)
            ]
            rel_err = [
                e / q.float().abs().max().item()
                for e, q in zip(abs_err, want)
            ]
            bound_ms, bound_by = bound(
                sgcn_flops(TRAIN_NM * t, c_in, c_out, a, backward=True),
                nbytes(x, w, a, gout, *got), name)
            del got, again, want
            ms = cuda_ms(
                lambda: sgcn.fused_graph_conv_backward(x, w, a, gout)
            )
            plain_ms = cuda_ms(
                lambda: sgcn.graph_conv_backward_reference(x, w, a, gout)
            )
            emit(
                "kernel_bwd", dtype=name, nm=TRAIN_NM, t=t, c_in=c_in,
                c_out=c_out, max_abs_err=dict(zip(("dx", "dW", "db"),
                                                  abs_err)),
                rel_err=dict(zip(("dx", "dW", "db"), rel_err)),
                rel_tol=BWD_REL_TOL[name], bit_identical=bit_identical,
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by,
            )
            check(bit_identical, f"sgcn_bwd repeats differ at {name} "
                  f"{(t, c_in, c_out)}")
            check(
                all(e <= tol for e, tol in zip(rel_err, BWD_REL_TOL[name])),
                f"sgcn_bwd disagrees at {name} {(t, c_in, c_out)}: "
                f"rel err {rel_err}",
            )
            if name == "f32":
                totals.add({"ms": ms, "plain_ms": plain_ms}, max(abs_err),
                           bound_ms, bound_by, blocks)
            del x, gout
            torch.cuda.empty_cache()
    return totals.entry()


def channel_sum_errors(got, want, out, ref):
    """Kernel #2/#4's channel sums ``got = (s, ss)``: the largest |error| /
    sum |terms| against the f64 sums of the kernel's own output ``out``
    (``own``) and against the plain version's sums ``want`` (``plain``),
    for ``s`` and ``ss``."""
    errors = {}
    for key, src, targets in (("own", out, None), ("plain", ref, want)):
        of = src.double()
        exact = (of.sum((0, 1, 2)), (of * of).sum((0, 1, 2)))
        scale = (of.abs().sum((0, 1, 2)), exact[1])
        for name, p, q, sc in zip(("s", "ss"), got,
                                  exact if targets is None else targets,
                                  scale):
            errors[f"{name}_{key}"] = ((p.double() - q.double()).abs()
                                       / sc.clamp_min(1e-30)).max().item()
    return errors


def phase_kernel_stats(device):
    """Kernel #2 (the spatial conv with the statistics epilogue) against
    its plain version at the six block shapes, NM=256 (the 128-clip
    training batch), f32 and bf16: errors of out, s and ss, two launches
    bit for bit, CUDA-event times."""
    a = torch.from_numpy(spatial_adjacency()).to(device)
    g = torch.Generator(device=device).manual_seed(SEED + 6)
    totals = Totals()
    for name, dtype in DTYPES.items():
        for (t, c_in, c_out), blocks in BLOCK_SHAPES:
            x = torch.randn(TRAIN_NM, t, 25, c_in, generator=g,
                            device=device).to(dtype)
            w = torch.randn(3 * c_out, c_in, generator=g, device=device)
            w *= (2.0 / c_in) ** 0.5
            b = 0.1 * torch.randn(3 * c_out, generator=g, device=device)
            got = sgcn.fused_graph_conv_stats(x, w, b, a)
            again = sgcn.fused_graph_conv_stats(x, w, b, a)
            torch.cuda.synchronize()
            bit_identical = all(torch.equal(p, q) for p, q in zip(got, again))
            want = sgcn.graph_conv_stats_reference(x, w, b, a)
            out_rel = rel_err(got[0], want[0])
            sums = channel_sum_errors(got[1:], want[1:], got[0], want[0])
            abs_err = max_abs_err(got, want)
            bound_ms, bound_by = bound(
                sgcn_flops(TRAIN_NM * t, c_in, c_out, a)
                + 3 * got[0].numel(), nbytes(x, w, b, a, *got), name)
            del again, want
            ms = cuda_ms(lambda: sgcn.fused_graph_conv_stats(x, w, b, a))
            plain_ms = cuda_ms(
                lambda: sgcn.graph_conv_stats_reference(x, w, b, a))
            emit(
                "kernel_stats", dtype=name, nm=TRAIN_NM, t=t, c_in=c_in,
                c_out=c_out, out_rel_err=out_rel,
                out_rel_tol=KERNEL_REL_TOL[name], sum_err=sums,
                sum_tol={"own": STATS_OWN_TOL,
                         "plain": STATS_PLAIN_TOL[name]},
                bit_identical=bit_identical, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by,
            )
            where = f"{name} {(t, c_in, c_out)}"
            check(bit_identical, f"sgcn_fwd_stats repeats differ at {where}")
            check(out_rel <= KERNEL_REL_TOL[name],
                  f"sgcn_fwd_stats out disagrees at {where}: {out_rel}")
            check(all(v <= (STATS_OWN_TOL if k.endswith("own")
                            else STATS_PLAIN_TOL[name])
                      for k, v in sums.items()),
                  f"sgcn_fwd_stats sums disagree at {where}: {sums}")
            if name == "f32":
                totals.add({"ms": ms, "plain_ms": plain_ms}, abs_err,
                           bound_ms, bound_by, blocks)
            del x, got
            torch.cuda.empty_cache()
    return totals.entry()


def tconv_inputs(t, c, dtype, device, g):
    """``s, scale, shift, weight, bias, gue`` of one temporal chain; the
    shift is positive, so that the padded frames' relu(shift) is far from
    0."""
    s = torch.randn(TRAIN_NM, t, 25, c, generator=g, device=device)
    scale = torch.randn(c, generator=g, device=device)
    shift = 0.5 + torch.rand(c, generator=g, device=device)
    w = torch.randn(c, c, 9, 1, generator=g, device=device) / (3 * c**0.5)
    b = 0.1 * torch.randn(c, generator=g, device=device)
    gue = torch.randn(TRAIN_NM, t, 25, c, generator=g, device=device)
    return s.to(dtype), scale, shift, w, b, gue.to(dtype)


def phase_tconv_kernel(device):
    """Kernels #4 and #5 (the fused temporal chain) against their plain
    versions at the three stride-1 shapes, NM=256, f32 and bf16: the error
    of every output, two launches of each bit for bit, and CUDA-event
    times of kernel, plain version and cuDNN's conv alone (forward:
    ``F.conv2d``; backward: ``convolution_backward`` of its input, weight
    and bias)."""
    g = torch.Generator(device=device).manual_seed(SEED + 7)
    totals = {"tconv_fwd": Totals(library=True),
              "tconv_bwd": Totals(library=True)}
    for name, dtype in DTYPES.items():
        for (t, c), blocks in TCONV_SHAPES:
            s, scale, shift, w, b, gue = tconv_inputs(t, c, dtype, device, g)
            fwd_args, bwd_args = (s, scale, shift, w, b), (s, scale, shift,
                                                          w, gue)
            got = tconv.affine_relu_tconv(*fwd_args)
            got_bwd = tconv.affine_relu_tconv_backward(*bwd_args)
            again = tconv.affine_relu_tconv(*fwd_args)
            again_bwd = tconv.affine_relu_tconv_backward(*bwd_args)
            torch.cuda.synchronize()
            bit_identical = all(torch.equal(p, q) for p, q in zip(
                got + got_bwd, again + again_bwd))
            del again, again_bwd
            want = tconv.affine_relu_tconv_reference(*fwd_args)
            want_bwd = tconv.affine_relu_tconv_backward_reference(*bwd_args)
            u_rel = rel_err(got[0], want[0])
            sums = channel_sum_errors(got[1:], want[1:], got[0], want[0])
            bwd_rel = dict(zip(("g_s", "dscale", "dshift", "dW", "dbias"),
                               (rel_err(p, q) for p, q in zip(got_bwd,
                                                              want_bwd))))
            errs = {"tconv_fwd": max_abs_err(got, want),
                    "tconv_bwd": max_abs_err(got_bwd, want_bwd)}
            rows = TRAIN_NM * t * 25
            bounds = {
                "tconv_fwd": bound(tconv_flops(rows, c),
                                   nbytes(*fwd_args, *got), name),
                "tconv_bwd": bound(tconv_flops(rows, c, backward=True),
                                   nbytes(*bwd_args, *got_bwd), name),
            }
            del got, got_bwd, want, want_bwd
            x = s.permute(0, 3, 1, 2)  # NCHW view, channels-last memory
            wd, bd = w.to(dtype), b.to(dtype)
            gy = gue.permute(0, 3, 1, 2)
            times = {
                "tconv_fwd": {
                    "ms": cuda_ms(lambda: tconv.affine_relu_tconv(*fwd_args)),
                    "plain_ms": cuda_ms(
                        lambda: tconv.affine_relu_tconv_reference(*fwd_args)),
                    "library_ms": cuda_ms(
                        lambda: F.conv2d(x, wd, bd, padding=(4, 0))),
                },
                "tconv_bwd": {
                    "ms": cuda_ms(
                        lambda: tconv.affine_relu_tconv_backward(*bwd_args)),
                    "plain_ms": cuda_ms(
                        lambda: tconv.affine_relu_tconv_backward_reference(
                            *bwd_args)),
                    "library_ms": cuda_ms(
                        lambda: torch.ops.aten.convolution_backward(
                            gy, x, wd, [c], [1, 1], [4, 0], [1, 1], False,
                            [0, 0], 1, [True, True, True])),
                },
            }
            emit(
                "tconv_kernel", dtype=name, nm=TRAIN_NM, t=t, c=c,
                u_rel_err=u_rel, u_rel_tol=TCONV_OUT_TOL[name],
                sum_err=sums, sum_tol={"own": STATS_OWN_TOL,
                                       "plain": STATS_PLAIN_TOL[name]},
                bwd_rel_err=bwd_rel,
                bwd_rel_tol={"g_s": TCONV_OUT_TOL[name],
                             "sums": TCONV_GRAD_TOL},
                bit_identical=bit_identical, **{
                    f"{k}_{m}": v for k, d in times.items()
                    for m, v in d.items()},
                **{f"{k}_bound_ms": v[0] for k, v in bounds.items()},
                **{f"{k}_bound_by": v[1] for k, v in bounds.items()},
            )
            where = f"{name} {(t, c)}"
            check(bit_identical, f"tconv repeats differ at {where}")
            check(u_rel <= TCONV_OUT_TOL[name],
                  f"tconv_fwd u disagrees at {where}: {u_rel}")
            check(all(v <= (STATS_OWN_TOL if k.endswith("own")
                            else STATS_PLAIN_TOL[name])
                      for k, v in sums.items()),
                  f"tconv_fwd sums disagree at {where}: {sums}")
            check(bwd_rel["g_s"] <= TCONV_OUT_TOL[name]
                  and all(v <= TCONV_GRAD_TOL for k, v in bwd_rel.items()
                          if k != "g_s"),
                  f"tconv_bwd disagrees at {where}: {bwd_rel}")
            if name == "f32":
                for k, tot in totals.items():
                    tot.add(times[k], errs[k], *bounds[k], blocks)
            del s, gue, x, gy
            torch.cuda.empty_cache()
    return {k: tot.entry() for k, tot in totals.items()}


def seeded_model(name, fused, state=None, **options):
    """Full-width NTU-60 ST-GCN computing in ``name`` ("f32" or "bf16"),
    with the model's other ``options``. Without ``state``: CONV_INIT
    weights from the seed, and BatchNorm affines, running statistics and
    every bias redrawn from it, so that eval-mode BatchNorm and the bias
    paths do real work."""
    g = torch.Generator().manual_seed(SEED)
    model = Model(
        num_classes=60, dtype=torch.bfloat16 if name == "bf16" else None,
        fused_sgcn=fused, fused_sgcn_min_channels=0, generator=g, **options,
    )
    if state is not None:
        model.load_state_dict(state)
        return model
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, layers.BatchNorm):
                module.weight.uniform_(0.5, 1.5, generator=g)
                module.running_mean.normal_(0.0, 0.1, generator=g)
                module.running_var.uniform_(0.5, 1.5, generator=g)
            if getattr(module, "bias", None) is not None:
                module.bias.normal_(0.0, 0.1, generator=g)
    return model


def phase_slice(device, requests):
    predictor = Predictor(seeded_model("f32", fused=True), 64, device)
    state = predictor.model.state_dict()

    # the main path: the counts cover exactly these requests
    sgcn.fused_graph_conv.launches = 0
    probs, per_request = {}, {}
    for n, x in requests.items():
        before = sgcn.fused_graph_conv.launches
        probs[n] = predictor(x)
        per_request[n] = sgcn.fused_graph_conv.launches - before
    launches = sgcn.fused_graph_conv.launches

    for n, p in probs.items():
        check(p.shape == (n, 60), f"probabilities of shape {p.shape}")
        check(np.isfinite(p).all(), f"non-finite probabilities at n={n}")
        check(
            np.abs(p.sum(-1) - 1.0).max() < 1e-5,
            f"rows do not sum to 1 at n={n}",
        )
        check(
            per_request[n] == 10,
            f"{per_request[n]} kernel launches at n={n}, not 10",
        )
    errors = {}
    for name in DTYPES:
        if name == "f32":
            fused = probs
        else:
            pred = Predictor(seeded_model(name, True, state), 64, device)
            fused = {n: pred(x) for n, x in requests.items()}
        plain = Predictor(seeded_model(name, False, state), 64, device)
        check(
            all(np.isfinite(p).all() for p in fused.values()),
            f"non-finite {name} probabilities",
        )
        errors[name] = max(
            float(np.abs(fused[n] - plain(x)).max())
            for n, x in requests.items()
        )
        check(
            errors[name] <= PROB_ATOL[name],
            f"{name} fused and unfused probabilities differ by "
            f"{errors[name]}",
        )
    # the training options leave eval on the fused-only path: the same
    # probabilities, ten forward launches, no stats or temporal kernel
    option_errors = {}
    for label, options in EVAL_OPTIONS.items():
        pred = Predictor(seeded_model("f32", True, state, **options), 64,
                         device)
        reset_launches()
        got = pred(requests[64])
        counts = read_launches(TRAIN_KERNELS)
        option_errors[label] = float(np.abs(got - probs[64]).max())
        check(counts == {**dict.fromkeys(TRAIN_KERNELS, 0), "sgcn_fwd": 10},
              f"{label} eval launched {counts}")
        check(option_errors[label] <= PROB_ATOL["f32"],
              f"{label} eval differs from fused eval by "
              f"{option_errors[label]}")
    emit(
        "slice", requests=list(requests), launches=launches,
        launches_per_request=per_request, prob_max_abs_err=errors,
        prob_atol=PROB_ATOL, top_prob_n64=float(probs[64].max(-1).mean()),
        options_prob_max_abs_err_n64=option_errors,
    )
    return state, launches


def phase_latency(device, state, x, reps=20):
    predictors = {
        (name, fused): Predictor(seeded_model(name, fused, state), 64, device)
        for name in DTYPES for fused in (False, True)
    }
    for pred in predictors.values():  # warm-up: cuDNN plans, allocator
        pred(x)
        pred(x)
    times = {key: [] for key in predictors}
    keys = list(predictors)
    for rep in range(reps):  # in turns, the order reversed every other rep
        for key in keys if rep % 2 == 0 else keys[::-1]:
            start = time.perf_counter()
            predictors[key](x)
            times[key].append(time.perf_counter() - start)
    for (name, fused), samples in times.items():
        torch.cuda.reset_peak_memory_stats()
        predictors[(name, fused)](x)
        med = statistics.median(samples)
        emit(
            "latency", dtype=name, fused_sgcn=fused, batch=len(x),
            t=x.shape[2], samples=len(samples), median_ms=1e3 * med,
            min_ms=1e3 * min(samples), max_ms=1e3 * max(samples),
            clips_per_s=len(x) / med,
            peak_mem_mb=torch.cuda.max_memory_allocated() / 2**20,
        )


COUNTERS = {
    "sgcn_fwd": sgcn.fused_graph_conv,
    "sgcn_fwd_stats": sgcn.fused_graph_conv_stats,
    "sgcn_bwd": sgcn.fused_graph_conv_backward,
    "tconv_fwd": tconv.affine_relu_tconv,
    "tconv_bwd": tconv.affine_relu_tconv_backward,
    "radar_fwd": radar.spline_radar,
    "radar_bwd": radar.spline_radar_backward,
    "radar_dense_fwd": radar.dense_radar,
    "radar_dense_bwd": radar.dense_radar_backward,
    "stft_fwd": stft_logmag.stft_logmag,
    "stft_bwd": stft_logmag.stft_logmag_backward,
}


def reset_launches():
    for fn in COUNTERS.values():
        fn.launches = 0


def read_launches(names=("sgcn_fwd", "sgcn_bwd")):
    return {name: COUNTERS[name].launches for name in names}


def train_runs(device, name, batch):
    """``{config: step}`` closures training the full-width model in each
    of ``TRAIN_CONFIGS``, from the same seed, each on its own fixed batch
    of seeded noise. Each closure keeps, in ``.saved_mb``, the device
    memory allocated when its last backward began (parameters, optimizer
    state and the activations saved for the backward)."""
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(
        rng.normal(size=(batch, 3, T, 25, 2)).astype(np.float32)
    ).to(device)
    y = torch.nn.functional.one_hot(
        torch.from_numpy(rng.integers(0, 60, batch)), 60
    ).float().to(device)
    runs = {}
    for config, options in TRAIN_CONFIGS.items():
        model = Model(
            num_classes=60,
            dtype=torch.bfloat16 if name == "bf16" else None,
            fused_sgcn_min_channels=0, remat=False, device=device,
            generator=torch.Generator().manual_seed(SEED), **options,
        )
        step = make_train_step(model, TFSGD(model.parameters(), 0.01), batch)

        def run(step=step):
            loss = step(x, y, False)["loss"].item()  # ends synchronized
            return loss

        def at_backward(grad, run=run):
            run.saved_mb = torch.cuda.memory_allocated() / 2**20

        def on_logits(module, args, out, hook=at_backward):
            out.register_hook(hook)  # returns None: the output stays

        model.register_forward_hook(on_logits)
        runs[config] = run
    return runs


def time_training(device, name, batch):
    """The configurations' steps in turns, each step's launches counted
    and checked against ``STEP_LAUNCHES``; returns the runs and the
    launches of all timed steps."""
    runs = train_runs(device, name, batch)
    losses = {k: [run() for _ in range(TRAIN_WARMUP)]
              for k, run in runs.items()}
    times = {k: [] for k in runs}
    counted = {k: dict.fromkeys(TRAIN_KERNELS, 0) for k in runs}
    keys = list(runs)
    # the main path: the counts cover exactly the timed steps
    reset_launches()
    for i in range(TRAIN_STEPS):  # in turns, the order reversed every other
        for k in keys if i % 2 == 0 else keys[::-1]:
            before = read_launches(TRAIN_KERNELS)
            start = time.perf_counter()
            losses[k].append(runs[k]())
            times[k].append(time.perf_counter() - start)
            after = read_launches(TRAIN_KERNELS)
            for n in TRAIN_KERNELS:
                counted[k][n] += after[n] - before[n]
    launches = read_launches(TRAIN_KERNELS)
    for k, samples in times.items():
        predicted = {n: TRAIN_STEPS * STEP_LAUNCHES[k].get(n, 0)
                     for n in TRAIN_KERNELS}
        check(counted[k] == predicted,
              f"{name} {k} training launched {counted[k]}, predicted "
              f"{predicted}")
        torch.cuda.reset_peak_memory_stats()
        runs[k]()
        loss = losses[k]
        med = statistics.median(samples)
        emit(
            "train", dtype=name, config=k, batch=batch, t=T, remat=False,
            steps=len(samples), median_step_ms=1e3 * med,
            min_step_ms=1e3 * min(samples), max_step_ms=1e3 * max(samples),
            clips_per_s=batch / med,
            peak_mem_mb=torch.cuda.max_memory_allocated() / 2**20,
            backward_start_mem_mb=runs[k].saved_mb,
            loss_first=loss[0], loss_last=loss[-1],
            launches_timed=counted[k],
        )
        check(all(np.isfinite(loss)), f"non-finite {name} {k} loss")
        check(
            np.mean(loss[-5:]) < np.mean(loss[:5]),
            f"{name} {k} training loss did not fall: {loss}",
        )
    return runs, launches


def device_profile(run, steps):
    """Device time by kernel name and the device's idle share over
    ``steps`` calls of ``run``, from a torch.profiler trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ) as prof:
        for _ in range(steps):
            run()
    spans = sorted(
        (e.time_range.start, e.time_range.end, e.name)
        for e in prof.events() if e.device_type == DeviceType.CUDA
    )
    if not spans:
        return {"device_events": 0}
    busy, end, by_name = 0.0, spans[0][0], {}
    for start, stop, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (stop - start)
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    span = end - spans[0][0]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    return {
        "device_events": len(spans),
        "busy_ms_per_step": busy / 1e3 / steps,
        "span_ms_per_step": span / 1e3 / steps,
        "idle_share": 1.0 - busy / span,
        "top_kernels_ms_per_step": {
            name[:120]: us / 1e3 / steps for name, us in top
        },
    }


def phase_train(device):
    """bf16 and then f32 training; returns the launches of all timed
    steps."""
    runs, launches = time_training(device, "bf16", TRAIN_BATCH)
    for config in ("fused", "fused_tconv"):
        emit("profile", dtype="bf16", config=config, batch=TRAIN_BATCH,
             steps=PROFILE_STEPS,
             **device_profile(runs[config], PROFILE_STEPS))
    del runs
    torch.cuda.empty_cache()
    for batch in (TRAIN_BATCH, 64, 32):  # f32 at the largest that fits
        try:
            _, f32_launches = time_training(device, "f32", batch)
            return {n: launches[n] + f32_launches[n] for n in launches}
        except torch.cuda.OutOfMemoryError:
            emit("train", dtype="f32", batch=batch, out_of_memory=True)
        torch.cuda.empty_cache()  # the failed run's tensors are freed now
    raise RuntimeError("f32 training fits at no batch of 128, 64 or 32")


def host_cpu():
    """The host CPU's model name (``/proc/cpuinfo``, else ``lscpu``), its
    architecture and the cores this process may use."""
    name = None
    try:
        with open("/proc/cpuinfo") as f:
            name = next((line.split(":", 1)[1].strip() for line in f
                         if line.startswith("model name")), None)
        if name is None:
            out = subprocess.run(["lscpu"], capture_output=True, text=True,
                                 timeout=30).stdout
            name = next((line.split(":", 1)[1].strip()
                         for line in out.splitlines()
                         if line.startswith("Model name")), None)
    except (OSError, subprocess.SubprocessError):
        pass
    return (f"{name or 'unknown model'}, {platform.machine()}, "
            f"{len(os.sched_getaffinity(0))} cores")


def phase_cli(device):
    """The trainer CLI on synthetic TFRecords, then resumed."""
    rng = np.random.default_rng(SEED)
    with tempfile.TemporaryDirectory() as tmp:
        dirs = {}
        for part, n in CLI_CLIPS.items():
            x = rng.normal(size=(n, 3, T, 25, 2)).astype(np.float32)
            dirs[part] = os.path.join(tmp, part)
            tfrecord.write_dataset(
                x, rng.integers(0, 60, n), dirs[part], part, num_shards=2
            )
        start = time.perf_counter()
        TFRecordDataset(dirs["train"], CLI_BATCH)._load_all()
        decode_s = time.perf_counter() - start
        argv = [
            "--model", "stgcn", "--fused-sgcn",
            "--fused-sgcn-min-channels", "0",
            "--batch-size", str(CLI_BATCH), "--num-epochs", "2",
            "--save-freq", "1", "--base-lr", "0.01",
            "--train-data-path", dirs["train"],
            "--test-data-path", dirs["val"],
            "--log-dir", os.path.join(tmp, "logs"),
        ]
        steps = CLI_CLIPS["train"] // CLI_BATCH
        evals = -(-CLI_CLIPS["val"] // CLI_BATCH)
        # remat: each block's forward runs again in the backward
        per_epoch = {"sgcn_fwd": 10 * (2 * steps + evals),
                     "sgcn_bwd": 10 * steps}
        # the main path: the counts cover exactly the two runs
        reset_launches()
        history = main_gnn.main(argv)
        first = read_launches()
        history += main_gnn.main(argv[:8] + ["3"] + argv[9:] + ["--resume"])
        launches = read_launches()
        (run,) = os.listdir(os.path.join(tmp, "logs"))
        ckpt_dir = os.path.join(tmp, "logs", run, "checkpoints")
        checkpoints = sorted(int(d) for d in os.listdir(ckpt_dir))
    predicted = {k: 3 * v for k, v in per_epoch.items()}
    emit(
        "cli", clips=CLI_CLIPS, batch=CLI_BATCH, t=T, history=history,
        checkpoints=checkpoints, launches=launches,
        launches_predicted=predicted, host_cpu=host_cpu(),
        decode_records=CLI_CLIPS["train"],
        decode_records_per_s=CLI_CLIPS["train"] / decode_s,
    )
    check(
        first == {k: 2 * v for k, v in per_epoch.items()}
        and launches == predicted,
        f"cli launched {first} then {launches}, predicted {predicted}",
    )
    check([h["epoch"] for h in history] == [0, 1, 2],
          f"epochs run {[h['epoch'] for h in history]}, not [0, 1, 2]")
    check(checkpoints == [0, 1, 2, 3], f"checkpoints {checkpoints}")
    check(
        all(np.isfinite(v) for h in history for v in h.values()),
        f"non-finite cli metrics: {history}",
    )
    return launches


SPEC_KERNELS = ("radar_fwd", "radar_bwd", "stft_fwd", "stft_bwd")


def spec_clips(n, seed):
    """Seeded skeleton-like clips ``(n, 3, T, 25, 2)`` (the JAX bench's
    ``normal x 0.3``), the second body of the last clip all zero, and
    labels of 60 classes."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, 3, SPEC_T, 25, 2)) * 0.3).astype(np.float32)
    x[-1, ..., 1] = 0.0
    return x, rng.integers(0, 60, n)


def rel_err(p, q):
    """max |p - q| / max |q|."""
    den = q.float().abs().max().clamp_min(1e-30)
    return ((p.float() - q.float()).abs().max() / den).item()


def max_abs_err(ps, qs):
    return max((p.float() - q.float()).abs().max().item()
               for p, q in zip(ps, qs))


def phase_radar_kernel(device):
    """Kernels #6 and #7 against their plain versions at the trainer's
    shape; returns the kernels line's entries (lambda = 5e-4) and that
    radar return for the STFT phase."""
    x, _ = spec_clips(SPEC_BATCH, SEED)
    e, src, dst, c, t_out = radar.spline_inputs(
        torch.from_numpy(x).to(device), SPEC_UP)
    loc = torch.tensor([0.1, -0.2, 0.3], device=device)
    g = torch.Generator(device=device).manual_seed(SEED + 2)
    gre = torch.randn(SPEC_BATCH, t_out, generator=g, device=device)
    gim = torch.randn(SPEC_BATCH, t_out, generator=g, device=device)
    totals, signal = {}, None
    for lam_v in LAMBDAS:
        args = (e, src, dst, c, loc, torch.tensor(lam_v, device=device))
        out = radar.spline_radar(*args, t_out)
        got = radar.spline_radar_backward(*args, gre, gim, t_out)
        again = radar.spline_radar_backward(*args, gre, gim, t_out)
        torch.cuda.synchronize()
        bit_identical = all(torch.equal(p, q) for p, q in zip(got, again))
        want = radar.spline_radar_reference(*args, t_out)
        want_bwd = radar.spline_radar_backward_reference(*args, gre, gim,
                                                         t_out)
        fwd_err = dict(zip(("re", "im"),
                           (rel_err(p, q) for p, q in zip(out, want))))
        bwd_err = dict(zip(("dsrc", "ddst", "dc", "dloc", "dlambda"),
                           (rel_err(p, q) for p, q in zip(got, want_bwd))))
        no_nan = not any(torch.isnan(p).any().item() for p in got)
        pairs = SPEC_BATCH * t_out * (src.shape[2] // 3)
        lam_t = args[5]
        fwd_bound = bound(RADAR_FWD_OPS * pairs,
                          nbytes(e, src, dst, c, loc, lam_t, *out), "f32")
        bwd_bound = bound(RADAR_BWD_OPS * pairs,
                          nbytes(e, src, dst, c, loc, lam_t, gre, gim, *got),
                          "f32")
        entries = {
            "radar_fwd": {
                "ms": cuda_ms(lambda: radar.spline_radar(*args, t_out)),
                "plain_ms": cuda_ms(
                    lambda: radar.spline_radar_reference(*args, t_out), 5, 1),
                "max_abs_err": max_abs_err(out, want),
                "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1],
                "library_ms": None,
            },
            "radar_bwd": {
                "ms": cuda_ms(lambda: radar.spline_radar_backward(
                    *args, gre, gim, t_out)),
                "plain_ms": cuda_ms(
                    lambda: radar.spline_radar_backward_reference(
                        *args, gre, gim, t_out), 5, 1),
                "max_abs_err": max_abs_err(got, want_bwd),
                "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1],
                "library_ms": None,
            },
        }
        emit(
            "radar_kernel", lam=lam_v, n=SPEC_BATCH, t_out=t_out,
            tiles=e.shape[0], rel_err=fwd_err, bwd_rel_err=bwd_err,
            rel_tol=RADAR_TOL[lam_v], bit_identical=bit_identical,
            dlambda=got[4].item(), **{
                f"{k}_{m}": v[m] for k, v in entries.items() for m in v},
        )
        check(bit_identical, f"radar_bwd repeats differ at lambda {lam_v}")
        check(no_nan, f"radar_bwd gave NaN at lambda {lam_v}")
        fwd_tol, bwd_tol = RADAR_TOL[lam_v]
        check(max(fwd_err.values()) <= fwd_tol,
              f"radar_fwd disagrees at lambda {lam_v}: {fwd_err}")
        check(max(bwd_err.values()) <= bwd_tol,
              f"radar_bwd disagrees at lambda {lam_v}: {bwd_err}")
        if lam_v == LAMBDAS[0]:
            totals, signal = entries, out
        del got, again, want, want_bwd
    torch.cuda.empty_cache()
    return totals, signal


DENSE_KERNELS = ("radar_dense_fwd", "radar_dense_bwd")


def phase_radar_dense_kernel(device):
    """Kernels #8 and #9 against their plain versions at the trainer's
    shape, the dense route against the spline route on the same clips, and
    the path of the JAX package's ``scripts/bench_spec_decompose.py``
    (``radar_return_fused`` forward, and backward through autograd to x,
    loc and lambda); returns the kernels line's entries (lambda = 5e-4)
    with the path's launches."""
    x = torch.from_numpy(spec_clips(SPEC_BATCH, SEED)[0]).to(device)
    op = torch.from_numpy(resample.pad_frames_operator(SPEC_T, SPEC_UP))
    op = op.to(device)
    t_out = op.shape[0]
    t_pad = -(-t_out // radar.TILE) * radar.TILE
    w = F.pad(op, (0, 0, 0, t_pad - t_out))  # as radar_return_fused pads
    src, dst = radar.gather_features(x, radar.RADAR_EDGES)
    c = radar.bone_length_mean_sq(x, op)
    loc = torch.tensor([0.1, -0.2, 0.3], device=device)
    g = torch.Generator(device=device).manual_seed(SEED + 2)
    gre = torch.randn(SPEC_BATCH, t_out, generator=g, device=device)
    gim = torch.randn(SPEC_BATCH, t_out, generator=g, device=device)
    em = src.shape[2] // 3
    pairs = SPEC_BATCH * t_out * em
    # one product of the operator's rows with one feature set
    product = 2 * SPEC_BATCH * t_out * SPEC_T * 3 * em
    entries = {}
    for lam_v in LAMBDAS:
        lam = torch.tensor(lam_v, device=device)
        args = (w, src, dst, c, loc, lam)
        out = radar.dense_radar(*args, t_out)
        got = radar.dense_radar_backward(*args, gre, gim, t_out)
        again = radar.dense_radar_backward(*args, gre, gim, t_out)
        torch.cuda.synchronize()
        bit_identical = all(torch.equal(p, q) for p, q in zip(got, again))
        del again
        want = radar.dense_radar_reference(*args, t_out)
        want_bwd = radar.dense_radar_backward_reference(*args, gre, gim,
                                                        t_out)
        fwd_err = dict(zip(("re", "im"),
                           (rel_err(p, q) for p, q in zip(out, want))))
        bwd_err = dict(zip(("dsrc", "ddst", "dc", "dloc", "dlambda"),
                           (rel_err(p, q) for p, q in zip(got, want_bwd))))
        no_nan = not any(torch.isnan(p).any().item() for p in got)
        spline = radar.radar_return_spline(x, SPEC_UP, loc, lam)
        route_err = dict(zip(("re", "im"),
                             (rel_err(p, q) for p, q in zip(out, spline))))
        record = {}
        if lam_v == LAMBDAS[0]:
            fwd_bound = bound(2 * product + DENSE_FWD_OPS * pairs,
                              nbytes(op, src, dst, c, loc, lam, *out), "f32")
            bwd_bound = bound(
                4 * product + DENSE_BWD_OPS * pairs,
                nbytes(op, src, dst, c, loc, lam, gre, gim, *got), "f32")
            entries = {
                "radar_dense_fwd": {
                    "ms": cuda_ms(lambda: radar.dense_radar(*args, t_out)),
                    "plain_ms": cuda_ms(lambda: radar.dense_radar_reference(
                        *args, t_out), 5, 1),
                    "max_abs_err": max_abs_err(out, want),
                    "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1],
                    # the two products alone (f32, TF32 off)
                    "library_ms": cuda_ms(lambda: (torch.matmul(w, src),
                                                   torch.matmul(w, dst))),
                },
                "radar_dense_bwd": {
                    "ms": cuda_ms(lambda: radar.dense_radar_backward(
                        *args, gre, gim, t_out)),
                    "plain_ms": cuda_ms(
                        lambda: radar.dense_radar_backward_reference(
                            *args, gre, gim, t_out), 5, 1),
                    "max_abs_err": max_abs_err(got, want_bwd),
                    "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1],
                },
            }
            # the four products alone: the recomputed positions and the
            # transposed products with row cotangents of the same shape
            g_rows = torch.randn(2, SPEC_BATCH, t_pad, 3 * em, generator=g,
                                 device=device)
            entries["radar_dense_bwd"]["library_ms"] = cuda_ms(lambda: (
                torch.matmul(w, src), torch.matmul(w, dst),
                torch.matmul(w.T, g_rows[0]), torch.matmul(w.T, g_rows[1])))
            del g_rows
            record = {f"{k}_{m}": v[m] for k, v in entries.items() for m in v}
        emit(
            "radar_dense_kernel", lam=lam_v, n=SPEC_BATCH, t_out=t_out,
            t_pad=t_pad, rel_err=fwd_err, bwd_rel_err=bwd_err,
            rel_tol=RADAR_TOL[lam_v], bit_identical=bit_identical,
            dlambda=got[4].item(), spline_route_rel_err=route_err,
            spline_route_rel_tol=ROUTE_TOL[lam_v], **record,
        )
        check(bit_identical,
              f"radar_dense_bwd repeats differ at lambda {lam_v}")
        check(no_nan, f"radar_dense_bwd gave NaN at lambda {lam_v}")
        fwd_tol, bwd_tol = RADAR_TOL[lam_v]
        check(max(fwd_err.values()) <= fwd_tol,
              f"radar_dense_fwd disagrees at lambda {lam_v}: {fwd_err}")
        check(max(bwd_err.values()) <= bwd_tol,
              f"radar_dense_bwd disagrees at lambda {lam_v}: {bwd_err}")
        check(max(route_err.values()) <= ROUTE_TOL[lam_v],
              f"dense and spline routes differ at lambda {lam_v}: "
              f"{route_err}")
        del out, got, want, want_bwd, spline
    torch.cuda.empty_cache()
    launches = dense_path(device, x, op, loc)
    for name in DENSE_KERNELS:
        entries[name]["launches"] = launches[name]
    return entries


def dense_path(device, x, op, loc):
    """``radar_return_fused`` as ``scripts/bench_spec_decompose.py`` drives
    it (the loss ``sum(re) + sum(im)``, lambda = 5e-4), backward through
    autograd to x, loc and lambda: exactly one launch of each kernel,
    finite gradients; CUDA-event times of the forward and of forward +
    backward beside the spline route's. Returns the launches."""
    xg = x.clone().requires_grad_()
    locg = loc.clone().requires_grad_()
    lamg = torch.tensor(LAMBDAS[0], device=device, requires_grad=True)
    routes = {
        "dense": lambda: radar.radar_return_fused(xg, op, locg, lamg),
        "spline": lambda: radar.radar_return_spline(xg, SPEC_UP, locg, lamg),
    }

    def train(route):
        xg.grad = locg.grad = lamg.grad = None
        sum(o.sum() for o in routes[route]()).backward()

    # the main path: the counts cover exactly one forward and its backward
    reset_launches()
    re, im = routes["dense"]()
    forward = read_launches(DENSE_KERNELS)
    (re.sum() + im.sum()).backward()
    launches = read_launches(DENSE_KERNELS)
    grads = {"x": xg.grad, "loc": locg.grad, "lambda": lamg.grad}
    finite = {k: bool(torch.isfinite(v).all()) for k, v in grads.items()}
    del re, im
    times = {}
    for route in routes:
        with torch.no_grad():
            times[f"{route}_forward_ms"] = cuda_ms(routes[route], 10, 2)
        times[f"{route}_train_ms"] = cuda_ms(lambda: train(route), 10, 2)
    emit("radar_dense_path", n=SPEC_BATCH, lam=LAMBDAS[0],
         forward_launches=forward, launches=launches, finite=finite, **times)
    check(forward == {"radar_dense_fwd": 1, "radar_dense_bwd": 0}
          and launches == {"radar_dense_fwd": 1, "radar_dense_bwd": 1},
          f"radar_return_fused launched {forward} forward, {launches} in "
          f"all; predicted one of each")
    check(all(finite.values()), f"non-finite dense gradients: {finite}")
    return launches


def phase_stft_kernel(device, radar_re, radar_im):
    """Kernels #10 and #11 against their plain versions at the trainer's
    shape, on seeded normal signals (as the JAX package's STFT tests); and
    kernel #10 on the radar return, compared as magnitudes."""
    cos, sin = (torch.from_numpy(b).to(device) for b in stft.stft_basis(256))
    hop, n, t = 16, radar_re.shape[0], radar_re.shape[1]
    frames = t // hop + 1
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    re, im = (torch.randn(n, t, generator=gen, device=device)
              for _ in range(2))
    g = torch.randn(n, 256, frames, generator=gen, device=device)
    out = stft_logmag.stft_logmag(re, im, hop, cos, sin)
    got = stft_logmag.stft_logmag_backward(re, im, hop, cos, sin, g)
    again = stft_logmag.stft_logmag_backward(re, im, hop, cos, sin, g)
    torch.cuda.synchronize()
    bit_identical = all(torch.equal(p, q) for p, q in zip(got, again))
    want = stft_logmag.stft_logmag_reference(re, im, hop, cos, sin)
    want_bwd = stft_logmag.stft_logmag_backward_reference(re, im, hop, cos,
                                                          sin, g)
    abs_err = max_abs_err([out], [want])
    bwd_err = dict(zip(("dre", "dim"),
                       (rel_err(p, q) for p, q in zip(got, want_bwd))))
    # the radar return's spectrum spans many decades: log|S| of its
    # smallest bins is ill-conditioned in f32 for any two summation orders,
    # |S| + eps = exp(out) is not
    # 4 real products a (frame, bin, tap) for each of re and im; the
    # backward recomputes the spectrum and takes the products' transposes
    products = n * frames * 256 * 256
    fwd_bound = bound(8 * products, nbytes(re, im, cos, sin, out), "f32")
    bwd_bound = bound(16 * products, nbytes(re, im, cos, sin, g, *got),
                      "f32")
    radar_mag_err = rel_err(
        stft_logmag.stft_logmag(radar_re, radar_im, hop, cos, sin).exp(),
        stft_logmag.stft_logmag_reference(radar_re, radar_im, hop, cos,
                                          sin).exp())
    entries = {
        "stft_fwd": {
            "ms": cuda_ms(lambda: stft_logmag.stft_logmag(
                re, im, hop, cos, sin)),
            "plain_ms": cuda_ms(lambda: stft_logmag.stft_logmag_reference(
                re, im, hop, cos, sin)),
            "max_abs_err": abs_err,
            "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1],
            "library_ms": None,
        },
        "stft_bwd": {
            "ms": cuda_ms(lambda: stft_logmag.stft_logmag_backward(
                re, im, hop, cos, sin, g)),
            "plain_ms": cuda_ms(
                lambda: stft_logmag.stft_logmag_backward_reference(
                    re, im, hop, cos, sin, g)),
            "max_abs_err": max_abs_err(got, want_bwd),
            "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1],
            "library_ms": None,
        },
    }
    emit(
        "stft_kernel", n=n, t=t, frames=frames, max_abs_err=abs_err,
        atol=STFT_ATOL, bwd_rel_err=bwd_err, bwd_rel_tol=STFT_GRAD_TOL,
        bit_identical=bit_identical, radar_magnitude_rel_err=radar_mag_err,
        radar_magnitude_rel_tol=STFT_MAG_TOL, **{
            f"{k}_{m}": v[m] for k, v in entries.items() for m in v},
    )
    check(bit_identical, "stft_bwd repeats differ")
    check(abs_err <= STFT_ATOL, f"stft_fwd disagrees by {abs_err}")
    check(max(bwd_err.values()) <= STFT_GRAD_TOL,
          f"stft_bwd disagrees: {bwd_err}")
    check(radar_mag_err <= STFT_MAG_TOL,
          f"stft_fwd magnitudes of the radar return differ by "
          f"{radar_mag_err}")
    return entries


def phase_spec_train(device):
    """The full-width spectrogram model's train steps, kernels and plain
    routes in turns, radar frozen and then unfrozen; a profile of the
    unfrozen kernel steps."""
    x, labels = spec_clips(SPEC_BATCH, SEED + 4)
    xs = torch.from_numpy(x).to(device)
    ys = torch.nn.functional.one_hot(torch.from_numpy(labels), 60)
    ys = ys.float().to(device)
    models = {}
    for route in ("kernels", "plain"):
        model = spectrogram.Model(
            num_classes=60, num_pad_frames=SPEC_UP,
            use_pallas=route == "kernels", use_pallas_stft=route == "kernels",
            device=device, generator=torch.Generator().manual_seed(SEED),
        )
        models[route] = (model, RadarOptimizer(model.named_parameters(),
                                               SPEC_LR))
    runs = {}
    for phase, unfrozen in (("frozen", False), ("unfrozen", True)):
        runs = {}
        for route, (model, opt) in models.items():
            step = make_radar_train_step(model, opt, SPEC_BATCH, unfrozen,
                                         unfrozen)
            runs[route] = lambda step=step: step(xs, ys)["loss"].item()
        losses = {route: [run() for _ in range(TRAIN_WARMUP)]
                  for route, run in runs.items()}
        times = {route: [] for route in runs}
        reset_launches()
        for i in range(TRAIN_STEPS):  # in turns, the order reversed
            for route in ("kernels", "plain")[:: 1 if i % 2 == 0 else -1]:
                start = time.perf_counter()
                losses[route].append(runs[route]())
                times[route].append(time.perf_counter() - start)
        launches = read_launches(SPEC_KERNELS)
        backward = TRAIN_STEPS if unfrozen else 0
        predicted = {"radar_fwd": TRAIN_STEPS, "radar_bwd": backward,
                     "stft_fwd": TRAIN_STEPS, "stft_bwd": backward}
        for route, samples in times.items():
            torch.cuda.reset_peak_memory_stats()
            runs[route]()
            loss = losses[route]
            med = statistics.median(samples)
            falling = bool(np.mean(loss[-5:]) < np.mean(loss[:5]))
            emit(
                "spec_train", radar=phase, route=route, batch=SPEC_BATCH,
                t=SPEC_T * SPEC_UP, steps=len(samples),
                median_step_ms=1e3 * med, min_step_ms=1e3 * min(samples),
                max_step_ms=1e3 * max(samples), clips_per_s=SPEC_BATCH / med,
                peak_mem_mb=torch.cuda.max_memory_allocated() / 2**20,
                loss_first=loss[0], loss_last=loss[-1], loss_falling=falling,
                radar_lambda=models[route][0].virtual_radar.radar_lambda.item(),
                launches_timed=launches if route == "kernels" else None,
            )
            check(all(np.isfinite(loss)), f"non-finite {route} loss")
            # unfrozen, each step moves lambda by 1% and with it the phase
            # of every return by ~100 rad: the input itself changes, and
            # the loss need not fall
            check(unfrozen or falling,
                  f"{route} frozen-phase loss did not fall: {loss}")
        check(launches == predicted,
              f"{phase} steps launched {launches}, predicted {predicted}")
    emit("spec_profile", radar="unfrozen", route="kernels", batch=SPEC_BATCH,
         steps=PROFILE_STEPS,
         **device_profile(runs["kernels"], PROFILE_STEPS))
    del models, runs
    torch.cuda.empty_cache()


def phase_spec_cli(device):
    """The spectrogram trainer CLI on synthetic clips, then resumed."""
    with tempfile.TemporaryDirectory() as tmp:
        for i, (part, n) in enumerate(SPEC_CLI_CLIPS.items()):
            x, labels = spec_clips(n, SEED + 5 + i)
            np.save(os.path.join(tmp, f"{part}_data_joint.npy"), x)
            with open(os.path.join(tmp, f"{part}_label.pkl"), "wb") as f:
                pickle.dump(([f"clip{j}" for j in range(n)],
                             [int(v) for v in labels]), f)
        argv = [
            "--data-path", os.path.join(tmp, "{}_data_joint.npy"),
            "--label-path", os.path.join(tmp, "{}_label.pkl"),
            "--log-dir", os.path.join(tmp, "logs"),
            "--batch-size", str(SPEC_BATCH), "--num-epochs", "2",
            "--save-freq", "1", "--lambda-train-epoch", "0",
            "--loc-train-epoch", "0",
        ]
        steps = SPEC_CLI_CLIPS["train"] // SPEC_BATCH
        evals = -(-SPEC_CLI_CLIPS["val"] // SPEC_BATCH)
        # each train step and eval batch: one radar and one STFT forward;
        # each train step after epoch 0 (lambda and loc unfrozen): one of
        # each backward; epoch 0: none
        fwd = steps + evals
        first_predicted = {"radar_fwd": 2 * fwd, "radar_bwd": steps,
                           "stft_fwd": 2 * fwd, "stft_bwd": steps}
        predicted = {"radar_fwd": 3 * fwd, "radar_bwd": 2 * steps,
                     "stft_fwd": 3 * fwd, "stft_bwd": 2 * steps}
        # the main path: the counts cover exactly the two runs
        reset_launches()
        history = main_spectrogram.main(argv)
        first = read_launches(SPEC_KERNELS)
        history += main_spectrogram.main(
            argv[:9] + ["3"] + argv[10:] + ["--resume"])
        launches = read_launches(SPEC_KERNELS)
        (run,) = os.listdir(os.path.join(tmp, "logs"))
        ckpt_dir = os.path.join(tmp, "logs", run, "checkpoints")
        checkpoints = sorted(int(d) for d in os.listdir(ckpt_dir))
    emit(
        "spec_cli", clips=SPEC_CLI_CLIPS, batch=SPEC_BATCH,
        t=SPEC_T, history=history, checkpoints=checkpoints,
        launches=launches, launches_predicted=predicted,
        first_run_launches=first, first_run_predicted=first_predicted,
    )
    check(first == first_predicted and launches == predicted,
          f"spec cli launched {first} then {launches}, predicted "
          f"{first_predicted} then {predicted}")
    check([h["epoch"] for h in history] == [0, 1, 2],
          f"epochs run {[h['epoch'] for h in history]}, not [0, 1, 2]")
    check(checkpoints == [0, 1, 2], f"checkpoints {checkpoints}")
    lams = [h["radar_lambda"] for h in history]
    check(lams[0] == float(np.float32(5e-4)) and lams[1] != lams[0]
          and lams[2] != lams[1], f"radar_lambda by epoch {lams}")
    check(all(np.isfinite(v) for h in history for v in h.values()),
          f"non-finite spec cli metrics: {history}")
    return launches


def main():
    phase_env()
    device = torch.device("cuda", 0)
    phase_build()
    totals = phase_kernel(device)
    bwd_totals = phase_kernel_bwd(device)
    new_totals = {"sgcn_fwd_stats": phase_kernel_stats(device),
                  **phase_tconv_kernel(device)}
    rng = np.random.default_rng(SEED)
    requests = {
        n: rng.normal(size=(n, 3, T, 25, 2)).astype(np.float32)
        for n in REQUESTS
    }
    state, _ = phase_slice(device, requests)
    phase_latency(device, state, requests[64])
    train_launches = phase_train(device)
    launches = phase_cli(device)
    torch.cuda.empty_cache()
    tf32_off()
    spec_totals, (re, im) = phase_radar_kernel(device)
    dense_totals = phase_radar_dense_kernel(device)
    spec_totals.update(phase_stft_kernel(device, re, im))
    del re, im
    phase_spec_train(device)
    spec_launches = phase_spec_cli(device)
    print(json.dumps({"kernels": [
        {"name": "sgcn_fwd", "route": "cuda", "source": SGCN_SOURCE,
         "replaces": SGCN_REPLACES, "launches": launches["sgcn_fwd"],
         **totals},
        {"name": "sgcn_bwd", "route": "cuda", "source": SGCN_BWD_SOURCE,
         "replaces": SGCN_BWD_REPLACES, "launches": launches["sgcn_bwd"],
         **bwd_totals},
    ] + [
        {"name": name, "route": "cuda",
         "source": f"skeleton_action_recognition_tpu_torch/csrc/{name}.cu",
         "replaces": KERNEL_REPLACES[name],
         "launches": spec_launches[name], **spec_totals[name]}
        for name in SPEC_KERNELS
    ] + [
        {"name": name, "route": "cuda",
         "source": KERNEL_SOURCES.get(
             name, f"skeleton_action_recognition_tpu_torch/csrc/{name}.cu"),
         "replaces": KERNEL_REPLACES[name],
         "launches": train_launches[name], **new_totals[name]}
        for name in ("sgcn_fwd_stats", "tconv_fwd", "tconv_bwd")
    ] + [
        {"name": name, "route": "cuda",
         "source": f"skeleton_action_recognition_tpu_torch/csrc/{name}.cu",
         "replaces": KERNEL_REPLACES[name], **dense_totals[name]}
        for name in DENSE_KERNELS
    ]}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
