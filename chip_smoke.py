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
   register and shared-memory reports); ``sgcn_build``: the registers,
   spills and shared memory of the six f32 spatial-conv kernels
   (``csrc/sgcn_tile_f32.cuh``; none may spill).
3. ``kernel``: the CUDA spatial graph-conv kernel against its plain PyTorch
   version at the six (T, C_in, C_out) shapes of the ten ST-GCN blocks, at
   NM=128 (64 clips x 2 bodies), in f32 and bf16: error, two launches bit
   for bit, and CUDA-event times of both and of cuBLAS's 1x1 conv alone
   (``F.linear``; ``library_ms``).
4. ``kernel_bwd``: the backward kernel against its plain version at the
   six shapes, NM=256 (the 128-clip training batch), f32 and bf16: the
   relative error of dx, dW and db, two launches bit for bit, CUDA-event
   times of both and of cuBLAS's two products on a materialized dz alone
   (``library_ms``).
   ``kernel_stats``: kernel #2 (the spatial conv with the BatchNorm
   statistics epilogue) against its plain version at the six shapes,
   NM=256, f32 and bf16: the errors of out and of the sums, two launches
   bit for bit, CUDA-event times (``F.linear`` alone as ``library_ms``).
   ``tconv_kernel``: kernels #4/#5 (the fused temporal chain, forward and
   backward) against their plain versions at the three stride-1 shapes,
   NM=256, f32 and bf16, with a positive shift: the error of every
   output, two launches of each bit for bit, CUDA-event times of kernel,
   plain version and cuDNN's conv alone; first (``tconv_build``) the
   registers, spills and shared memory of the f32 and bf16 kernels (the
   f32 ones must not spill).
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
   shape (B=128, T=300, remat off) in five configurations, timed in turns
   (10 steps after 3 warm-up, each ending synchronized), in bf16 and in
   f32 with TF32 off (B=128 if it fits, else 64 or 32): unfused, the
   spatial conv fused on every block, that with ``sgcn_stats`` or with
   ``fused_tconv``, and fused on the six blocks of 128 and more filters
   (the CLI's default ``--fused-sgcn-min-channels 128``, ``bench.py``'s).
   Step time, clips/s, peak memory; the loss finite and falling; each
   step's launches exactly ``STEP_LAUNCHES``; the ``fused_tconv`` step
   beside the ``fused`` one (``fused_tconv_vs_fused``: in bf16 and in f32
   it must be faster and use less memory). Then f32 once more with TF32
   on in cuBLAS and cuDNN (``main_gnn``'s default ``--precision``; the
   kernels stay f32): unfused, fused and ``fused_min128`` as ``dtype:
   "f32_tf32"``, the same readings and checks. Between the bf16 and the
   f32 steps, profiler traces of 3 bf16 steps, unfused, fused and
   fused_tconv: device time by kernel name and the device's idle share.
8. ``cli``: ``cli.main_gnn.main`` on a seeded synthetic TFRecord set
   (T=300, 60 classes, 48 training and 16 test clips, written with the
   port's writer), ``--fused-sgcn --fused-sgcn-min-channels 0``, default
   remat, 2 epochs and then ``--resume`` for a third: the checkpoints, the
   resumed epoch, finite losses and accuracies, and launch counts equal to
   the prediction (20 forward and 10 backward a train step with remat, 10
   forward an eval batch). Also the TFRecord decode rate of this host.

9. ``radar_build``: registers, spills and shared memory of the spline
   radar kernels (csrc/radar_spline.cuh: #6, #7 and #7's loc/lambda
   instance); a spill fails the script. ``radar_kernel``: those three
   against their plain versions at the spectrogram trainer's shape (16
   clips, T=300 upsampled 250x to 75,000 samples, 24 edges x 2 bodies),
   seeded skeleton-like clips with one empty body, at lambda = 5e-4 and at
   a damped lambda = 10: the error of each output, two launches of each
   backward instance bit for bit, whether the instances' dloc/dlambda
   agree bit for bit, CUDA-event times of kernel and plain.
   ``radar_dense_kernel``: the dense-operator radar kernels (#8 forward, #9
   backward) against their plain versions on the same clips (the operator
   ``pad_frames_operator(300, 250)`` padded to 512-row tiles), at both
   lambdas, TF32 off: the error of each output, two backward launches bit
   for bit, the dense route against the spline route, CUDA-event times of
   kernel, plain and the operator products alone (``torch.matmul``); the
   operator's band (``radar.dense_band``: the widths of a 64-row block's
   and a 4,096-row split's band, mean and largest, and the band pass's
   time) and the bounds counted over the entries the forward contracts,
   with the dense count beside them (``*_dense_bound_ms``). #8's time
   takes in its band pass; #9 is timed as the main path runs it, on the
   forward's band. Then ``radar_dense_path``:
   ``radar_return_fused`` forward and backward through autograd to x, loc
   and lambda, as the JAX package's ``scripts/bench_spec_decompose.py``
   drives it: one launch of each kernel, finite gradients, the times of
   forward and forward + backward beside the spline route's, and one
   profiler pass over a forward and backward (``glue_profile``: the
   device time of #8/#9 and of the plain-torch glue around them, and the
   glue's largest kernels and operators).
10. ``stft_kernel``: the STFT log-magnitude kernels (#10, #11), FFTs in
    the block, at that shape (16 x 75,000 samples, n_fft 256, hop 16:
    4,688 frames) on seeded normal signals, against their plain versions
    evaluated in float64 (the f32 plain versions' distance beside, as
    ``*_vs_f32_plain``), and #10 on the radar return as magnitudes: the
    errors, two launches of each bit for bit, #11's peak memory (no
    workspace), CUDA-event times of kernel, plain version and
    ``torch.stft`` (cuFFT) forward and its backward alone (``library_ms``),
    and the bounds of the FFT route with the PR 3 design's DFT products'
    beside (``dft_bound_ms``).
11. ``spec_train``: training steps of the full-width spectrogram model
    (ResNet-18, 64 filters, 256 x 256 images, 60 classes) at B=16, f32,
    TF32 off, through the kernels and through the plain routes
    (``use_pallas=False, use_pallas_stft=False``), radar frozen and then
    unfrozen (lambda and loc), timed in turns (10 steps after 3 warm-up,
    each ending synchronized): step time, clips/s, peak memory, the loss
    finite (and falling while frozen), exactly 1 + 1 forward launches a
    step and 1 + 1 backward launches a step unfrozen (#7's loc/lambda
    instance, never the full one: the joints are data), none frozen. Then
    a profiler trace of 3 unfrozen kernel steps.
12. ``spec_cli``: ``cli.main_spectrogram.main`` on a seeded synthetic
    ``.npy`` + pickled-label set (T=300, 60 classes, 48 training and 20
    validation clips, B=16, kernels on), 2 epochs with lambda and loc
    unfrozen after epoch 0, then ``--resume`` for a third: the checkpoints,
    the resumed epoch, lambda frozen through epoch 0 and moving after,
    finite metrics, and launch counts equal to the prediction.
13. ``eval_path``: the evaluation chain from raw files. Seeded synthetic
    ``.skeleton`` files (``scripts/corpus_lib.py``: 60 classes x 2 clips,
    camera 1 xview's val part and camera 2 its train part, and four
    files of 2-4 bodies with empty frames from this script's writer) through
    ``cli.data_gen.main`` (xview, the joint and bone streams as TFRecords,
    2 shards): the artifacts' shapes, finite values, labels and camera
    split, and its records/s on this host (the Python tokenizer). Then
    seeded full-width checkpoints (ST-GCN for the joint and the bone
    stream, 60 classes; the spectrogram model, 64 filters, 250 frames
    padded), ``cli.evaluate.main`` on ST-GCN (val TFRecords) and on the
    spectrogram model (``data_gen``'s ``.npy`` + ``.pkl``), each report
    equal to the one recomputed from the model's probabilities (each after
    an untimed warm-up run), the spectrogram run launching #6 and #10 once
    a batch; the spectrogram model through the kernels against the plain
    routes: the return and |S| + eps on data_gen's clips, the logits on
    seeded normal clips; ``cli.ensemble.main`` over joint, bone and
    spectrogram with unequal weights, its report equal to the one
    recomputed from the streams' probabilities and its launches as
    predicted; ``Predictor.from_checkpoint`` on the fused ST-GCN, 10
    launches of #1 a request, its probabilities and logits against the
    unfused predictor's. Clips/s of each evaluation, end to end and of the
    forward alone.

Then the kernels line (``sgcn_fwd`` ``ms``/``plain_ms``: f32 time of the
ten spatial convs of one 64-clip request; ``sgcn_bwd`` and
``sgcn_fwd_stats``: f32 time of the ten blocks' calls at NM=256; these
three carry cuBLAS's 1x1 conv (#1, #2) or its two products on a
materialized dz (#3) alone as ``library_ms``, and the bf16 kernel's numbers
beside as ``bf16_ms``, ``bf16_plain_ms``, ``bf16_library_ms``,
``bf16_bound_ms``, ``bf16_bound_by`` and ``bf16_max_abs_err``;
``tconv_*``: f32 time of the eight stride-1 blocks' calls at NM=256, with
cuDNN's conv alone as ``library_ms``, and the bf16 numbers beside as
``bf16_*`` (with ``bf16_library_ms``); ``radar_*``/``stft_*``: one call at
16 clips, lambda = 5e-4, with the operator products alone as the dense
radar kernels' ``library_ms`` and ``torch.stft`` and its backward as the
STFT kernels' (their ``dft_bound_ms`` beside); ``radar_bwd`` the numbers
of #7's loc/lambda instance beside as ``loc_lam_ms``, ``loc_lam_plain_ms``,
``loc_lam_bound_ms``, ``loc_lam_bound_by``, ``loc_lam_max_abs_err`` and
``loc_lam_launches`` (its ``launches`` count both instances); ``bound_ms``: the least
time of the same work at the card's published f32 (bf16) peak and memory
rate; ``launches``: the
counts of the ``cli`` run for ``sgcn_fwd``/``sgcn_bwd``, of the
``spec_cli`` run for the spline radar and STFT kernels, of
``radar_dense_path`` for the dense radar kernels and of the ``train``
phase's timed steps for the others, each main path counted from 0), the
card's name and power limit as ``nvidia-smi`` prints them, and the result
line.
"""

from __future__ import annotations

import ctypes
import json
import os
import platform
import re
import statistics
import subprocess
import tempfile
import time
from concurrent import futures

import pickle

import numpy as np
import torch
import torch.nn.functional as F

from scripts import corpus_lib
from skeleton_action_recognition_tpu_torch.cli import (
    data_gen,
    ensemble,
    evaluate,
    main_gnn,
    main_spectrogram,
)
from skeleton_action_recognition_tpu_torch.data import skeleton, tfrecord
from skeleton_action_recognition_tpu_torch.data.pipeline import (
    NumpyDataset,
    TFRecordDataset,
    stream_transform,
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
    virtual_radar,
)
from skeleton_action_recognition_tpu_torch.serving import Predictor
from skeleton_action_recognition_tpu_torch.train.optim import (
    TFSGD,
    RadarOptimizer,
)
from skeleton_action_recognition_tpu_torch.train.checkpoint import (
    CheckpointManager,
    restore_latest_for_eval,
)
from skeleton_action_recognition_tpu_torch.train.steps import (
    make_eval_step,
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
    # the CLI's default --fused-sgcn-min-channels and bench.py's: the six
    # blocks of 128 and 256 filters fused
    "fused_min128": dict(fused_sgcn=True, fused_sgcn_min_channels=128),
}
STEP_LAUNCHES = {
    "unfused": {},
    "fused": {"sgcn_fwd": 10, "sgcn_bwd": 10},
    "sgcn_stats": {"sgcn_fwd_stats": 10, "sgcn_bwd": 10},
    "fused_tconv": {"sgcn_fwd": 10, "sgcn_bwd": 10, "tconv_fwd": 8,
                    "tconv_bwd": 8},
    "fused_min128": {"sgcn_fwd": 6, "sgcn_bwd": 6},
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
# the f32 configurations timed again with TF32 on (main_gnn's default
# --precision): unfused, every block fused, and the CLI's default
TF32_CONFIGS = ("unfused", "fused", "fused_min128")
PROFILE_CONFIGS = ("unfused", "fused", "fused_tconv")
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
# STFT kernels vs their plain versions evaluated in float64, on normal
# signals: log|S| to 5e-4 absolute (the error grows as 1/|S| at the
# smallest bins; the f32 plain version is itself 1.1e-3 from float64 at
# this shape, an f32 FFT 2.2e-4: scripts/torch_stft_oracle.py on the CPU),
# the (re, im) cotangent to 2e-3 of the largest (the 1/|S| of the smallest
# of 16 x 4,688 x 256 bins). On the radar return, |S| + eps to 1e-5 of its
# largest (f32 sums in other orders: 7.3e-7 measured against the f32 plain
# version); torch.stft's magnitudes likewise.
STFT_ATOL, STFT_GRAD_TOL, STFT_MAG_TOL = 5e-4, 2e-3, 1e-5
SPEC_LR = 1e-4  # the JAX bench's Adam rate
# the evaluation chain: corpus_lib's 60 classes x 2 clips (camera 1: xview
# val, camera 2: train), evaluated in batches of 16 (the last one partial)
EVAL_CLASSES, EVAL_CLIPS_PER_CLASS, EVAL_BATCH = 60, 2, 16
ENSEMBLE = (("joint", 1.0), ("bone", 0.6), ("spectrogram", 0.3))
# the spectrogram model's logits through the kernels against the plain
# routes, max |diff| / max |plain|, on seeded normal clips (spec_clips):
# the return at lambda = 5e-4 moves by up to ROUTE_TOL's 1e-2 of its scale,
# log|S| amplifies that at the smallest bins, and the ResNet carries it to
# the logits (the CPU tests' tolerance against the JAX model,
# tests/test_torch_spectrogram.py). On data_gen's clips (smooth motion, a
# clip tiled to 300 frames) most bins are near zero, where log(|S| + 1e-6)
# is the routes' rounding: there the stages are held, the return at
# ROUTE_TOL and |S| + eps at STFT_MAG_TOL, and the logits' distance printed.
SPEC_LOGIT_TOL = 5e-3
# the fused predictor's logits against the unfused one's, max |diff| / max
# |unfused|: KERNEL_REL_TOL's f32 1e-5 a block, through ten blocks
PREDICTOR_LOGIT_TOL = 1e-4
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
# #7's loc/lambda instance: the backward without the contraction (52) and
# without the chain's cotangents of the bone (g_b and 1 / |b|: 16), of the
# endpoints (15) and of c (5)
RADAR_BWD_LOC_LAM_OPS = RADAR_BWD_OPS - 52 - 36
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


def band_stats(w, t_out):
    """The band the dense kernels contract (``radar.dense_band``) for the
    first ``t_out`` rows of ``w``, and its record: the widths of a 64-row
    block's and a 4,096-row split's band, mean and largest, and the band
    pass's time (CUDA events)."""
    band = radar.dense_band(w, t_out)
    record = {"band_ms": cuda_ms(lambda: radar.dense_band(w, t_out))}
    for name, b in zip(("tile", "split"), band):
        width = (b[:, 1] - b[:, 0]).double()
        record.update({f"band_{name}_mean": width.mean().item(),
                       f"band_{name}_max": width.max().item()})
    return band, record


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


def dtype_entries(totals):
    """The kernels-line numbers of a spatial-conv kernel: f32 under the
    contract's keys, bf16 beside them as ``bf16_<key>``."""
    return {**totals["f32"].entry(),
            **{f"bf16_{k}": v for k, v in totals["bf16"].entry().items()}}


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


def linear_ms(x, w, b):
    """#1/#2's library yardstick: cuBLAS's 1x1 conv ``F.linear(x, W, b)``
    alone, in ``x``'s dtype (no library call contracts the adjacency or
    takes the statistics)."""
    wd, bd = w.to(x.dtype), b.to(x.dtype)
    return cuda_ms(lambda: F.linear(x, wd, bd))


def dz_products_ms(x, w, a, gout):
    """#3's library yardstick: cuBLAS's two products ``dz @ W`` and ``dz^T
    @ x`` on a materialized ``dz = A g``, in ``x``'s dtype (the adjacency
    contraction and db not timed)."""
    dz = torch.einsum("kvw,ntwo->ntvko", a.to(x.dtype), gout)
    dz = dz.reshape(-1, w.shape[0])
    x2, wd = x.reshape(-1, x.shape[-1]), w.to(x.dtype)
    ms = cuda_ms(lambda: (dz @ wd, dz.T @ x2))
    del dz
    return ms


def spilling(ptxas):
    """The lines of a ``ptxas_entries`` report that show a spill."""
    return [line for lines in ptxas.values() for line in lines
            if "spill" in line and not re.search(
                r"\b0 bytes spill stores, 0 bytes spill loads", line)]


def sgcn_build_report():
    """Registers, spills and dynamic shared memory of the f32 spatial-conv
    kernels (csrc/sgcn_tile_f32.cuh, namespace ``sgcn_f32``: the forward
    and its stats instance, dx and dW in their wide and narrow instances),
    from the build."""
    fn = build.load_library("sgcn_bwd.cu").sgcn_f32_smem_bytes
    fn.argtypes = [ctypes.c_void_p] * 3
    fn.restype = None
    sizes = [ctypes.c_int() for _ in range(3)]
    fn(*(ctypes.byref(s) for s in sizes))
    return {
        "ptxas": {**ptxas_entries("sgcn_fwd.cu", "8sgcn_f32"),
                  **ptxas_entries("sgcn_bwd.cu", "8sgcn_f32")},
        "smem_bytes": dict(zip(("fwd_kernel", "dx_kernel", "dw_kernel"),
                               (s.value for s in sizes))),
    }


def phase_sgcn_build():
    """The f32 spatial-conv kernels' build report: six kernels (the
    forward and its stats instance; dx and dW, each wide and narrow), none
    spilling."""
    report = sgcn_build_report()
    emit("sgcn_build", **report)
    check(len(report["ptxas"]) == 6 and not spilling(report["ptxas"]),
          f"the f32 spatial kernels spill: {report['ptxas']}")


def phase_kernel(device):
    a = torch.from_numpy(spatial_adjacency()).to(device)
    g = torch.Generator(device=device).manual_seed(SEED)
    totals = {name: Totals(library=True) for name in DTYPES}
    for name, dtype in DTYPES.items():
        for (t, c_in, c_out), blocks in BLOCK_SHAPES:
            x = torch.randn(NM, t, 25, c_in, generator=g, device=device)
            x = x.to(dtype)
            w = torch.randn(3 * c_out, c_in, generator=g, device=device)
            w *= (2.0 / c_in) ** 0.5
            b = 0.1 * torch.randn(3 * c_out, generator=g, device=device)
            out = sgcn.fused_graph_conv(x, w, b, a)
            bit_identical = torch.equal(out, sgcn.fused_graph_conv(x, w, b,
                                                                   a))
            torch.cuda.synchronize()
            ref = sgcn.graph_conv_reference(x, w, b, a)
            abs_err = (out.float() - ref.float()).abs().max().item()
            rel_err = abs_err / ref.float().abs().max().item()
            times = {
                "ms": cuda_ms(lambda: sgcn.fused_graph_conv(x, w, b, a)),
                "plain_ms": cuda_ms(
                    lambda: sgcn.graph_conv_reference(x, w, b, a)),
                "library_ms": linear_ms(x, w, b),
            }
            bound_ms, bound_by = bound(
                sgcn_flops(NM * t, c_in, c_out, a), nbytes(x, w, b, a, out),
                name)
            emit(
                "kernel", dtype=name, nm=NM, t=t, c_in=c_in, c_out=c_out,
                max_abs_err=abs_err, rel_err=rel_err,
                rel_tol=KERNEL_REL_TOL[name], bit_identical=bit_identical,
                **times, bound_ms=bound_ms, bound_by=bound_by,
            )
            check(bit_identical, f"sgcn kernel repeats differ at {name} "
                  f"{(t, c_in, c_out)}")
            check(
                rel_err <= KERNEL_REL_TOL[name],
                f"sgcn kernel disagrees at {name} {(t, c_in, c_out)}: "
                f"rel err {rel_err}",
            )
            totals[name].add(times, abs_err, bound_ms, bound_by, blocks)
            del x, out, ref
    return dtype_entries(totals)


def phase_kernel_bwd(device):
    a = torch.from_numpy(spatial_adjacency()).to(device)
    g = torch.Generator(device=device).manual_seed(SEED + 1)
    totals = {name: Totals(library=True) for name in DTYPES}
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
            times = {
                "ms": cuda_ms(
                    lambda: sgcn.fused_graph_conv_backward(x, w, a, gout)),
                "plain_ms": cuda_ms(
                    lambda: sgcn.graph_conv_backward_reference(x, w, a,
                                                               gout)),
                "library_ms": dz_products_ms(x, w, a, gout),
            }
            emit(
                "kernel_bwd", dtype=name, nm=TRAIN_NM, t=t, c_in=c_in,
                c_out=c_out, max_abs_err=dict(zip(("dx", "dW", "db"),
                                                  abs_err)),
                rel_err=dict(zip(("dx", "dW", "db"), rel_err)),
                rel_tol=BWD_REL_TOL[name], bit_identical=bit_identical,
                **times, bound_ms=bound_ms, bound_by=bound_by,
            )
            check(bit_identical, f"sgcn_bwd repeats differ at {name} "
                  f"{(t, c_in, c_out)}")
            check(
                all(e <= tol for e, tol in zip(rel_err, BWD_REL_TOL[name])),
                f"sgcn_bwd disagrees at {name} {(t, c_in, c_out)}: "
                f"rel err {rel_err}",
            )
            totals[name].add(times, max(abs_err), bound_ms, bound_by,
                             blocks)
            del x, gout
            torch.cuda.empty_cache()
    return dtype_entries(totals)


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
    totals = {name: Totals(library=True) for name in DTYPES}
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
            times = {
                "ms": cuda_ms(lambda: sgcn.fused_graph_conv_stats(x, w, b,
                                                                  a)),
                "plain_ms": cuda_ms(
                    lambda: sgcn.graph_conv_stats_reference(x, w, b, a)),
                "library_ms": linear_ms(x, w, b),
            }
            emit(
                "kernel_stats", dtype=name, nm=TRAIN_NM, t=t, c_in=c_in,
                c_out=c_out, out_rel_err=out_rel,
                out_rel_tol=KERNEL_REL_TOL[name], sum_err=sums,
                sum_tol={"own": STATS_OWN_TOL,
                         "plain": STATS_PLAIN_TOL[name]},
                bit_identical=bit_identical, **times, bound_ms=bound_ms,
                bound_by=bound_by,
            )
            where = f"{name} {(t, c_in, c_out)}"
            check(bit_identical, f"sgcn_fwd_stats repeats differ at {where}")
            check(out_rel <= KERNEL_REL_TOL[name],
                  f"sgcn_fwd_stats out disagrees at {where}: {out_rel}")
            check(all(v <= (STATS_OWN_TOL if k.endswith("own")
                            else STATS_PLAIN_TOL[name])
                      for k, v in sums.items()),
                  f"sgcn_fwd_stats sums disagree at {where}: {sums}")
            totals[name].add(times, abs_err, bound_ms, bound_by, blocks)
            del x, got
            torch.cuda.empty_cache()
    return dtype_entries(totals)


def ptxas_entries(source, needle):
    """``{kernel: ptxas's "Used ..." line and its spill line}`` of the
    entry functions of ``source``'s build whose mangled name holds
    ``needle``, from the compiler's report kept beside the library."""
    log = build.library_path(source).with_suffix(".log").read_text()
    entries, kernel = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            kernel = name if needle in name else None
        elif kernel and ("spill" in line or "Used" in line):
            entries.setdefault(kernel, []).append(line.split(":")[-1].strip()
                                                  if "Used" in line
                                                  else line.strip())
    return entries


def tconv_build_report():
    """Registers, spills and dynamic shared memory of the kernels of the
    fused temporal chain, from the build: f32 (csrc/tconv_tile.cuh and
    tconv_bwd.cu, namespace ``tconv``) and bf16 (csrc/tconv_mma.cuh)."""
    lib = build.load_library("tconv_bwd.cu")
    report = {}
    for dtype, prefix, fn_name, names in (
            ("f32", "_ZN5tconv", "tconv_f32_smem_bytes",
             ("tile_kernel", "wgrad_kernel")),
            ("bf16", "tconv_mma", "tconv_mma_smem_bytes",
             ("mma_tile_kernel", "mma_wgrad_kernel"))):
        tile, wgrad = ctypes.c_int(), ctypes.c_int()
        fn = getattr(lib, fn_name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = None
        fn(ctypes.byref(tile), ctypes.byref(wgrad))
        report[dtype] = {
            "ptxas": {**ptxas_entries("tconv_fwd.cu", prefix),
                      **ptxas_entries("tconv_bwd.cu", prefix)},
            "smem_bytes": {names[0]: tile.value, names[1]: wgrad.value},
        }
    return report


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
    totals = {k: {name: Totals(library=True) for name in DTYPES}
              for k in ("tconv_fwd", "tconv_bwd")}
    report = tconv_build_report()
    emit("tconv_build", **report)
    check(len(report["f32"]["ptxas"]) == 3
          and not spilling(report["f32"]["ptxas"]),
          f"the f32 temporal kernels spill: {report['f32']['ptxas']}")
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
            for k, tot in totals.items():
                tot[name].add(times[k], errs[k], *bounds[k], blocks)
            del s, gue, x, gy
            torch.cuda.empty_cache()
    return {k: dtype_entries(tot) for k, tot in totals.items()}


def seeded_model(name, fused, state=None, seed=SEED, **options):
    """Full-width NTU-60 ST-GCN computing in ``name`` ("f32" or "bf16"),
    with the model's other ``options``. Without ``state``: CONV_INIT
    weights from ``seed``, and BatchNorm affines, running statistics and
    every bias redrawn from it, so that eval-mode BatchNorm and the bias
    paths do real work."""
    g = torch.Generator().manual_seed(seed)
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
    "radar_bwd_loc_lam": radar.spline_radar_loc_lam_backward,
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


def train_runs(device, name, batch, configs=tuple(TRAIN_CONFIGS)):
    """``{config: step}`` closures training the full-width model in each
    of ``configs`` (``TRAIN_CONFIGS``' names), from the same seed, each on
    its own fixed batch of seeded noise. Each closure keeps, in
    ``.saved_mb``, the device memory allocated when its last backward
    began (parameters, optimizer state and the activations saved for the
    backward)."""
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(
        rng.normal(size=(batch, 3, T, 25, 2)).astype(np.float32)
    ).to(device)
    y = torch.nn.functional.one_hot(
        torch.from_numpy(rng.integers(0, 60, batch)), 60
    ).float().to(device)
    runs = {}
    for config in configs:
        options = TRAIN_CONFIGS[config]
        model = Model(
            num_classes=60,
            dtype=torch.bfloat16 if name == "bf16" else None,
            remat=False, device=device,
            generator=torch.Generator().manual_seed(SEED),
            **{"fused_sgcn_min_channels": 0, **options},
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


def time_training(device, name, batch, configs=tuple(TRAIN_CONFIGS)):
    """The configurations' steps in turns, each step's launches counted
    and checked against ``STEP_LAUNCHES``; returns the runs, the launches
    of all timed steps and each configuration's median step ms and peak
    memory MB. ``name`` is "bf16", "f32" or "f32_tf32" (f32 as the
    caller's TF32 switches leave it)."""
    runs = train_runs(device, name, batch, configs)
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
    summary = {}
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
        summary[k] = (1e3 * med, torch.cuda.max_memory_allocated() / 2**20)
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
    return runs, launches, summary


def compare_fused_tconv(name, summary):
    """The ``fused_tconv`` step beside the ``fused`` one of the same run:
    step time and peak memory. The option must win both."""
    (fused_ms, fused_mb), (tconv_ms, tconv_mb) = (
        summary["fused"], summary["fused_tconv"])
    emit("fused_tconv_vs_fused", dtype=name, fused_step_ms=fused_ms,
         fused_tconv_step_ms=tconv_ms, step_ratio=tconv_ms / fused_ms,
         fused_peak_mem_mb=fused_mb, fused_tconv_peak_mem_mb=tconv_mb,
         peak_mem_ratio=tconv_mb / fused_mb)
    check(tconv_ms < fused_ms and tconv_mb < fused_mb,
          f"the {name} fused_tconv step ({tconv_ms} ms, {tconv_mb} MB) "
          f"does not beat the fused one ({fused_ms} ms, {fused_mb} MB)")


def trace(run, steps):
    """One ``torch.profiler`` trace of ``steps`` calls of ``run``: the
    profiler, the device's busy and idle time per step, and its device
    time by kernel name (us, all steps)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ) as prof:
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
    spans = sorted(
        (e.time_range.start, e.time_range.end, e.name)
        for e in prof.events() if e.device_type == DeviceType.CUDA
    )
    if not spans:
        return prof, {"device_events": 0}, {}
    busy, end, by_name = 0.0, spans[0][0], {}
    for start, stop, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (stop - start)
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    span = end - spans[0][0]
    return prof, {
        "device_events": len(spans),
        "busy_ms_per_step": busy / 1e3 / steps,
        "span_ms_per_step": span / 1e3 / steps,
        "idle_share": 1.0 - busy / span,
    }, by_name


def largest(times_us, steps=1, top=15):
    """The ``top`` entries of ``times_us`` in ms per step, names cut to 120
    characters."""
    return {name[:120]: us / 1e3 / steps for name, us in
            sorted(times_us.items(), key=lambda kv: -kv[1])[:top]}


def device_profile(run, steps):
    """Device time by kernel name and the device's idle share over
    ``steps`` calls of ``run``, from a torch.profiler trace."""
    _, summary, by_name = trace(run, steps)
    return {**summary, "top_kernels_ms_per_step": largest(by_name, steps)}


def phase_train(device):
    """bf16 and then f32 training; returns the launches of all timed
    steps."""
    runs, launches, summary = time_training(device, "bf16", TRAIN_BATCH)
    compare_fused_tconv("bf16", summary)
    for config in PROFILE_CONFIGS:
        emit("profile", dtype="bf16", config=config, batch=TRAIN_BATCH,
             steps=PROFILE_STEPS,
             **device_profile(runs[config], PROFILE_STEPS))
    del runs
    torch.cuda.empty_cache()
    for batch in (TRAIN_BATCH, 64, 32):  # f32 at the largest that fits
        try:
            runs, f32_launches, summary = time_training(device, "f32", batch)
            compare_fused_tconv("f32", summary)
            break
        except torch.cuda.OutOfMemoryError:
            emit("train", dtype="f32", batch=batch, out_of_memory=True)
        torch.cuda.empty_cache()  # the failed run's tensors are freed now
    else:
        raise RuntimeError("f32 training fits at no batch of 128, 64 or 32")
    del runs
    torch.cuda.empty_cache()
    # f32 at the CLI's default --precision: TF32 on in cuBLAS and cuDNN (the
    # kernels stay f32 on the CUDA cores)
    main_gnn.set_precision("default")
    try:
        _, tf32_launches, _ = time_training(device, "f32_tf32", batch,
                                            TF32_CONFIGS)
    finally:
        tf32_off()
    return {n: launches[n] + f32_launches[n] + tf32_launches[n]
            for n in launches}


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
# the spectrogram paths' counts: the kernels and #7's loc/lambda instance
SPEC_COUNTS = SPEC_KERNELS + ("radar_bwd_loc_lam",)


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


def radar_build_report():
    """Registers, spills and dynamic shared memory at the trainer's shape
    of the spline radar kernels (csrc/radar_spline.cuh: #6's fwd_kernel,
    #7's bwd_kernel in its full and its loc/lambda instance, and their
    reduce_kernel)."""
    ns4, em = 16, 48  # NS = 4 segments a 512-row tile; 24 edges x 2 bodies
    return {
        "ptxas": {**ptxas_entries("radar_fwd.cu", "radar_spline"),
                  **ptxas_entries("radar_bwd.cu", "radar_spline")},
        "smem_bytes": {
            "fwd_kernel": radar._forward_smem(ns4, em),
            "bwd_kernel_full": radar._backward_smem(ns4, radar.TILE, em,
                                                    True),
            "bwd_kernel_loc_lam": radar._backward_smem(ns4, radar.TILE, em,
                                                       False),
        },
    }


def phase_radar_build():
    report = radar_build_report()
    emit("radar_build", **report)
    check(len(report["ptxas"]) == 5,
          f"radar build report names {sorted(report['ptxas'])}")
    check(not spilling(report["ptxas"]),
          f"a spline radar kernel spills: {spilling(report['ptxas'])}")


def phase_radar_kernel(device):
    """Kernels #6, #7 and #7's loc/lambda instance against their plain
    versions at the trainer's shape; returns the kernels line's entries
    (lambda = 5e-4) and that radar return for the STFT phase."""
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
        ll = radar.spline_radar_loc_lam_backward(*args, gre, gim, t_out)
        ll_again = radar.spline_radar_loc_lam_backward(*args, gre, gim, t_out)
        torch.cuda.synchronize()
        bit_identical = all(torch.equal(p, q) for p, q in
                            zip(got + ll, again + ll_again))
        loc_lam_equals_full = all(torch.equal(p, q)
                                  for p, q in zip(ll, got[3:]))
        want = radar.spline_radar_reference(*args, t_out)
        want_bwd = radar.spline_radar_backward_reference(*args, gre, gim,
                                                         t_out)
        fwd_err = dict(zip(("re", "im"),
                           (rel_err(p, q) for p, q in zip(out, want))))
        bwd_err = dict(zip(("dsrc", "ddst", "dc", "dloc", "dlambda"),
                           (rel_err(p, q) for p, q in zip(got, want_bwd))))
        ll_err = dict(zip(("dloc", "dlambda"),
                          (rel_err(p, q) for p, q in zip(ll, want_bwd[3:]))))
        no_nan = not any(torch.isnan(p).any().item() for p in got + ll)
        pairs = SPEC_BATCH * t_out * (src.shape[2] // 3)
        lam_t = args[5]
        fwd_bound = bound(RADAR_FWD_OPS * pairs,
                          nbytes(e, src, dst, c, loc, lam_t, *out), "f32")
        bwd_bound = bound(RADAR_BWD_OPS * pairs,
                          nbytes(e, src, dst, c, loc, lam_t, gre, gim, *got),
                          "f32")
        ll_bound = bound(RADAR_BWD_LOC_LAM_OPS * pairs,
                         nbytes(e, src, dst, c, loc, lam_t, gre, gim, *ll),
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
                "loc_lam_ms": cuda_ms(
                    lambda: radar.spline_radar_loc_lam_backward(
                        *args, gre, gim, t_out)),
                "loc_lam_plain_ms": cuda_ms(
                    lambda: radar.spline_radar_backward_reference(
                        *args, gre, gim, t_out, coef_grads=False), 5, 1),
                "loc_lam_max_abs_err": max_abs_err(ll, want_bwd[3:]),
                "loc_lam_bound_ms": ll_bound[0],
                "loc_lam_bound_by": ll_bound[1],
            },
        }
        emit(
            "radar_kernel", lam=lam_v, n=SPEC_BATCH, t_out=t_out,
            tiles=e.shape[0], rel_err=fwd_err, bwd_rel_err=bwd_err,
            loc_lam_rel_err=ll_err, rel_tol=RADAR_TOL[lam_v],
            bit_identical=bit_identical,
            loc_lam_equals_full=loc_lam_equals_full,
            loc_lam_vs_full_abs_diff=max_abs_err(ll, got[3:]),
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
        check(max(ll_err.values()) <= bwd_tol,
              f"radar_bwd's loc/lambda instance disagrees at lambda "
              f"{lam_v}: {ll_err}")
        if lam_v == LAMBDAS[0]:
            totals, signal = entries, out
        del got, again, ll, ll_again, want, want_bwd
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
    band, band_record = band_stats(w, t_out)
    # the operator's entries the forward contracts: each row over its
    # 64-row block's band. The backward needs those and no more (its
    # transposed products walk a 4,096-row split's wider band: this
    # design's own extra work, not the function's)
    band_entries = ((band[0][:, 1] - band[0][:, 0]).double()
                    .repeat_interleave(64)[:t_out].sum().item())
    # one product of the operator's rows with one feature set: dense, and
    # over the band
    product = 2 * SPEC_BATCH * t_out * SPEC_T * 3 * em
    band_product = 2 * SPEC_BATCH * band_entries * 3 * em
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
            # #8's wrapper finds the band, so it reads the whole operator;
            # #9 is timed as the main path runs it, on the forward's band,
            # and reads the operator over the band alone
            fwd_bytes = nbytes(op, src, dst, c, loc, lam, *out)
            bwd_bytes = nbytes(src, dst, c, loc, lam, gre, gim, *got)
            fwd_bound = bound(2 * band_product + DENSE_FWD_OPS * pairs,
                              fwd_bytes, "f32")
            bwd_bound = bound(4 * band_product + DENSE_BWD_OPS * pairs,
                              bwd_bytes + 4 * band_entries + nbytes(*band),
                              "f32")
            # the count before the band: every product over all of T_in
            record = {
                "radar_dense_fwd_dense_bound_ms": bound(
                    2 * product + DENSE_FWD_OPS * pairs, fwd_bytes, "f32")[0],
                "radar_dense_bwd_dense_bound_ms": bound(
                    4 * product + DENSE_BWD_OPS * pairs,
                    bwd_bytes + nbytes(op), "f32")[0],
            }
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
                    "ms": cuda_ms(lambda: radar._dense_backward(
                        w, band, *args[1:], gre, gim, t_out)),
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
            record.update({f"{k}_{m}": v[m] for k, v in entries.items()
                           for m in v})
        emit(
            "radar_dense_kernel", lam=lam_v, n=SPEC_BATCH, t_out=t_out,
            t_pad=t_pad, rel_err=fwd_err, bwd_rel_err=bwd_err,
            rel_tol=RADAR_TOL[lam_v], bit_identical=bit_identical,
            dlambda=got[4].item(), spline_route_rel_err=route_err,
            spline_route_rel_tol=ROUTE_TOL[lam_v], **band_record, **record,
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
    glue = glue_profile(lambda: train("dense"))
    emit("radar_dense_path", n=SPEC_BATCH, lam=LAMBDAS[0],
         forward_launches=forward, launches=launches, finite=finite, **times,
         glue_profile=glue)
    check(glue["dense_kernels_ms"] > 0,
          f"the profile found no kernel of #8/#9: {glue}")
    check(forward == {"radar_dense_fwd": 1, "radar_dense_bwd": 0}
          and launches == {"radar_dense_fwd": 1, "radar_dense_bwd": 1},
          f"radar_return_fused launched {forward} forward, {launches} in "
          f"all; predicted one of each")
    check(all(finite.values()), f"non-finite dense gradients: {finite}")
    return launches


# the kernels of #8 and #9 (csrc/radar_dense_{fwd,bwd}.cu) as the profiler
# names them, in the sources' anonymous namespace, demangled or not
DENSE_KERNEL_NAME = re.compile(
    r"(^(void )?\(anonymous namespace\)::|^_ZN\d+_GLOBAL__N_\w*?\d)"
    r"(radar_dense_fwd_kernel|rows_kernel|wt_kernel|reduce_kernel|"
    r"scalar_sums_kernel)")


def glue_profile(run, top=10):
    """One :func:`trace` of ``run`` (a forward and backward of
    ``radar_return_fused``): the device time of kernels #8/#9 and of the
    rest (the op's plain-torch glue), and the glue's largest kernels by
    name and operators by self device time."""
    from torch.autograd import DeviceType

    prof, summary, by_name = trace(run, 1)
    glue = {k: v for k, v in by_name.items() if not DENSE_KERNEL_NAME.match(k)}
    ops = {}  # host operators, less the Function around the kernels
    for avg in prof.key_averages():
        us = getattr(avg, "self_device_time_total", None)
        if us is None:
            us = avg.self_cuda_time_total
        if (avg.device_type == DeviceType.CPU and us > 0
                and "DenseRadar" not in avg.key):
            ops[avg.key] = us
    return {
        **summary,
        "dense_kernels_ms": (sum(by_name.values()) - sum(glue.values())) / 1e3,
        "glue_kernels_ms": sum(glue.values()) / 1e3,
        "top_glue_kernels_ms": largest(glue, top=top),
        "top_glue_ops_self_ms": largest(ops, top=top),
    }


def stft_library(re, im, hop, window):
    """``torch.stft`` (cuFFT) of ``re + i im`` as the kernels take it
    (centered, reflect-padded, two-sided), and the backward of that one
    call alone: ``(forward, backward)`` callables, the library yardsticks
    of #10 and #11."""
    n_fft = window.shape[0]
    z = torch.complex(re, im).requires_grad_()

    def forward():
        return torch.stft(z, n_fft, hop_length=hop, window=window,
                          center=True, pad_mode="reflect", onesided=False,
                          return_complex=True)

    spec = forward()
    gen = torch.Generator(device=re.device).manual_seed(SEED + 6)
    g = torch.complex(*(torch.randn(spec.shape, generator=gen,
                                    device=re.device) for _ in range(2)))
    return forward, lambda: torch.autograd.grad(spec, z, g,
                                                retain_graph=True)


def stft_ops(n, frames, n_fft, backward=False):
    """Operations of the FFT route over ``n * frames`` frames: 5 N log2 N
    a complex FFT; the forward's window, magnitude, square root and log, 8
    a bin; the backward's two FFTs, the recomputed forward's 8 and the
    cotangent chain, window and overlap-add's 12 a bin."""
    fft = 5 * n_fft * int(np.log2(n_fft))
    per_frame = 2 * fft + 20 * n_fft if backward else fft + 8 * n_fft
    return n * frames * per_frame


def phase_stft_kernel(device, radar_re, radar_im):
    """Kernels #10 and #11 at the trainer's shape, on seeded normal signals
    (as the JAX package's STFT tests), against their plain versions
    evaluated in float64 (inputs, g and ``stft_basis(256, float64)``
    promoted; the result compared in f32), with the distance to the f32
    plain versions beside; kernel #10 on the radar return, compared as
    magnitudes; both kernels bit for bit across two launches; #11's peak
    memory; ``torch.stft`` and its backward as the library yardsticks."""
    cos, sin = (torch.from_numpy(b).to(device) for b in stft.stft_basis(256))
    cos64, sin64 = (torch.from_numpy(b).to(device)
                    for b in stft.stft_basis(256, dtype=np.float64))
    hop, n, t = 16, radar_re.shape[0], radar_re.shape[1]
    frames = t // hop + 1
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    re, im = (torch.randn(n, t, generator=gen, device=device)
              for _ in range(2))
    g = torch.randn(n, 256, frames, generator=gen, device=device)
    out = stft_logmag.stft_logmag(re, im, hop, cos, sin)
    out_again = stft_logmag.stft_logmag(re, im, hop, cos, sin)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = stft_logmag.stft_logmag_backward(re, im, hop, cos, sin, g)
    torch.cuda.synchronize()
    bwd_peak = torch.cuda.max_memory_allocated() - base
    again = stft_logmag.stft_logmag_backward(re, im, hop, cos, sin, g)
    torch.cuda.synchronize()
    bit_identical = {
        "stft_fwd": torch.equal(out, out_again),
        "stft_bwd": all(torch.equal(p, q) for p, q in zip(got, again))}
    want = stft_logmag.stft_logmag_reference(
        re.double(), im.double(), hop, cos64, sin64).float()
    want_bwd = [d.float() for d in stft_logmag.stft_logmag_backward_reference(
        re.double(), im.double(), hop, cos64, sin64, g.double())]
    abs_err = max_abs_err([out], [want])
    bwd_err = dict(zip(("dre", "dim"),
                       (rel_err(p, q) for p, q in zip(got, want_bwd))))
    f32_want = stft_logmag.stft_logmag_reference(re, im, hop, cos, sin)
    f32_want_bwd = stft_logmag.stft_logmag_backward_reference(
        re, im, hop, cos, sin, g)
    vs_f32_plain = {
        "stft_fwd_max_abs_err_vs_f32_plain": max_abs_err([out], [f32_want]),
        "stft_bwd_rel_err_vs_f32_plain": dict(zip(
            ("dre", "dim"),
            (rel_err(p, q) for p, q in zip(got, f32_want_bwd)))),
        "f32_plain_max_abs_err_vs_f64": max_abs_err([f32_want], [want]),
    }
    del f32_want, f32_want_bwd
    # the radar return's spectrum spans many decades: log|S| of its
    # smallest bins is ill-conditioned in f32 for any two summation orders,
    # |S| + eps = exp(out) is not
    radar_out = stft_logmag.stft_logmag(radar_re, radar_im, hop, cos, sin)
    radar_mag_err = rel_err(radar_out.exp(), stft_logmag.stft_logmag_reference(
        radar_re.double(), radar_im.double(), hop, cos64, sin64).float().exp())
    lib_fwd, lib_bwd = stft_library(re, im, hop, cos[0])
    # torch.stft's bins are in FFT order: rolled by 128 they are the
    # kernel's rows
    lib_mag = torch.roll(lib_fwd().detach().abs(), 128, 1) + 1e-6
    lib_mag_err = rel_err(out.exp(), lib_mag)
    del radar_out, lib_mag
    # the FFT route: inputs read once, outputs written once, with the
    # window and the twiddle table; the PR 3 design's DFT products (4 real
    # products a (frame, bin, tap) for each of re and im; the backward
    # recomputes the spectrum and takes the products' transposes) beside
    table = nbytes(cos[0]) * 3
    fwd_bound = bound(stft_ops(n, frames, 256),
                      nbytes(re, im, out) + table, "f32")
    bwd_bound = bound(stft_ops(n, frames, 256, backward=True),
                      nbytes(re, im, g, *got) + table, "f32")
    products = n * frames * 256 * 256
    dft_bounds = (bound(8 * products, nbytes(re, im, cos, sin, out), "f32"),
                  bound(16 * products, nbytes(re, im, cos, sin, g, *got),
                        "f32"))
    entries = {
        "stft_fwd": {
            "ms": cuda_ms(lambda: stft_logmag.stft_logmag(
                re, im, hop, cos, sin)),
            "plain_ms": cuda_ms(lambda: stft_logmag.stft_logmag_reference(
                re, im, hop, cos, sin)),
            "max_abs_err": abs_err,
            "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1],
            "dft_bound_ms": dft_bounds[0][0],
            "library_ms": cuda_ms(lib_fwd),
        },
        "stft_bwd": {
            "ms": cuda_ms(lambda: stft_logmag.stft_logmag_backward(
                re, im, hop, cos, sin, g)),
            "plain_ms": cuda_ms(
                lambda: stft_logmag.stft_logmag_backward_reference(
                    re, im, hop, cos, sin, g)),
            "max_abs_err": max_abs_err(got, want_bwd),
            "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1],
            "dft_bound_ms": dft_bounds[1][0],
            "library_ms": cuda_ms(lib_bwd),
        },
    }
    # the PR 3 design's workspaces: gbuf (N, frames, 2F), dfr (N, frames,
    # 2 n_fft)
    dft_workspace = 4 * n * frames * (2 * 256 + 2 * 256)
    emit(
        "stft_kernel", n=n, t=t, frames=frames, reference="float64",
        max_abs_err=abs_err, atol=STFT_ATOL, bwd_rel_err=bwd_err,
        bwd_rel_tol=STFT_GRAD_TOL, bit_identical=bit_identical,
        radar_magnitude_rel_err=radar_mag_err,
        radar_magnitude_rel_tol=STFT_MAG_TOL,
        library_magnitude_rel_err=lib_mag_err,
        stft_bwd_peak_mb=bwd_peak / 2**20,
        stft_bwd_dft_workspace_mb=dft_workspace / 2**20,
        **vs_f32_plain, **{
            f"{k}_{m}": v[m] for k, v in entries.items() for m in v},
    )
    check(all(bit_identical.values()), f"repeats differ: {bit_identical}")
    check(abs_err <= STFT_ATOL, f"stft_fwd disagrees by {abs_err}")
    check(max(bwd_err.values()) <= STFT_GRAD_TOL,
          f"stft_bwd disagrees: {bwd_err}")
    check(radar_mag_err <= STFT_MAG_TOL,
          f"stft_fwd magnitudes of the radar return differ by "
          f"{radar_mag_err}")
    check(lib_mag_err <= STFT_MAG_TOL,
          f"stft_fwd magnitudes differ from torch.stft's by {lib_mag_err}")
    # no workspace: the outputs, the edge buffer and the allocator's
    # rounding
    check(bwd_peak <= 2 * nbytes(*got),
          f"stft_bwd allocated {bwd_peak} bytes for {nbytes(*got)} of "
          "output")
    del got, again, want, want_bwd, lib_fwd, lib_bwd
    torch.cuda.empty_cache()
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
        launches = read_launches(SPEC_COUNTS)
        # unfrozen, only lambda and loc need a gradient: #7's loc/lambda
        # instance, never the full one
        backward = TRAIN_STEPS if unfrozen else 0
        predicted = {"radar_fwd": TRAIN_STEPS, "radar_bwd": 0,
                     "radar_bwd_loc_lam": backward,
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
        # each backward, #7's loc/lambda instance; epoch 0: none
        fwd = steps + evals
        first_predicted = {"radar_fwd": 2 * fwd, "radar_bwd": 0,
                           "radar_bwd_loc_lam": steps, "stft_fwd": 2 * fwd,
                           "stft_bwd": steps}
        predicted = {"radar_fwd": 3 * fwd, "radar_bwd": 0,
                     "radar_bwd_loc_lam": 2 * steps, "stft_fwd": 3 * fwd,
                     "stft_bwd": 2 * steps}
        # the main path: the counts cover exactly the two runs
        reset_launches()
        history = main_spectrogram.main(argv)
        first = read_launches(SPEC_COUNTS)
        history += main_spectrogram.main(
            argv[:9] + ["3"] + argv[10:] + ["--resume"])
        launches = read_launches(SPEC_COUNTS)
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


def write_skeleton_file(path, frames):
    """An NTU ``.skeleton`` file of ``frames``, a list of ``(bodies, 25,
    3)`` arrays (``bodies`` may be 0)."""
    lines = [str(len(frames))]
    for bodies in frames:
        lines.append(str(len(bodies)))
        for b, joints in enumerate(bodies):
            lines += [f"{1000 + b} 0 1 1 1 1 0 0.0 0.0 2", "25"]
            lines += [f"{x:.5f} {y:.5f} {z:.5f} 0 0 0 0 0 0 0 0 2"
                      for x, y, z in joints]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def write_multi_body_files(raw, rng):
    """Four clips of 2-4 people (corpus_lib's skeletons, a metre apart),
    two in each xview part: bodies that come and go, an empty first frame
    and empty interior frames. Returns ``{name: people}``."""
    specs = [  # camera, action, people, frames, empty frames
        (1, 1, 3, 70, ()), (1, 2, 2, 64, (0, 20, 21)),
        (2, 3, 4, 80, ()), (3, 4, 2, 75, (0, 1, 40)),
    ]
    written = {}
    for camera, action, people, t, empty in specs:
        clips = [corpus_lib.make_clip(action - 1, rng, t) + [k, 0.0, 0.0]
                 for k in range(people)]
        frames = []
        for f in range(t):
            # the last person steps out for the second half of the clip
            n = 0 if f in empty else people - (f >= t // 2 and people > 2)
            frames.append(np.stack([c[f] for c in clips[:n]])
                          if n else np.zeros((0, 25, 3)))
        name = f"S017C{camera:03d}P001R001A{action:03d}.skeleton"
        write_skeleton_file(os.path.join(raw, name), frames)
        written[name] = people
    return written


def check_data_gen(out, written):
    """The xview artifacts: shapes, finite values, the labels and the
    camera split, the TFRecords of both streams; returns ``{part: n}``."""
    counts = {}
    for part, cameras in (("train", (2, 3)), ("val", (1,))):
        with open(os.path.join(out, f"{part}_label.pkl"), "rb") as f:
            names, labels = pickle.load(f)
        n = len(names)
        counts[part] = n
        check(n == EVAL_CLASSES + 2, f"{n} {part} clips")
        for name, label in zip(names, labels):
            _, camera, _, _, action = skeleton.sample_metadata(name)
            check(camera in cameras and label == action - 1,
                  f"{part} holds {name} as label {label}")
        for stream in ("joint", "bone", "joint_motion", "bone_motion"):
            arr = np.load(os.path.join(out, f"{part}_data_{stream}.npy"))
            check(arr.shape == (n, 3, 300, 25, 2) and arr.dtype == np.float32
                  and np.isfinite(arr).all(),
                  f"{part} {stream}: {arr.shape} {arr.dtype}")
        joint = np.load(os.path.join(out, f"{part}_data_joint.npy"))
        for i, name in enumerate(names):
            second = np.abs(joint[i, ..., 1]).sum() > 0
            check(second == (name in written),
                  f"{name}: second body present {second}")
        for stream in ("joint", "bone"):
            d = os.path.join(out, f"{part}_data_{stream}")
            shards = sorted(os.listdir(d))
            records = sum(tfrecord.count_records(os.path.join(d, p))
                          for p in shards)
            check(len(shards) == 2 and records == n,
                  f"{part} {stream}: {records} records in {shards}")
    return counts


def reference_report(probs, labels):
    """top-1 and top-5 of ``probs`` as the CLIs count them, and the clips
    whose 1st/2nd or 5th/6th probabilities are equal (where the logits,
    which the CLIs rank, may still order them)."""
    ranked = -np.sort(-probs, axis=-1)
    ties = int(((ranked[:, 0] == ranked[:, 1])
                | (ranked[:, 4] == ranked[:, 5])).sum())
    top5 = np.argsort(probs, axis=-1)[:, -5:]
    n = max(len(labels), 1)
    return {
        "top1": round(int((probs.argmax(-1) == labels).sum()) / n, 4),
        "top5": round(int((top5 == labels[:, None]).any(-1).sum()) / n, 4),
    }, ties


def check_report(label, report, want, ties, n):
    """``report``'s top-1/top-5 equal ``want``'s, each by at most the tied
    clips' share."""
    for key in ("top1", "top5"):
        check(abs(report[key] - want[key]) <= ties / n + 1e-4
              and (ties or report[key] == want[key]),
              f"{label} {key} {report[key]}, recomputed {want[key]} "
              f"({ties} tied clips)")


def restored(model, directory, device):
    model.to(device)
    check(restore_latest_for_eval(model, directory) == 0,
          f"{directory}: not step 0")
    return model.eval()


def probabilities(model, batches, device):
    """The softmax of ``model`` over ``batches`` (numpy ``(x, y)``), as
    ``make_eval_step`` gives it, and the forward's clips/s (each batch
    ending synchronized)."""
    step = make_eval_step(model)
    out, seconds = [], 0.0
    for xb, _ in batches:
        x = torch.from_numpy(xb).to(device)
        torch.cuda.synchronize()
        start = time.perf_counter()
        p = step(x)
        torch.cuda.synchronize()
        seconds += time.perf_counter() - start
        out.append(p.cpu().numpy())
    probs = np.concatenate(out)
    return probs, len(probs) / seconds


def spec_stage_errors(kernels, plain, x):
    """max |diff| / max |plain| of the spectrogram model's stages through
    the kernels (``kernels``) and the plain routes (``plain``) on clips
    ``x``: the radar return (#6 against the dense route), |S| + eps (#10
    against the plain STFT, both on #6's return) and the logits."""
    vr = kernels.virtual_radar
    re, im = radar.radar_return_spline(
        x, SPEC_UP, vr.radar_loc, vr.radar_lambda, vr.edges,
        sigma=vr.pad_sigma)
    w = spectrogram._pad_operator(x.shape[2], SPEC_UP, vr.pad_sigma,
                                  x.device)
    re_p, im_p = virtual_radar.radar_return_upsampled(
        x, w, vr.radar_loc, vr.radar_lambda, vr.edges)
    mag = stft_logmag.stft_logmag(re, im, vr.hop_length, vr.stft_cos,
                                  vr.stft_sin).exp()
    mag_p = stft_logmag.stft_logmag_reference(
        re, im, vr.hop_length, vr.stft_cos, vr.stft_sin).exp()
    return {"return": max(rel_err(re, re_p), rel_err(im, im_p)),
            "mag": rel_err(mag, mag_p),
            "logits_data_gen": rel_err(kernels(x), plain(x))}


def timed(fn):
    start = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - start


def phase_eval_path(device):
    """Raw ``.skeleton`` files -> ``data_gen`` -> ``evaluate`` /
    ``ensemble`` / ``Predictor.from_checkpoint`` on seeded checkpoints."""
    rng = np.random.default_rng(SEED + 7)
    with tempfile.TemporaryDirectory() as tmp:
        raw = os.path.join(tmp, "raw")
        corpus_lib.synthesize_corpus(raw, EVAL_CLIPS_PER_CLASS, seed=SEED,
                                     num_classes=EVAL_CLASSES)
        written = write_multi_body_files(raw, rng)
        _, gen_s = timed(lambda: data_gen.main([
            "--data-path", raw, "--out-folder", os.path.join(tmp, "ntu"),
            "--ignored-sample-path", os.path.join(tmp, "none.txt"),
            "--benchmarks", "xview", "--streams", "joint", "bone",
            "--num-shards", "2",
        ]))
        out = os.path.join(tmp, "ntu", "xview")
        counts = check_data_gen(out, written)
        records = sum(counts.values())

        ckpt = {name: os.path.join(tmp, "ckpt", name) for name, _ in ENSEMBLE}
        for i, name in enumerate(("joint", "bone")):
            CheckpointManager(ckpt[name]).save(
                0, seeded_model("f32", False, seed=SEED + i))
        CheckpointManager(ckpt["spectrogram"]).save(0, spectrogram.Model(
            num_classes=60, num_pad_frames=SPEC_UP,
            generator=torch.Generator().manual_seed(SEED)))
        val = {
            "tfrecord": os.path.join(out, "val_data_joint"),
            "npy": os.path.join(out, "val_data_joint.npy"),
            "pkl": os.path.join(out, "val_label.pkl"),
        }
        n = counts["val"]
        batches = -(-n // EVAL_BATCH)
        flags = ["--batch-size", str(EVAL_BATCH)]

        gnn_argv = flags + ["--model", "stgcn", "--checkpoint", ckpt["joint"],
                            "--test-data-path", val["tfrecord"]]
        spec_argv = flags + [
            "--model", "spectrogram", "--checkpoint", ckpt["spectrogram"],
            "--data-path", val["npy"], "--label-path", val["pkl"]]
        # warm-up: the kernels' build, cuDNN's plans, the spline plan
        for argv in (gnn_argv, spec_argv):
            evaluate.main(argv, device=device)

        # the main paths: the counts cover exactly each run
        reset_launches()
        gnn_report, gnn_s = timed(lambda: evaluate.main(gnn_argv,
                                                        device=device))
        gnn_launches = read_launches(tuple(COUNTERS))
        reset_launches()
        spec_report, spec_s = timed(lambda: evaluate.main(spec_argv,
                                                          device=device))
        spec_launches = read_launches(tuple(COUNTERS))
        weights = [str(w) for _, w in ENSEMBLE]
        reset_launches()
        ens_report, ens_s = timed(lambda: ensemble.main(flags + [
            "--streams", *(s for s, _ in ENSEMBLE),
            "--checkpoints", *(ckpt[s] for s, _ in ENSEMBLE),
            "--weights", *weights, "--test-data-path", val["tfrecord"]],
            device=device))
        ens_launches = read_launches(tuple(COUNTERS))

        # the reports, recomputed from each model's probabilities
        tf_data = TFRecordDataset(val["tfrecord"], EVAL_BATCH)
        labels = tf_data._load_all()[1]
        probs, forward_rate = {}, {}
        for name, _ in ENSEMBLE:
            if name == "spectrogram":
                model = spectrogram.Model(
                    num_classes=60, num_pad_frames=SPEC_UP, use_pallas=True,
                    use_pallas_stft=True)
                data = NumpyDataset(val["npy"], val["pkl"], EVAL_BATCH)
            else:
                model = Model(num_classes=60)
                data = TFRecordDataset(val["tfrecord"], EVAL_BATCH,
                                       transform=stream_transform(name))
            probs[name], forward_rate[name] = probabilities(
                restored(model, ckpt[name], device), data.batches(), device)
        ties = {}
        for label, report, name in (("evaluate stgcn", gnn_report, "joint"),
                                    ("evaluate spectrogram", spec_report,
                                     "spectrogram")):
            want, ties[label] = reference_report(probs[name], labels)
            check(report["samples"] == n and report["checkpoint_step"] == 0,
                  f"{label} report {report}")
            check_report(label, report, want, ties[label], n)
        combined = sum(w * probs[s] for s, w in ENSEMBLE)
        want, ties["ensemble"] = reference_report(combined, labels)
        check_report("ensemble", {"top1": ens_report["ensemble_top1"],
                                  "top5": ens_report["ensemble_top5"]},
                     want, ties["ensemble"], n)
        for name, _ in ENSEMBLE:
            top1 = round(float((probs[name].argmax(-1) == labels).mean()), 4)
            check(ens_report[f"{name}_top1"] == top1,
                  f"ensemble {name}_top1 {ens_report[f'{name}_top1']}, "
                  f"recomputed {top1}")

        # the spectrogram model through the kernels and the plain routes
        kernels = restored(spectrogram.Model(
            num_classes=60, num_pad_frames=SPEC_UP, use_pallas=True,
            use_pallas_stft=True), ckpt["spectrogram"], device)
        plain = restored(spectrogram.Model(
            num_classes=60, num_pad_frames=SPEC_UP), ckpt["spectrogram"],
            device)
        spec_err = dict.fromkeys(("return", "mag", "logits_data_gen"), 0.0)
        with torch.no_grad():
            for xb, _ in NumpyDataset(val["npy"], val["pkl"],
                                      EVAL_BATCH).batches():
                x = torch.from_numpy(xb).to(device)
                errs = spec_stage_errors(kernels, plain, x)
                spec_err = {k: max(v, errs[k]) for k, v in spec_err.items()}
            x = torch.from_numpy(spec_clips(EVAL_BATCH, SEED + 8)[0]).to(
                device)
            spec_err["logits"] = rel_err(kernels(x), plain(x))
        del kernels, plain

        # the fused predictor from the joint checkpoint, against the unfused
        clips = np.load(val["npy"])
        requests = {len(clips): clips, 7: clips[:7]}
        fused = Predictor.from_checkpoint(
            Model(num_classes=60, fused_sgcn=True, fused_sgcn_min_channels=0),
            ckpt["joint"], 64, device)
        unfused = Predictor.from_checkpoint(Model(num_classes=60),
                                            ckpt["joint"], 64, device)
        reset_launches()
        served = {k: fused(x) for k, x in requests.items()}
        pred_launches = read_launches(tuple(COUNTERS))
        pred_err = max(float(np.abs(served[k] - unfused(x)).max())
                       for k, x in requests.items())
        # the probabilities of random full-width weights are near 0 or 1:
        # the logits too, f32 sums in other orders through ten blocks
        with torch.no_grad():
            x = torch.from_numpy(clips).to(device)
            pred_logit_err = rel_err(fused.model(x), unfused.model(x))
        served_top1 = round(float(
            (served[len(clips)].argmax(-1) == labels).mean()), 4)

    none = dict.fromkeys(COUNTERS, 0)
    predicted = {
        "evaluate_stgcn": none,
        "evaluate_spectrogram": {**none, "radar_fwd": batches,
                                 "stft_fwd": batches},
        "ensemble": {**none, "radar_fwd": batches, "stft_fwd": batches},
        "predictor": {**none, "sgcn_fwd": 10 * len(requests)},
    }
    launches = {"evaluate_stgcn": gnn_launches,
                "evaluate_spectrogram": spec_launches,
                "ensemble": ens_launches, "predictor": pred_launches}
    emit(
        "eval_path", clips=counts, multi_body_files=written,
        data_gen_s=gen_s, data_gen_records_per_s=records / gen_s,
        host_cpu=host_cpu(), batch=EVAL_BATCH, batches=batches,
        reports={"evaluate_stgcn": gnn_report,
                 "evaluate_spectrogram": spec_report, "ensemble": ens_report},
        tied_clips=ties, predictor_top1=served_top1,
        eval_clips_per_s={"stgcn": n / gnn_s, "spectrogram": n / spec_s,
                          "ensemble": n / ens_s},
        forward_clips_per_s=forward_rate,
        spec_rel_err=spec_err, spec_tol={
            "return": ROUTE_TOL[5e-4], "mag": STFT_MAG_TOL,
            "logits": SPEC_LOGIT_TOL},
        predictor_prob_max_abs_err=pred_err, prob_atol=PROB_ATOL["f32"],
        predictor_logit_rel_err=pred_logit_err,
        predictor_logit_tol=PREDICTOR_LOGIT_TOL,
        launches={k: {c: v for c, v in counts_.items() if v}
                  for k, counts_ in launches.items()},
        launches_predicted={k: {c: v for c, v in counts_.items() if v}
                            for k, counts_ in predicted.items()},
    )
    check(launches == predicted,
          f"eval path launched {launches}, predicted {predicted}")
    check(spec_err["return"] <= ROUTE_TOL[5e-4]
          and spec_err["mag"] <= STFT_MAG_TOL
          and spec_err["logits"] <= SPEC_LOGIT_TOL,
          f"spectrogram, kernels vs plain routes: {spec_err}")
    check(pred_err <= PROB_ATOL["f32"]
          and pred_logit_err <= PREDICTOR_LOGIT_TOL,
          f"fused and unfused predictors differ by {pred_err} "
          f"(logits {pred_logit_err})")
    check(all(np.isfinite(p).all() for p in probs.values()),
          "non-finite probabilities")


def main():
    phase_env()
    device = torch.device("cuda", 0)
    phase_build()
    phase_sgcn_build()
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
    phase_radar_build()
    spec_totals, (re, im) = phase_radar_kernel(device)
    dense_totals = phase_radar_dense_kernel(device)
    spec_totals.update(phase_stft_kernel(device, re, im))
    del re, im
    phase_spec_train(device)
    spec_launches = phase_spec_cli(device)
    phase_eval_path(device)
    # #7's entry counts both instances; the loc/lambda one's count beside
    loc_lam = spec_launches.pop("radar_bwd_loc_lam")
    spec_totals["radar_bwd"]["loc_lam_launches"] = loc_lam
    spec_launches["radar_bwd"] += loc_lam
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
