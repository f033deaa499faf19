#!/usr/bin/env python3
"""On-GPU smoke check of the PyTorch port (``skeleton_action_recognition_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It imports no jax. Each phase prints one JSON line; a failed check raises,
so the exit code is not 0.

1. ``env``: the card, its power limit, torch and CUDA versions. Without a
   CUDA device the script stops here (it never falls back to the CPU).
2. ``build``: compiles the thirteen ``csrc/*.cu`` sources (sgcn, radar,
   radar_dense, stft, tconv and ctrgc, forward and backward, and the fused
   blocks' tail, ``block_tail.cu``) for ``sm_90a`` from
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
   ``block_tail_kernel``: the fused blocks' tail kernels (``block_tail_fwd``,
   ``block_tail_bwd``, ``tconv_gue``) against their plain versions at the
   three stride-1 shapes, NM=256, ``u`` in f32 and bf16, the residual
   absent, f32 and bf16: out, g_u, g_res and gue bit for bit, the channel
   sums within ``TAIL_SUM_TOL``, two launches of each bit for bit,
   CUDA-event times of kernel and plain version beside the bound and the
   bytes an element; first (``block_tail_build``) their ptxas reports.
   ``ctrgc_kernel``: CTR-GCN's channel-wise aggregation kernels (#12
   ``ctrgc_fwd``, #13 ``ctrgc_bwd``) against their plain version (the
   published einsums) at the ten blocks' shapes of the 64-frame training
   cell, NM=256, f32 and bf16: z, dx3 and ds within ``CTRGC_TOL``, two
   launches bit for bit, CUDA-event times of kernel and plain version
   beside the bound; first (``ctrgc_build``) their ptxas reports, last
   (``ctrgc_step``) one training step's launches, 10 of each. Alone:
   ``python3 -c "import torch, chip_smoke as cs; cs.phase_env();
   cs.phase_ctrgc_kernel(torch.device('cuda', 0))"``.
5. ``slice``: the full-width NTU-60 ST-GCN (T=300) from seeded random
   weights and BatchNorm statistics, behind ``Predictor(max_batch=64)``.
   Requests of 1, 7 and 64 clips: every row finite and summing to 1, ten
   kernel launches per request, agreement with the same weights unfused;
   models with the training options ``sgcn_stats`` and ``fused_tconv``
   answer the 64-clip request as the fused-only model, through the same
   ten launches.
6. ``latency``: the 64-clip request, fused and unfused, in f32 and bf16,
   and through the four folded predictors (``models/export.py``: f32 with
   TF32 off, bf16, W8, W8A8), timed in turns on the host clock (the
   predictor returns numpy, so each request ends synchronized); peak
   memory as one predictor's own (its resident tensors plus the request's
   peak above what was allocated before it).
   ``export``: those four folded predictors, folded from the slice's
   weights (each build's host time, the weights' device bytes), on the 1-,
   7- and 64-clip requests: the logits against the stock f32 predictor's
   and, at 1 and 7 clips, against the same route and weights on the CPU,
   max |diff| / max |reference| within ``FOLDED_TOL`` /
   ``FOLDED_CPU_TOL`` and the argmax the same wherever the reference's
   two largest lie further apart than twice that; 10 ``torch._int_mm``
   calls a W8A8 request and none elsewhere; no launch of any kernel of the
   port. Then the f32 route with TF32 on and off in turns (medians), the
   bf16 product through ``torch.mm(out_dtype=float32)`` and as a bf16
   product read back in f32 at the ten blocks' shapes (error against the
   f32 product of the same operands, CUDA-event times), and
   ``export.int8_product`` at padded shapes against the exact product
   (and whether ``torch._int_mm`` takes a row-major B); a profile of 3
   64-clip requests of each route (device time by kernel, idle share).
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
   ``ddp``: data parallelism on this one card. (b) ``ddp_ranks``: two
   gloo ranks (CUDA tensors, ``file://`` rendezvous), each a child process
   on 64 rows of a seeded global batch of 128 (T=300), one train step of
   the full-width ST-GCN with ``fused_tconv`` (#1, #3, #4, #5) and with
   ``sgcn_stats`` (#2, #3), every block fused, remat off, f32 with TF32
   off, and one unfrozen step of the full-width spectrogram model (#6,
   #7's loc/lambda instance, #10, #11), held against this process on all
   128 rows: the ranks' parameters and running statistics bit for bit
   alike, each step's launches, the loss and parameters at ``DDP_*``'s
   tolerances, then the median time of 3 further steps in each process. (a) ``ddp_world_1``: ``cli.main_gnn`` in a child process
   under torchrun's environment at world size 1 (NCCL, ``env://`` on
   127.0.0.1), ``--fused-sgcn`` with both fused training options
   (``StatsTconvModel``), one epoch on the ``cli`` phase's TFRecords,
   against two runs without a process group (the second beside (b)'s
   ranks): its losses equal bit for bit where the two plain runs are, its
   launches equal; then 5 train steps of that model at 64 clips in the
   group's process and the first plain one's (step time with the group and
   without). (c) ``ddp_host``: this host's TFRecord records/s on 256
   full-size clips (in RAM, streamed, native and Python decode) and
   ``data_gen`` on 60 ``corpus_lib`` clips with the native and the Python
   parser (their joint arrays within 1e-6). (d) ``ddp_serving``:
   ``Predictor(devices=[card, card])`` against one replica on the 64-clip
   request (probabilities within ``PROB_ATOL``, the same argmax, median
   latency of 5 each in turns).

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
    unfused predictor's. ``cli.evaluate.main --predictor folded`` and
    ``int8`` on the joint checkpoint (no kernel launch), each report equal
    to the one recomputed from the same route's logits, at most a quarter
    of the clips tied (``zoo_cli``'s tolerance). Clips/s of each
    evaluation, end to end (a folded run's fold included) and of the
    forward alone.
14. ``zoo``: ST-GIN, ST-PGCN, ST-PGCN-P and the debug ST-GCN
    (``experimental``), full-width NTU-60 (T=300), seeded weights with
    BatchNorm statistics redrawn: a 64-clip ``Predictor`` request (rows
    finite and summing to 1, median latency of 5) and 2 clips on the card
    against the same weights on the CPU (eval and train-mode logits, TF32
    off; ``zoo_serve``); 10 train steps after 3 warm-up, f32 with TF32 off
    and bf16 for the two that take a dtype, remat off, B=128 if it fits,
    else 64 or 32: step time, clips/s, peak memory, the loss finite and
    falling, and a profile of 3 f32 steps (``zoo_train``); an
    ``adjacency_matrix`` unchanged bit for bit by a step while frozen and
    changed by one while training, ST-GIN's and the debug model's ten
    (``zoo_adjacency``); ``cli.main_gnn.main --model stgin|stpgcnp`` for
    one epoch on 48 + 16 synthetic clips and ``cli.evaluate.main`` on its
    checkpoint, the report equal to the one recomputed from the logits of
    ``Predictor.from_checkpoint``'s model, with at most a quarter of the
    clips near a rank-1/2 or rank-5/6 tie (``zoo_cli``); the LSTM frame
    sampler ``TemporalSampler((128,), top_k=200)`` on (16, 300, 25, 3),
    the card against the CPU (``zoo_sampler``). No kernel of the port may
    launch in the phase (``zoo``): none of these models reaches one, as
    none of their JAX counterparts reaches ``pl.pallas_call``.
15. ``remat``: the full-width ST-GCN at B=128, T=300 (seeded weights) in
    bf16 with the CLI's default fusion (``fused_min128``: #1, #3), in bf16
    with both fused training options on it (#2-#5) and in f32 with TF32 off
    (``fused_min128``), each with remat off, ``remat_policy="full"`` and
    ``"dots"``: the first step's loss, gradient norm and running statistics
    against remat off (``REMAT_TOL``), the matrix products the backward
    recomputes (counted by a dispatch mode: none under "dots", every one of
    the blocks' forward under "full"), #1-#5's launches a step (a block's
    forward kernels twice under remat, asserted), the median of 10 steps
    after 3 warm-up in turns and each policy's peak memory (off > "dots"
    >= "full", asserted).
16. ``seqpar``: ``ops.virtual_radar.radar_return_sharded`` (N=16, T_in=300
    x 250 = 75,000 samples, 24 edges x 2 bodies, both lambdas) and
    ``radar_spectrogram_sharded`` (x 256 = 76,800: at 75,000 no count of
    ranks above 1 gives hop-aligned blocks) in one process without a group
    and on 2 and 4 gloo ranks on this card (child processes, ``file://``
    rendezvous), forward and backward to x, loc and lambda, against one
    process through ``radar_return_fused`` (and ``stft_logmag``): the
    return at ``RADAR_TOL``, its gradients in norm at the same, the
    spectrogram at the JAX test's above-median criterion and its gradients
    through those bins at 5e-2 in norm, the ranks alike bit for bit, #8 and
    #9 once a rank a pass and #10 and #11 once a rank a spectrogram pass
    (the last rank's launch holds the final frame), each rank's time
    (gloo through host memory on one card, not NCCL).
17. ``demo``: ``examples/virtual_radar_demo_torch.py``'s ``main`` on
    synthetic inputs of the reference's shapes drawn on the card (CMU (200,
    42, 3) mm, gait (200, 17, 3), NTU (1, 3, 300, 25, 2): 4,000, 2,000 and
    165,000 samples, 41, 16 and 24 edge-body pairs): #8 and #10 once a
    spectrogram, no backward; each spectrogram's return against #8's plain
    version, #10 against the float64 STFT of that return, the route against
    the plain route and float64 as magnitudes (``DEMO_*``); the cubic
    operators' band widths; the scipy cross-check; a synthetic Azure Kinect
    JSON through ``data.demo.load_azure_kinect``.

Then ``seconds`` (each phase's wall time) and the kernels line
(``sgcn_fwd`` ``ms``/``plain_ms``: f32 time of the
ten spatial convs of one 64-clip request; ``sgcn_bwd`` and
``sgcn_fwd_stats``: f32 time of the ten blocks' calls at NM=256; these
three carry cuBLAS's 1x1 conv (#1, #2) or its two products on a
materialized dz (#3) alone as ``library_ms``, and the bf16 kernel's numbers
beside as ``bf16_ms``, ``bf16_plain_ms``, ``bf16_library_ms``,
``bf16_bound_ms``, ``bf16_bound_by`` and ``bf16_max_abs_err``;
``tconv_*``: f32 time of the eight stride-1 blocks' calls at NM=256, with
cuDNN's conv alone as ``library_ms``, and the bf16 numbers beside as
``bf16_*`` (with ``bf16_library_ms``); ``block_tail_fwd``,
``block_tail_bwd``, ``tconv_gue``: f32 time of the eight stride-1 blocks'
calls at NM=256 with each block's residual (``TAIL_BLOCKS``), and the bf16
numbers beside as ``bf16_*``; ``radar_*``/``stft_*``: one call at
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
phase's timed steps for the others, each main path counted from 0; since
the ``remat``, ``seqpar`` and ``demo`` phases ``launches`` is the sum over
the paths of ``launches_by_path``, which adds the first steps of ``remat``
for #1-#5, the compared passes of ``seqpar`` in every process for #8-#11
and ``demo``'s ``main`` for #8 and #10), the card's name and power limit as
``nvidia-smi`` prints them, and the result line.
"""

from __future__ import annotations

import copy
import ctypes
import functools
import inspect
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
import socket
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from scripts import corpus_lib
from skeleton_action_recognition_tpu_torch import tracing
from skeleton_action_recognition_tpu_torch.cli import (
    data_gen,
    ensemble,
    evaluate,
    main_gnn,
    main_spectrogram,
)
from skeleton_action_recognition_tpu_torch.data import skeleton, tfrecord
from skeleton_action_recognition_tpu_torch.data import demo as data_demo
from skeleton_action_recognition_tpu_torch.data.pipeline import (
    NumpyDataset,
    TFRecordDataset,
    stream_transform,
)
from skeleton_action_recognition_tpu_torch.graphs.ntu_rgb_d import (
    spatial_adjacency,
)
from skeleton_action_recognition_tpu_torch.models import (
    export,
    layers,
    lstm_sampler,
    model_class,
    spectrogram,
)
from skeleton_action_recognition_tpu_torch.models import stgcn
from skeleton_action_recognition_tpu_torch.models.stgcn import Model
from skeleton_action_recognition_tpu_torch.models import ctrgcn
from skeleton_action_recognition_tpu_torch.ops import (
    build,
    ctrgc,
    radar,
    resample,
    sgcn,
    stft,
    stft_logmag,
    tconv,
    virtual_radar,
)
from skeleton_action_recognition_tpu_torch.parallel import distributed
from skeleton_action_recognition_tpu_torch.parallel.sharding import (
    DataParallel,
)
from skeleton_action_recognition_tpu_torch.serving import Predictor
from skeleton_action_recognition_tpu_torch.train import losses
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
           "radar_dense_fwd.cu", "radar_dense_bwd.cu", "block_tail.cu",
           "ctrgc_fwd.cu", "ctrgc_bwd.cu")
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
    "sgcn_stats": {"sgcn_fwd_stats": 10, "sgcn_bwd": 10, "tconv_gue": 10},
    # the 8 stride-1 blocks take BN1's sums from #2's epilogue, and fold
    # their cotangents with tconv_gue as BN2's are folded
    "fused_tconv": {"sgcn_fwd_stats": 8, "sgcn_fwd": 2, "sgcn_bwd": 10,
                    "tconv_fwd": 8, "tconv_bwd": 8, "block_tail_fwd": 8,
                    "block_tail_bwd": 8, "tconv_gue": 16},
    "fused_min128": {"sgcn_fwd": 6, "sgcn_bwd": 6},
}
TRAIN_KERNELS = ("sgcn_fwd", "sgcn_fwd_stats", "sgcn_bwd", "tconv_fwd",
                 "tconv_bwd", "block_tail_fwd", "block_tail_bwd",
                 "tconv_gue")
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
# the folded predictors (models/export.py; export phase): the routes, as
# (dtype, Predictor's quantize); f32 is no Predictor option (the JAX
# Predictor folds in bf16), so its Predictor serves the f32 fold directly
FOLDED = {"f32": (torch.float32, None), "bf16": (torch.bfloat16, None),
          "w8": (torch.bfloat16, "w8"), "w8a8": (torch.bfloat16, "w8a8")}
# each route's logits against the stock f32 Predictor's on the card, max
# |diff| / max |stock|: f32 is the same sums in other orders
# (PREDICTOR_LOGIT_TOL); bf16 rounds the activations to 8 bits of mantissa
# before each product and conv (the CPU tests hold the port's bf16, W8 and
# W8A8 routes within 2e-2 of the JAX package's same route); W8 and W8A8
# add the weights' and the activations' int8 rounding (the JAX package's
# own test allows them 2.5x and 5x its bf16 bound, tests/test_export.py)
FOLDED_TOL = {"f32": PREDICTOR_LOGIT_TOL, "bf16": 2e-2, "w8": 5e-2,
              "w8a8": 5e-2}
# each route on the card against the same route and weights on the CPU:
# the CPU multiplies the bf16-rounded operands in f32, the card in cuBLAS's
# and cuDNN's bf16 with f32 accumulation, and a last-bit difference can
# move an activation's rounding (bf16 or int8) by one step
FOLDED_CPU_TOL = {"f32": PREDICTOR_LOGIT_TOL, "bf16": 2e-2, "w8": 2e-2,
                  "w8a8": 2e-2}
FOLDED_CPU_REQUESTS = (1, 7)  # the CPU forward of 64 clips takes seconds
FOLDED_TF32_REPS = 5
# the GNN zoo (zoo phase): the models, those that take a dtype (trained in
# bf16 too), those with an adjacency parameter to freeze, those driven
# through the CLIs (the two trunks: ST-GCN's blocks with GIN convs, and the
# projection-pool pyramid), and the frame sampler's shape
ZOO = ("stgin", "stpgcn", "stpgcnp", "experimental")
ZOO_BF16 = ("stgin", "stpgcn")
ZOO_ADJACENCY = {"stgin": dict(trainable_adjacency=True), "experimental": {}}
ZOO_CLI = ("stgin", "stpgcnp")
# zoo_cli ranks the clips by their logits, as evaluate does: a clip whose
# 1st/2nd or 5th/6th logits lie within this share of its largest |logit|
# is a tie, which the two computations may order differently (the same
# model on the same card and batches: equal up to the kernels' choice of
# algorithm). The probabilities are no yardstick: after one epoch ST-GIN's
# softmax puts exactly 0 on every class past the first few, so every clip
# tied there. The check fails when more than ZOO_CLI_TIES of the clips tie
ZOO_CLI_TIE_TOL = 1e-5
ZOO_CLI_TIES = 0.25
ZOO_SERVE_CLIPS, ZOO_SERVE_REPS, ZOO_COMPARE_CLIPS = 64, 5, 2
# the learning rate of the zoo's training steps and CLI runs: the train
# phase's 0.01, but 1e-3 for ST-PGCN-P, whose first gradient on pool_1's
# variance is ~2e3 at this init: a step of 0.01 drives sigmoid(variance)
# to where 1 / s^2 overflows, and the loss is NaN by the third step, in the
# JAX model as in the port (the same losses on the CPU, B=2)
ZOO_LR = {"stpgcnp": 1e-3}
SAMPLER_HIDDEN, SAMPLER_TOP_K, SAMPLER_SHAPE = (128,), 200, (16, 300, 25, 3)
# the card against the CPU on the same weights, f32 with TF32 off, max
# |diff| / max |CPU| of the eval logits: f32 sums in other orders through
# 8-10 blocks (moving the input by 1e-7 relative moves the logits by
# 1.3e-7 to 2.7e-7 on the CPU). ST-PGCN-P's pools are ill-conditioned at
# random eval-mode statistics: that 1e-7 moves its logits by 4.5e-4, so
# its bound is 40x that, not the others' 400x
ZOO_LOGIT_TOL = {"stgin": 1e-4, "stpgcn": 1e-4, "stpgcnp": 2e-2,
                 "experimental": 1e-4}
# the sampler's scores (LSTM outputs in (-1, 1)): f32, TF32 off, cuDNN's
# LSTM against the CPU's over 300 steps
SAMPLER_TOL = 1e-4
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
# the fused blocks' tail (csrc/block_tail.cu) at the stride-1 shapes: how
# many of a step's eight blocks take each residual, by the model's dtype.
# Block 0 has none; 5 and 8 take the stride-2 blocks' output (bf16 in the
# bf16 model), the others the previous fused block's f32 output. Every
# combination is checked; the kernels line sums the step's.
TAIL_RESIDUALS = {"none": None, "f32": torch.float32, "bf16": torch.bfloat16}
TAIL_BLOCKS = {
    "f32": {(300, 64): {"none": 1, "f32": 3}, (150, 128): {"f32": 2},
            (75, 256): {"f32": 2}},
    "bf16": {(300, 64): {"none": 1, "f32": 3},
             (150, 128): {"bf16": 1, "f32": 1},
             (75, 256): {"bf16": 1, "f32": 1}},
}
# g_scale2, g_shift2: f32 sums over 1.9 M rows in another order than the
# plain version's, max |diff| / max |plain|; every other output bit for bit
TAIL_SUM_TOL = 1e-4
# f32 operations an element: the forward's multiply, two adds and max; the
# backward's mask, two multiplies and the two sums' adds; the fold's two
# adds and two multiplies
TAIL_OPS = {"block_tail_fwd": 4, "block_tail_bwd": 5, "tconv_gue": 4}
TAIL_KERNELS = tuple(TAIL_OPS)
TAIL_OUTPUTS = ("out", "g_u", "g_scale2", "g_shift2", "g_res", "gue")
TAIL_SUMS = ("g_scale2", "g_shift2")
# CTR-GCN's channel-wise aggregation (#12 forward, #13 backward) at the
# 64-frame training cell's batch (128 clips x 2 bodies): (C, T) of its ten
# blocks' graph convs (the stride is in the temporal conv after) and how
# many blocks have it
CTRGC_NM = 256
CTRGC_SHAPES = [((64, 64), 4), ((128, 64), 1), ((128, 32), 2),
                ((256, 32), 1), ((256, 16), 2)]
CTRGC_KERNELS = ("ctrgc_fwd", "ctrgc_bwd")
CTRGC_OUTPUTS = ("z", "dx3", "ds")
# kernel vs plain, max |diff| / max |plain| of each output: both sum in f32
# in other orders (z and dx3 in bf16 are rounded once from sums that
# differ in their last f32 bits, so an element may sit one bf16 ulp away)
CTRGC_TOL = {"f32": 1e-5, "bf16": 2**-7}
# The card's published peaks (NVIDIA H100 SXM data sheet, dense): FLOP/s of
# f32 on the CUDA cores (TF32 off) and of bf16 on the tensor cores, and the
# device memory's bytes/s. A kernel's bound is the larger of its operations
# over the peak of their type and its bytes (inputs read once, outputs
# written once) over the memory rate.
# the ddp phase: (b) two gloo ranks of DDP_LOCAL_BATCH clips on card 0
# against one process on both ranks' rows, the ST-GCN in two
# configurations that between them launch #1-#5 (every block fused, remat
# off), the spectrogram model unfrozen (#6, #7's loc/lambda instance, #10,
# #11). Parameters after the step to the JAX data-parallel test's 3e-4
# (tests/test_parallel.py; f32 sums over the rows in another order), the
# ST-GCN's loss to its 1e-5; the spectrogram's backbone, Adam's first step
# (+-lr an element, sign-like), to 2 lr, its loss to 1e-4 (f32 through the
# radar at lambda = 5e-4), lambda's relative step to 1e-5 and loc's
# direction to within 8 degrees (tests/test_torch_radar_train.py).
DDP_WORLD, DDP_LOCAL_BATCH = 2, 64
DDP_REPEATS = 3  # further steps after the compared one, timed (median)
DDP_STGCN = {"fused_tconv": dict(fused_tconv=True),
             "sgcn_stats": dict(sgcn_stats=True)}
DDP_PARAM_ATOL, DDP_LOSS_RTOL, DDP_SPEC_LOSS_RTOL = 3e-4, 1e-5, 1e-4
# (a): main_gnn as torchrun starts it at world size 1 (NCCL), twice
# without a process group; then DDP_TIMED_STEPS train steps of its model
# at DDP_LOCAL_BATCH clips after TRAIN_WARMUP, timed on the host clock
DDP_TIMED_STEPS = 5
# (c): the host's TFRecord rates on DDP_HOST_CLIPS full-size clips in
# DDP_HOST_SHARDS shards, and data_gen on corpus_lib's 60 classes x 1
DDP_HOST_CLIPS, DDP_HOST_SHARDS = 256, 8
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
    **{name: "skeleton_action_recognition_tpu_torch/csrc/block_tail.cu"
       for name in TAIL_KERNELS},
}
# the tail kernels replace no TPU kernel: XLA fuses this elementwise work
KERNEL_REPLACES.update({
    "ctrgc_fwd": "none: the JAX package has no CTR-GCN",
    "ctrgc_bwd": "none: the JAX package has no CTR-GCN",
    "block_tail_fwd": "none: XLA fuses skeleton_action_recognition_tpu/"
                      "models/stgcn.py:179 and :316",
    "block_tail_bwd": "none: XLA fuses the VJP of skeleton_action_"
                      "recognition_tpu/models/stgcn.py:179 and :316",
    "tconv_gue": "none: XLA fuses skeleton_action_recognition_tpu/ops/"
                 "pallas/tconv.py:380-386",
})


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


def tail_inputs(t, c, dtype, res_dtype, device, g):
    """``u, scale2, shift2, res, g_out, g_u, g_sum, g_sumsq`` of one
    block's tail at NM=256 (``res`` None for ``res_dtype`` None)."""
    shape = (TRAIN_NM, t, 25, c)
    u = torch.randn(shape, generator=g, device=device).to(dtype)
    scale2 = torch.randn(c, generator=g, device=device)
    shift2 = 0.1 * torch.randn(c, generator=g, device=device)
    res = (None if res_dtype is None else
           torch.randn(shape, generator=g, device=device).to(res_dtype))
    g_out = torch.randn(shape, generator=g, device=device)
    g_u = torch.randn(shape, generator=g, device=device).to(dtype)
    g_sum = torch.randn(c, generator=g, device=device)
    g_sumsq = 0.1 * torch.randn(c, generator=g, device=device)
    return u, scale2, shift2, res, g_out, g_u, g_sum, g_sumsq


def phase_block_tail_kernel(device):
    """The fused blocks' tail kernels (``block_tail_fwd``,
    ``block_tail_bwd``, ``tconv_gue``) through their wrappers against
    their plain versions at the three stride-1 shapes, NM=256, ``u`` in f32
    and bf16, the residual absent, f32 and bf16: out, g_u, g_res and gue
    bit for bit, g_scale2/g_shift2 within TAIL_SUM_TOL of the largest plain
    value, two launches of each bit for bit, and CUDA-event times of each
    kernel and plain version beside its bound."""
    g = torch.Generator(device=device).manual_seed(SEED + 23)
    totals = {k: {name: Totals() for name in DTYPES} for k in TAIL_KERNELS}
    emit("block_tail_build", ptxas=ptxas_entries("block_tail.cu",
                                                 "block_tail"))
    for name, dtype in DTYPES.items():
        for (t, c), _ in TCONV_SHAPES:
            for res_name, res_dtype in TAIL_RESIDUALS.items():
                args = tail_inputs(t, c, dtype, res_dtype, device, g)
                u, scale2, shift2, res, g_out, g_u, g_sum, g_sumsq = args

                def fwd():
                    return tconv._tail_forward(u, scale2, shift2, res)

                def fwd_plain():
                    return tconv.block_tail_reference(u, scale2, shift2, res)

                out = fwd()

                def bwd():
                    return tconv._tail_backward(g_out, out, u, scale2,
                                                res_dtype)

                def bwd_plain():
                    return tconv.block_tail_backward_reference(
                        g_out, out, u, scale2, res_dtype)

                def gue():
                    return tconv.tconv_gue(g_u, u, g_sum, g_sumsq)

                def gue_plain():
                    return tconv.tconv_gue_reference(g_u, u, g_sum, g_sumsq)

                # out, g_u, g_scale2, g_shift2, g_res, gue
                got = (out, *bwd(), gue())
                again = (fwd(), *bwd(), gue())
                torch.cuda.synchronize()
                bit_identical = all(
                    (p is None and q is None) or torch.equal(p, q)
                    for p, q in zip(got, again))
                del again
                want = (fwd_plain(), *bwd_plain(), gue_plain())
                named = dict(zip(TAIL_OUTPUTS, zip(got, want)))
                # bit for bit but for the sign of a zero, which torch.equal
                # does not see
                equal = {k: (p is None and q is None) or (
                    p.dtype == q.dtype and torch.equal(p, q))
                    for k, (p, q) in named.items() if k not in TAIL_SUMS}
                sum_err = {k: rel_err(*named[k]) for k in TAIL_SUMS}
                spans = {"block_tail_fwd": slice(0, 1),
                         "block_tail_bwd": slice(1, 5),
                         "tconv_gue": slice(5, 6)}
                errs = {k: max_abs_err(*zip(*[
                    (p, q) for p, q in zip(got[v], want[v])
                    if p is not None])) for k, v in spans.items()}
                n_bytes = {k: nbytes(*(x for x in v if x is not None))
                           for k, v in {
                               "block_tail_fwd": (u, scale2, shift2, res,
                                                  out),
                               "block_tail_bwd": (g_out, out, u, scale2,
                                                  *got[1:5]),
                               "tconv_gue": (g_u, u, g_sum, g_sumsq,
                                             got[5])}.items()}
                del got, want, named
                bounds = {k: bound(TAIL_OPS[k] * u.numel(), n_bytes[k], "f32")
                          for k in TAIL_KERNELS}
                times = {
                    "block_tail_fwd": {"ms": cuda_ms(fwd),
                                       "plain_ms": cuda_ms(fwd_plain)},
                    "block_tail_bwd": {"ms": cuda_ms(bwd),
                                       "plain_ms": cuda_ms(bwd_plain)},
                    "tconv_gue": {"ms": cuda_ms(gue),
                                  "plain_ms": cuda_ms(gue_plain)},
                }
                blocks = TAIL_BLOCKS[name][(t, c)].get(res_name, 0)
                emit(
                    "block_tail_kernel", dtype=name, nm=TRAIN_NM, t=t, c=c,
                    res=res_name, blocks=blocks, equal=equal,
                    sum_err=sum_err, sum_tol=TAIL_SUM_TOL,
                    bit_identical=bit_identical, **{
                        f"{k}_{m}": v for k, d in times.items()
                        for m, v in d.items()},
                    **{f"{k}_bound_ms": v[0] for k, v in bounds.items()},
                    **{f"{k}_bound_by": v[1] for k, v in bounds.items()},
                    **{f"{k}_bytes_per_elem": v / u.numel()
                       for k, v in n_bytes.items()},
                )
                where = f"u {name}, res {res_name}, {(t, c)}"
                check(bit_identical, f"block tail repeats differ at {where}")
                check(all(equal.values()),
                      f"block tail outputs differ at {where}: {equal}")
                check(all(v <= TAIL_SUM_TOL for v in sum_err.values()),
                      f"block tail sums disagree at {where}: {sum_err}")
                for k, tot in totals.items():
                    tot[name].add(times[k], errs[k], *bounds[k], blocks)
                del args, u, res, g_out, g_u, out
                torch.cuda.empty_cache()
    return {k: dtype_entries(tot) for k, tot in totals.items()}


def ctrgc_inputs(c, t, dtype, device, g):
    """``x3, s, dz`` of one CTR-GCN block's aggregation at ``CTRGC_NM``."""
    x3 = torch.randn((CTRGC_NM, 3, c, t, 25), generator=g,
                     device=device).to(dtype)
    s = torch.randn((CTRGC_NM, 3, c, 25, 25), generator=g, device=device)
    dz = torch.randn((CTRGC_NM, c, t, 25), generator=g,
                     device=device).to(dtype)
    return x3, s, dz


def ctrgc_step_launches(device, batch=CTRGC_NM // 2):
    """Each aggregation kernel's launches in one training step of the
    full-width CTR-GCN (64 frames, bf16, remat off)."""
    model = ctrgcn.Model(num_classes=60, dtype=torch.bfloat16, remat=False,
                         device=device,
                         generator=torch.Generator().manual_seed(SEED))
    x = torch.randn(batch, 3, 64, 25, 2, device=device)
    reset_launches()
    model(x).sum().backward()
    torch.cuda.synchronize()
    launches = read_launches(CTRGC_KERNELS)
    del model, x
    torch.cuda.empty_cache()
    return launches


def phase_ctrgc_kernel(device):
    """CTR-GCN's aggregation kernels (#12 ``ctrgc_fwd``, #13
    ``ctrgc_bwd``) through their wrappers against their plain version (the
    published model's einsums, what eager PyTorch runs) at the ten blocks'
    shapes of the 64-frame cell, NM=256, f32 and bf16: z, dx3 and ds within
    ``CTRGC_TOL``, two launches of each bit for bit, CUDA-event times of
    kernel and plain version beside the bound (f32 CUDA-core operations
    and the operands' bytes); then one training step's launches (10 of
    each). Returns the kernels-line totals and those launches."""
    g = torch.Generator(device=device).manual_seed(SEED + 29)
    totals = {k: {name: Totals() for name in DTYPES} for k in CTRGC_KERNELS}
    emit("ctrgc_build", ptxas={
        **ptxas_entries("ctrgc_fwd.cu", "ctrgc"),
        **ptxas_entries("ctrgc_bwd.cu", "ctrgc")})
    for name, dtype in DTYPES.items():
        for (c, t), blocks in CTRGC_SHAPES:
            x3, s, dz = ctrgc_inputs(c, t, dtype, device, g)

            def fwd():
                return ctrgc._forward(x3, s)

            def fwd_plain():
                return ctrgc.channel_aggregate_reference(x3, s)

            def bwd():
                return ctrgc._backward(dz, x3, s)

            def bwd_plain():
                return ctrgc.channel_aggregate_backward_reference(dz, x3, s)

            got = (fwd(), *bwd())
            again = (fwd(), *bwd())
            torch.cuda.synchronize()
            bit_identical = all(torch.equal(p, q) for p, q in zip(got, again))
            del again
            want = (fwd_plain(), *bwd_plain())
            errs = {k: rel_err(p, q)
                    for k, p, q in zip(CTRGC_OUTPUTS, got, want)}
            tol = {"z": CTRGC_TOL[name], "dx3": CTRGC_TOL[name],
                   "ds": CTRGC_TOL["f32"]}
            ops = 2 * 3 * CTRGC_NM * c * t * 25 * 25
            bounds = {"ctrgc_fwd": bound(ops, nbytes(x3, s, got[0]), "f32"),
                      "ctrgc_bwd": bound(2 * ops, nbytes(dz, x3, s, *got[1:]),
                                         "f32")}
            abs_errs = {"ctrgc_fwd": max_abs_err(got[:1], want[:1]),
                        "ctrgc_bwd": max_abs_err(got[1:], want[1:])}
            del got, want
            times = {
                "ctrgc_fwd": {"ms": cuda_ms(fwd),
                              "plain_ms": cuda_ms(fwd_plain)},
                "ctrgc_bwd": {"ms": cuda_ms(bwd),
                              "plain_ms": cuda_ms(bwd_plain)},
            }
            emit(
                "ctrgc_kernel", dtype=name, nm=CTRGC_NM, c=c, t=t,
                blocks=blocks, err=errs, tol=tol,
                bit_identical=bit_identical, **{
                    f"{k}_{m}": v for k, d in times.items()
                    for m, v in d.items()},
                **{f"{k}_bound_ms": v[0] for k, v in bounds.items()},
                **{f"{k}_bound_by": v[1] for k, v in bounds.items()},
            )
            where = f"{name}, (C, T) = {(c, t)}"
            check(bit_identical, f"ctrgc repeats differ at {where}")
            check(all(errs[k] <= tol[k] for k in errs),
                  f"ctrgc outputs disagree at {where}: {errs}")
            for k, tot in totals.items():
                tot[name].add(times[k], abs_errs[k], *bounds[k], blocks)
            del x3, s, dz
            torch.cuda.empty_cache()
    launches = ctrgc_step_launches(device)
    emit("ctrgc_step", launches=launches)
    check(launches == dict.fromkeys(CTRGC_KERNELS, 10),
          f"a CTR-GCN training step launched {launches}")
    return {k: dtype_entries(tot) for k, tot in totals.items()}, launches


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
    return redraw_statistics(model, g)


def redraw_statistics(model, g):
    """``model`` with its BatchNorm affines and running statistics and
    every bias redrawn from the generator ``g``."""
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
    reset_launches()
    probs, per_request = {}, {}
    for n, x in requests.items():
        before = tracing.counters()["launch.sgcn_fwd"]
        probs[n] = predictor(x)
        per_request[n] = tracing.counters()["launch.sgcn_fwd"] - before
    launches = tracing.counters()["launch.sgcn_fwd"]

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


def folded_predictors(device, state):
    """``{route: (Predictor, build seconds)}`` for the routes of
    ``FOLDED``, each folded from the stock f32 model of ``state`` and timed
    from the model's copy to the card to the weights' arrival there (the
    fold is host code)."""
    out = {}
    for route, (dtype, quantize) in FOLDED.items():
        model = seeded_model("f32", False, state)
        torch.cuda.synchronize()
        start = time.perf_counter()
        if route == "f32":
            pred = Predictor(model, 64, device)
            pred._forward = export.fused_stgcn_predictor(
                pred.model, dtype, device)
        else:
            pred = Predictor(model, 64, device, fused=True,
                             quantize=quantize)
        torch.cuda.synchronize()
        out[route] = (pred, time.perf_counter() - start)
    return out


def resident_tensors(pred):
    """The tensors a ``Predictor`` keeps on its device: the model's
    parameters and buffers, or the folded predictor's weights and head."""
    fwd = pred._forward
    if isinstance(fwd, torch.nn.Module):
        return [*fwd.parameters(), *fwd.buffers()]
    tensors = list(fwd.head)
    for blk in fwd.weights:
        for value in blk.values():
            if isinstance(value, torch.Tensor):
                tensors.append(value)
            elif value is not None:
                tensors.extend(value)
    return tensors


def phase_latency(device, state, x, folded, reps=20):
    """The 64-clip request through the stock predictors (f32 and bf16,
    unfused and ``fused_sgcn``) and the folded ones (``folded``), timed in
    turns. ``peak_mem_mb`` is one predictor's own: its resident tensors
    plus the request's peak above what was allocated before it."""
    predictors = {
        ("stock", name, fused): Predictor(seeded_model(name, fused, state),
                                          64, device)
        for name in DTYPES for fused in (False, True)
    }
    for route, (pred, _) in folded.items():
        predictors[("folded", route, False)] = pred
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
    for (kind, name, fused), samples in times.items():
        pred = predictors[(kind, name, fused)]
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        pred(x)
        peak = (torch.cuda.max_memory_allocated() - before
                + nbytes(*resident_tensors(pred)))
        med = statistics.median(samples)
        label = (dict(dtype=name, fused_sgcn=fused) if kind == "stock"
                 else dict(route=name))
        emit(
            "latency", predictor=kind, **label, batch=len(x),
            t=x.shape[2], samples=len(samples), median_ms=1e3 * med,
            min_ms=1e3 * min(samples), max_ms=1e3 * max(samples),
            clips_per_s=len(x) / med, peak_mem_mb=peak / 2**20,
        )


def on_cpu(folded):
    """A copy of the folded predictor ``folded`` (``models.export``) with
    its weights and head on the CPU: the same numbers through the CPU's
    route."""
    def move(value):
        if value is None or isinstance(value, torch.Tensor):
            return None if value is None else value.cpu()
        return tuple(t.cpu() for t in value)

    cpu = copy.copy(folded)
    cpu.device = torch.device("cpu")
    cpu.weights = [{k: move(v) for k, v in blk.items()}
                   for blk in folded.weights]
    cpu.head = move(folded.head)
    return cpu


def logit_errors(got, want, tol):
    """max |got - want| / max |want|, and the clips whose argmax differs
    though ``want``'s two largest lie more than twice ``tol`` of its scale
    apart (a disagreement no tie explains)."""
    scale = np.abs(want).max()
    ranked = -np.sort(-want, axis=-1)
    clear = ranked[:, 0] - ranked[:, 1] > 2 * tol * scale
    return (float(np.abs(got - want).max() / scale),
            float((got.argmax(-1) == want.argmax(-1)).mean()),
            int((clear & (got.argmax(-1) != want.argmax(-1))).sum()))


def product_routes(folded_bf16, n_clips):
    """The bf16 folded products at the ten blocks' shapes for ``n_clips``
    clips (seeded ReLU'd activations, the bf16 predictor's ``wf``):
    ``torch.mm``'s ``out_dtype=float32`` (the route kept) against the bf16
    product read back as f32, each's error against the f32 product of the
    same bf16 operands (the CPU's route, TF32 off) and their CUDA-event
    times summed over the blocks."""
    g = torch.Generator(device=folded_bf16.device).manual_seed(SEED)
    totals = {"out_f32_ms": 0.0, "bf16_ms": 0.0, "out_f32_err": 0.0,
              "bf16_err": 0.0}
    t = T
    for blk, (stride, _, c_out) in zip(folded_bf16.weights,
                                       folded_bf16.static):
        w = blk["wf"]
        a = torch.randn(n_clips * 2 * t, w.shape[0], generator=g,
                        device=w.device).relu_().bfloat16()
        exact = a.float() @ w.float()
        scale = exact.abs().max()
        for key, fn in (("out_f32", lambda: torch.mm(a, w,
                                                     out_dtype=torch.float32)),
                        ("bf16", lambda: torch.mm(a, w).float())):
            totals[f"{key}_err"] = max(totals[f"{key}_err"], float(
                (fn() - exact).abs().max() / scale))
            totals[f"{key}_ms"] += cuda_ms(fn)
        t = -(-t // stride)
    return totals


def int8_shapes(device):
    """``export.int8_product`` on the card at rows 1, 17 and 593 (padded)
    and K = 75 (block 0's, padded to 80) against the exact product, and
    whether ``torch._int_mm`` takes a row-major B (the route does not rely
    on it): ``{check: "ok" or the error's first line}``."""
    g = torch.Generator().manual_seed(SEED)
    wq = torch.randint(-127, 128, (80, 1600), generator=g,
                       dtype=torch.int8)
    wq[75:] = 0
    col = wq.t().contiguous().to(device).t()
    out = {}
    for m in (1, 17, 593):
        qa = torch.randint(-127, 128, (m, 75), generator=g, dtype=torch.int8)
        got = export.int8_product(qa.to(device), col).cpu()
        exact = (qa.double() @ wq[:75].double()).to(torch.int32)
        check(torch.equal(got, exact), f"int8_product at {m} rows differs")
        out[f"rows_{m}"] = "ok"
    try:
        torch._int_mm(torch.zeros(600, 80, dtype=torch.int8, device=device),
                      wq.to(device))
        torch.cuda.synchronize()
        out["row_major_b"] = "ok"
    except RuntimeError as err:
        out["row_major_b"] = str(err).splitlines()[0][:160]
    return out


def phase_export(device, state, requests, folded):
    """The folded predictors (``folded_predictors``) on the 1-, 7- and
    64-clip requests: each route's logits against the stock f32
    ``Predictor``'s on the card and against the same route on the CPU
    (``FOLDED_CPU_REQUESTS``), argmax agreement, ``torch._int_mm`` calls
    (10 a W8A8 request, none elsewhere), no launch of any kernel of the
    port, the folded weights' device bytes and each build's host time; the
    f32 route with TF32 on and off; the bf16 product's two accumulation
    routes; ``int8_product``'s padded shapes."""
    stock = Predictor(seeded_model("f32", False, state), 64, device)
    int_mm = torch._int_mm
    calls = [0]

    def counted(*args, **kwargs):
        calls[0] += 1
        return int_mm(*args, **kwargs)

    records = {}
    try:
        torch._int_mm = counted
        for route, (pred, build_s) in folded.items():
            fwd = pred._forward
            cpu = on_cpu(fwd)
            errors, cpu_errors, per_request = {}, {}, {}
            reset_launches()
            for n, x in requests.items():
                before = calls[0]
                logits = fwd(x).cpu().numpy()
                per_request[n] = calls[0] - before
                with torch.inference_mode():
                    want = stock.model(torch.from_numpy(x).to(device))
                want = want.float().cpu().numpy()
                check(logits.shape == (n, 60) and np.isfinite(logits).all(),
                      f"{route}: logits {logits.shape} or not finite")
                errors[n] = logit_errors(logits, want, FOLDED_TOL[route])
                if n in FOLDED_CPU_REQUESTS:
                    cpu_errors[n] = logit_errors(logits, cpu(x).numpy(),
                                                 FOLDED_CPU_TOL[route])
            launches = read_launches(COUNTERS)
            records[route] = dict(
                build_s=build_s,
                weight_mb=nbytes(*resident_tensors(pred)) / 2**20,
                int_mm_calls=per_request, launches=launches,
                vs_stock={n: e[0] for n, e in errors.items()},
                argmax_agree={n: e[1] for n, e in errors.items()},
                vs_cpu={n: e[0] for n, e in cpu_errors.items()},
                cpu_argmax_agree={n: e[1] for n, e in cpu_errors.items()})
            check(not any(launches.values()),
                  f"{route} launched kernels of the port: {launches}")
            want_calls = 10 if route == "w8a8" else 0
            check(all(c == want_calls for c in per_request.values()),
                  f"{route}: {per_request} _int_mm calls, not {want_calls} "
                  "a request")
            check(all(e[0] <= FOLDED_TOL[route] and not e[2]
                      for e in errors.values()),
                  f"{route} against the stock predictor: {errors}")
            check(all(e[0] <= FOLDED_CPU_TOL[route] and not e[2]
                      for e in cpu_errors.values()),
                  f"{route} on the card against the CPU: {cpu_errors}")
            del cpu
    finally:
        torch._int_mm = int_mm

    # the f32 route with TF32 on (the stock model's matmuls follow the
    # same switch) and off, in turns
    x = requests[64]
    f32 = folded["f32"][0]
    tf32 = {False: [], True: []}
    for rep in range(2 * FOLDED_TF32_REPS + 2):
        on = rep % 2 == 1
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        start = time.perf_counter()
        f32(x)
        if rep >= 2:  # a warm-up request each way
            tf32[on].append(time.perf_counter() - start)
    logits_tf32 = f32._forward(x).cpu().numpy()
    tf32_off()
    with torch.inference_mode():
        want = stock.model(torch.from_numpy(x).to(device)).cpu().numpy()
    # where each route's 64-clip request spends the device's time
    profiles = {route: device_profile(lambda: pred(x), PROFILE_STEPS)
                for route, (pred, _) in folded.items()}
    emit("export", routes=records, tol=FOLDED_TOL, cpu_tol=FOLDED_CPU_TOL,
         profile_n64=profiles,
         f32_median_ms={"tf32_off": 1e3 * statistics.median(tf32[False]),
                        "tf32_on": 1e3 * statistics.median(tf32[True])},
         f32_tf32_vs_stock=logit_errors(logits_tf32, want, 1.0)[0],
         product_routes_n64=product_routes(folded["bf16"][0]._forward, 64),
         int8_shapes=int8_shapes(device))


# the port's kernel entry points, as ops.build.launch counts their calls
COUNTERS = ("sgcn_fwd", "sgcn_fwd_stats", "sgcn_bwd", "tconv_fwd",
            "tconv_bwd", "block_tail_fwd", "block_tail_bwd", "tconv_gue",
            "ctrgc_fwd", "ctrgc_bwd",
            "radar_fwd", "radar_bwd", "radar_bwd_loc_lam",
            "radar_dense_fwd", "radar_dense_bwd", "stft_fwd", "stft_bwd")


def reset_launches():
    tracing.reset_counters()


def read_launches(names=("sgcn_fwd", "sgcn_bwd")):
    counts = tracing.counters()
    return {name: counts[f"launch.{name}"] for name in names}


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
    time by kernel, copy and fill name (us, all steps). Busy and idle are
    the benchmark's (``benchmark/harness/trace.py``): busy is the union of
    the kernels', copies' and fills' intervals (a ``record_function``
    range is not busy), idle the rest of the window, the host's clock from
    the synchronize before the first call to the one after the last
    (``span_ms_per_step``)."""
    from benchmark.harness import trace as bench_trace

    torch.cuda.synchronize()
    with bench_trace.profiler() as prof:
        start = time.perf_counter()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        window = time.perf_counter() - start
    reduced = bench_trace.read(prof, window)
    return prof, {
        "device_events": reduced["device_work"],
        "busy_ms_per_step": reduced["busy_s"] * 1e3 / steps,
        "span_ms_per_step": window * 1e3 / steps,
        "idle_share": 1.0 - reduced["busy_s"] / window,
    }, {name: s * 1e6 for name, s in reduced["by_name"].items()}


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


def write_cli_data(tmp, rng):
    """``CLI_CLIPS`` seeded normal clips of 60 classes as TFRecords under
    ``tmp``, 2 shards a part; returns ``{part: directory}``."""
    dirs = {}
    for part, n in CLI_CLIPS.items():
        x = rng.normal(size=(n, 3, T, 25, 2)).astype(np.float32)
        dirs[part] = os.path.join(tmp, part)
        tfrecord.write_dataset(
            x, rng.integers(0, 60, n), dirs[part], part, num_shards=2
        )
    return dirs


def phase_cli(device):
    """The trainer CLI on synthetic TFRecords, then resumed."""
    rng = np.random.default_rng(SEED)
    with tempfile.TemporaryDirectory() as tmp:
        dirs = write_cli_data(tmp, rng)
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


def reference_report(scores, labels, tie_tol=0.0):
    """top-1 and top-5 of ``scores`` (probabilities or logits) as the CLIs
    count them, and the clips whose 1st/2nd or 5th/6th scores lie within
    ``tie_tol`` of the row's largest |score| (by default: are equal, where
    the logits, which the CLIs rank, may still order them)."""
    ranked = -np.sort(-scores, axis=-1)
    tol = tie_tol * np.abs(scores).max(-1)
    ties = int(((ranked[:, 0] - ranked[:, 1] <= tol)
                | (ranked[:, 4] - ranked[:, 5] <= tol)).sum())
    top5 = np.argsort(scores, axis=-1)[:, -5:]
    n = max(len(labels), 1)
    return {
        "top1": round(int((scores.argmax(-1) == labels).sum()) / n, 4),
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
        gnn_launches = read_launches(COUNTERS)
        reset_launches()
        spec_report, spec_s = timed(lambda: evaluate.main(spec_argv,
                                                          device=device))
        spec_launches = read_launches(COUNTERS)
        weights = [str(w) for _, w in ENSEMBLE]
        reset_launches()
        ens_report, ens_s = timed(lambda: ensemble.main(flags + [
            "--streams", *(s for s, _ in ENSEMBLE),
            "--checkpoints", *(ckpt[s] for s, _ in ENSEMBLE),
            "--weights", *weights, "--test-data-path", val["tfrecord"]],
            device=device))
        ens_launches = read_launches(COUNTERS)
        # the folded and W8 predictors (no warm-up: the export phase warmed
        # cuBLAS and cuDNN; each run folds the checkpoint on the host). The
        # predictor each run folds is kept for the recomputed report below
        # (folding again would take seconds)
        folded_runs = {}
        for predictor, name in (("folded", "fused_stgcn_predictor"),
                                ("int8", "quantized_stgcn_predictor")):
            factory, built = getattr(export, name), []
            setattr(export, name, lambda *args, **kwargs: built.append(
                factory(*args, **kwargs)) or built[-1])
            try:
                reset_launches()
                report, seconds = timed(lambda: evaluate.main(
                    gnn_argv + ["--predictor", predictor], device=device))
            finally:
                setattr(export, name, factory)
            check(len(built) == 1, f"evaluate {predictor} folded "
                  f"{len(built)} times")
            folded_runs[predictor] = (report, seconds,
                                      read_launches(COUNTERS),
                                      built[0])

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
        # the folded routes' reports, recomputed from the same route's
        # logits; ranked by logits, as evaluate ranks them (zoo_cli's ties)
        for predictor, (report, _, _, fwd) in folded_runs.items():
            logits = np.concatenate([
                fwd(xb).cpu().numpy() for xb, _ in TFRecordDataset(
                    val["tfrecord"], EVAL_BATCH,
                    transform=stream_transform("joint")).batches()])
            label = f"evaluate {predictor}"
            want, ties[label] = reference_report(logits, labels,
                                                 ZOO_CLI_TIE_TOL)
            check(ties[label] <= ZOO_CLI_TIES * n,
                  f"{label}: {ties[label]} of {n} clips tie in their logits")
            check(report["samples"] == n and report["checkpoint_step"] == 0
                  and report["predictor"] == predictor,
                  f"{label} report {report}")
            check_report(label, report, want, ties[label], n)
        folded_runs = {p: run[:3] for p, run in folded_runs.items()}

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
        pred_launches = read_launches(COUNTERS)
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
        "evaluate_folded": none,
        "evaluate_int8": none,
    }
    launches = {"evaluate_stgcn": gnn_launches,
                "evaluate_spectrogram": spec_launches,
                "ensemble": ens_launches, "predictor": pred_launches,
                **{f"evaluate_{p}": run[2] for p, run in folded_runs.items()}}
    emit(
        "eval_path", clips=counts, multi_body_files=written,
        data_gen_s=gen_s, data_gen_records_per_s=records / gen_s,
        host_cpu=host_cpu(), batch=EVAL_BATCH, batches=batches,
        reports={"evaluate_stgcn": gnn_report,
                 "evaluate_spectrogram": spec_report, "ensemble": ens_report,
                 **{f"evaluate_{p}": run[0]
                    for p, run in folded_runs.items()}},
        tied_clips=ties, predictor_top1=served_top1,
        eval_clips_per_s={"stgcn": n / gnn_s, "spectrogram": n / spec_s,
                          "ensemble": n / ens_s,
                          **{f"stgcn_{p}": n / run[1]
                             for p, run in folded_runs.items()}},
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


def zoo_model(name, seed=SEED, **options):
    """Full-width NTU-60 ``models.<name>.Model`` with ``options``, CONV_INIT
    weights from ``seed``, and BatchNorm affines, running statistics and
    biases redrawn from it."""
    g = torch.Generator().manual_seed(seed)
    return redraw_statistics(
        model_class(name)(num_classes=60, generator=g, **options), g)


def zoo_serve(device, name, x):
    """The 64-clip request through ``Predictor`` on the card (rows finite
    and summing to 1, its median latency), and 2 clips on the card against
    the same weights on the CPU, eval logits and train-mode logits."""
    predictor = Predictor(zoo_model(name), ZOO_SERVE_CLIPS, device)
    probs = predictor(x)  # warm-up: cuDNN's plans, the allocator
    check(probs.shape == (len(x), 60) and np.isfinite(probs).all(),
          f"{name}: probabilities of shape {probs.shape}, or not finite")
    check(np.abs(probs.sum(-1) - 1.0).max() < 1e-5,
          f"{name}: probability rows do not sum to 1")
    times = []
    for _ in range(ZOO_SERVE_REPS):
        start = time.perf_counter()
        predictor(x)
        times.append(time.perf_counter() - start)
    med = statistics.median(times)

    cpu = zoo_model(name).eval()
    clips = torch.from_numpy(x[:ZOO_COMPARE_CLIPS])
    errors = {}
    with torch.no_grad():
        errors["eval"] = rel_err(predictor.model(clips.to(device)).cpu(),
                                 cpu(clips))
        # batch statistics in both (each a copy: the running ones stay)
        card = copy.deepcopy(predictor.model).train()
        errors["train"] = rel_err(card(clips.to(device)).cpu(),
                                  copy.deepcopy(cpu).train()(clips))
    del predictor, card
    torch.cuda.empty_cache()
    return {"latency_ms": 1e3 * med, "clips_per_s": len(x) / med,
            "latency_min_ms": 1e3 * min(times),
            "latency_max_ms": 1e3 * max(times),
            "top_prob": float(probs.max(-1).mean()),
            "card_vs_cpu_logit_rel_err": errors}


def zoo_train(device, name, dtype, batch):
    """``TRAIN_WARMUP`` and then ``TRAIN_STEPS`` timed train steps (each
    ending synchronized) of the full-width model at ``batch`` on seeded
    noise: step times, peak memory, the losses; in f32 also a profile of
    ``PROFILE_STEPS`` more steps (device time by kernel, idle share)."""
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(
        rng.normal(size=(batch, 3, T, 25, 2)).astype(np.float32)).to(device)
    y = F.one_hot(torch.from_numpy(rng.integers(0, 60, batch)),
                  60).float().to(device)
    # remat off where the model takes it, as in the train phase
    params = inspect.signature(model_class(name)).parameters
    options = {"remat": False} if "remat" in params else {}
    if dtype == "bf16":
        options["dtype"] = torch.bfloat16
    model = model_class(name)(
        num_classes=60, device=device,
        generator=torch.Generator().manual_seed(SEED), **options)
    step = make_train_step(
        model, TFSGD(model.parameters(), ZOO_LR.get(name, 0.01)), batch)
    losses = [step(x, y, False)["loss"].item()
              for _ in range(TRAIN_WARMUP)]
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(TRAIN_STEPS):
        start = time.perf_counter()
        losses.append(step(x, y, False)["loss"].item())
        times.append(time.perf_counter() - start)
    med = statistics.median(times)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    profile = device_profile(lambda: step(x, y, False)["loss"].item(),
                             PROFILE_STEPS) if dtype == "f32" else None
    return {"median_step_ms": 1e3 * med, "min_step_ms": 1e3 * min(times),
            "max_step_ms": 1e3 * max(times), "clips_per_s": batch / med,
            "peak_mem_mb": peak_mb, "loss_first": losses[0],
            "loss_last": losses[-1], "losses": losses, "profile": profile}


def adjacency_params(model):
    return {k: p for k, p in model.named_parameters()
            if "adjacency_matrix" in k}


def zoo_freeze(device, name, options):
    """One train step with the graph frozen leaves every
    ``adjacency_matrix`` bit for bit as it was; one with it training
    changes each."""
    rng = np.random.default_rng(SEED + 10)
    x = torch.from_numpy(
        rng.normal(size=(4, 3, T, 25, 2)).astype(np.float32)).to(device)
    y = F.one_hot(torch.from_numpy(rng.integers(0, 60, 4)),
                  60).float().to(device)
    model = model_class(name)(num_classes=60, device=device,
                              generator=torch.Generator().manual_seed(SEED),
                              **options)
    step = make_train_step(model, TFSGD(model.parameters(), 0.01), 4)
    before = {k: p.detach().clone() for k, p in adjacency_params(model).items()}
    check(before, f"{name}: no adjacency_matrix parameter")
    step(x, y, False)
    frozen = all(torch.equal(p, before[k])
                 for k, p in adjacency_params(model).items())
    step(x, y, True)
    moved = all(not torch.equal(p, before[k])
                for k, p in adjacency_params(model).items())
    check(frozen and moved, f"{name}: adjacency unchanged while frozen "
          f"{frozen}, changed while training {moved}")
    return {"params": len(before), "frozen_unchanged": frozen,
            "trained_changed": moved}


def zoo_cli(device, name, dirs, tmp):
    """``main_gnn --model <name>`` for one epoch on the ``cli`` phase's
    kind of data, then ``evaluate`` on its checkpoint: the report over the
    validation clips, equal to the one recomputed from the logits of
    ``Predictor.from_checkpoint``'s model, whose probability rows are
    finite and sum to 1."""
    log_dir = os.path.join(tmp, f"logs_{name}")
    (history,), train_s = timed(lambda: main_gnn.main([
        "--model", name, "--batch-size", str(CLI_BATCH), "--num-epochs",
        "1", "--base-lr", str(ZOO_LR.get(name, 0.01)),
        "--train-data-path", dirs["train"],
        "--test-data-path", dirs["val"], "--log-dir", log_dir],
        device=device))
    tf32_off()  # main_gnn's default --precision turned it on
    (run,) = os.listdir(log_dir)
    ckpt = os.path.join(log_dir, run, "checkpoints")
    report, eval_s = timed(lambda: evaluate.main([
        "--model", name, "--checkpoint", ckpt, "--batch-size",
        str(CLI_BATCH), "--test-data-path", dirs["val"]], device=device))
    data = TFRecordDataset(dirs["val"], CLI_BATCH)
    labels = data._load_all()[1]
    predictor = Predictor.from_checkpoint(model_class(name)(num_classes=60),
                                          ckpt, CLI_BATCH, device)
    probs = np.concatenate([predictor(xb) for xb, _ in data.batches()])
    with torch.inference_mode():
        logits = np.concatenate([
            predictor.model(torch.from_numpy(xb).to(device)).float().cpu()
            .numpy() for xb, _ in data.batches()])
    n = CLI_CLIPS["val"]
    check(probs.shape == (n, 60) and np.isfinite(probs).all()
          and np.abs(probs.sum(-1) - 1.0).max() < 1e-5,
          f"{name}: predictor rows {probs.shape}, not finite or not 1")
    check(logits.shape == (n, 60) and np.isfinite(logits).all(),
          f"{name}: predictor logits {logits.shape} or not finite")
    want, ties = reference_report(logits, labels, ZOO_CLI_TIE_TOL)
    check(ties <= ZOO_CLI_TIES * n,
          f"{name}: {ties} of {n} clips tie in their logits")
    check(report["samples"] == n and report["checkpoint_step"] == 1,
          f"{name} evaluate report {report}")
    check_report(f"evaluate {name}", report, want, ties, n)
    check(all(np.isfinite(v) for v in history.values()),
          f"{name}: non-finite epoch metrics {history}")
    return {"history": history, "train_s": train_s, "report": report,
            "recomputed": want, "tied_clips": ties,
            "eval_clips_per_s": n / eval_s}


def zoo_sampler(device):
    """``TemporalSampler((128,), top_k=200)`` on seeded (16, 300, 25, 3)
    clips, the card against the CPU: the scores, the chosen frames, and
    the output (each row's frames in frame order)."""
    g = torch.Generator().manual_seed(SEED)
    n, t, v, c = SAMPLER_SHAPE
    cpu = lstm_sampler.TemporalSampler(v * c, SAMPLER_HIDDEN, SAMPLER_TOP_K,
                                       generator=g)
    card = copy.deepcopy(cpu).to(device)
    x = torch.from_numpy(np.random.default_rng(SEED + 11).normal(
        size=SAMPLER_SHAPE).astype(np.float32))
    xd = x.to(device)
    with torch.no_grad():
        scores = (card.scores(xd).cpu(), cpu.scores(x))
        outs = (card(xd).cpu(), cpu(x))
        ms = cuda_ms(lambda: card(xd), iters=5, warmup=2)
    picked = [torch.topk(sc, SAMPLER_TOP_K, dim=-1).indices for sc in scores]
    same = all(set(a.tolist()) == set(b.tolist())
               for a, b in zip(*picked))
    check(same, "sampler: the card and the CPU chose other frames")
    ordered = [torch.gather(o, 1, torch.argsort(i, dim=1)[:, :, None, None]
                            .expand(o.shape)) for o, i in zip(outs, picked)]
    err = {"scores": float((scores[0] - scores[1]).abs().max()),
           "out": rel_err(*ordered)}
    check(err["scores"] <= SAMPLER_TOL and err["out"] <= SAMPLER_TOL,
          f"sampler, card vs CPU: {err}")
    return {"shape": list(SAMPLER_SHAPE), "top_k": SAMPLER_TOP_K,
            "forward_ms": ms, "card_vs_cpu": err, "tol": SAMPLER_TOL}


def phase_zoo(device, x):
    """ST-GIN, ST-PGCN, ST-PGCN-P and the debug ST-GCN at full width:
    served, trained, their adjacency frozen and trained, through the CLIs,
    and the frame sampler; none of them launches a kernel of the port."""
    tf32_off()
    reset_launches()
    for name in ZOO:
        emit("zoo_serve", model=name, batch=len(x), t=T,
             **zoo_serve(device, name, x))
    for name in ZOO:
        for dtype in ("f32", "bf16") if name in ZOO_BF16 else ("f32",):
            for batch in (TRAIN_BATCH, 64, 32):  # the largest that fits
                try:
                    record = zoo_train(device, name, dtype, batch)
                    break
                except torch.cuda.OutOfMemoryError:
                    emit("zoo_train", model=name, dtype=dtype, batch=batch,
                         out_of_memory=True)
                finally:
                    torch.cuda.empty_cache()
            else:
                raise RuntimeError(f"{name} {dtype}: no batch fits")
            emit("zoo_train", model=name, dtype=dtype, batch=batch, t=T,
                 remat=False, steps=TRAIN_STEPS, **record)
            loss = record["losses"]
            check(all(np.isfinite(loss)), f"{name} {dtype}: non-finite loss")
            check(np.mean(loss[-5:]) < np.mean(loss[:5]),
                  f"{name} {dtype}: the loss did not fall: {loss}")
    for name, options in ZOO_ADJACENCY.items():
        emit("zoo_adjacency", model=name, **zoo_freeze(device, name, options))
    with tempfile.TemporaryDirectory() as tmp:
        dirs = write_cli_data(tmp, np.random.default_rng(SEED + 9))
        for name in ZOO_CLI:
            emit("zoo_cli", model=name, clips=CLI_CLIPS, batch=CLI_BATCH,
                 **zoo_cli(device, name, dirs, tmp))
    emit("zoo_sampler", **zoo_sampler(device))
    launches = read_launches(COUNTERS)
    emit("zoo", launches=launches)
    check(not any(launches.values()),
          f"the zoo launched kernels of the port: {launches}")

class StatsTconvModel(Model):
    """The ST-GCN with both fused training options on (``sgcn_stats`` on
    the fused blocks, ``fused_tconv`` on the others' stride-1 temporal
    chains), for ``main_gnn --model``: as in JAX, no flag sets them. With
    ``--fused-sgcn-min-channels 128`` a train step launches #2 and #3 on
    the six wide blocks and #4 and #5 on the three narrow stride-1 ones,
    and an eval batch #1 on the six."""

    def __init__(self, num_classes=60, dtype=None, fused_sgcn=False,
                 fused_sgcn_min_channels=0, remat=True,
                 trainable_adjacency=False, device=None, generator=None):
        super().__init__(
            num_classes, dtype=dtype, fused_sgcn=fused_sgcn,
            fused_sgcn_min_channels=fused_sgcn_min_channels, remat=remat,
            trainable_adjacency=trainable_adjacency, fused_tconv=True,
            sgcn_stats=True, device=device, generator=generator,
        )


def ddp_cli_child(out, device, *argv):
    """One process of the ``ddp`` phase's (a), in a process group where
    torchrun's environment names one: ``main_gnn.main(argv)`` on
    ``device`` with :class:`StatsTconvModel`, its launches, then the median
    time of ``DDP_TIMED_STEPS`` train steps of that model at
    ``DDP_LOCAL_BATCH`` clips (its precision, its data parallelism);
    written to ``out`` as JSON."""
    main_gnn.model_class = lambda name: StatsTconvModel
    reset_launches()
    history = main_gnn.main(list(argv), device=device)
    launches = read_launches(COUNTERS)
    device = distributed.local_device(device)
    dp = DataParallel()
    model = StatsTconvModel(fused_sgcn=True, fused_sgcn_min_channels=128,
                            device=device,
                            generator=torch.Generator().manual_seed(SEED))
    x, y = ddp_batch(DDP_LOCAL_BATCH, SEED + 11)
    xs, ys = torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)
    step = make_train_step(model, TFSGD(model.parameters(), 0.01),
                           DDP_LOCAL_BATCH * dp.world_size,
                           dp=dp if dp.active else None)
    times = []
    for i in range(TRAIN_WARMUP + DDP_TIMED_STEPS):
        start = time.perf_counter()
        step(xs, ys, False)["loss"].item()  # ends synchronized
        times.append(time.perf_counter() - start)
    with open(out, "w") as f:
        json.dump({"history": history, "launches": launches,
                   "group": dp.active, "world_size": dp.world_size,
                   "backend": dist.get_backend() if dp.active else None,
                   "step_ms": 1e3 * statistics.median(
                       times[TRAIN_WARMUP:])}, f)
    if dp.active:
        dist.destroy_process_group()


def ddp_batch(n, seed):
    """``n`` seeded normal clips (T=300) and one-hot labels of 60
    classes."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3, T, 25, 2)).astype(np.float32)
    return x, np.eye(60, dtype=np.float32)[rng.integers(0, 60, n)]


def ddp_steps(device, dp):
    """One train step of each DDP_STGCN configuration and of the unfrozen
    spectrogram model, each rank on its rows of the same seeded global
    batch (``dp`` without a group: the whole batch); each step's loss, the
    model's state after it and its launches; then the median time of
    DDP_REPEATS further steps."""
    n = DDP_WORLD * DDP_LOCAL_BATCH
    x, y = ddp_batch(n, SEED + 12)
    sx, labels = spec_clips(n, SEED + 13)
    sy = np.eye(60, dtype=np.float32)[labels]
    out = {}
    for name in list(DDP_STGCN) + ["spectrogram"]:
        g = torch.Generator().manual_seed(SEED)
        if name == "spectrogram":
            model = spectrogram.Model(
                num_classes=60, num_pad_frames=SPEC_UP, use_pallas=True,
                use_pallas_stft=True, device=device, generator=g)
            opt = RadarOptimizer(model.named_parameters(), SPEC_LR)
            fn = make_radar_train_step(model, opt, n, True, True,
                                       dp=dp if dp.active else None)
            step, data = (lambda xs, ys: fn(xs, ys)), (sx, sy)
        else:
            model = Model(num_classes=60, fused_sgcn=True, remat=False,
                          device=device, generator=g, **DDP_STGCN[name])
            fn = make_train_step(model, TFSGD(model.parameters(), 0.01), n,
                                 dp=dp if dp.active else None)
            step, data = (lambda xs, ys: fn(xs, ys, False)), (x, y)
        dp.broadcast_module(model)
        xs, ys = (torch.from_numpy(dp.local_rows(a)).to(device)
                  for a in data)
        before = {k: v.detach().cpu().clone()
                  for k, v in model.state_dict().items()}
        reset_launches()
        m = step(xs, ys)
        out[name] = {
            "loss": m["loss"].item(), "count": int(m["count"].item()),
            "launches": read_launches(COUNTERS), "before": before,
            "state": {k: v.detach().cpu().clone()
                      for k, v in model.state_dict().items()},
        }
        times = []
        for _ in range(DDP_REPEATS):
            start = time.perf_counter()
            step(xs, ys)["loss"].item()  # ends synchronized
            times.append(time.perf_counter() - start)
        out[name]["step_ms"] = 1e3 * statistics.median(times)
        del model, step, fn, xs, ys
        torch.cuda.empty_cache()
    return out


def ddp_rank(rank, init_file, out, device="cuda:0"):
    """One gloo rank of the ``ddp`` phase's (b) on ``device`` (every rank
    on card 0): joins the group through ``maybe_initialize_distributed``
    and saves :func:`ddp_steps`'s results to ``out``."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(DDP_WORLD),
                      LOCAL_RANK="0")
    check(distributed.maybe_initialize_distributed(
        "gloo", init_method=f"file://{init_file}"), "no process group")
    tf32_off()
    dp = DataParallel()
    check((dp.rank, dp.world_size) == (int(rank), DDP_WORLD),
          f"rank {dp.rank} of {dp.world_size}")
    torch.save(ddp_steps(torch.device(device), dp), out)
    dist.destroy_process_group()


def child(code, *args, env=None):
    """Start ``python3 -c code args...`` from the repository's root;
    returns the process, not waited for."""
    return subprocess.Popen(
        [sys.executable, "-c", code, *args],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        env={**os.environ, **(env or {})}, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
    )


def wait_all(procs, timeout=600):
    """Wait for ``procs``; raise with the output's tail if one failed."""
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        check(p.returncode == 0, f"child exited {p.returncode}:\n"
                                 f"{log[-4000:]}")
    return logs


def free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def degrees_between(a, b):
    cos = float((a @ b) / (a.norm() * b.norm()))
    return float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))


def ddp_compare(ranks, alone):
    """(b)'s checks: the ranks' states bit for bit alike and their global
    counts; against one process, the losses and states at the DDP_*
    tolerances. Returns the errors by configuration."""
    errors = {}
    for name, ref in alone.items():
        got = [r[name] for r in ranks]
        check(all(g["loss"] == got[0]["loss"] for g in got),
              f"{name}: the ranks' losses differ")
        check(all(g["count"] == DDP_WORLD * DDP_LOCAL_BATCH for g in got),
              f"{name}: counts {[g['count'] for g in got]}")
        for k, v in got[0]["state"].items():
            check(all(torch.equal(g["state"][k], v) for g in got[1:]),
                  f"{name}: {k} differs between the ranks")
        spec = name == "spectrogram"
        loss_err = abs(got[0]["loss"] - ref["loss"]) / abs(ref["loss"])
        check(loss_err <= (DDP_SPEC_LOSS_RTOL if spec else DDP_LOSS_RTOL),
              f"{name}: loss {got[0]['loss']} against {ref['loss']}")
        worst, stats_worst, radar = 0.0, 0.0, {}
        for k, want in ref["state"].items():
            have, init = got[0]["state"][k], ref["before"][k]
            if "radar_lambda" in k:
                rel = float(((have - init) / (want - init) - 1).abs())
                radar["lambda_step_rel_err"] = rel
                check(rel <= 1e-5, f"radar_lambda moved {have} for {want}")
            elif "radar_loc" in k:
                deg = degrees_between(have - init, want - init)
                radar["loc_step_degrees"] = deg
                check(deg <= 8.0, f"radar_loc moved {deg} degrees apart")
            elif "running" in k:
                stats_worst = max(stats_worst,
                                  float((have - want).abs().max()))
            else:
                worst = max(worst, float((have - want).abs().max()))
        atol = 2 * SPEC_LR + 1e-6 if spec else DDP_PARAM_ATOL
        check(worst <= atol, f"{name}: parameters {worst} from one process")
        check(stats_worst <= DDP_PARAM_ATOL,
              f"{name}: running statistics {stats_worst} from one process")
        errors[name] = {"loss_rel_err": loss_err, "param_max_abs_err": worst,
                        "param_atol": atol,
                        "running_stats_max_abs_err": stats_worst, **radar}
    return errors


def host_rates(tmp):
    """(c): TFRecord records/s of this host, in RAM and streamed, native
    and Python decode; data_gen records/s with the native and the Python
    parser, and the distance of their joint arrays."""
    rng = np.random.default_rng(SEED + 14)
    x = rng.normal(size=(DDP_HOST_CLIPS, 3, T, 25, 2)).astype(np.float32)
    d = os.path.join(tmp, "host")
    paths = tfrecord.write_dataset(x, rng.integers(0, 60, DDP_HOST_CLIPS),
                                   d, "h", num_shards=DDP_HOST_SHARDS)
    rates = {}

    def epoch(**kwargs):
        ds = TFRecordDataset(d, 64, shuffle=True, **kwargs)
        return sum(len(b) for b, _ in ds.batches())

    for name, fn in (
        ("in_ram_epoch", lambda: epoch()),
        ("stream_epoch", lambda: epoch(stream=True)),
        ("stream_epoch_reservoir_64", lambda: epoch(stream=True,
                                                   shuffle_buffer=64)),
        ("native_decode_one_thread",
         lambda: sum(len(tfrecord.decode_shard(p)[1]) for p in paths)),
        ("python_decode_one_thread",
         lambda: sum(len(tfrecord.decode_shard(p, use_native=False)[1])
                     for p in paths[:2])),
    ):
        n, seconds = timed(fn)
        rates[name] = n / seconds
    raw = os.path.join(tmp, "raw")
    corpus_lib.synthesize_corpus(raw, 1, seed=SEED, num_classes=60)
    read_xyz = skeleton.read_xyz
    joints = {}
    for route, use_native in (("native", True), ("python", False)):
        skeleton.read_xyz = functools.partial(read_xyz, use_native=use_native)
        try:
            out = os.path.join(tmp, route)
            _, seconds = timed(lambda: data_gen.main([
                "--data-path", raw, "--out-folder", out,
                "--ignored-sample-path", os.path.join(tmp, "none.txt"),
                "--benchmarks", "xview", "--streams", "joint",
                "--num-shards", "2",
            ]))
        finally:
            skeleton.read_xyz = read_xyz
        rates[f"data_gen_{route}"] = 60 / seconds
        joints[route] = np.concatenate([
            np.load(os.path.join(out, "xview", f"{part}_data_joint.npy"))
            for part in ("train", "val")])
    err = float(np.abs(joints["native"] - joints["python"]).max())
    check(err <= 1e-6, f"data_gen's routes differ by {err}")
    return rates, err


def phase_ddp(device, request):
    """Data parallelism: (a) ``main_gnn`` as torchrun starts it at world
    size 1 (NCCL) against two runs without a process group; (b) two gloo
    ranks on this card against one process; (c) the host's input rates;
    (d) ``Predictor`` with a replica twice on this card."""
    torch.cuda.empty_cache()
    laps, last = {}, [time.perf_counter()]

    def lap(name):  # the seconds since the last lap, by part
        now = time.perf_counter()
        laps[name], last[0] = now - last[0], now

    with tempfile.TemporaryDirectory() as tmp:
        dirs = write_cli_data(tmp, np.random.default_rng(SEED))

        def cli_run(label):
            """(a)'s child ``label``: a process group at world size 1
            (NCCL, torchrun's environment) for ``nccl_world_1``, none
            otherwise."""
            env = {}
            if label.startswith("nccl"):
                env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                           LOCAL_WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                           MASTER_PORT=str(free_port()))
            argv = ["--model", "stgcn", "--fused-sgcn",
                    "--batch-size", str(CLI_BATCH), "--num-epochs", "1",
                    "--base-lr", "0.01", "--train-data-path", dirs["train"],
                    "--test-data-path", dirs["val"],
                    "--log-dir", os.path.join(tmp, label)]
            return child("import sys, chip_smoke; "
                         "chip_smoke.ddp_cli_child(*sys.argv[1:])",
                         os.path.join(tmp, f"{label}.json"), "cuda", *argv,
                         env=env)

        # (b) first, the ranks while this process is idle; with them (a)'s
        # second plain run, whose losses alone are read
        init_file = os.path.join(tmp, "rendezvous")
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(DDP_WORLD)]
        wait_all([child(f"import chip_smoke; chip_smoke.ddp_rank({r}, "
                        f"{init_file!r}, {outs[r]!r})")
                  for r in range(DDP_WORLD)] + [cli_run("plain_2")])
        ranks = [torch.load(o, weights_only=False) for o in outs]
        alone = ddp_steps(device, DataParallel())
        errors = ddp_compare(ranks, alone)
        # the kernels each step must launch: #1-#5 between the two
        # configurations, and the spectrogram's forward and loc/lambda
        # backward
        launched = {k: sum(step["launches"][k] for step in ranks[0].values())
                    for k in COUNTERS}
        want = ("sgcn_fwd", "sgcn_fwd_stats", "sgcn_bwd", "tconv_fwd",
                "tconv_bwd", "radar_fwd", "radar_bwd_loc_lam", "stft_fwd",
                "stft_bwd")
        check(all(launched[k] > 0 for k in want),
              f"two-rank steps launched {launched}")
        emit("ddp_ranks", world=DDP_WORLD, backend="gloo",
             local_batch=DDP_LOCAL_BATCH, t=T, errors=errors,
             launches_rank0={n: ranks[0][n]["launches"] for n in ranks[0]},
             step_ms_rank0={n: ranks[0][n]["step_ms"] for n in ranks[0]},
             step_ms_one_process={n: alone[n]["step_ms"] for n in alone})
        del ranks, alone
        lap("b_ranks_and_plain_2")

        # (a): main_gnn under torchrun's environment at world size 1, and
        # without a group, one after the other (their step times compared)
        for label in ("plain_1", "nccl_world_1"):
            wait_all([cli_run(label)])
        runs = {}
        for label in ("plain_1", "nccl_world_1", "plain_2"):
            with open(os.path.join(tmp, f"{label}.json")) as f:
                runs[label] = json.load(f)
        check(runs["nccl_world_1"]["group"]
              and runs["nccl_world_1"]["backend"] == "nccl"
              and not runs["plain_1"]["group"], "the runs' groups")
        losses = {k: [h["train_loss"] for h in r["history"]]
                  for k, r in runs.items()}
        plain_equal = losses["plain_1"] == losses["plain_2"]
        check(losses["nccl_world_1"] == losses["plain_1"] if plain_equal
              else np.allclose(losses["nccl_world_1"], losses["plain_1"],
                               rtol=DDP_LOSS_RTOL),
              f"world size 1 against no group: {losses}")
        check(runs["nccl_world_1"]["launches"] == runs["plain_1"]["launches"],
              "the launches differ under the group")
        emit("ddp_world_1", backend="nccl", losses=losses,
             plain_runs_bit_equal=plain_equal,
             history={k: r["history"] for k, r in runs.items()},
             launches={k: r["launches"] for k, r in runs.items()},
             step_ms={k: runs[k]["step_ms"]
                      for k in ("plain_1", "nccl_world_1")},
             step_batch=DDP_LOCAL_BATCH)
        lap("a_world_1")

        # (c): the host
        rates, gen_err = host_rates(tmp)
        emit("ddp_host", host_cpu=host_cpu(), clips=DDP_HOST_CLIPS,
             shards=DDP_HOST_SHARDS, records_per_s=rates,
             data_gen_native_vs_python_max_abs=gen_err)
        lap("c_host")

    # (d): a replica twice on this card against one
    state = seeded_model("f32", True).state_dict()
    one = Predictor(seeded_model("f32", True, state), 64, device)
    two = Predictor(seeded_model("f32", True, state), 64,
                    devices=[device, device])
    want, got = one(request), two(request)
    times = {"one": [], "two": []}
    for i in range(5):
        for name, pred in (("one", one), ("two", two))[:: 1 - 2 * (i % 2)]:
            start = time.perf_counter()
            pred(request)
            times[name].append(time.perf_counter() - start)
    err = float(np.abs(got - want).max())
    emit("ddp_serving", devices=2, n=len(request), prob_max_abs_err=err,
         median_ms={k: 1e3 * statistics.median(v) for k, v in times.items()})
    check(err <= PROB_ATOL["f32"] and np.array_equal(
        got.argmax(-1), want.argmax(-1)),
        f"two replicas' probabilities {err} from one's")
    del one, two
    torch.cuda.empty_cache()
    lap("d_serving")
    emit("ddp_seconds", **laps)


# ---------------------------------------------------------------------------
# remat: the ST-GCN's remat policies (models/layers.py::remat_block) at the
# training shape

# (dtype, options, launches of one step with remat off): the CLI's default
# fusion (#1, #3 on the six wide blocks), and both fused training options on
# it (#2, #3 on the wide blocks, #4, #5 on the four narrow stride-1 ones)
REMAT_CONFIGS = {
    "bf16_fused_min128": (
        "bf16", dict(fused_sgcn=True, fused_sgcn_min_channels=128),
        {"sgcn_fwd": 6, "sgcn_bwd": 6}),
    "bf16_stats_tconv": (
        "bf16", dict(fused_sgcn=True, fused_sgcn_min_channels=128,
                     sgcn_stats=True, fused_tconv=True),
        {"sgcn_fwd_stats": 6, "sgcn_bwd": 6, "tconv_fwd": 4,
         "tconv_bwd": 4, "block_tail_fwd": 4, "block_tail_bwd": 4,
         "tconv_gue": 10}),
    "f32_fused_min128": (
        "f32", dict(fused_sgcn=True, fused_sgcn_min_channels=128),
        {"sgcn_fwd": 6, "sgcn_bwd": 6}),
}
REMAT_POLICIES = ("off", "full", "dots")
# the kernels a block's forward launches, which remat runs again in the
# backward under either policy
FORWARD_KERNELS = ("sgcn_fwd", "sgcn_fwd_stats", "tconv_fwd",
                   "block_tail_fwd")
# the first step's loss, gradient norm and running statistics under a
# policy against remat off, relative: the same computation, the recompute
# bit for bit where cuDNN's and the kernels' sums are (f32: the JAX
# package's remat test's 1e-5)
REMAT_TOL = {"f32": 1e-5, "bf16": 1e-3}


class ProductCounter(TorchDispatchMode):
    """Counts the matrix products (``layers.SAVED_PRODUCTS``: what F.linear
    and einsum lower to) that reach the dispatcher while it is on. Entered
    around a backward it sits below a selective-checkpoint context, which
    answers the products it keeps without running them: what it counts
    ran."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count += func in layers.SAVED_PRODUCTS
        return func(*args, **(kwargs or {}))


def remat_first_step(model, x, y):
    """One training-mode forward and backward of the cross-entropy: the
    loss, the gradients' norm, the gradients and running statistics, the
    products of the forward and of the backward, and the launches of
    #1-#5."""
    model.train()
    forward, backward = ProductCounter(), ProductCounter()
    reset_launches()
    with forward:
        loss = losses.total_loss(model(x), y, model, len(x))
    with backward:
        loss.backward()
    torch.cuda.synchronize()
    launches = read_launches(TRAIN_KERNELS)
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return {
        "loss": loss.item(),
        "grad_norm": torch.sqrt(sum((g.double() ** 2).sum()
                                    for g in grads.values())).item(),
        "grads": grads,
        "stats": {n: b.clone() for n, b in model.named_buffers()
                  if "running" in n},
        "products": (forward.count, backward.count), "launches": launches,
    }


def phase_remat(device):
    """The full-width NTU-60 ST-GCN (B=128, T=300, seeded weights) in each
    of ``REMAT_CONFIGS`` with remat off, "full" and "dots": the first
    step's loss, gradients and running statistics against remat off, the
    products the backward recomputes (none under "dots", every product of
    the blocks' forward under "full"), #1-#5's launches a step (a block's
    forward kernels twice under remat), then the median of 10 steps after 3
    warm-up in turns and each policy's peak memory (off > "dots" >=
    "full"). Returns the launches of the first steps by kernel."""
    rng = np.random.default_rng(SEED + 21)
    x = torch.from_numpy(rng.normal(size=(TRAIN_BATCH, 3, T, 25, 2)).astype(
        np.float32)).to(device)
    y = torch.nn.functional.one_hot(torch.from_numpy(
        rng.integers(0, 60, TRAIN_BATCH)), 60).float().to(device)
    total = dict.fromkeys(TRAIN_KERNELS, 0)
    for config, (name, options, base) in REMAT_CONFIGS.items():
        tol = REMAT_TOL[name]
        firsts, steps = {}, {}
        for policy in REMAT_POLICIES:
            model = Model(
                num_classes=60, dtype=DTYPES[name] if name == "bf16" else None,
                remat=policy != "off",
                remat_policy="full" if policy == "off" else policy,
                device=device, generator=torch.Generator().manual_seed(SEED),
                **options)
            firsts[policy] = remat_first_step(model, x, y)
            fn = make_train_step(model, TFSGD(model.parameters(), 0.01),
                                 TRAIN_BATCH)
            steps[policy] = (lambda fn=fn: fn(x, y, False)["loss"].item())
            for k, v in firsts[policy]["launches"].items():
                total[k] += v
        off = firsts["off"]
        fwd_products, bwd_products = off["products"]
        record = {}
        for policy in REMAT_POLICIES:
            got = firsts[policy]
            want_launches = {k: base.get(k, 0) * (
                2 if policy != "off" and k in FORWARD_KERNELS else 1)
                for k in TRAIN_KERNELS}
            check(got["launches"] == want_launches,
                  f"remat {config} {policy}: launched {got['launches']}, "
                  f"predicted {want_launches}")
            recomputed = got["products"][1] - bwd_products
            record[policy] = {
                "loss": got["loss"], "grad_norm": got["grad_norm"],
                "launches": got["launches"],
                "forward_products": got["products"][0],
                "recomputed_products": recomputed,
            }
            if policy == "off":
                continue
            loss_err = abs(got["loss"] - off["loss"]) / abs(off["loss"])
            norm_err = abs(got["grad_norm"] - off["grad_norm"]) / off[
                "grad_norm"]
            stats_err = max(rel_err(got["stats"][k], v)
                            for k, v in off["stats"].items())
            # each tensor's largest difference over the largest gradient
            # (a bias before a training-mode BatchNorm has a gradient at
            # rounding level, which repeats need not reproduce)
            grad_err = max((got["grads"][k] - v).abs().max().item()
                           for k, v in off["grads"].items()) / max(
                v.abs().max().item() for v in off["grads"].values())
            record[policy].update(
                loss_rel_err=loss_err, grad_norm_rel_err=norm_err,
                running_stats_rel_err=stats_err,
                stats_bit_equal=all(torch.equal(got["stats"][k], v)
                                    for k, v in off["stats"].items()),
                grad_max_rel_err=grad_err)
            check(loss_err <= tol and norm_err <= tol and stats_err <= tol,
                  f"remat {config} {policy} against off: loss {loss_err}, "
                  f"gradient norm {norm_err}, statistics {stats_err}")
            check(got["products"][0] == fwd_products,
                  f"remat {config} {policy}: {got['products'][0]} forward "
                  f"products, off {fwd_products}")
        # every block's products, which is all of the forward's but the
        # logits head's
        check(record["dots"]["recomputed_products"] == 0
              and record["full"]["recomputed_products"] == fwd_products - 1
              and fwd_products > 1,
              f"remat {config}: recomputed products "
              f"{ {p: r['recomputed_products'] for p, r in record.items()} }"
              f" of {fwd_products} in the forward")
        del firsts
        times = {p: [] for p in steps}
        losses_ = {p: [run() for _ in range(TRAIN_WARMUP)]
                   for p, run in steps.items()}
        for i in range(TRAIN_STEPS):  # in turns, reversed every other
            for p in REMAT_POLICIES[:: 1 if i % 2 == 0 else -1]:
                start = time.perf_counter()
                losses_[p].append(steps[p]())
                times[p].append(time.perf_counter() - start)
        peaks = {}
        for p, run in steps.items():
            torch.cuda.reset_peak_memory_stats()
            run()
            peaks[p] = torch.cuda.max_memory_allocated() / 1e9
            record[p].update(
                median_step_ms=1e3 * statistics.median(times[p]),
                min_step_ms=1e3 * min(times[p]),
                max_step_ms=1e3 * max(times[p]),
                clips_per_s=TRAIN_BATCH / statistics.median(times[p]),
                peak_gb=peaks[p], loss_last=losses_[p][-1])
            check(all(np.isfinite(losses_[p])),
                  f"remat {config} {p}: non-finite loss")
        emit("remat", config=config, dtype=name, batch=TRAIN_BATCH, t=T,
             steps=TRAIN_STEPS, tf32=False, policies=record)
        check(peaks["off"] > peaks["dots"] >= peaks["full"],
              f"remat {config}: peak memory {peaks}, predicted off > dots "
              f">= full")
        del steps
        torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# seqpar: the sequence-parallel radar ops (ops/virtual_radar.py) on gloo
# ranks on this one card

SEQPAR_WORLDS = (2, 4)
# radar_spectrogram_sharded's upsampling: 300 x 256 = 76,800 samples. At
# the trainer's 75,000 = 2^3 3 5^5 no count of ranks above 1 gives
# hop-aligned blocks (in JAX too)
SEQPAR_SPEC_UP = 256
SEQPAR_REPS = 3  # timed forward + backward passes a rank (median)
# the sharded spectrogram against one process: the JAX test's criterion on
# the above-median bins (tests/test_parallel.py:166-172); gradients through
# those bins alone, in norm (the f32 routes' gradients lie up to 3.1e-2
# from float64 there at lambda = 5e-4: tests/test_torch_seqpar_radar.py)
SEQPAR_SPEC_MAX, SEQPAR_SPEC_MEAN, SEQPAR_SPEC_GRAD_TOL = 0.15, 0.01, 5e-2
SEQPAR_KERNELS = DENSE_KERNELS + ("stft_fwd", "stft_bwd")


def rel_norm(p, q):
    return ((p.double() - q.double()).norm() / q.double().norm()).item()


def seqpar_pass(op, x, loc, lam, cotangents):
    """``op(x, loc, lam)`` and the gradients of ``sum(out * cotangent)``
    in the three; the outputs, gradients (each on the host) and the
    launches of the kernels."""
    xg, locg = x.clone().requires_grad_(), loc.clone().requires_grad_()
    lamg = torch.tensor(lam, device=x.device, requires_grad=True)
    reset_launches()
    out = op(xg, locg, lamg)
    sum((o * g).sum() for o, g in zip(out, cotangents)).backward()
    torch.cuda.synchronize()
    return {"out": [o.detach().cpu() for o in out],
            "grads": [t.grad.cpu() for t in (xg, locg, lamg)],
            "launches": read_launches(SEQPAR_KERNELS)}


def seqpar_inputs(device):
    """The phase's clips (the trainer's 16, T=300, 24 edges x 2 bodies),
    location, the two operators (x250, x256) and seeded cotangents of the
    return."""
    x = torch.from_numpy(spec_clips(SPEC_BATCH, SEED + 31)[0]).to(device)
    ops_ = {up: torch.from_numpy(resample.pad_frames_operator(
        SPEC_T, up)).to(device) for up in (SPEC_UP, SEQPAR_SPEC_UP)}
    g = torch.Generator(device=device).manual_seed(SEED + 32)
    t_out = SPEC_T * SPEC_UP
    cot = [torch.randn(SPEC_BATCH, t_out, generator=g, device=device)
           for _ in range(2)]
    loc = torch.tensor([0.1, -0.2, 0.3], device=device)
    return x, loc, ops_, cot


def stft_bases(device, dtype=torch.float32):
    return [torch.from_numpy(b).to(device, dtype)
            for b in stft.stft_basis(256, dtype=np.float64)]


def seqpar_runs(device, mask, group=None):
    """The sharded ops on this process's group (none: one process):
    ``radar_return_sharded`` forward and backward at both LAMBDAS, and
    ``radar_spectrogram_sharded`` at lambda 5e-4 with the cotangent
    ``mask`` (seeded normal on the reference's above-median bins), each
    pass's launches; then the median time of ``SEQPAR_REPS`` forward and
    backward passes of each op at lambda 5e-4."""
    x, loc, ops_, cot = seqpar_inputs(device)
    passes = {
        "return": (lambda a, b, c: virtual_radar.radar_return_sharded(
            a, ops_[SPEC_UP], b, c, group), cot),
        "spectrogram": (lambda a, b, c: (
            virtual_radar.radar_spectrogram_sharded(
                a, ops_[SEQPAR_SPEC_UP], b, c, group),), [mask.to(device)]),
    }
    out = {f"return_{lam}": seqpar_pass(passes["return"][0], x, loc, lam,
                                        cot) for lam in LAMBDAS}
    op, cots = passes["spectrogram"]
    out["spectrogram"] = seqpar_pass(op, x, loc, LAMBDAS[0], cots)
    for name, (op, cots) in passes.items():
        times = []
        for _ in range(SEQPAR_REPS):
            distributed.barrier()
            start = time.perf_counter()
            seqpar_pass(op, x, loc, LAMBDAS[0], cots)
            times.append(time.perf_counter() - start)
        out[f"{name}_ms"] = 1e3 * statistics.median(times)
    return out


def seqpar_rank(rank, world, init_file, mask_file, out, device="cuda:0"):
    """One gloo rank of the ``seqpar`` phase on ``device`` (every rank on
    card 0): joins the group and saves :func:`seqpar_runs`'s results to
    ``out``."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0")
    check(distributed.maybe_initialize_distributed(
        "gloo", init_method=f"file://{init_file}"), "no process group")
    tf32_off()
    check((distributed.rank(), distributed.world_size()) == (
        int(rank), int(world)), f"rank {distributed.rank()}")
    torch.save(seqpar_runs(torch.device(device),
                           torch.load(mask_file, weights_only=True)), out)
    dist.destroy_process_group()


def seqpar_reference(device):
    """One process without the sharded ops: ``radar_return_fused`` forward
    and backward at both LAMBDAS, and its return at x256 through
    ``stft_logmag`` (centered), whose above-median bins make the
    spectrogram's cotangent."""
    x, loc, ops_, cot = seqpar_inputs(device)
    ref = {f"return_{lam}": seqpar_pass(
        lambda a, b, c: radar.radar_return_fused(a, ops_[SPEC_UP], b, c),
        x, loc, lam, cot) for lam in LAMBDAS}
    cos, sin = stft_bases(device)

    def spectrogram(a, b, c):
        re, im = radar.radar_return_fused(a, ops_[SEQPAR_SPEC_UP], b, c)
        return (stft_logmag.stft_logmag(re, im, 16, cos, sin),)

    with torch.no_grad():
        spec = spectrogram(x, loc, torch.tensor(LAMBDAS[0], device=device))[0]
    g = torch.Generator(device=device).manual_seed(SEED + 33)
    mask = torch.randn(spec.shape, generator=g, device=device) * (
        spec > spec.median()).float()
    ref["spectrogram"] = seqpar_pass(spectrogram, x, loc, LAMBDAS[0], [mask])
    return ref, mask.cpu()


def seqpar_errors(got, ref):
    """The sharded results ``got`` against one process's ``ref``; raises
    past the tolerances."""
    errors = {}
    for lam in LAMBDAS:
        key = f"return_{lam}"
        fwd_tol, bwd_tol = RADAR_TOL[lam]
        fwd = max(rel_err(p, q) for p, q in zip(got[key]["out"],
                                                 ref[key]["out"]))
        bwd = dict(zip(("x", "loc", "lambda"), (
            rel_norm(p, q) for p, q in zip(got[key]["grads"],
                                           ref[key]["grads"]))))
        errors[key] = {"out_rel_err": fwd, "grad_rel_norm_err": bwd,
                       "tol": RADAR_TOL[lam]}
        check(fwd <= fwd_tol and max(bwd.values()) <= bwd_tol,
              f"seqpar {key}: return {fwd}, gradients {bwd}")
    s, r = got["spectrogram"]["out"][0], ref["spectrogram"]["out"][0]
    diff = (s - r).abs()[r > r.median()]
    grads = dict(zip(("x", "loc", "lambda"), (
        rel_norm(p, q) for p, q in zip(got["spectrogram"]["grads"],
                                       ref["spectrogram"]["grads"]))))
    errors["spectrogram"] = {
        "above_median_max": diff.max().item(),
        "above_median_mean": diff.mean().item(),
        "grad_rel_norm_err": grads}
    check(s.shape == r.shape and diff.max() < SEQPAR_SPEC_MAX
          and diff.mean() < SEQPAR_SPEC_MEAN
          and max(grads.values()) <= SEQPAR_SPEC_GRAD_TOL,
          f"seqpar spectrogram: {errors['spectrogram']}")
    return errors


def phase_seqpar(device):
    """``radar_return_sharded`` and ``radar_spectrogram_sharded`` at the
    trainer's shape in one process without a group, and on 2 and 4 gloo
    ranks on this card (child processes, ``file://`` rendezvous), against
    one process through ``radar_return_fused`` (and ``stft_logmag``): the
    results and gradients, the ranks alike bit for bit, #8/#9 once a rank
    a pass and #10/#11 once a rank a spectrogram pass, each rank's time
    (gloo through host memory on one card, not NCCL). Returns the launches
    of the compared passes, summed over every process, by kernel."""
    ref, mask = seqpar_reference(device)
    total = dict.fromkeys(SEQPAR_KERNELS, 0)
    want = {"return": {"radar_dense_fwd": 1, "radar_dense_bwd": 1,
                       "stft_fwd": 0, "stft_bwd": 0},
            "spectrogram": dict.fromkeys(SEQPAR_KERNELS, 1)}

    def tally(result, label):
        for key, run in result.items():
            if key.endswith("_ms"):
                continue
            predicted = want["spectrogram" if key == "spectrogram"
                             else "return"]
            check(run["launches"] == predicted,
                  f"seqpar {label} {key}: launched {run['launches']}, "
                  f"predicted {predicted}")
            for k, v in run["launches"].items():
                total[k] += v

    alone = seqpar_runs(device, mask)
    tally(alone, "one process")
    # without a group the op is radar_return_fused: the same bits where
    # the two calls' sums are (seqpar_errors holds it at RADAR_TOL)
    bit_equal = {lam: all(torch.equal(p, q) for p, q in zip(
        alone[f"return_{lam}"]["out"], ref[f"return_{lam}"]["out"]))
        for lam in LAMBDAS}
    emit("seqpar", world=1, group=None, n=SPEC_BATCH, t_in=SPEC_T,
         return_bit_equal_to_fused=bit_equal,
         t_out={"return": SPEC_T * SPEC_UP,
                "spectrogram": SPEC_T * SEQPAR_SPEC_UP},
         errors=seqpar_errors(alone, ref),
         launches={k: v["launches"] for k, v in alone.items()
                   if not k.endswith("_ms")},
         ms={"return": alone["return_ms"],
             "spectrogram": alone["spectrogram_ms"]},
         reference_ms_note="one process, no group")
    del alone
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        mask_file = os.path.join(tmp, "mask.pt")
        torch.save(mask, mask_file)
        for world in SEQPAR_WORLDS:
            init_file = os.path.join(tmp, f"rendezvous{world}")
            outs = [os.path.join(tmp, f"seqpar{world}_{r}.pt")
                    for r in range(world)]
            wait_all([child(f"import chip_smoke; chip_smoke.seqpar_rank("
                            f"{r}, {world}, {init_file!r}, {mask_file!r}, "
                            f"{outs[r]!r}, {str(device)!r})")
                      for r in range(world)])
            ranks = [torch.load(o, weights_only=False) for o in outs]
            for r, result in enumerate(ranks):
                tally(result, f"rank {r} of {world}")
                for key in (k for k in result if not k.endswith("_ms")):
                    check(all(torch.equal(p, q) for p, q in zip(
                        result[key]["out"] + result[key]["grads"],
                        ranks[0][key]["out"] + ranks[0][key]["grads"])),
                        f"seqpar: rank {r} of {world} differs from rank 0 "
                        f"on {key}")
            emit("seqpar", world=world, group="gloo", n=SPEC_BATCH,
                 t_in=SPEC_T, rows_per_rank={
                     "return": -(-SPEC_T * SPEC_UP // world),
                     "spectrogram": SPEC_T * SEQPAR_SPEC_UP // world},
                 errors=seqpar_errors(ranks[0], ref),
                 launches_rank0={k: v["launches"] for k, v in
                                 ranks[0].items() if not k.endswith("_ms")},
                 rank_ms={k: [r[f"{k}_ms"] for r in ranks]
                          for k in ("return", "spectrogram")},
                 rank_ms_note="gloo through host memory on one card, not "
                              "NCCL: a forward and backward each, median "
                              f"of {SEQPAR_REPS}")
            del ranks
    return total


# ---------------------------------------------------------------------------
# demo: examples/virtual_radar_demo_torch.py on synthetic inputs of the
# reference's shapes

DEMO_FRAMES = {"cmu_mocap": (200, 42), "simulated_gait": (200, 17),
               "ntu_example": (300, 25)}
# each spectrogram's stages: #8's return against its plain version on the
# same inputs (DEMO_RETURN_TOL), #10 against the float64 STFT of #8's own return (log|S| to
# STFT_ATOL on the above-median bins within DEMO_LOG_FLOOR of the largest,
# and |S| + eps to STFT_MAG_TOL of the largest); the whole route against
# the plain one and against float64, as magnitudes relative to the largest
# (two f32 routes round the positions apart, which the phase turns into up
# to 1.2e-2 of the return: tests/test_torch_demo.py). The floor: a smooth
# clip upsampled 550x has its median bin ~16 nats below its peak, where an
# f32 FFT's rounding (~1e-7 of a frame's energy) is the bin itself
# (torch.stft in f32 lies 0.24 from float64 there, and 3.4e-5 on the bins
# within 1e-3 of the largest: the demo's NTU input on the CPU)
DEMO_ROUTE_TOL = 2e-2
DEMO_LOG_FLOOR = float(np.log(1e3))
# #8 against its plain version: the demo's joints lie ~3 m from the radar
# (the trainer's clips ~0.5 m), where a position's f32 rounding (~2e-7 m)
# moves the phase by ~5e-3 rad at lambda 5e-4 (measured 4.8e-3 of the
# return's scale on the gait): ROUTE_TOL's 1e-2
DEMO_RETURN_TOL = ROUTE_TOL[5e-4]


def demo_module():
    """``examples/virtual_radar_demo_torch.py`` as a module."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples", "virtual_radar_demo_torch.py")
    spec = importlib.util.spec_from_file_location("radar_demo", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def demo_trajectories(t, v, g, device):
    """``(t, v, 3)`` smooth joint trajectories drawn on the card from ``g``:
    each joint about a rest position 3 m in front of the origin, moving
    along sinusoids of 0.1 m; float64 on the host."""
    rest = 0.4 * torch.randn(1, v, 3, generator=g, device=device,
                             dtype=torch.float64)
    rest[..., 2] += 3.0
    freq = 0.05 + 0.25 * torch.rand(1, v, 3, generator=g, device=device,
                                    dtype=torch.float64)
    phase = 2 * np.pi * torch.rand(1, v, 3, generator=g, device=device,
                                   dtype=torch.float64)
    steps = torch.arange(t, device=device, dtype=torch.float64)[:, None,
                                                                 None]
    return (rest + 0.1 * torch.sin(freq * steps + phase)).cpu().numpy()


def demo_plain(demo, data, edges, lam, pad, device, dtype):
    """The demo's route through the kernels' plain versions, in ``dtype``:
    the joint smoothing, ``dense_radar_reference`` against the cubic
    operator (with the gather and bone lengths of ``radar_return_fused``),
    ``stft_logmag_reference``; ``(spectrogram, (re, im))``."""
    x = torch.as_tensor(data, dtype=dtype, device=device)
    t, v, _ = x.shape
    g = torch.from_numpy(resample.gaussian_smooth_matrix(
        v, demo.SIGMA)).to(device, dtype)
    x5 = torch.einsum("vu,tuc->tvc", g, x).permute(2, 0, 1)[None, ..., None]
    w = torch.from_numpy(resample.cubic_interp_matrix(t, t * pad)).to(
        device, dtype)
    src, dst = radar.gather_features(x5, edges)
    c = radar.bone_length_mean_sq(x5, w, edges)
    re, im = radar.dense_radar_reference(
        w, src, dst, c, torch.zeros(3, dtype=dtype, device=device),
        torch.tensor(lam, dtype=dtype, device=device), w.shape[0])
    cos, sin = stft_bases(device, dtype)
    return stft_logmag.stft_logmag_reference(re, im, 16, cos, sin)[0], (
        re, im)


def magnitude_err(got, want):
    """Spectrograms as magnitudes |S| (log(|S| + eps) undone), max |diff|
    / max |want|."""
    got, want = got.double().exp() - 1e-6, want.double().exp() - 1e-6
    return ((got - want).abs().max() / want.abs().max()).item()


def phase_demo(device):
    """``examples/virtual_radar_demo_torch.py``'s ``main`` on synthetic
    inputs of the reference's shapes drawn on the card (CMU (200, 42, 3) in
    mm, gait (200, 17, 3), NTU (1, 3, 300, 25, 2): T_out 4,000, 2,000 and
    165,000): one launch of #8 and of #10 a spectrogram and no backward;
    each spectrogram's stages and route against the plain route and
    float64, the cubic operator's band widths, the scipy cross-check; and
    a synthetic Azure Kinect JSON through ``data.demo.load_azure_kinect``.
    Returns the launches of ``main``."""
    demo = demo_module()
    g = torch.Generator(device=device).manual_seed(SEED + 41)
    with tempfile.TemporaryDirectory() as tmp:
        frames = {k: demo_trajectories(t, v, g, device)
                  for k, (t, v) in DEMO_FRAMES.items()}
        np.save(os.path.join(tmp, "cmu_mocap.npy"),
                frames["cmu_mocap"] * 1000.0)
        np.save(os.path.join(tmp, "simulated_gait.npy"),
                frames["simulated_gait"])
        t_ntu = DEMO_FRAMES["ntu_example"][0]
        ntu = np.zeros((1, 3, t_ntu, 25, 2))
        ntu[0, ..., 0] = frames["ntu_example"].transpose(2, 0, 1)
        ntu[0, ..., 1] = demo_trajectories(t_ntu, 25, g, device).transpose(
            2, 0, 1)
        np.save(os.path.join(tmp, "NTU_preprocessed_skeleton_examples.npy"),
                ntu)
        reset_launches()
        results, seconds = timed(lambda: demo.main([
            "--data-root", tmp, "--out-dir", os.path.join(tmp, "out")]
            + (["--cpu"] if device.type == "cpu" else [])))
        launches = read_launches(SEQPAR_KERNELS)
        check(launches == {"radar_dense_fwd": 3, "radar_dense_bwd": 0,
                           "stft_fwd": 3, "stft_bwd": 0},
              f"the demo launched {launches}; predicted #8 and #10 once a "
              f"spectrogram")
        inputs = demo.load_inputs(tmp)
        records = {}
        for name, (_, edges, lam, pad) in demo.DEMOS.items():
            spec, (re, im) = demo.spectrogram(inputs[name], edges, lam, pad,
                                              device)
            plain, (p_re, p_im) = demo_plain(demo, inputs[name], edges, lam,
                                             pad, device, torch.float32)
            exact, _ = demo_plain(demo, inputs[name], edges, lam, pad,
                                  device, torch.float64)
            cos, sin = stft_bases(device, torch.float64)
            oracle = stft_logmag.stft_logmag_reference(
                re.double(), im.double(), 16, cos, sin)[0]
            above = (oracle > oracle.median()) & (
                oracle > oracle.max() - DEMO_LOG_FLOOR)
            stft_err = (spec.double() - oracle).abs()[above].max().item()
            stft_mag = magnitude_err(spec, oracle)
            return_err = max(rel_err(re, p_re), rel_err(im, p_im))
            t_out = re.shape[1]
            w = torch.from_numpy(resample.cubic_interp_matrix(
                len(inputs[name]), t_out).astype(np.float32)).to(device)
            _, band_record = band_stats(w, t_out)
            records[name] = {
                "shape": list(spec.shape), "t_out": t_out,
                "edge_body_pairs": len(edges), "lam": lam,
                "min": results[name].min().item(),
                "max": results[name].max().item(),
                "main_equals_route": bool(np.array_equal(
                    results[name], spec.cpu().numpy())),
                "return_vs_plain_rel_err": return_err,
                "stft_vs_f64_above_median_max_abs": stft_err,
                "stft_bins_held": above.double().mean().item(),
                "stft_vs_f64_magnitude_rel_err": stft_mag,
                "route_vs_plain_magnitude_rel_err": magnitude_err(spec,
                                                                  plain),
                "route_vs_f64_magnitude_rel_err": magnitude_err(spec, exact),
                "plain_vs_f64_magnitude_rel_err": magnitude_err(plain, exact),
                **band_record,
            }
            check(return_err <= DEMO_RETURN_TOL
                  and stft_err <= STFT_ATOL and stft_mag <= STFT_MAG_TOL
                  and records[name]["route_vs_plain_magnitude_rel_err"]
                  <= DEMO_ROUTE_TOL
                  and records[name]["route_vs_f64_magnitude_rel_err"]
                  <= DEMO_ROUTE_TOL
                  and bool(torch.isfinite(spec).all()),
                  f"demo {name}: {records[name]}")
            del spec, plain, exact, oracle, w, re, im, p_re, p_im
            torch.cuda.empty_cache()
        # an Azure Kinect recording: 30 frames, every fifth without a body
        rng = np.random.default_rng(SEED + 42)
        joints = rng.normal(0.0, 500.0, (30, 32, 3))
        doc = {"frames": [
            {"num_bodies": 0 if i % 5 == 0 else 1, "bodies": [] if i % 5 == 0
             else [{"joint_positions": joints[i].tolist()}]}
            for i in range(30)]}
        path = os.path.join(tmp, "kinect.json")
        with open(path, "w") as f:
            json.dump(doc, f)
        kinect, edges = data_demo.load_azure_kinect(path)
        kept = [i for i in range(30) if i % 5]
        check(kinect.shape == (24, 32, 3)
              and np.allclose(kinect, joints[kept] * 0.001, rtol=0,
                              atol=1e-12) and len(edges) == 26,
              f"load_azure_kinect gave {kinect.shape}")
    emit("demo", seconds=seconds, launches=launches,
         scipy_cross_check=dict(zip(("mean", "p99"),
                                    results["scipy_cross_check"])),
         spectrograms=records, azure_kinect_frames=int(kinect.shape[0]))
    return launches


def main():
    phase_env()
    device = torch.device("cuda", 0)
    laps, last = {}, [time.perf_counter()]

    def lap(name):  # the seconds since the last lap, by phase
        now = time.perf_counter()
        laps[name], last[0] = now - last[0], now

    phase_build()
    phase_sgcn_build()
    lap("build")
    totals = phase_kernel(device)
    bwd_totals = phase_kernel_bwd(device)
    ctrgc_totals, ctrgc_launches = phase_ctrgc_kernel(device)
    new_totals = {"sgcn_fwd_stats": phase_kernel_stats(device),
                  **phase_tconv_kernel(device),
                  **phase_block_tail_kernel(device), **ctrgc_totals}
    lap("kernels")
    rng = np.random.default_rng(SEED)
    requests = {
        n: rng.normal(size=(n, 3, T, 25, 2)).astype(np.float32)
        for n in REQUESTS
    }
    state, _ = phase_slice(device, requests)
    lap("slice")
    folded = folded_predictors(device, state)
    phase_latency(device, state, requests[64], folded)
    lap("latency")
    phase_export(device, state, requests, folded)
    del folded
    torch.cuda.empty_cache()
    lap("export")
    train_launches = phase_train(device)
    lap("train")
    launches = phase_cli(device)
    torch.cuda.empty_cache()
    tf32_off()
    lap("cli")
    phase_ddp(device, requests[64])
    lap("ddp")
    phase_radar_build()
    spec_totals, (re, im) = phase_radar_kernel(device)
    dense_totals = phase_radar_dense_kernel(device)
    spec_totals.update(phase_stft_kernel(device, re, im))
    del re, im
    lap("radar_stft_kernels")
    phase_spec_train(device)
    spec_launches = phase_spec_cli(device)
    lap("spec_train_cli")
    phase_eval_path(device)
    lap("eval_path")
    phase_zoo(device, requests[64])
    lap("zoo")
    tf32_off()
    remat_launches = phase_remat(device)
    lap("remat")
    seqpar_launches = phase_seqpar(device)
    lap("seqpar")
    demo_launches = phase_demo(device)
    lap("demo")
    emit("seconds", **laps)
    # #7's entry counts both instances; the loc/lambda one's count beside
    loc_lam = spec_launches.pop("radar_bwd_loc_lam")
    spec_totals["radar_bwd"]["loc_lam_launches"] = loc_lam
    spec_launches["radar_bwd"] += loc_lam
    # each kernel's launches by main path, each counted from 0; "launches"
    # is their sum
    by_path = {name: {} for name in COUNTERS if name != "radar_bwd_loc_lam"}
    for path, counts in (("cli", launches), ("train", train_launches),
                         ("spec_cli", spec_launches),
                         ("radar_dense_path", {
                             k: dense_totals[k]["launches"]
                             for k in DENSE_KERNELS}),
                         ("remat", remat_launches),
                         ("ctrgcn_train", ctrgc_launches),
                         ("seqpar", seqpar_launches), ("demo", demo_launches)):
        for name, n in counts.items():
            if name in by_path and n:
                by_path[name][path] = n
    # the earlier rows' paths: #1 and #3 from cli, #2, #4, #5 from train
    by_path["sgcn_fwd"].pop("train", None)
    by_path["sgcn_bwd"].pop("train", None)
    rows = [
        {"name": "sgcn_fwd", "route": "cuda", "source": SGCN_SOURCE,
         "replaces": SGCN_REPLACES, **totals},
        {"name": "sgcn_bwd", "route": "cuda", "source": SGCN_BWD_SOURCE,
         "replaces": SGCN_BWD_REPLACES, **bwd_totals},
    ] + [
        {"name": name, "route": "cuda",
         "source": f"skeleton_action_recognition_tpu_torch/csrc/{name}.cu",
         "replaces": KERNEL_REPLACES[name], **spec_totals[name]}
        for name in SPEC_KERNELS
    ] + [
        {"name": name, "route": "cuda",
         "source": KERNEL_SOURCES.get(
             name, f"skeleton_action_recognition_tpu_torch/csrc/{name}.cu"),
         "replaces": KERNEL_REPLACES[name], **new_totals[name]}
        for name in ("sgcn_fwd_stats", "tconv_fwd", "tconv_bwd",
                     *TAIL_KERNELS, *CTRGC_KERNELS)
    ] + [
        {"name": name, "route": "cuda",
         "source": f"skeleton_action_recognition_tpu_torch/csrc/{name}.cu",
         "replaces": KERNEL_REPLACES[name], **dense_totals[name]}
        for name in DENSE_KERNELS
    ]
    for row in rows:
        row["launches"] = sum(by_path[row["name"]].values())
        row["launches_by_path"] = by_path[row["name"]]
    print(json.dumps({"kernels": rows}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
