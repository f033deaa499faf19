#!/usr/bin/env python3
"""On-GPU smoke check of the PyTorch port (``skeleton_action_recognition_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It imports no jax. Each phase prints one JSON line; a failed check raises,
so the exit code is not 0.

1. ``env``: the card, its power limit, torch and CUDA versions. Without a
   CUDA device the script stops here (it never falls back to the CPU).
2. ``build``: compiles ``csrc/sgcn_fwd.cu`` and ``csrc/sgcn_bwd.cu`` for
   ``sm_90a`` from the checkout, one ``nvcc`` each, at once (seconds, and
   the compiler's register/shared-memory reports).
3. ``kernel``: the CUDA spatial graph-conv kernel against its plain PyTorch
   version at the six (T, C_in, C_out) shapes of the ten ST-GCN blocks, at
   NM=128 (64 clips x 2 bodies), in f32 and bf16: error and CUDA-event
   times of both.
4. ``kernel_bwd``: the backward kernel against its plain version at the
   six shapes, NM=256 (the 128-clip training batch), f32 and bf16: the
   relative error of dx, dW and db, two launches bit for bit, CUDA-event
   times of both.
5. ``slice``: the full-width NTU-60 ST-GCN (T=300) from seeded random
   weights and BatchNorm statistics, behind ``Predictor(max_batch=64)``.
   Requests of 1, 7 and 64 clips: every row finite and summing to 1, ten
   kernel launches per request, agreement with the same weights unfused.
6. ``latency``: the 64-clip request, fused and unfused, in f32 and bf16,
   timed in turns on the host clock (the predictor returns numpy, so each
   request ends synchronized).
7. ``train``: training steps of the full-width ST-GCN at the JAX bench's
   shape (B=128, T=300, remat off), the spatial conv fused on every block
   and unfused, timed in turns (20 steps after 3 warm-up, each ending
   synchronized), in bf16 and in f32 with TF32 off (B=128 if it fits,
   else 64 or 32): step time, clips/s, peak memory; the loss finite and
   falling; exactly 10 forward and 10 backward launches a fused step. Then
   a profiler trace of 3 fused bf16 steps: device time by kernel name and
   the device's idle share.
8. ``cli``: ``cli.main_gnn.main`` on a seeded synthetic TFRecord set
   (T=300, 60 classes, 48 training and 16 test clips, written with the
   port's writer), ``--fused-sgcn --fused-sgcn-min-channels 0``, default
   remat, 2 epochs and then ``--resume`` for a third: the checkpoints, the
   resumed epoch, finite losses and accuracies, and launch counts equal to
   the prediction (20 forward and 10 backward a train step with remat, 10
   forward an eval batch). Also the TFRecord decode rate of this host.

Then the kernels line (``sgcn_fwd`` ``ms``/``plain_ms``: f32 time of the
ten spatial convs of one 64-clip request; ``sgcn_bwd``: f32 time of their
ten backwards at NM=256; ``launches``: the counts of the ``cli`` run, the
training main path), the card's name and power limit as ``nvidia-smi``
prints them, and the result line.
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

import numpy as np
import torch

from skeleton_action_recognition_tpu_torch.cli import main_gnn
from skeleton_action_recognition_tpu_torch.data import tfrecord
from skeleton_action_recognition_tpu_torch.data.pipeline import (
    TFRecordDataset,
)
from skeleton_action_recognition_tpu_torch.graphs.ntu_rgb_d import (
    spatial_adjacency,
)
from skeleton_action_recognition_tpu_torch.models import layers
from skeleton_action_recognition_tpu_torch.models.stgcn import Model
from skeleton_action_recognition_tpu_torch.ops import build, sgcn
from skeleton_action_recognition_tpu_torch.serving import Predictor
from skeleton_action_recognition_tpu_torch.train.optim import TFSGD
from skeleton_action_recognition_tpu_torch.train.steps import make_train_step

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
SOURCES = ("sgcn_fwd.cu", "sgcn_bwd.cu")
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
TRAIN_STEPS, TRAIN_WARMUP = 20, 3
PROFILE_STEPS = 3
CLI_CLIPS = {"train": 48, "val": 16}
CLI_BATCH = 16


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


def phase_env():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing was run")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
    totals = {"ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0}
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
            emit(
                "kernel", dtype=name, nm=NM, t=t, c_in=c_in, c_out=c_out,
                max_abs_err=abs_err, rel_err=rel_err,
                rel_tol=KERNEL_REL_TOL[name], ms=ms, plain_ms=plain_ms,
            )
            check(
                rel_err <= KERNEL_REL_TOL[name],
                f"sgcn kernel disagrees at {name} {(t, c_in, c_out)}: "
                f"rel err {rel_err}",
            )
            if name == "f32":
                totals["ms"] += blocks * ms
                totals["plain_ms"] += blocks * plain_ms
                totals["max_abs_err"] = max(totals["max_abs_err"], abs_err)
            del x, out, ref
    return totals


def phase_kernel_bwd(device):
    a = torch.from_numpy(spatial_adjacency()).to(device)
    g = torch.Generator(device=device).manual_seed(SEED + 1)
    totals = {"ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0}
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
                ms=ms, plain_ms=plain_ms,
            )
            check(bit_identical, f"sgcn_bwd repeats differ at {name} "
                  f"{(t, c_in, c_out)}")
            check(
                all(e <= tol for e, tol in zip(rel_err, BWD_REL_TOL[name])),
                f"sgcn_bwd disagrees at {name} {(t, c_in, c_out)}: "
                f"rel err {rel_err}",
            )
            if name == "f32":
                totals["ms"] += blocks * ms
                totals["plain_ms"] += blocks * plain_ms
                totals["max_abs_err"] = max(totals["max_abs_err"], *abs_err)
            del x, gout
            torch.cuda.empty_cache()
    return totals


def seeded_model(name, fused, state=None):
    """Full-width NTU-60 ST-GCN computing in ``name`` ("f32" or "bf16").
    Without ``state``: CONV_INIT weights from the seed, and BatchNorm
    affines, running statistics and every bias redrawn from it, so that
    eval-mode BatchNorm and the bias paths do real work."""
    g = torch.Generator().manual_seed(SEED)
    model = Model(
        num_classes=60, dtype=torch.bfloat16 if name == "bf16" else None,
        fused_sgcn=fused, fused_sgcn_min_channels=0, generator=g,
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
    emit(
        "slice", requests=list(requests), launches=launches,
        launches_per_request=per_request, prob_max_abs_err=errors,
        prob_atol=PROB_ATOL, top_prob_n64=float(probs[64].max(-1).mean()),
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


def reset_launches():
    sgcn.fused_graph_conv.launches = 0
    sgcn.fused_graph_conv_backward.launches = 0


def read_launches():
    return {
        "sgcn_fwd": sgcn.fused_graph_conv.launches,
        "sgcn_bwd": sgcn.fused_graph_conv_backward.launches,
    }


def train_runs(device, name, batch):
    """``{fused: step}`` closures training the full-width model, one fused
    on every block and one unfused, from the same seed, each on its own
    fixed batch of seeded noise. Each closure keeps, in ``.saved_mb``, the
    device memory allocated when its last backward began (parameters,
    optimizer state and the activations saved for the backward)."""
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(
        rng.normal(size=(batch, 3, T, 25, 2)).astype(np.float32)
    ).to(device)
    y = torch.nn.functional.one_hot(
        torch.from_numpy(rng.integers(0, 60, batch)), 60
    ).float().to(device)
    runs = {}
    for fused in (False, True):
        model = Model(
            num_classes=60,
            dtype=torch.bfloat16 if name == "bf16" else None,
            fused_sgcn=fused, fused_sgcn_min_channels=0, remat=False,
            device=device, generator=torch.Generator().manual_seed(SEED),
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
        runs[fused] = run
    return runs


def time_training(device, name, batch):
    runs = train_runs(device, name, batch)
    losses = {fused: [run() for _ in range(TRAIN_WARMUP)]
              for fused, run in runs.items()}
    times = {fused: [] for fused in runs}
    reset_launches()
    for i in range(TRAIN_STEPS):  # in turns, the order reversed every other
        for fused in (False, True) if i % 2 == 0 else (True, False):
            start = time.perf_counter()
            losses[fused].append(runs[fused]())
            times[fused].append(time.perf_counter() - start)
    launches = read_launches()
    check(
        launches == {"sgcn_fwd": 10 * TRAIN_STEPS,
                     "sgcn_bwd": 10 * TRAIN_STEPS},
        f"{name} training launched {launches}, not 10 + 10 a step",
    )
    for fused, samples in times.items():
        torch.cuda.reset_peak_memory_stats()
        runs[fused]()
        loss = losses[fused]
        med = statistics.median(samples)
        emit(
            "train", dtype=name, fused_sgcn=fused, batch=batch, t=T,
            remat=False, steps=len(samples), median_step_ms=1e3 * med,
            min_step_ms=1e3 * min(samples), max_step_ms=1e3 * max(samples),
            clips_per_s=batch / med,
            peak_mem_mb=torch.cuda.max_memory_allocated() / 2**20,
            backward_start_mem_mb=runs[fused].saved_mb,
            loss_first=loss[0], loss_last=loss[-1],
            launches_timed=launches if fused else None,
        )
        check(all(np.isfinite(loss)), f"non-finite {name} training loss")
        check(
            np.mean(loss[-5:]) < np.mean(loss[:5]),
            f"{name} training loss did not fall: {loss}",
        )
    return runs


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
    runs = time_training(device, "bf16", TRAIN_BATCH)
    emit("profile", dtype="bf16", fused_sgcn=True, batch=TRAIN_BATCH,
         steps=PROFILE_STEPS, **device_profile(runs[True], PROFILE_STEPS))
    del runs
    torch.cuda.empty_cache()
    for batch in (TRAIN_BATCH, 64, 32):  # f32 at the largest that fits
        try:
            time_training(device, "f32", batch)
            return
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


def main():
    phase_env()
    device = torch.device("cuda", 0)
    phase_build()
    totals = phase_kernel(device)
    bwd_totals = phase_kernel_bwd(device)
    rng = np.random.default_rng(SEED)
    requests = {
        n: rng.normal(size=(n, 3, T, 25, 2)).astype(np.float32)
        for n in REQUESTS
    }
    state, _ = phase_slice(device, requests)
    phase_latency(device, state, requests[64])
    phase_train(device)
    launches = phase_cli(device)
    print(json.dumps({"kernels": [
        {"name": "sgcn_fwd", "route": "cuda", "source": SGCN_SOURCE,
         "replaces": SGCN_REPLACES, "launches": launches["sgcn_fwd"],
         **totals},
        {"name": "sgcn_bwd", "route": "cuda", "source": SGCN_BWD_SOURCE,
         "replaces": SGCN_BWD_REPLACES, "launches": launches["sgcn_bwd"],
         **bwd_totals},
    ]}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
