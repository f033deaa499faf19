#!/usr/bin/env python3
"""On-GPU smoke check of the PyTorch port (``skeleton_action_recognition_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It imports no jax. Each phase prints one JSON line; a failed check raises,
so the exit code is not 0.

1. ``env``: the card, its power limit, torch and CUDA versions. Without a
   CUDA device the script stops here (it never falls back to the CPU).
2. ``build``: compiles ``csrc/sgcn_fwd.cu`` for ``sm_90a`` from the
   checkout (seconds, and the compiler's register/shared-memory report).
3. ``kernel``: the CUDA spatial graph-conv kernel against its plain PyTorch
   version at the six (T, C_in, C_out) shapes of the ten ST-GCN blocks, at
   NM=128 (64 clips x 2 bodies), in f32 and bf16: error and CUDA-event
   times of both.
4. ``slice``: the full-width NTU-60 ST-GCN (T=300) from seeded random
   weights and BatchNorm statistics, behind ``Predictor(max_batch=64)``.
   Requests of 1, 7 and 64 clips: every row finite and summing to 1, ten
   kernel launches per request, agreement with the same weights unfused.
5. ``latency``: the 64-clip request, fused and unfused, in f32 and bf16,
   timed in turns on the host clock (the predictor returns numpy, so each
   request ends synchronized).

Then the kernels line (``ms``/``plain_ms``: f32 time of the ten spatial
convs of one 64-clip request, summed over the blocks), the card's name and
power limit as ``nvidia-smi`` prints them, and the result line.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import numpy as np
import torch

from skeleton_action_recognition_tpu_torch.graphs.ntu_rgb_d import (
    spatial_adjacency,
)
from skeleton_action_recognition_tpu_torch.models import layers
from skeleton_action_recognition_tpu_torch.models.stgcn import Model
from skeleton_action_recognition_tpu_torch.ops import build, sgcn
from skeleton_action_recognition_tpu_torch.serving import Predictor

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
SGCN_SOURCE = "skeleton_action_recognition_tpu_torch/csrc/sgcn_fwd.cu"
SGCN_REPLACES = "skeleton_action_recognition_tpu/ops/pallas/sgcn.py:90"


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
    start = time.perf_counter()
    lib = build.library_path("sgcn_fwd.cu")
    build.load_library("sgcn_fwd.cu")
    emit(
        "build", source=SGCN_SOURCE, seconds=time.perf_counter() - start,
        ptxas=lib.with_suffix(".log").read_text().strip().splitlines(),
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


def main():
    phase_env()
    device = torch.device("cuda", 0)
    phase_build()
    totals = phase_kernel(device)
    rng = np.random.default_rng(SEED)
    requests = {
        n: rng.normal(size=(n, 3, T, 25, 2)).astype(np.float32)
        for n in REQUESTS
    }
    state, launches = phase_slice(device, requests)
    phase_latency(device, state, requests[64])
    print(json.dumps({"kernels": [{
        "name": "sgcn_fwd", "route": "cuda", "source": SGCN_SOURCE,
        "replaces": SGCN_REPLACES, "launches": launches, **totals,
    }]}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
