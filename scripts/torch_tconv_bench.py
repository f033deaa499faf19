#!/usr/bin/env python3
"""Time the fused temporal chain's kernels (#4 forward, #5 backward) on the
card, beside cuDNN's conv and the plain versions.

Run from the repository root on a machine with a CUDA card:

    PYTHONPATH=. python scripts/torch_tconv_bench.py [f32|bf16 ...]
    PYTHONPATH=. python scripts/torch_tconv_bench.py variants [f32|bf16]

For each of ``chip_smoke.py``'s three stride-1 shapes (T, C) at NM=256 it
prints one JSON line: CUDA-event times (mean of 20 calls after 3) of the
kernels, of cuDNN's 9x1 ``F.conv2d`` and ``convolution_backward``, the
bound, and the device time of each CUDA kernel of one backward call by
name (``torch.profiler``: #5's input-gradient tile kernel and its dW
kernel apart, in either dtype); then the times summed over the eight blocks
(four of (300, 64), two each of (150, 128) and (75, 256)) and the card's
name and power limit. The inputs are ``chip_smoke.tconv_inputs``'s.

``variants`` builds copies of ``csrc/`` with the source substitutions of
``VARIANTS`` (one ``nvcc`` each, all at once, with ``ops/build.py``'s
flags) and times each build's kernels of one dtype (bf16 unless named)
the same way, through the wrapper, with its registers and spills and its
largest error against the plain versions. A tool for redesigning the
kernels: the port never loads these builds (a variant that changes a
tiling the wrapper sizes its workspaces by needs that constant of
``ops/tconv.py`` set to match while it is timed).
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import shutil
import subprocess
import sys
import tempfile

import torch
import torch.nn.functional as F

import chip_smoke
from skeleton_action_recognition_tpu_torch.ops import build, tconv

SOURCES = ("tconv_fwd.cu", "tconv_bwd.cu")
# name -> [(file under csrc/, text, replacement)], each against the sources
# of the checkout
TILE, BWD = "tconv_tile.cuh", "tconv_bwd.cu"
VARIANTS = {
    "as built": [],
    "probe, f32 tile: no staging after the first chunk (wrong results)": [
        (TILE, "const bool more = i + 1 < chunks;",
         "const bool more = false;")],
    "probe, f32 dW: no staging after the first chunk (wrong results)": [
        (BWD, "const bool more = x + 1 < chunks;",
         "const bool more = false;")],
}


def backward_by_kernel(args, steps=5):
    """Device ms of each CUDA kernel of one backward call, by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            tconv.affine_relu_tconv_backward(*args)
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3 / steps
    return by_name


def time_shapes(names, device, g, errors=False):
    """The JSON lines of each shape and the eight blocks' totals."""
    for name in names:
        dtype = chip_smoke.DTYPES[name]
        totals = dict.fromkeys(("fwd_ms", "fwd_cudnn_ms", "bwd_ms",
                                "bwd_cudnn_ms", "fwd_bound_ms",
                                "bwd_bound_ms"), 0.0)
        for (t, c), blocks in chip_smoke.TCONV_SHAPES:
            s, scale, shift, w, b, gue = chip_smoke.tconv_inputs(
                t, c, dtype, device, g)
            fwd_args, bwd_args = (s, scale, shift, w, b), (s, scale, shift,
                                                          w, gue)
            x, gy = s.permute(0, 3, 1, 2), gue.permute(0, 3, 1, 2)
            wd, bd = w.to(dtype), b.to(dtype)
            rows = chip_smoke.TRAIN_NM * t * 25
            got = tconv.affine_relu_tconv(*fwd_args)
            got_bwd = tconv.affine_relu_tconv_backward(*bwd_args)
            record = {
                "fwd_ms": chip_smoke.cuda_ms(
                    lambda: tconv.affine_relu_tconv(*fwd_args)),
                "fwd_cudnn_ms": chip_smoke.cuda_ms(
                    lambda: F.conv2d(x, wd, bd, padding=(4, 0))),
                "bwd_ms": chip_smoke.cuda_ms(
                    lambda: tconv.affine_relu_tconv_backward(*bwd_args)),
                "bwd_cudnn_ms": chip_smoke.cuda_ms(
                    lambda: torch.ops.aten.convolution_backward(
                        gy, x, wd, [c], [1, 1], [4, 0], [1, 1], False,
                        [0, 0], 1, [True, True, True])),
                "fwd_bound_ms": chip_smoke.bound(
                    chip_smoke.tconv_flops(rows, c),
                    chip_smoke.nbytes(*fwd_args, *got), name)[0],
                "bwd_bound_ms": chip_smoke.bound(
                    chip_smoke.tconv_flops(rows, c, backward=True),
                    chip_smoke.nbytes(*bwd_args, *got_bwd), name)[0],
            }
            for k, v in record.items():
                totals[k] += blocks * v
            if errors:
                want = (tconv.affine_relu_tconv_reference(*fwd_args)
                        + tconv.affine_relu_tconv_backward_reference(
                            *bwd_args))
                record["rel_err"] = max(chip_smoke.rel_err(p, q)
                                        for p, q in zip(got + got_bwd, want))
            print(json.dumps({
                "dtype": name, "t": t, "c": c, "nm": chip_smoke.TRAIN_NM,
                **record, "bwd_by_kernel_ms": backward_by_kernel(bwd_args),
            }), flush=True)
            del s, gue, x, gy, got, got_bwd
            torch.cuda.empty_cache()
        print(json.dumps({"dtype": name, "eight_blocks": totals}),
              flush=True)


def variants(device, dtype_name):
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for i, (name, subs) in enumerate(VARIANTS.items()):
            src_dir = pathlib.Path(tmp) / str(i)
            shutil.copytree(build.CSRC_DIR, src_dir)
            for fname, old, new in subs:
                path = src_dir / fname
                text = path.read_text()
                if old not in text:
                    raise ValueError(f"{name}: {old!r} not in {fname}")
                path.write_text(text.replace(old, new))
            procs[name] = [subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, "-o",
                 str(src_dir / f"{source}.so"), str(src_dir / source)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for source in SOURCES]
        kernel = tconv._kernel
        try:
            for i, (name, pair) in enumerate(procs.items()):
                log = "".join(proc.communicate()[0] for proc in pair)
                if any(proc.returncode for proc in pair):
                    raise RuntimeError(f"{name}: nvcc failed\n{log}")
                libs = {source: ctypes.CDLL(
                    str(pathlib.Path(tmp) / str(i) / f"{source}.so"))
                    for source in SOURCES}

                def variant_kernel(source, n_pointers, n_ints, dtype,
                                   libs=libs):
                    suffix = "f32" if dtype == torch.float32 else "bf16"
                    fn = getattr(libs[source],
                                 f"{source.removesuffix('.cu')}_{suffix}")
                    fn.argtypes = ([ctypes.c_void_p] * n_pointers
                                   + [ctypes.c_int] * n_ints
                                   + [ctypes.c_void_p])
                    fn.restype = ctypes.c_int
                    return fn

                tconv._kernel = variant_kernel
                print(json.dumps({"variant": name, "ptxas": [
                    line.split("'")[1] if "entry function" in line
                    else line.split(":")[-1].strip()
                    for line in log.splitlines()
                    if "entry function" in line or "Used" in line
                    or "spill" in line]}), flush=True)
                g = torch.Generator(device=device).manual_seed(
                    chip_smoke.SEED + 7)
                time_shapes([dtype_name], device, g, errors=True)
        finally:
            tconv._kernel = kernel


def main(args):
    chip_smoke.phase_env()  # raises without a card
    device = torch.device("cuda", 0)
    if args[:1] == ["variants"]:
        variants(device, args[1] if len(args) > 1 else "bf16")
    else:
        g = torch.Generator(device=device).manual_seed(chip_smoke.SEED + 7)
        time_shapes(args or ["bf16"], device, g)
    print(chip_smoke.nvidia_smi_line())


if __name__ == "__main__":
    main(sys.argv[1:])
