#!/usr/bin/env python3
"""Time the fused spatial graph conv's kernels (#1 forward, #2 forward with
statistics, #3 backward) on the card, beside cuBLAS and the plain versions.

Run from the repository root on a machine with a CUDA card:

    PYTHONPATH=. python scripts/torch_sgcn_bench.py [f32|bf16 ...]
    PYTHONPATH=. python scripts/torch_sgcn_bench.py variants [f32|bf16]
    PYTHONPATH=. python scripts/torch_sgcn_bench.py ab PARENT [f32|bf16]

For each of ``chip_smoke.py``'s six block shapes it prints one JSON line:
CUDA-event times (mean of 20 calls after 3) of #1 at NM=128 (a 64-clip
request), #2 and #3 at NM=256 (the 128-clip training batch), of the plain
versions and of cuBLAS's share of the work alone (``F.linear``; the two
products on a materialized dz), the largest relative error against the
plain versions, and the device time of each CUDA kernel of one #3 call by
name (``torch.profiler``: the dx kernel, the dW kernel and the reduces
apart); then the times summed over the ten blocks and the card's name and
power limit.

``variants`` builds copies of ``csrc/`` with the source substitutions of
``VARIANTS`` (one ``nvcc`` each, all at once, with ``ops/build.py``'s
flags) and times each build's kernels the same way, through the wrapper,
with its registers and spills. The port never loads these builds.

``ab PARENT`` times the kernels of the checkout at ``PARENT`` (unpacked
with ``git archive`` into a directory that ``.gitignore`` lists) and of
this one, in turns: parent, this, this, parent, each in its own process.
"""

from __future__ import annotations

import ctypes
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile

import torch
import torch.nn.functional as F

import chip_smoke
from skeleton_action_recognition_tpu_torch.graphs.ntu_rgb_d import (
    spatial_adjacency,
)
from skeleton_action_recognition_tpu_torch.ops import build, sgcn

SOURCES = ("sgcn_fwd.cu", "sgcn_bwd.cu")
# name -> [(file under csrc/, text, replacement[, times it occurs, 1 if
# not given])], each against the sources of the checkout
TILE = "sgcn_tile_f32.cuh"
DX_DZ = "for (int e = tid; e < KV * (DX_OC / 4); e += DX_THREADS) {"
DW_DZ = "for (int e = tid; e < KV * (DW_OC / 4); e += DW_THREADS) {"
VARIANTS = {
    "as built": [],
    "forward: 64 output channels, chunks of 32, one block an SM": [
        (TILE, "FWD_CO = 32;", "FWD_CO = 64;"),
        (TILE, "FWD_KC = 16;", "FWD_KC = 32;"),
        (TILE, "FWD_STAGES = 3;", "FWD_STAGES = 2;"),
        (TILE, "FWD_BLOCKS = 2;", "FWD_BLOCKS = 1;")],
    "forward: 64 output channels, one block an SM": [
        (TILE, "FWD_CO = 32;", "FWD_CO = 64;"),
        (TILE, "FWD_BLOCKS = 2;", "FWD_BLOCKS = 1;")],
    "probe: dx computes no dz (wrong results)": [
        (TILE, DX_DZ, DX_DZ.replace("KV * (DX_OC / 4)", "0"))],
    "probe: dW computes no dz (wrong results)": [
        (TILE, DW_DZ, DW_DZ.replace("KV * (DW_OC / 4)", "0"))],
    "probe: no staging after the first chunks (wrong results)": [
        (TILE, "stage_next();  // step + FWD_STAGES - 1,",
         "mma_bf16::cp_async_commit();  //"),
        (TILE, "if (more) stage_w(buf ^ 1);", ""),
        (TILE, "if (more) stage_g();", ""),
        (TILE, "if (more) stage_x(c + 1);", ""),
        (TILE, "if (more) stage_g(c + 1);", "")],
}


def by_kernel(fn, steps=5):
    """Device ms of each CUDA kernel of one call of ``fn``, by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    times = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name[:60]
            times[name] = times.get(name, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3 / steps
    return times


def max_rel(got, want):
    return max((p.float() - q.float()).abs().max().item()
               / q.float().abs().max().item() for p, q in zip(got, want))


def time_shapes(names, device, yardsticks=True):
    """The JSON lines of each shape and the ten blocks' totals; without
    ``yardsticks``, the kernels alone (no plain or library times)."""
    a = torch.from_numpy(spatial_adjacency()).to(device)
    g = torch.Generator(device=device).manual_seed(chip_smoke.SEED + 1)
    for name in names:
        dtype = chip_smoke.DTYPES[name]
        totals = {}
        for (t, c_in, c_out), blocks in chip_smoke.BLOCK_SHAPES:
            record = {}
            for kernel, nm in (("fwd", chip_smoke.NM),
                               ("stats", chip_smoke.TRAIN_NM),
                               ("bwd", chip_smoke.TRAIN_NM)):
                x = torch.randn(nm, t, 25, c_in, generator=g,
                                device=device).to(dtype)
                w = torch.randn(3 * c_out, c_in, generator=g, device=device)
                w *= (2.0 / c_in) ** 0.5
                b = 0.1 * torch.randn(3 * c_out, generator=g, device=device)
                if kernel == "bwd":
                    gout = torch.randn(nm, t, 25, c_out, generator=g,
                                       device=device).to(dtype)
                    run = lambda: sgcn.fused_graph_conv_backward(x, w, a,
                                                                 gout)
                    plain = lambda: sgcn.graph_conv_backward_reference(
                        x, w, a, gout)
                    dz = torch.einsum("kvw,ntwo->ntvko", a.to(dtype), gout)
                    dz = dz.reshape(-1, 3 * c_out)
                    x2, wd = x.reshape(-1, c_in), w.to(dtype)
                    library = lambda: (dz @ wd, dz.T @ x2)
                    flops = chip_smoke.sgcn_flops(nm * t, c_in, c_out, a,
                                                  backward=True)
                else:
                    run = {"fwd": lambda: (sgcn.fused_graph_conv(x, w, b,
                                                                 a),),
                           "stats": lambda: sgcn.fused_graph_conv_stats(
                               x, w, b, a)}[kernel]
                    plain = {"fwd": lambda: (sgcn.graph_conv_reference(
                        x, w, b, a),),
                        "stats": lambda: sgcn.graph_conv_stats_reference(
                            x, w, b, a)}[kernel]
                    wd, bd = w.to(dtype), b.to(dtype)
                    library = lambda: F.linear(x, wd, bd)
                    flops = chip_smoke.sgcn_flops(nm * t, c_in, c_out, a)
                got = run()
                record[f"{kernel}_rel_err"] = max_rel(got, plain())
                inputs = (x, w, a, gout) if kernel == "bwd" else (x, w, b, a)
                record[f"{kernel}_bound_ms"] = chip_smoke.bound(
                    flops, chip_smoke.nbytes(*inputs, *got), name)[0]
                del got
                record[f"{kernel}_ms"] = chip_smoke.cuda_ms(run)
                if yardsticks:
                    record[f"{kernel}_plain_ms"] = chip_smoke.cuda_ms(plain)
                    record[f"{kernel}_library_ms"] = chip_smoke.cuda_ms(
                        library)
                if kernel == "bwd":
                    record["bwd_by_kernel_ms"] = by_kernel(run)
                    del dz, gout
                del x, run, plain, library, inputs
                torch.cuda.empty_cache()
            for k, v in record.items():
                if k.endswith("_ms") and not k.endswith("by_kernel_ms"):
                    totals[k] = totals.get(k, 0.0) + blocks * v
            print(json.dumps({"dtype": name, "t": t, "c_in": c_in,
                              "c_out": c_out, **record}), flush=True)
        print(json.dumps({"dtype": name, "ten_blocks": totals}), flush=True)


def variants(device, dtype_name):
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for i, (name, subs) in enumerate(VARIANTS.items()):
            src_dir = pathlib.Path(tmp) / str(i)
            shutil.copytree(build.CSRC_DIR, src_dir)
            for fname, old, new, *count in subs:
                path = src_dir / fname
                text = path.read_text()
                if text.count(old) != (count or [1])[0]:
                    raise ValueError(f"{name}: {old!r} not as often in "
                                     f"{fname}")
                path.write_text(text.replace(old, new))
            procs[name] = [subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, "-o",
                 str(src_dir / f"{source}.so"), str(src_dir / source)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for source in SOURCES]
        kernels = sgcn._kernels
        try:
            for i, (name, pair) in enumerate(procs.items()):
                log = "".join(proc.communicate()[0] for proc in pair)
                if any(proc.returncode for proc in pair):
                    raise RuntimeError(f"{name}: nvcc failed\n{log}")
                libs = {source: ctypes.CDLL(
                    str(pathlib.Path(tmp) / str(i) / f"{source}.so"))
                    for source in SOURCES}

                def variant_kernels(source, n_pointers, n_ints, stem=None,
                                    libs=libs):
                    stem = stem or source.removesuffix(".cu")
                    fns = {}
                    for dtype, suffix in ((torch.float32, "f32"),
                                          (torch.bfloat16, "bf16")):
                        fn = getattr(libs[source], f"{stem}_{suffix}")
                        fn.argtypes = ([ctypes.c_void_p] * n_pointers
                                       + [ctypes.c_int] * n_ints
                                       + [ctypes.c_void_p])
                        fn.restype = ctypes.c_int
                        fns[dtype] = fn
                    return fns

                sgcn._kernels = variant_kernels
                print(json.dumps({"variant": name, "ptxas": [
                    line.split("'")[1] if "entry function" in line
                    else line.split(":")[-1].strip()
                    for line in log.splitlines()
                    if ("entry function" in line and "sgcn_f32" in line)
                    or "Used" in line or "spill" in line]}), flush=True)
                time_shapes([dtype_name], device, yardsticks=False)
        finally:
            sgcn._kernels = kernels


def ab(parent, names):
    """Parent, this, this, parent: each run a process of its own."""
    here = pathlib.Path(__file__).resolve().parent.parent
    for root in (parent, here, here, parent):
        root = pathlib.Path(root).resolve()
        print(json.dumps({"checkout": str(root)}), flush=True)
        subprocess.run(
            [sys.executable, str(here / "scripts" / "torch_sgcn_bench.py"),
             *names], cwd=root, check=True,
            env={**os.environ, "PYTHONPATH": str(root)})


def main(args):
    if args[:1] == ["ab"]:
        ab(args[1], args[2:] or ["f32"])
        return
    chip_smoke.phase_env()  # raises without a card
    device = torch.device("cuda", 0)
    if args[:1] == ["variants"]:
        variants(device, args[1] if len(args) > 1 else "f32")
    else:
        for source in SOURCES:
            build.load_library(source)
        if hasattr(chip_smoke, "sgcn_build_report"):
            print(json.dumps({"sgcn_build": chip_smoke.sgcn_build_report()}),
                  flush=True)
        time_shapes(args or ["f32"], device)
    print(chip_smoke.nvidia_smi_line())


if __name__ == "__main__":
    main(sys.argv[1:])
