#!/usr/bin/env python3
"""Time the PyTorch port's dense radar kernels (#8 forward, #9 backward) on
a CUDA card, at the spectrogram trainer's shape (16 seeded clips, T=300
upsampled 250x, lambda = 5e-4, f32, TF32 off). From the repository root:

    python scripts/torch_radar_dense_bench.py profile
    python scripts/torch_radar_dense_bench.py variants
    python scripts/torch_radar_dense_bench.py ab PARENT [PAIRS]

``profile`` and ``variants`` first print the operator's band
(``radar.dense_band``: the widths of a 64-row block's and a 4,096-row
split's band, mean and largest) and the band pass's time (CUDA events).

``profile``: device time by kernel name of one call of each wrapper
(``torch.profiler``, 3 calls; each wrapper call finds the band too),
which splits #9 into its four kernels.

``variants``: builds copies of ``csrc/`` with the source substitutions of
``VARIANTS`` (one ``nvcc`` each, at once, with ``ops/build.py``'s flags),
and times each build's entry points side by side on the band found once
(CUDA events, two readings of 10 calls after 2 warm-up), with its
registers and spills and its largest error against the plain versions.
A tool for redesigning the kernels: the port never loads these builds.

``ab``: the end-to-end op, this checkout against another (``PARENT``, the
root of a checkout of the port) on one card: ``chip_smoke.py``'s
``radar_dense_path`` (``radar_return_fused`` forward and forward +
backward, and the spline route, CUDA events over 10 calls) of each, in
``PAIRS`` pairs (default 10) of processes of their own, in turns (parent,
change, change, parent, ...), each checkout's own ``chip_smoke.py`` and
kernels; then the median and quartiles of each time on each side and the
median of the pairs' differences. The path waits on the host's launches,
so its times move from run to run: compare only inside one call.

Each prints JSON lines and, last, the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import shutil
import statistics
import subprocess
import sys
import tempfile

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from skeleton_action_recognition_tpu_torch.ops import (  # noqa: E402
    build,
    radar,
    resample,
)

# name -> [(file under csrc/, text, replacement)], each against the sources
# of the checkout
DENSE_ROWS = [
    ("radar_dense_fwd.cu",
     "band[2 * blockIdx.y],\n" + " " * 25 + "band[2 * blockIdx.y + 1]",
     "0, t_in"),
    ("radar_dense_bwd.cu",
     "band[2 * tile],\n" + " " * 27 + "band[2 * tile + 1]",
     "0, t_in"),
]
DENSE_TRANSPOSED = [
    ("radar_dense_bwd.cu",
     "const int m_end = split_band[2 * split + 1];\n"
     "  const int m0 = split_band[2 * split] +",
     "const int m_end = t_in;\n  const int m0 ="),
    ("radar_dense_bwd.cu",
     "if (split_band[2 * s] <= m && m < split_band[2 * s + 1]) {",
     "if (true) {"),
]
VARIANTS = {
    "as built": [],
    # the row blocks over their band, the transposed products over all of
    # T_in
    "banded rows, dense transposed products": DENSE_TRANSPOSED,
    # every contraction over all of T_in
    "dense": DENSE_ROWS + DENSE_TRANSPOSED,
}


def inputs(device):
    """The kernels' inputs at the trainer's shape and the plain versions'
    results: ``(args, gre, gim, t_out, want_fwd, want_bwd)``."""
    x = torch.from_numpy(cs.spec_clips(cs.SPEC_BATCH, cs.SEED)[0]).to(device)
    op = torch.from_numpy(
        resample.pad_frames_operator(cs.SPEC_T, cs.SPEC_UP)).to(device)
    t_out = op.shape[0]
    w = F.pad(op, (0, 0, 0, -(-t_out // radar.TILE) * radar.TILE - t_out))
    src, dst = radar.gather_features(x, radar.RADAR_EDGES)
    c = radar.bone_length_mean_sq(x, op)
    loc = torch.tensor([0.1, -0.2, 0.3], device=device)
    lam = torch.tensor(cs.LAMBDAS[0], device=device)
    g = torch.Generator(device=device).manual_seed(cs.SEED + 2)
    gre = torch.randn(cs.SPEC_BATCH, t_out, generator=g, device=device)
    gim = torch.randn(cs.SPEC_BATCH, t_out, generator=g, device=device)
    args = (w, src, dst, c, loc, lam)
    band, record = cs.band_stats(w, t_out)
    print(json.dumps(record), flush=True)
    return (args, band, gre, gim, t_out,
            radar.dense_radar_reference(*args, t_out),
            radar.dense_radar_backward_reference(*args, gre, gim, t_out))


def profile(device):
    args, _, gre, gim, t_out, _, _ = inputs(device)
    for name, fn in (
        ("radar_dense_fwd", lambda: radar.dense_radar(*args, t_out)),
        ("radar_dense_bwd", lambda: radar.dense_radar_backward(
            *args, gre, gim, t_out)),
    ):
        fn()
        torch.cuda.synchronize()
        print(json.dumps({"profile": name, **cs.device_profile(fn, 3)}),
              flush=True)


def entry_points(libs, args, band, gre, gim, t_out):
    """Closures calling a build's two C entry points (``libs``: the
    forward's and the backward's library) on fresh outputs, and those
    outputs."""
    w, src, dst, c, loc, lam = args
    n, t_in, f3 = src.shape
    em = f3 // 3
    emp = -(-em // 4) * 4
    tiles, splits = -(-t_out // 64), -(-t_out // 4096)
    stream = torch.cuda.current_stream().cuda_stream
    fwd_out = [torch.empty(n, t_out, device=src.device) for _ in range(2)]
    bwd_out = [torch.empty_like(t) for t in (src, dst, c, loc, lam)]
    workspace = [torch.empty(k, device=src.device) for k in (
        n * t_out * 6 * emp, splits * n * t_in * 6 * emp, n * tiles * em,
        n * tiles * 4)]
    fwd = libs[0].radar_dense_fwd_f32
    fwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    bwd = libs[1].radar_dense_bwd_f32
    bwd.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fwd_ptrs = [t.data_ptr() for t in (w, band[0], *args[1:], *fwd_out)]
    bwd_ptrs = [t.data_ptr() for t in (w, *band, *args[1:], gre, gim,
                                       *bwd_out, *workspace)]

    def call(fn, ptrs):
        err = fn(*ptrs, n, t_in, em, t_out, stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError_t {err}")

    return ((lambda: call(fwd, fwd_ptrs)), fwd_out,
            (lambda: call(bwd, bwd_ptrs)), bwd_out)


def variants(device):
    args, band, gre, gim, t_out, want_fwd, want_bwd = inputs(device)
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
                 str(src_dir / f"{stem}.so"), str(src_dir / f"{stem}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for stem in ("radar_dense_fwd", "radar_dense_bwd")]
        for i, (name, pair) in enumerate(procs.items()):
            log = "".join(proc.communicate()[0] for proc in pair)
            if any(proc.returncode for proc in pair):
                raise RuntimeError(f"{name}: nvcc failed\n{log}")
            libs = [ctypes.CDLL(str(pathlib.Path(tmp) / str(i) / f"{stem}.so"))
                    for stem in ("radar_dense_fwd", "radar_dense_bwd")]
            fwd, fwd_out, bwd, bwd_out = entry_points(libs, args, band, gre,
                                                      gim, t_out)
            fwd()
            bwd()
            torch.cuda.synchronize()
            print(json.dumps({
                "variant": name,
                "fwd_ms": [cs.cuda_ms(fwd, 10, 2) for _ in range(2)],
                "bwd_ms": [cs.cuda_ms(bwd, 10, 2) for _ in range(2)],
                "fwd_rel_err": max(cs.rel_err(p, q)
                                   for p, q in zip(fwd_out, want_fwd)),
                "bwd_rel_err": max(cs.rel_err(p, q)
                                   for p, q in zip(bwd_out, want_bwd)),
                "ptxas": [line.strip() for line in log.splitlines()
                          if "Used" in line or "spill" in line],
            }), flush=True)


# one process of ``ab``, run from the root of the checkout to time: its
# radar kernels built at once, then its ``chip_smoke.py``'s dense path
PATH_RUN = """
from concurrent import futures
import torch
import chip_smoke as cs
from skeleton_action_recognition_tpu_torch.ops import build, resample
cs.phase_env()
sources = ("radar_fwd.cu", "radar_bwd.cu", "radar_dense_fwd.cu",
           "radar_dense_bwd.cu")
with futures.ThreadPoolExecutor(len(sources)) as pool:
    list(pool.map(build.load_library, sources))
device = torch.device("cuda", 0)
x = torch.from_numpy(cs.spec_clips(cs.SPEC_BATCH, cs.SEED)[0]).to(device)
op = resample.pad_frames_operator(cs.SPEC_T, cs.SPEC_UP)
cs.dense_path(device, x, torch.from_numpy(op).to(device),
              torch.tensor([0.1, -0.2, 0.3], device=device))
"""
AB_TIMES = ("dense_forward_ms", "dense_train_ms", "spline_forward_ms",
            "spline_train_ms")


def path_times(root):
    """``AB_TIMES`` of one ``radar_dense_path`` of the checkout at
    ``root``, in a process of its own."""
    proc = subprocess.run([sys.executable, "-c", PATH_RUN], cwd=root,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode:
        raise RuntimeError(f"{root}: exit {proc.returncode}\n"
                           f"{proc.stderr[-4000:]}")
    line = next(json.loads(text) for text in proc.stdout.splitlines()
                if '"phase": "radar_dense_path"' in text)
    return {name: line[name] for name in AB_TIMES}


def ab(parent, pairs):
    roots = {"parent": pathlib.Path(parent).resolve(), "change": REPO}
    runs = {"parent": [], "change": []}
    for i in range(pairs):
        for side in (("parent", "change"), ("change", "parent"))[i % 2]:
            runs[side].append(path_times(roots[side]))
            print(json.dumps({"ab_run": side, "pair": i, **runs[side][-1]}),
                  flush=True)
    summary = {}
    for name in AB_TIMES:
        for side, times in runs.items():
            values = [t[name] for t in times]
            q1, _, q3 = statistics.quantiles(values, n=4)
            summary[f"{side}_{name}"] = {
                "q1": q1, "median": statistics.median(values), "q3": q3}
        diffs = [c[name] - p[name]
                 for c, p in zip(runs["change"], runs["parent"])]
        summary[f"change_minus_parent_{name}"] = {
            "median": statistics.median(diffs),
            "change_slower": sum(d > 0 for d in diffs), "pairs": len(diffs)}
    print(json.dumps({"ab_summary": summary}), flush=True)


def main():
    args = sys.argv[1:]
    if not (args[:1] in (["profile"], ["variants"]) and len(args) == 1
            or args[:1] == ["ab"] and len(args) in (2, 3)):
        raise SystemExit(__doc__)
    cs.phase_env()  # raises without a card
    if args[0] == "ab":
        ab(args[1], int(args[2]) if len(args) == 3 else 10)
    else:
        {"profile": profile, "variants": variants}[args[0]](
            torch.device("cuda", 0))
    print(cs.nvidia_smi_line())


if __name__ == "__main__":
    main()
