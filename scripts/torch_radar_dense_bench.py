#!/usr/bin/env python3
"""Time the PyTorch port's dense radar kernels (#8 forward, #9 backward) on
a CUDA card, at the spectrogram trainer's shape (16 seeded clips, T=300
upsampled 250x, lambda = 5e-4, f32, TF32 off). From the repository root:

    python scripts/torch_radar_dense_bench.py profile
    python scripts/torch_radar_dense_bench.py variants

``profile``: device time by kernel name of one call of each wrapper
(``torch.profiler``, 3 calls), which splits #9 into its four kernels.

``variants``: builds copies of ``csrc/`` with the source substitutions of
``VARIANTS`` (one ``nvcc`` each, at once, with ``ops/build.py``'s flags),
and times each build's entry points side by side (CUDA events, two
readings of 10 calls after 2 warm-up), with its registers and spills and
its largest error against the plain versions. A tool for redesigning the
kernels: the port never loads these builds.

Each prints JSON lines and, last, the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import shutil
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
VARIANTS = {
    "as built": [],
    "row blocks: one an SM": [
        ("radar_dense_tile.cuh",
         "return threads <= kTwoBlockThreads ? 2 : 1;", "return 1;"),
    ],
    "row blocks: three an SM": [
        ("radar_dense_tile.cuh",
         "return threads <= kTwoBlockThreads ? 2 : 1;",
         "return threads <= kTwoBlockThreads ? 3 : 1;"),
    ],
    "transposed products: four blocks an SM": [
        ("radar_dense_bwd.cu", "constexpr int kWtBlocks = 5;",
         "constexpr int kWtBlocks = 4;"),
    ],
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
    return (args, gre, gim, t_out, radar.dense_radar_reference(*args, t_out),
            radar.dense_radar_backward_reference(*args, gre, gim, t_out))


def profile(device):
    args, gre, gim, t_out, _, _ = inputs(device)
    for name, fn in (
        ("radar_dense_fwd", lambda: radar.dense_radar(*args, t_out)),
        ("radar_dense_bwd", lambda: radar.dense_radar_backward(
            *args, gre, gim, t_out)),
    ):
        fn()
        torch.cuda.synchronize()
        print(json.dumps({"profile": name, **cs.device_profile(fn, 3)}),
              flush=True)


def entry_points(libs, args, gre, gim, t_out):
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
    fwd.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    bwd = libs[1].radar_dense_bwd_f32
    bwd.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fwd_ptrs = [t.data_ptr() for t in (*args, *fwd_out)]
    bwd_ptrs = [t.data_ptr() for t in (*args, gre, gim, *bwd_out,
                                       *workspace)]

    def call(fn, ptrs):
        err = fn(*ptrs, n, t_in, em, t_out, stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError_t {err}")

    return ((lambda: call(fwd, fwd_ptrs)), fwd_out,
            (lambda: call(bwd, bwd_ptrs)), bwd_out)


def variants(device):
    args, gre, gim, t_out, want_fwd, want_bwd = inputs(device)
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
            fwd, fwd_out, bwd, bwd_out = entry_points(libs, args, gre, gim,
                                                      t_out)
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


def main():
    if len(sys.argv) != 2 or sys.argv[1] not in ("profile", "variants"):
        raise SystemExit(__doc__)
    cs.phase_env()  # raises without a card
    {"profile": profile, "variants": variants}[sys.argv[1]](
        torch.device("cuda", 0))
    print(cs.nvidia_smi_line())


if __name__ == "__main__":
    main()
