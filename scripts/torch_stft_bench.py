#!/usr/bin/env python3
"""Time the STFT log-magnitude kernels (#10 forward, #11 backward) on the
card, beside ``torch.stft`` (cuFFT) and the plain versions.

Run from the repository root on a machine with a CUDA card:

    PYTHONPATH=. python scripts/torch_stft_bench.py
    PYTHONPATH=. python scripts/torch_stft_bench.py ab PARENT [PAIRS]

The first form builds the two sources, prints each STFT kernel's registers,
spills and shared memory as ``nvcc -Xptxas -v`` reports them, then runs
``chip_smoke.py``'s ``stft_kernel`` phase alone at the trainer's shape (16
signals of 75,000 samples, n_fft 256, hop 16) on a radar return of
``chip_smoke.py``'s seeded clips, and the card's name and power limit.

``ab PARENT`` times #10 and #11 (CUDA events, mean of 20 calls after 3)
and #11's peak device memory above what was allocated before the call, for
the checkout at ``PARENT`` (unpacked with ``git archive`` into a directory
that ``.gitignore`` lists) and this one, in turns: parent, this, this,
parent, PAIRS times (1 if not given), each run its own process. The
timing form (``times``) uses only the op's public functions, which both
checkouts have.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
N, T, N_FFT, HOP = 16, 75000, 256, 16


def times():
    """One JSON line: #10's and #11's times and #11's peak memory, through
    the package on ``PYTHONPATH``."""
    import chip_smoke
    from skeleton_action_recognition_tpu_torch.ops import stft, stft_logmag

    device = torch.device("cuda")
    chip_smoke.tf32_off()
    gen = torch.Generator(device=device).manual_seed(chip_smoke.SEED + 3)
    re, im = (torch.randn(N, T, generator=gen, device=device)
              for _ in range(2))
    g = torch.randn(N, N_FFT, T // HOP + 1, generator=gen, device=device)
    cos, sin = (torch.from_numpy(b).to(device)
                for b in stft.stft_basis(N_FFT))
    fwd_ms = chip_smoke.cuda_ms(
        lambda: stft_logmag.stft_logmag(re, im, HOP, cos, sin))
    bwd_ms = chip_smoke.cuda_ms(
        lambda: stft_logmag.stft_logmag_backward(re, im, HOP, cos, sin, g))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    stft_logmag.stft_logmag_backward(re, im, HOP, cos, sin, g)
    torch.cuda.synchronize()
    print(json.dumps({
        "checkout": os.getcwd(), "stft_fwd_ms": fwd_ms, "stft_bwd_ms": bwd_ms,
        "stft_bwd_peak_mb": (torch.cuda.max_memory_allocated() - base)
        / 2**20,
    }), flush=True)


def ab(parent, pairs):
    """Parent, this, this, parent, ``pairs`` times, each its own process
    run from its checkout."""
    for _ in range(pairs):
        for where in (parent, ROOT, ROOT, parent):
            where = pathlib.Path(where).resolve()
            subprocess.run(
                [sys.executable, str(ROOT / "scripts" / "torch_stft_bench.py"),
                 "times"], cwd=where, check=True,
                env={**os.environ, "PYTHONPATH": str(where)})


def main(args):
    import chip_smoke

    if not torch.cuda.is_available():
        raise SystemExit("torch_stft_bench: no CUDA device")
    if args[:1] == ["times"]:
        times()
    elif args[:1] == ["ab"]:
        ab(args[1], int(args[2]) if len(args) > 2 else 1)
    else:
        from skeleton_action_recognition_tpu_torch.ops import build, radar

        chip_smoke.tf32_off()
        for source in ("stft_fwd.cu", "stft_bwd.cu"):
            build.load_library(source)
            chip_smoke.emit("stft_build", source=source,
                            ptxas=chip_smoke.ptxas_entries(source, "stft"))
        device = torch.device("cuda")
        x, _ = chip_smoke.spec_clips(chip_smoke.SPEC_BATCH, chip_smoke.SEED)
        e, src, dst, c, t_out = radar.spline_inputs(
            torch.from_numpy(x).to(device), chip_smoke.SPEC_UP)
        loc = torch.tensor([0.1, -0.2, 0.3], device=device)
        lam = torch.tensor(chip_smoke.LAMBDAS[0], device=device)
        re, im = radar.spline_radar(e, src, dst, c, loc, lam, t_out)
        chip_smoke.phase_stft_kernel(device, re, im)
    print(chip_smoke.nvidia_smi_line())


if __name__ == "__main__":
    main(sys.argv[1:])
