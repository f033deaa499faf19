#!/usr/bin/env python3
"""Time the spline radar kernels (#6 forward; #7 backward, its full and
its loc/lambda instance) on the card, with their build report.

Run from the repository root on a machine with a CUDA card:

    PYTHONPATH=. python scripts/torch_radar_bench.py
    PYTHONPATH=. python scripts/torch_radar_bench.py ab PARENT [PAIRS]

The first form builds ``radar_fwd.cu`` and ``radar_bwd.cu`` and prints,
for each of their kernels, the registers, spills and shared memory that
``nvcc -Xptxas -v`` reports and the SASS instruction counts that
``cuobjdump -sass`` shows: the kernel's, and its pair loop's (the
smallest loop around ``sincosf`` that reads shared memory: one (row,
pair) of the backward, kernel #6's ``kFwdRows`` rows of one pair; static
counts, the functions' slow paths that lie in the loop's range included;
:func:`sass_report`). Then it runs
``chip_smoke.py``'s ``radar_build`` and ``radar_kernel`` phases alone at
the trainer's shape (16 clips, T=300 upsampled 250x, 24 edges x 2 bodies)
and prints the card's name and power limit.

``ab PARENT`` times #6, #7 and (where the checkout has it) #7's loc/lambda
instance through the op's public functions (CUDA events, mean of 20 calls
after 3, lambda = 5e-4), and their plain versions (mean of 5 after 1),
with each checkout's SASS counts, for the
checkout at ``PARENT`` (unpacked with ``git archive`` into a directory
that ``.gitignore`` lists) and this one, in turns: parent, this, this,
parent, PAIRS times (1 if not given), each run its own process.
"""

from __future__ import annotations

import inspect
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
SOURCES = ("radar_fwd.cu", "radar_bwd.cu")
TWO_OVER_PI = "0.63661974668502807617"  # f32(2 / pi) as cuobjdump prints it


def _cuobjdump():
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = pathlib.Path(cuda_home) / "bin" / "cuobjdump"
    return str(path) if path.exists() else shutil.which("cuobjdump")


def sass_counts(source):
    """:func:`sass_report` of the library built from ``csrc/<source>``."""
    from skeleton_action_recognition_tpu_torch.ops import build

    return sass_report(subprocess.run(
        [_cuobjdump(), "-sass", str(build.library_path(source))],
        capture_output=True, text=True, check=True, timeout=300).stdout)


def sass_report(listing):
    """``{kernel: {"instructions", "pair_loop", "loops"}}`` of a
    ``cuobjdump -sass`` listing: SASS instructions of each entry function,
    of its pair loop and of each loop (a backward branch and what lies
    between it and its target). The pair loop is the smallest loop that
    holds both ``sincosf``'s range reduction (a product with f32(2 / pi))
    and a shared load (``LDS``: the row's staged monomials, cotangent or
    coefficients); that leaves out the loops of the functions' slow paths
    (``sqrtf``'s, ``sincosf``'s large-argument reduction), which read no
    shared memory."""
    functions, name = {}, None
    for line in listing.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            name = head.group(1)
            functions[name] = ([], {})
            continue
        label = re.match(r"\s*(\.L_x_\d+):", line)
        ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if name and label:
            functions[name][1][label.group(1)] = None  # the next address
        elif name and ins:
            at = int(ins.group(1), 16)
            labels = functions[name][1]
            for key in [k for k, v in labels.items() if v is None]:
                labels[key] = at
            functions[name][0].append((at, ins.group(2)))
    report = {}
    for name, (ins, labels) in functions.items():
        loops = []
        for at, text in ins:
            branch = re.search(r"\bBRA\b.*?(0x[0-9a-f]+|\.L_x_\d+)", text)
            if not branch:
                continue
            to = branch.group(1)
            to = int(to, 16) if to.startswith("0x") else labels.get(to)
            if to is not None and to < at:
                body = [t for x, t in ins if to <= x <= at]
                pair = (any(TWO_OVER_PI in t for t in body)
                        and any(re.search(r"\bLDS\b", t) for t in body))
                loops.append((len(body), pair))
        pair = [n for n, is_pair in loops if is_pair]
        report[name] = {"instructions": len(ins),
                        "pair_loop": min(pair) if pair else None,
                        "loops": sorted(n for n, _ in loops)}
    return report


def times():
    """One JSON line: #6's and #7's times (and the loc/lambda instance's)
    and their plain versions', with the SASS counts, through the package
    on ``PYTHONPATH``."""
    import chip_smoke
    from skeleton_action_recognition_tpu_torch.ops import build, radar

    device = torch.device("cuda")
    chip_smoke.tf32_off()
    for source in SOURCES:
        build.load_library(source)
    x, _ = chip_smoke.spec_clips(chip_smoke.SPEC_BATCH, chip_smoke.SEED)
    e, src, dst, c, t_out = radar.spline_inputs(
        torch.from_numpy(x).to(device), chip_smoke.SPEC_UP)
    loc = torch.tensor([0.1, -0.2, 0.3], device=device)
    lam = torch.tensor(chip_smoke.LAMBDAS[0], device=device)
    gen = torch.Generator(device=device).manual_seed(chip_smoke.SEED + 2)
    gre, gim = (torch.randn(chip_smoke.SPEC_BATCH, t_out, generator=gen,
                            device=device) for _ in range(2))
    args = (e, src, dst, c, loc, lam)
    record = {
        "checkout": os.getcwd(),
        "radar_fwd_ms": chip_smoke.cuda_ms(
            lambda: radar.spline_radar(*args, t_out)),
        "radar_bwd_ms": chip_smoke.cuda_ms(
            lambda: radar.spline_radar_backward(*args, gre, gim, t_out)),
    }
    record["radar_fwd_plain_ms"] = chip_smoke.cuda_ms(
        lambda: radar.spline_radar_reference(*args, t_out), 5, 1)
    record["radar_bwd_plain_ms"] = chip_smoke.cuda_ms(
        lambda: radar.spline_radar_backward_reference(*args, gre, gim,
                                                      t_out), 5, 1)
    if "coef_grads" in inspect.signature(
            radar.spline_radar_backward).parameters:
        record["radar_bwd_loc_lam_ms"] = chip_smoke.cuda_ms(
            lambda: radar.spline_radar_backward(*args, gre, gim, t_out,
                                                coef_grads=False))
        record["radar_bwd_loc_lam_plain_ms"] = chip_smoke.cuda_ms(
            lambda: radar.spline_radar_backward_reference(
                *args, gre, gim, t_out, coef_grads=False), 5, 1)
    record["sass"] = {source: sass_counts(source) for source in SOURCES}
    print(json.dumps(record), flush=True)


def ab(parent, pairs):
    """Parent, this, this, parent, ``pairs`` times, each its own process
    run from its checkout."""
    for _ in range(pairs):
        for where in (parent, ROOT, ROOT, parent):
            where = pathlib.Path(where).resolve()
            subprocess.run(
                [sys.executable, str(ROOT / "scripts" / "torch_radar_bench.py"),
                 "times"], cwd=where, check=True,
                env={**os.environ, "PYTHONPATH": str(where)})


def main(args):
    import chip_smoke

    if not torch.cuda.is_available():
        raise SystemExit("torch_radar_bench: no CUDA device")
    if args[:1] == ["times"]:
        times()
    elif args[:1] == ["ab"]:
        ab(args[1], int(args[2]) if len(args) > 2 else 1)
    else:
        from skeleton_action_recognition_tpu_torch.ops import build

        chip_smoke.tf32_off()
        for source in SOURCES:
            build.load_library(source)
            chip_smoke.emit("radar_sass", source=source,
                            kernels=sass_counts(source))
        chip_smoke.phase_radar_build()
        chip_smoke.phase_radar_kernel(torch.device("cuda"))
    print(chip_smoke.nvidia_smi_line())


if __name__ == "__main__":
    main(sys.argv[1:])
