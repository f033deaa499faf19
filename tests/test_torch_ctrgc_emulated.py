"""CTR-GCN's channel-wise aggregation kernels (``csrc/ctrgc_tile.cuh``: the
forward ``z = sum_k sum_v s x3`` and the backward's ``dx3`` and ``ds`` in
one pass) run on the CPU in an emulation of the CUDA constructs they use
(``tests/cuda_emulation/``), against the same f32 multiply-adds in their
order and against f64.

The card is where the kernels are checked against their plain version
(``test_torch_ctrgc_gpu.py``); this holds their staging, zero padding,
tiles, items and stores on the CPU, where no CUDA compiler exists. The
header is compiled by the host's C++ compiler as it is. A block's threads
are threads, ``__syncthreads`` a barrier, shared memory and the outputs
start as NaN, and the address and undefined-behaviour sanitizers watch
every access.
"""

import pathlib
import shutil
import subprocess

import pytest

from skeleton_action_recognition_tpu_torch.ops import build

EMULATION = pathlib.Path(__file__).resolve().parent / "cuda_emulation"
# (N, K, C, T, V): the model's three widths at the frames each stage runs
# at in the 64-frame recipe (V = 25: five tiles a row, no joint padding;
# two planes, four and eight a block), one clip; and edges: ragged frames
# (T = 5, 7, 30, not multiples of the tile's 4), joints that need padding
# (V = 7, 18), the 3-channel input's width, K = 2, and a plane count that
# leaves the last block of the forward short.
SHAPES = [(1, 3, 64, 64, 25), (1, 3, 128, 32, 25), (1, 3, 256, 16, 25),
          (2, 3, 5, 7, 7), (1, 2, 3, 5, 18), (3, 3, 7, 30, 25),
          (1, 3, 9, 16, 25)]
# |kernel - f64| / sum |terms| of an element: f32 sums of at most 75 (z),
# 25 (dx3) and 64 (ds) terms; z and dx3 also rounded once to bf16 (2^-8)
REL_TOL = {"f32": 1e-5, "bf16": 4e-3}
SUM_TOL = 1e-5


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    compiler = shutil.which("g++")
    if compiler is None:
        pytest.skip("needs a C++20 compiler (g++)")
    tmp = tmp_path_factory.mktemp("ctrgc_emulation")
    for path in EMULATION.iterdir():
        shutil.copy(path, tmp / path.name)
    shutil.copy(build.CSRC_DIR / "ctrgc_tile.cuh", tmp / "ctrgc_tile.cuh")
    exe = tmp / "harness"
    proc = subprocess.run(
        [compiler, "-std=c++20", "-O1", "-g", "-fsanitize=address,undefined",
         "-fno-sanitize-recover=undefined", "-Wno-unknown-pragmas",
         "-ffp-contract=off", "-pthread", f"-I{tmp}", "-include",
         "cuda_shim.h", str(tmp / "ctrgc_harness.cpp"), "-o", str(exe)],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return exe


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_ctrgc_kernels_match_f64_in_emulation(harness, shape, dtype):
    """Forward and backward: every element equal to the kernels' order of
    f32 fused multiply-adds, and within f32 summation (and, for bf16 z and
    dx3, one bf16 rounding) of f64."""
    proc = subprocess.run(
        [str(harness), *map(str, shape), dtype],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = dict(line.split() for line in proc.stdout.splitlines())
    names = ("z", "dx3", "ds")
    assert set(got) == set(names) | {f"{n}_ulps" for n in names} | {
        "fwd_blocks", "bwd_blocks"}
    assert {n: int(got[f"{n}_ulps"]) for n in names} == dict.fromkeys(
        names, 0)
    tol = {"z": REL_TOL[dtype], "dx3": REL_TOL[dtype], "ds": SUM_TOL}
    bad = {n: got[n] for n in names if not float(got[n]) <= tol[n]}
    assert not bad, bad
