"""The channels-first BatchNorm kernels (``csrc/channel_norm.cuh``: the
statistics, the normalize with the running update, the backward's sums and
``dx``) run on the CPU in an emulation of the CUDA constructs they use
(``tests/cuda_emulation/``), against f64 references.

The card is where the kernels are checked against ``F.batch_norm``
(``test_torch_channel_norm_gpu.py``); this holds their chunks, plane walk,
vector accesses, strided inputs, Chan merges, fixed-order combination of the
partials and the weight gradients without ``dx`` on the CPU, where no CUDA
compiler exists. The header is compiled by the host's C++ compiler as it
is, but for its block: 32 threads instead of 256, so that the emulated
barriers stay cheap and every thread walks several vectors (the merge
trees and the partials' fold are written for any power of two). A
block's threads are threads, ``__syncthreads`` a barrier, shared memory,
the workspace and the outputs start as NaN, and the address and
undefined-behaviour sanitizers watch every access.
"""

import pathlib
import shutil
import subprocess

import pytest

from skeleton_action_recognition_tpu_torch.ops import build, channel_norm

EMULATION = pathlib.Path(__file__).resolve().parent / "cuda_emulation"
# (N, C, L, x's type, y's type, planes a block, elements an access, padding
# channels): one clip (two bodies) at the cell's three widths and frames,
# a block a plane; the data BatchNorm's (128, 150, 64) at the planes the
# wrapper picks; ragged edges: L = 175 (T V not a multiple of 8 or 2: one
# element an access) with a last block of one plane, one plane a channel
# (N = 1), 70 chunks a channel (more than a block's threads: each thread
# folds several partials), and x and dy strided as slices of a
# concatenation (padding channels), in every pair of types.
CASES = [
    (2, 64, 1600, "bf16", "bf16", 1, 8, 0),
    (2, 128, 800, "bf16", "bf16", 1, 8, 0),
    (2, 256, 400, "bf16", "bf16", 1, 8, 0),
    (2, 64, 1600, "f32", "f32", 1, 8, 0),
    (128, 150, 64, "f32", "bf16", channel_norm.planes_per_block(128, 150, 64),
     8, 0),
    (3, 5, 175, "f32", "f32", 2, 1, 0),
    (1, 3, 36, "f32", "f32", 1, 4, 0),
    (70, 3, 24, "bf16", "bf16", 1, 8, 0),
    (4, 16, 1600, "bf16", "bf16", 3, 8, 3),
    (3, 6, 40, "bf16", "f32", 1, 8, 1),
    (5, 4, 50, "f32", "bf16", 2, 2, 2),
]
# kernel vs f64: the statistics, the running statistics and the weight
# gradients from f32 sums and merges of at most 8,192 elements a channel
# (measured up to 5.4e-7); y and dx within f32 rounding of f64, or one bf16
# rounding (2^-8 of the largest element) in bf16
STAT_TOL = 2e-6
REL_TOL = {"f32": 1e-6, "bf16": 4e-3}


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    compiler = shutil.which("g++")
    if compiler is None:
        pytest.skip("needs a C++20 compiler (g++)")
    tmp = tmp_path_factory.mktemp("channel_norm_emulation")
    for path in EMULATION.iterdir():
        shutil.copy(path, tmp / path.name)
    shutil.copy(build.CSRC_DIR / "block_tail.cuh", tmp / "block_tail.cuh")
    header = (build.CSRC_DIR / "channel_norm.cuh").read_text()
    block = "constexpr int THREADS = 256;"
    assert header.count(block) == 1
    (tmp / "channel_norm.cuh").write_text(
        header.replace(block, "constexpr int THREADS = 32;"))
    exe = tmp / "harness"
    proc = subprocess.run(
        [compiler, "-std=c++20", "-O1", "-g", "-fsanitize=address,undefined",
         "-fno-sanitize-recover=undefined", "-Wno-unknown-pragmas",
         "-ffp-contract=off", "-pthread", f"-I{tmp}", "-include",
         "cuda_shim.h", str(tmp / "channel_norm_harness.cpp"), "-o",
         str(exe)],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return exe


@pytest.mark.parametrize("case", CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_channel_norm_kernels_match_f64_in_emulation(harness, case):
    """Statistics, running update, y, dx and the weight gradients within
    f32 (and bf16) rounding of f64; y equal to the f32 operations on the
    kernels' own statistics; two runs bit-identical; the weight gradients
    the same without dx."""
    n, c, length, ti, to, ppc, vec, pad = case
    proc = subprocess.run([str(harness), *map(str, case)],
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = dict(line.split() for line in proc.stdout.splitlines())
    stats = ("mean", "invstd", "running_mean", "running_var", "grad_weight",
             "grad_bias")
    assert set(got) == set(stats) | {"y", "dx", "y_ulps", "repeat_bits",
                                     "no_dx_bits", "blocks"}
    assert int(got["blocks"]) == c * -(-n // ppc)
    counts = {k: int(got[k]) for k in ("y_ulps", "repeat_bits", "no_dx_bits")}
    assert counts == dict.fromkeys(counts, 0)
    tol = {**dict.fromkeys(stats, STAT_TOL), "y": REL_TOL[to],
           "dx": REL_TOL[ti]}
    bad = {k: got[k] for k in tol if not float(got[k]) <= tol[k]}
    assert not bad, bad
