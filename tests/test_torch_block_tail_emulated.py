"""The block-tail kernels (``csrc/block_tail.cuh``: the fused ST-GCN
block's BN2 normalize, residual and ReLU, their backward, and the fold of
BN2's statistics' cotangents) run on the CPU in an emulation of the CUDA
constructs they use (``tests/cuda_emulation/``), against the eager order of
operations and f64 references.

The card is where the kernels are checked against their plain versions
(``test_torch_block_tail_gpu.py``); this holds their row walk, lanes,
vector accesses, ragged last row group, shared-memory reduction and
per-block partials on the CPU, where no CUDA compiler exists. The header is
compiled by the host's C++ compiler as it is, but for its grid: at most 3
blocks a launch instead of one wave of the H100's, so that every block
walks several row groups. A block's threads are threads, ``__syncthreads``
a barrier, shared memory and the workspace start as NaN, and the address
and undefined-behaviour sanitizers watch every access.
"""

import pathlib
import shutil
import subprocess

import pytest

from skeleton_action_recognition_tpu_torch.ops import build

EMULATION = pathlib.Path(__file__).resolve().parent / "cuda_emulation"
# (rows, C, channels a thread): the model's widths 64, 128 and 256 (8
# channels a thread, 16-byte accesses) over row counts that leave the last
# row group ragged (32, 16 and 8 rows a group); C = 20, 6 and 5 at 4, 2 and
# 1 channels a thread (51, 85 and 51 rows a group, one idle thread); C =
# 300 at 4 (75 lanes: three rows a group and 31 idle threads). Each has
# 8 to 32 row groups for the 3 blocks.
SHAPES = [(1001, 64, 8), (333, 128, 8), (101, 256, 8), (400, 20, 4),
          (700, 6, 2), (400, 5, 1), (31, 300, 4)]
# kernel vs f64, max |diff| / max |f64|: one f32 rounding an element
# (out, f32 g_u and gue), a bf16 one (bf16 g_u, g_res and gue: 2^-8); the
# channel sums as |diff| / sum |terms|, f32 sums of at most ~1,000 rows
REL_TOL = {"f32": 1e-6, "bf16": 4e-3}
SUM_TOL = 1e-5


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    compiler = shutil.which("g++")
    if compiler is None:
        pytest.skip("needs a C++20 compiler (g++)")
    tmp = tmp_path_factory.mktemp("block_tail_emulation")
    for path in EMULATION.iterdir():
        shutil.copy(path, tmp / path.name)
    header = (build.CSRC_DIR / "block_tail.cuh").read_text()
    grid = "constexpr int MAX_BLOCKS = 4 * 132;"
    assert header.count(grid) == 1
    (tmp / "block_tail.cuh").write_text(
        header.replace(grid, "constexpr int MAX_BLOCKS = 3;"))
    exe = tmp / "harness"
    proc = subprocess.run(
        [compiler, "-std=c++20", "-O1", "-g", "-fsanitize=address,undefined",
         "-fno-sanitize-recover=undefined", "-Wno-unknown-pragmas",
         "-ffp-contract=off", "-pthread", f"-I{tmp}", "-include",
         "cuda_shim.h", str(tmp / "block_tail_harness.cpp"), "-o", str(exe)],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return exe


@pytest.mark.parametrize("res", ["none", "f32", "bf16"])
@pytest.mark.parametrize("u", ["f32", "bf16"])
@pytest.mark.parametrize("rows,c,vec", SHAPES)
def test_block_tail_kernels_match_f64_in_emulation(harness, rows, c, vec,
                                                   u, res):
    """Forward, backward and fold: every element equal to the eager order
    of f32 operations, within one rounding of f64, and the channel sums
    within f32 summation of f64."""
    proc = subprocess.run(
        [str(harness), str(rows), str(c), str(vec), u, res],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = dict(line.split() for line in proc.stdout.splitlines())
    names = ["out", "g_u", "gue"] + (["g_res"] if res != "none" else [])
    assert set(got) == {"sum", "sum_u", "blocks"} | set(names) | {
        f"{n}_ulps" for n in names}
    assert int(got["blocks"]) == 3
    assert {n: int(got[f"{n}_ulps"]) for n in names} == dict.fromkeys(
        names, 0)
    tol = {"out": REL_TOL["f32"], "g_u": REL_TOL[u], "gue": REL_TOL[u],
           "g_res": REL_TOL.get(res)}
    bad = {n: got[n] for n in names if not float(got[n]) <= tol[n]}
    bad.update({n: got[n] for n in ("sum", "sum_u")
                if not float(got[n]) <= SUM_TOL})
    assert not bad, bad
