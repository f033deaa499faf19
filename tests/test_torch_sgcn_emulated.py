"""The f32 spatial graph-conv kernels (``csrc/sgcn_tile_f32.cuh``: kernels
#1/#2's forward and #3's dx and dW) run on the CPU in an emulation of the
CUDA constructs they use (``tests/cuda_emulation/``), against f64
references.

The card is where the kernels are checked against their plain versions
(``test_torch_sgcn_gpu.py``, ``chip_smoke.py``); this holds their tiling,
staging, persistent walk and edge masks on the CPU, where no CUDA compiler
exists. The header is compiled by the host's C++ compiler with its two
inline-assembly copies replaced by synchronous ones: a block's threads are
threads, ``__syncthreads`` a barrier, a copy lands at once, shared memory
starts as NaN, and the address and undefined-behaviour sanitizers watch
every access. A persistent kernel gets two SMs' worth of blocks, so each
block walks several tiles.
"""

import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest

from skeleton_action_recognition_tpu_torch.graphs.ntu_rgb_d import (
    spatial_adjacency,
)
from skeleton_action_recognition_tpu_torch.ops import build

EMULATION = pathlib.Path(__file__).resolve().parent / "cuda_emulation"
# (frames, C_in, C_out): the first block's C_in = 3 (the narrow instances,
# 12-byte rows); C_in = 4 and 5 on either side of the narrow limit; the
# model's widths 64, 128 and 256 over frames that are no multiple of the
# 5-frame tile or the 2-frame chunk; C_in = 20, 40, 136, 300 and C_out =
# 33, 40, 72, 100, 150: partial chunks and tiles of every kernel, unaligned
# rows, and (300, 150) several channel tiles a frame tile, so the
# persistent walk wraps across them
SHAPES = [(7, 3, 64), (12, 4, 24), (12, 5, 16), (1, 16, 32), (7, 20, 40),
          (13, 40, 100), (4, 136, 72), (5, 16, 33), (13, 64, 64),
          (12, 64, 128), (11, 128, 128), (9, 256, 256), (20, 300, 150)]
# kernel vs f64, max |diff| / max |reference|: f32 sums of at most 3 * 300
# products (out, dx) and of 1,000 rows (dW, db, the channel sums), as in
# the GPU tests' f32 tolerance
REL_TOL = 1e-5


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    compiler = shutil.which("g++")
    if compiler is None:
        pytest.skip("needs a C++20 compiler (g++)")
    tmp = tmp_path_factory.mktemp("sgcn_emulation")
    for path in EMULATION.iterdir():
        shutil.copy(path, tmp / path.name)
    header = (build.CSRC_DIR / "sgcn_tile_f32.cuh").read_text()
    header, copies = re.subn(
        r"(void cp_async4\(float\* dst, const float\* src,\s*bool valid\) "
        r"\{).*?\n\}", r"\1\n  *dst = valid ? *src : 0.f;\n}", header,
        flags=re.S)
    header, waits = re.subn(r"(void cp_async_wait\(\) \{).*?\n\}", r"\1}",
                            header, flags=re.S)
    assert copies == 1 and waits == 1 and "asm" not in header
    (tmp / "sgcn_tile_f32.cuh").write_text(header)
    exe = tmp / "harness"
    proc = subprocess.run(
        [compiler, "-std=c++20", "-O1", "-g", "-fsanitize=address,undefined",
         "-fno-sanitize-recover=undefined", "-Wno-unknown-pragmas",
         "-pthread", f"-I{tmp}", "-include", "cuda_shim.h",
         str(tmp / "sgcn_f32_harness.cpp"), "-o", str(exe)],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    adjacency = {
        "ntu": spatial_adjacency(),
        "dense": np.random.default_rng(0).normal(size=(3, 25, 25)),
    }
    files = {}
    for name, a in adjacency.items():
        files[name] = tmp / f"{name}.bin"
        a.astype(np.float32).tofile(files[name])
    return exe, files


@pytest.mark.parametrize("adjacency", ["ntu", "dense"])
@pytest.mark.parametrize("frames,c_in,c_out", SHAPES)
def test_f32_kernels_match_f64_in_emulation(harness, frames, c_in, c_out,
                                            adjacency):
    """Forward, stats, dx and dW/db against f64 at the tile edges, with the
    model's graph (73 nonzeros, one row of four) and a dense adjacency (25
    a row: the lists full)."""
    exe, files = harness
    proc = subprocess.run(
        [str(exe), str(files[adjacency]), str(frames), str(c_in),
         str(c_out)], capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    errors = dict(line.split() for line in proc.stdout.splitlines())
    assert set(errors) == {"out", "out_stats", "s", "ss", "dx", "dW", "db"}
    bad = {k: v for k, v in errors.items() if not float(v) <= REL_TOL}
    assert not bad, bad
