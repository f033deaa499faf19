"""The spline radar kernels (``csrc/radar_spline.cuh``: kernel #6's
forward, kernel #7's backward in its full and its loc/lambda instance, and
their sums) run on the CPU in an emulation of the CUDA constructs they use
(``tests/cuda_emulation/``), against an f64 transcription of their plain
versions.

The card is where the kernels are checked against their plain versions
(``test_torch_radar_gpu.py``, ``chip_smoke.py``), with their approximate
reciprocals and square roots; this holds their slot search, the backward's
runs, flushes, entries and fixed-order sums on the CPU, where no CUDA
compiler exists. The header is compiled by the host's C++ compiler (the
approximate operations become exact ones): a block's threads are threads,
``__syncthreads`` a barrier, shared memory starts as NaN (and must stay NaN
past a block's allocation), and the address and undefined-behaviour
sanitizers watch every access.
"""

import pathlib
import shutil
import subprocess

import pytest

from skeleton_action_recognition_tpu_torch.ops import build

EMULATION = pathlib.Path(__file__).resolve().parent / "cuda_emulation"
# (N, T_in, upsample, tile, EM, lambda, zero body, shuffle): the model's 48
# edge-body pairs (4 runs of tile / 4 rows a thread) at tile 128 (segments
# of ~20 rows: ~7 slots a tile, every run crosses a segment boundary; 40
# pad rows) and tile 256 (168 pad rows); segments of ~175 rows in 512-row
# tiles, some spanning 4 slots; 5 pairs (38 runs of 3-4 rows) and 200
# pairs (one run, some threads two pairs); an all-zero body (c = 0); a
# tile whose slots run backwards (NaN in its dsrc/ddst, the rest exact).
CASES = [
    (2, 30, 20, 128, 48, 5e-4, 1, 0),
    (2, 30, 20, 256, 48, 10.0, 1, 0),
    (1, 12, 160, 512, 48, 5e-4, 1, 0),
    (2, 12, 160, 512, 48, 10.0, 0, 0),
    (2, 30, 20, 128, 5, 10.0, 1, 0),
    (1, 30, 20, 256, 200, 10.0, 0, 0),
    (2, 30, 20, 128, 48, 10.0, 0, 1),
]
# kernel vs f64, max |diff| over the largest sum of |terms| of an output
# (f32 rounding of a sum grows with its terms; dc, dloc and dlambda cancel),
# to the tolerances of chip_smoke.py's RADAR_TOL: at lambda = 5e-4 the phase
# is ~1e4 rad, and f32 rounds it by ~1e-3 rad (2e-3 for the return, 1e-2
# for the cotangents; 1.0e-3 and 4.7e-4 measured); at lambda = 10, f32
# rounding of the sums (1e-4; 1.6e-5 measured)
TOL = {5e-4: (2e-3, 1e-2), 10.0: (1e-4, 1e-4)}


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    compiler = shutil.which("g++")
    if compiler is None:
        pytest.skip("needs a C++20 compiler (g++)")
    tmp = tmp_path_factory.mktemp("radar_emulation")
    for path in EMULATION.iterdir():
        shutil.copy(path, tmp / path.name)
    for name in ("radar_spline.cuh", "radar_math.cuh"):
        shutil.copy(build.CSRC_DIR / name, tmp / name)
    exe = tmp / "harness"
    proc = subprocess.run(
        [compiler, "-std=c++20", "-O1", "-g", "-fsanitize=address,undefined",
         "-fno-sanitize-recover=undefined", "-Wno-unknown-pragmas",
         "-pthread", f"-I{tmp}", "-include", "cuda_shim.h",
         str(tmp / "radar_harness.cpp"), "-o", str(exe)],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return exe


@pytest.mark.parametrize("n,t_in,up,tile,em,lam,zero_body,shuffle", CASES)
def test_spline_radar_kernels_match_f64_in_emulation(harness, n, t_in, up,
                                                     tile, em, lam,
                                                     zero_body, shuffle):
    """#6, #7 and #7's loc/lambda instance against f64; the instance's
    dloc/dlambda equal to the full one's, and a second launch of each
    kernel, bit for bit."""
    proc = subprocess.run(
        [str(harness), *map(str, (n, t_in, up, tile, em, lam, zero_body,
                                  shuffle))],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = dict(line.split() for line in proc.stdout.splitlines())
    assert got["repeat"] == "1"
    assert got["loc_lam_same"] == "1"
    assert int(got["nan_blocks"]) == (n if shuffle else 0)
    if (up, tile) == (160, 512):
        assert int(got["max_slots"]) == 4
    fwd_tol, bwd_tol = TOL[lam]
    limits = {"re": fwd_tol, "im": fwd_tol, **{
        k: bwd_tol for k in ("dsrc", "ddst", "dc", "dloc", "dlam",
                             "dloc_ll", "dlam_ll")}}
    bad = {k: got[k] for k, tol in limits.items()
           if not float(got[k]) <= tol}
    assert not bad, bad
