"""The STFT log-magnitude kernels (``csrc/stft_fft.cuh``: kernel #10's
forward, kernel #11's backward and its reflect fold) run on the CPU in an
emulation of the CUDA constructs they use (``tests/cuda_emulation/``),
against f64 references: a direct DFT of the windowed frames and its
adjoint.

The card is where the kernels are checked against their plain versions
(``test_torch_stft_gpu.py``, ``chip_smoke.py``); this holds their FFT
passes, frame and sample ranges, overlap-add and fold on the CPU, where no
CUDA compiler exists. The header is compiled by the host's C++ compiler: a
block's threads are threads, ``__syncthreads`` a barrier, shared memory
starts as NaN (and must stay NaN past a block's allocation), and the
address and undefined-behaviour sanitizers watch every access.
"""

import pathlib
import shutil
import subprocess

import pytest

from skeleton_action_recognition_tpu_torch.ops import build

EMULATION = pathlib.Path(__file__).resolve().parent / "cuda_emulation"
# (n_fft, hop, F, T, signals, center, fftshift, window): the model's n_fft
# 256 and hop 16, also with F < n_fft; the three radix plans (64 = 16 x 4,
# 256 = 16 x 16, 1024 = 16 x 16 x 4) and the other two (128, 512 = 16 x
# 16 x 2); hop 1, n_fft and one that does not divide n_fft; the shortest
# centered T (n_fft / 2 + 2) and uncentered T (n_fft); T whose frames are no
# multiple of a forward block's (4,096 / n_fft) and whose samples are none
# of a backward block's; a fold whose two mirrors meet (T = 34 at n_fft 64).
# Hann zeroes the window's first tap, and with it the cotangent of the
# padding's first sample; the Hamming cases hold that sample's fold too.
CASES = [
    (256, 16, 256, 600, 2, 1, 1, "hann"),
    (256, 16, 256, 600, 1, 1, 1, "hamming"),
    (256, 16, 256, 3001, 1, 1, 1, "hann"),
    (256, 16, 100, 1000, 1, 1, 1, "hann"),
    (256, 1, 256, 200, 1, 1, 1, "hamming"),
    (256, 256, 256, 2000, 1, 1, 1, "hann"),
    (256, 100, 256, 2000, 1, 1, 0, "hann"),
    (256, 16, 256, 130, 1, 1, 1, "hamming"),
    (256, 16, 200, 256, 1, 0, 0, "hann"),
    (64, 16, 64, 500, 1, 1, 1, "hann"),
    (64, 1, 64, 200, 1, 1, 0, "hann"),
    (64, 64, 40, 777, 1, 0, 1, "hamming"),
    (64, 16, 64, 34, 1, 1, 1, "hamming"),
    (128, 32, 128, 700, 1, 1, 0, "hann"),
    (512, 16, 300, 1500, 1, 1, 1, "hann"),
    (1024, 16, 1024, 700, 1, 1, 1, "hamming"),
    (1024, 1, 1024, 1060, 1, 0, 1, "hann"),
    (1024, 1024, 700, 5000, 1, 0, 0, "hann"),
]
# kernel vs f64, the checks of chip_smoke.py: log|S| to 5e-4 absolute,
# |S| + eps to 1e-5 of its largest, the (re, im) cotangent to 2e-3 of its
# largest (f32 FFTs of at most 1,024 points: 1e-5, 3e-7 and 3e-5 measured)
LOG_ATOL, MAG_TOL, GRAD_TOL = 5e-4, 1e-5, 2e-3


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    compiler = shutil.which("g++")
    if compiler is None:
        pytest.skip("needs a C++20 compiler (g++)")
    tmp = tmp_path_factory.mktemp("stft_emulation")
    for path in EMULATION.iterdir():
        shutil.copy(path, tmp / path.name)
    shutil.copy(build.CSRC_DIR / "stft_fft.cuh", tmp / "stft_fft.cuh")
    exe = tmp / "harness"
    proc = subprocess.run(
        [compiler, "-std=c++20", "-O1", "-g", "-fsanitize=address,undefined",
         "-fno-sanitize-recover=undefined", "-Wno-unknown-pragmas",
         "-pthread", f"-I{tmp}", "-include", "cuda_shim.h",
         str(tmp / "stft_harness.cpp"), "-o", str(exe)],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return exe


@pytest.mark.parametrize("n_fft,hop,f,t,signals,center,fftshift,window",
                         CASES)
def test_stft_kernels_match_f64_in_emulation(harness, n_fft, hop, f, t,
                                             signals, center, fftshift,
                                             window):
    """Forward, backward and fold against f64, and a second launch of each
    bit for bit."""
    proc = subprocess.run(
        [str(harness), *map(str, (n_fft, hop, f, t, signals, center,
                                  fftshift, int(window == "hamming")))],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = dict(line.split() for line in proc.stdout.splitlines())
    assert set(got) == {"log", "mag", "dre", "dim", "repeat"}
    assert got["repeat"] == "1"
    limits = {"log": LOG_ATOL, "mag": MAG_TOL, "dre": GRAD_TOL,
              "dim": GRAD_TOL}
    bad = {k: got[k] for k, tol in limits.items()
           if not float(got[k]) <= tol}
    assert not bad, bad
