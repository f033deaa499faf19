"""Build the package's CUDA sources into a shared library at first use.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``) into
``_build/<stem>-<digest>.so`` and loaded with ``ctypes``. The digest covers
every file under ``csrc/`` and the compiler flags, so an edited source is
rebuilt and an unchanged one is reused. The compiler's register and
shared-memory report (``-Xptxas -v``) is kept beside the library as
``<stem>-<digest>.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

from skeleton_action_recognition_tpu_torch import tracing

PACKAGE_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found under {cuda_home}/bin or on PATH; the CUDA "
            "kernels are built only on a machine with the CUDA toolkit"
        )
    return found


def library_path(source: str) -> pathlib.Path:
    """Where ``csrc/<source>``'s library lives for the current sources."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.iterdir()):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    stem = pathlib.Path(source).stem
    return BUILD_DIR / f"{stem}-{digest.hexdigest()[:16]}.so"


@functools.cache
def load_library(source: str) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` unless its library exists, and load it."""
    lib = library_path(source)
    if not lib.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        # build under a private name and rename, so that processes building
        # at once never load a half-written library
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {source} ({proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)
    return ctypes.CDLL(str(lib))


@functools.cache
def kernel_function(source: str, name: str, n_pointers: int, n_ints: int,
                    n_floats: int = 0):
    """The C entry point ``name`` of ``csrc/<source>``: it takes
    ``n_pointers`` device pointers, ``n_ints`` ints, ``n_floats`` floats and
    the CUDA stream, launches its kernels on that stream and returns the
    ``cudaError_t`` of the launch."""
    fn = getattr(load_library(source), name)
    fn.argtypes = (
        [ctypes.c_void_p] * n_pointers + [ctypes.c_int] * n_ints
        + [ctypes.c_float] * n_floats + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


# shared memory one block may use on an H100 (sm_90)
MAX_SMEM_BYTES = 232448


def check_cuda(kernel: str, **tensors) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor: ``kernel``'s
    kernels take nothing else."""
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"no {kernel} kernel for device {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def raw_stream(index: int) -> int:
    """The ``cudaStream_t`` of card ``index``'s current stream."""
    import torch

    return torch._C._cuda_getCurrentRawStream(index)


def launch(fn, name: str, device, *args) -> None:
    """Call ``fn(*args, stream)`` on ``device`` with its current stream;
    raise if the launch was refused. Every kernel of the package is
    launched here: each call counts as ``launch.<name>``
    (:func:`..tracing.counters`) and, under a profiler, is the range
    ``op.<name>`` around the kernels the entry point enqueues. The card is
    switched only when ``device`` is not the current one, and the stream
    is read as its raw handle: a launch's host time is most of a small
    kernel's."""
    import torch

    tracing.count(f"launch.{name}")
    here = torch.cuda.current_device()
    index = getattr(device, "index", None)
    index = here if index is None else index
    with tracing.span(f"op.{name}"):
        if index == here:
            err = fn(*args, raw_stream(index))
        else:
            with torch.cuda.device(index):
                err = fn(*args, raw_stream(index))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")
