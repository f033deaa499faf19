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
