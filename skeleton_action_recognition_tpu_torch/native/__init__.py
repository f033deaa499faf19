"""The C++ host runtime: crc32c, the ``.skeleton`` parser and the one-call
TFRecord shard decoder, loaded with ``ctypes``.

Counterpart of ``skeleton_action_recognition_tpu/native/``, with its own
copies of the three sources (``crc32c.cc``, ``skeleton_parser.cc``,
``tfrecord_decoder.cc``) and the same entry points. At first use the
sources are compiled with ``g++`` into ``_build/libsar_native-<digest>.so``
beside the CUDA libraries (gitignored); the digest covers the sources, the
flags and the compiler's version and target, so an edited source (or a
library left by another toolchain) is rebuilt and an unchanged one
reused.
Each process builds under a private name and renames the result into
place, so processes that build at once never load a half-written library.

Where the JAX package falls back to Python when the library does not build
or load, this module raises: callers that want the Python or numpy route
ask for it with ``use_native=False``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import subprocess

import numpy as np

SOURCE_DIR = pathlib.Path(__file__).resolve().parent
SOURCES = ("crc32c.cc", "skeleton_parser.cc", "tfrecord_decoder.cc")
BUILD_DIR = SOURCE_DIR.parent / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_FLOAT_P = ctypes.POINTER(ctypes.c_float)
_INT64_P = ctypes.POINTER(ctypes.c_int64)
# name: (restype, argtypes)
_SIGNATURES = {
    "sar_crc32c": (ctypes.c_uint32, [ctypes.c_char_p, ctypes.c_size_t]),
    "sar_parse_skeleton": (ctypes.c_long, [
        ctypes.c_char_p, ctypes.c_size_t, _FLOAT_P, ctypes.c_long,
        ctypes.c_long, ctypes.c_long,
    ]),
    "sar_count_records": (ctypes.c_long, [ctypes.c_char_p]),
    "sar_decode_tfrecord_file": (ctypes.c_long, [
        ctypes.c_char_p, _FLOAT_P, _INT64_P, ctypes.c_long, ctypes.c_long,
        ctypes.c_int,
    ]),
}


@functools.cache
def compiler() -> str:
    """``g++``'s version line and target triple; raises ``RuntimeError``
    when there is no ``g++``."""
    try:
        out = [subprocess.run(["g++", flag], capture_output=True, text=True,
                              check=True).stdout.splitlines()[0]
               for flag in ("--version", "-dumpmachine")]
    except (OSError, subprocess.CalledProcessError) as err:
        raise RuntimeError(
            "g++ not found: the native host library cannot be built; pass "
            "use_native=False to take the Python route"
        ) from err
    return " ".join(out)


def library_path(build_dir: pathlib.Path = BUILD_DIR) -> pathlib.Path:
    """Where the library for the current sources, flags and compiler
    lives."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS + (compiler(),)).encode())
    for name in SOURCES:
        digest.update(name.encode())
        digest.update((SOURCE_DIR / name).read_bytes())
    return build_dir / f"libsar_native-{digest.hexdigest()[:16]}.so"


def build(build_dir: pathlib.Path = BUILD_DIR) -> pathlib.Path:
    """Compile the sources unless their library exists; returns its path.
    Raises ``RuntimeError`` when ``g++`` is missing or fails."""
    lib = library_path(build_dir)
    if lib.exists():
        return lib
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp")
    proc = subprocess.run(
        ["g++", *CXX_FLAGS, "-o", str(tmp),
         *(str(SOURCE_DIR / name) for name in SOURCES)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"g++ failed on the native sources ({proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)
    return lib


@functools.cache
def load() -> ctypes.CDLL:
    """The native library, built at first use."""
    lib = ctypes.CDLL(str(build()))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def crc32c(data: bytes) -> int:
    """crc32c (Castagnoli) of ``data``."""
    return int(load().sar_crc32c(data, len(data)))


def parse_skeleton(text: bytes, max_body: int, max_frames: int,
                   num_joint: int) -> np.ndarray:
    """Parse raw ``.skeleton`` bytes -> ``(max_body, T, V, 3)`` float32,
    ``T = min(frames, max_frames)``; bodies past ``max_body`` and joints
    past ``num_joint`` are dropped. Raises ``ValueError`` on a malformed
    file."""
    out = np.zeros((max_body, max_frames, num_joint, 3), np.float32)
    n = load().sar_parse_skeleton(
        text, len(text), out.ctypes.data_as(_FLOAT_P), max_body,
        max_frames, num_joint,
    )
    if n < 0:
        raise ValueError(f".skeleton parse error (code {n})")
    return out[:, :n]


def count_records(path) -> int:
    """Record count of one TFRecord shard by walking the framing (no crc,
    no decode)."""
    n = int(load().sar_count_records(os.fsencode(path)))
    if n < 0:
        raise IOError(f"{path}: corrupt TFRecord framing (code {n})")
    return n


def decode_tfrecord(path, num_records: int, sample_shape: tuple,
                    check_crc: bool = True):
    """Decode one whole shard of at most ``num_records`` records ->
    ``(feats (N, *sample_shape) float32, labels (N,) int64)``. ctypes
    releases the GIL for the call, so shards decode in parallel from a
    thread pool. Raises ``IOError`` on a corrupt frame, crc or proto, or a
    sample whose tensor does not hold ``sample_shape``'s element count."""
    feat_len = int(np.prod(sample_shape))
    feats = np.empty((num_records, feat_len), np.float32)
    labels = np.empty((num_records,), np.int64)
    n = int(load().sar_decode_tfrecord_file(
        os.fsencode(path), feats.ctypes.data_as(_FLOAT_P),
        labels.ctypes.data_as(_INT64_P), num_records, feat_len,
        1 if check_crc else 0,
    ))
    if n < 0:
        raise IOError(f"{path}: TFRecord decode error (code {n})")
    return feats[:n].reshape((n,) + tuple(sample_shape)), labels[:n]
