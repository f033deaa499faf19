"""The port's native host runtime (``native/``: crc32c, the ``.skeleton``
parser, the one-call TFRecord decoder) against the JAX package's, bit for
bit, on synthetic files (``scripts/corpus_lib.py``); its build under
concurrent processes; and the routes through it by default and around it
with ``use_native=False``."""

import ctypes
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from scripts import corpus_lib
from skeleton_action_recognition_tpu import native as jax_native
from skeleton_action_recognition_tpu.data import skeleton as jax_skeleton
from skeleton_action_recognition_tpu.data import tfrecord as jax_tfrecord
from skeleton_action_recognition_tpu_torch import native
from skeleton_action_recognition_tpu_torch.data import skeleton, tfrecord
from test_torch_data_gen import hand_written_cases, write_skeleton

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory):
    """The JAX package's native library, built by its own Makefile into a
    temporary file (its in-tree build races under several test workers,
    ROADMAP.md Tier-1) with the port's flags, and loaded by its own loader.
    The Makefile's ``-march=native`` would let g++ fuse the parser's
    multiply-adds, which moves a double's last bit; the port builds for any
    x86-64 host."""
    lib = tmp_path_factory.mktemp("jax_native") / "libsar_native.so"
    flags = " ".join(f for f in native.CXX_FLAGS if f != "-shared")
    subprocess.run(
        ["make", "-s", "-C", str(pathlib.Path(jax_native.__file__).parent),
         f"LIB={lib}", f"CXXFLAGS={flags}"],
        check=True, capture_output=True,
    )
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_LIB_PATH", str(lib))
        mp.setattr(jax_native, "_lib", None)
        mp.setattr(jax_native, "_load_failed", False)
        assert jax_native.load() is not None
        yield jax_native


def table_crc32c(data: bytes) -> int:
    """crc32c one byte at a time over the JAX package's table."""
    crc = np.uint32(0xFFFFFFFF)
    for b in data:
        crc = jax_tfrecord._TABLE[(crc ^ b) & np.uint32(0xFF)] ^ (
            crc >> np.uint8(8))
    return int(crc ^ np.uint32(0xFFFFFFFF))


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 100, 4096, 65537])
def test_crc32c_equals_jax(jax_lib, n):
    data = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
    want = table_crc32c(data)
    assert native.crc32c(data) == jax_lib.crc32c(data) == want
    assert tfrecord.crc32c(data) == tfrecord.crc32c(data, use_native=False)
    assert tfrecord.crc32c(data) == want


@pytest.fixture(scope="module")
def skeleton_files(tmp_path_factory):
    """corpus_lib's one-body clips (6 classes) and the hand-written
    multi-body cases of ``test_torch_data_gen.py`` (five bodies, bodies
    coming and going, empty frames)."""
    root = tmp_path_factory.mktemp("skeletons")
    corpus_lib.synthesize_corpus(str(root), clips_per_class=1, seed=4,
                                 num_classes=6)
    for name, frames in hand_written_cases(np.random.default_rng(0)).items():
        write_skeleton(str(root / f"S001C001P001R001A00{len(name) % 9}"
                                  f"_{name}.skeleton"), frames)
    return sorted(root.iterdir())


def test_parse_skeleton_equals_jax(jax_lib, skeleton_files):
    assert len(skeleton_files) == 11
    for path in skeleton_files:
        text = path.read_bytes()
        frames = int(text.split(None, 1)[0])
        got = native.parse_skeleton(text, 4, frames, 25)
        want = jax_lib.parse_skeleton(text, 4, frames, 25)
        assert got.dtype == np.float32 and got.shape == (4, frames, 25, 3)
        np.testing.assert_array_equal(got, want)
        # frames past max_frames are dropped, as in JAX
        np.testing.assert_array_equal(
            native.parse_skeleton(text, 2, 3, 25),
            jax_lib.parse_skeleton(text, 2, 3, 25))


def test_read_xyz_native_route_equals_jax(jax_lib, skeleton_files):
    """``read_xyz``'s default route is the JAX package's native one, bit
    for bit; the Python route (float64 coordinates) within float32
    rounding of it."""
    for path in skeleton_files:
        got = skeleton.read_xyz(str(path))
        np.testing.assert_array_equal(
            got, jax_skeleton.read_xyz(str(path), use_native=True))
        np.testing.assert_allclose(
            got, skeleton.read_xyz(str(path), use_native=False),
            rtol=1e-6, atol=1e-7)


def test_a_malformed_skeleton_raises(tmp_path):
    """A non-numeric coordinate is a parse error (the JAX parser leaves
    the coordinate unset); the Python route raises too."""
    frames = hand_written_cases(np.random.default_rng(0))["one_body"]
    path = tmp_path / "S001C001P001R001A001.skeleton"
    write_skeleton(str(path), frames)
    lines = path.read_text().splitlines()
    lines[4] = "abc " + lines[4].split(" ", 1)[1]
    path.write_text("\n".join(lines) + "\n")
    with pytest.raises(ValueError, match="parse error"):
        skeleton.read_xyz(str(path))
    with pytest.raises(ValueError):
        skeleton.read_xyz(str(path), use_native=False)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """corpus_lib clips ``(3, 40, 25, 2)`` of 6 classes in 3 shards."""
    root = tmp_path_factory.mktemp("shards")
    rng = np.random.default_rng(5)
    x = np.stack([np.stack([corpus_lib.make_clip(i % 6, rng, 40)
                            .transpose(2, 0, 1)] * 2, -1) for i in range(14)])
    paths = tfrecord.write_dataset(x.astype(np.float32), np.arange(14) % 6,
                                   str(root), "n", num_shards=3)
    return paths, x


def test_count_and_decode_equal_jax(jax_lib, shards):
    paths, x = shards
    rows = []
    for path in paths:
        n = native.count_records(path)
        assert n == jax_lib.count_records(path) == tfrecord.count_records(
            path, use_native=False)
        feats, labels = native.decode_tfrecord(path, n, (3, 40, 25, 2))
        want_f, want_l = jax_lib.decode_tfrecord(path, n, (3, 40, 25, 2))
        np.testing.assert_array_equal(feats, want_f)
        np.testing.assert_array_equal(labels, want_l)
        assert labels.dtype == np.int64
        for a, b in zip(tfrecord.decode_shard(path),
                        tfrecord.decode_shard(path, use_native=False)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
        rows.append(feats)
    np.testing.assert_array_equal(np.concatenate(rows), x)
    assert [native.count_records(p) for p in paths] == [4, 4, 6]


def test_decode_refuses_what_jax_refuses(jax_lib, shards, tmp_path):
    """A wrong sample shape, a flipped payload byte (crc) and a truncated
    shard raise with the JAX decoder's codes."""
    path = shards[0][0]
    with pytest.raises(IOError, match="code -5"):
        native.decode_tfrecord(path, 4, (3, 40, 25, 1))
    whole = open(path, "rb").read()
    (tmp_path / "cut.tfrecord").write_bytes(whole[:-10])
    data = bytearray(whole)
    data[100] ^= 0xFF
    (tmp_path / "crc.tfrecord").write_bytes(bytes(data))
    with pytest.raises(IOError, match="code -3"):
        native.decode_tfrecord(tmp_path / "crc.tfrecord", 4, (3, 40, 25, 2))
    with pytest.raises(IOError, match="code -2"):
        native.decode_tfrecord(tmp_path / "cut.tfrecord", 4, (3, 40, 25, 2))
    for name in ("crc", "cut"):
        with pytest.raises(IOError):
            jax_lib.decode_tfrecord(str(tmp_path / f"{name}.tfrecord"), 4,
                                    (3, 40, 25, 2))


def test_processes_building_at_once_all_load(tmp_path):
    """Four processes build the library into one empty directory at the
    same moment: each builds under a private name and renames it into
    place, so every one loads a whole library and no temporary is left."""
    code = (
        "import ctypes, pathlib, sys\n"
        f"sys.path.insert(0, {str(REPO_ROOT)!r})\n"
        "from skeleton_action_recognition_tpu_torch import native\n"
        "lib = ctypes.CDLL(str(native.build(pathlib.Path(sys.argv[1]))))\n"
        "lib.sar_crc32c.restype = ctypes.c_uint32\n"
        "lib.sar_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t]\n"
        "assert lib.sar_crc32c(b'123456789', 9) == 0xE3069283\n"
    )
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for _ in range(4)]
    try:
        logs = [p.communicate(timeout=120)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    assert [p.name for p in tmp_path.iterdir()] == [
        native.library_path(tmp_path).name]


def test_a_failed_build_raises_unless_the_python_route_is_asked_for(
        monkeypatch, tmp_path, shards):
    monkeypatch.setenv("PATH", str(tmp_path))  # no g++
    native.compiler.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            native.build(tmp_path / "build")
    finally:
        native.compiler.cache_clear()

    def no_library():
        raise RuntimeError("no native library")

    monkeypatch.setattr(native, "load", no_library)
    path = shards[0][0]
    with pytest.raises(RuntimeError, match="no native library"):
        tfrecord.count_records(path)
    with pytest.raises(RuntimeError, match="no native library"):
        tfrecord.crc32c(b"x")
    assert tfrecord.count_records(path, use_native=False) == 4
    assert tfrecord.decode_shard(path, use_native=False)[0].shape == (
        4, 3, 40, 25, 2)


def test_the_library_is_keyed_on_sources_and_flags(monkeypatch, tmp_path):
    first = native.library_path(tmp_path)
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-g",))
    assert native.library_path(tmp_path) != first
    assert first.parent == tmp_path and first.suffix == ".so"
