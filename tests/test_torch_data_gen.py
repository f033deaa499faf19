"""The port's data generation (``.skeleton`` -> ``.npy``/``.pkl``/TFRecord)
against the JAX package's: parsing and body selection, the split, the
rotations, both pre-normalizations and ``cli/data_gen.py``'s artifacts byte
for byte, on seeded synthetic clips (``scripts/corpus_lib.py``) and
hand-written files with several bodies and empty frames."""

import functools
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scripts import corpus_lib
from skeleton_action_recognition_tpu.cli import data_gen as jax_data_gen
from skeleton_action_recognition_tpu.data import preprocess as jax_preprocess
from skeleton_action_recognition_tpu.data import rotation as jax_rotation
from skeleton_action_recognition_tpu.data import skeleton as jax_skeleton
from skeleton_action_recognition_tpu_torch import data as port_data
from skeleton_action_recognition_tpu_torch.cli import data_gen
from skeleton_action_recognition_tpu_torch.data import (
    preprocess,
    rotation,
    skeleton,
)
import torch_parity_helpers  # noqa: F401  (caps torch's threads)


def write_skeleton(path, frames, num_joints=25):
    """An NTU ``.skeleton`` file of ``frames``, a list of ``(bodies,
    num_joints, 3)`` arrays (``bodies`` may be 0)."""
    lines = [str(len(frames))]
    for bodies in frames:
        lines.append(str(len(bodies)))
        for b, joints in enumerate(bodies):
            lines.append(f"{1000 + b} 0 1 1 1 1 0 0.0 0.0 2")
            lines.append(str(num_joints))
            for x, y, z in joints:
                lines.append(f"{x:.5f} {y:.5f} {z:.5f} 0 0 0 0 0 0 0 0 2")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def body_frames(rng, t, scales, present=None):
    """``t`` frames of ``len(scales)`` bodies whose motion grows with their
    scale (the energy order); ``present[f]`` bodies in frame ``f``."""
    base = rng.normal(size=(len(scales), 1, 25, 3))
    motion = rng.normal(size=(len(scales), t, 25, 3))
    bodies = base + np.asarray(scales)[:, None, None, None] * motion
    counts = present if present is not None else [len(scales)] * t
    return [bodies[:counts[f], f] for f in range(t)]


def hand_written_cases(rng):
    """``{name: frames}`` of the parser's edge cases."""
    quiet_first = body_frames(rng, 12, [0.01, 0.5, 0.2])
    empty = [np.zeros((0, 25, 3))]
    return {
        "one_body": body_frames(rng, 9, [0.3]),
        # four bodies: the two most moving (the 2nd and 4th) are kept
        "four_bodies": body_frames(rng, 10, [0.05, 0.4, 0.1, 0.8]),
        # five tracked bodies: the fifth is past MAX_BODY_KINECT
        "five_bodies": body_frames(rng, 7, [0.1, 0.2, 0.3, 0.4, 2.0]),
        # bodies come and go between frames
        "varying_bodies": body_frames(
            rng, 10, [0.2, 0.6, 0.4], present=[1, 2, 3, 3, 2, 1, 3, 2, 2, 1]
        ),
        # an empty first frame and two empty interior frames
        "empty_frames": empty + quiet_first[1:4] + empty * 2
        + quiet_first[6:],
    }


HAND_WRITTEN = sorted(hand_written_cases(np.random.default_rng(0)))


@pytest.mark.parametrize("case", HAND_WRITTEN)
def test_read_xyz_matches_jax(tmp_path, case):
    frames = hand_written_cases(np.random.default_rng(0))[case]
    path = str(tmp_path / "S001C001P001R001A001.skeleton")
    write_skeleton(path, frames)
    got = skeleton.read_xyz(path, use_native=False)
    want = jax_skeleton.read_xyz(path, use_native=False)
    assert got.shape == (3, len(frames), 25, 2) and got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    num_frames, parsed = skeleton.parse_skeleton_file(path)
    ref_frames, ref_parsed = jax_skeleton.parse_skeleton_file(path)
    assert num_frames == ref_frames
    for a, b in zip(parsed, ref_parsed):
        np.testing.assert_array_equal(a, b)


def test_energy_keeps_the_two_most_moving_bodies(tmp_path):
    frames = hand_written_cases(np.random.default_rng(0))["four_bodies"]
    path = str(tmp_path / "S001C001P001R001A001.skeleton")
    write_skeleton(path, frames)
    got = skeleton.read_xyz(path)
    kept = [np.stack([f[b] for f in frames]) for b in (3, 1)]
    for m, body in enumerate(kept):
        np.testing.assert_allclose(got[..., m].transpose(1, 2, 0), body,
                                   atol=1e-5)


def _names(rng, n):
    return [
        f"S{rng.integers(1, 18):03d}C{rng.integers(1, 4):03d}"
        f"P{rng.integers(1, 41):03d}R{rng.integers(1, 3):03d}"
        f"A{rng.integers(1, 61):03d}.skeleton"
        for _ in range(n)
    ]


@pytest.mark.parametrize("benchmark", ["xview", "xsub"])
@pytest.mark.parametrize("part", ["train", "val"])
def test_split_and_metadata_match_jax(tmp_path, benchmark, part):
    names = _names(np.random.default_rng(1), 200)
    skip = tmp_path / "missing.txt"
    skip.write_text("\n".join(n[:-9] for n in names[::17]) + "\n\n")
    ignored = skeleton.load_ignored_samples(str(skip))
    assert ignored == jax_skeleton.load_ignored_samples(str(skip))
    assert skeleton.load_ignored_samples(None) == []
    got = skeleton.split_samples(names, benchmark, part, ignored)
    assert got == jax_skeleton.split_samples(names, benchmark, part, ignored)
    assert 0 < len(got[0]) < 200
    for name in names[:20]:
        assert skeleton.sample_metadata("raw/" + name) == (
            jax_skeleton.sample_metadata("raw/" + name))


def test_split_and_metadata_refuse_what_jax_refuses():
    for module in (skeleton, jax_skeleton):
        with pytest.raises(ValueError, match="not an NTU sample"):
            module.sample_metadata("clip.skeleton")
        with pytest.raises(ValueError, match="unknown part"):
            module.split_samples([], "xview", "test")
        with pytest.raises(ValueError, match="unknown benchmark"):
            module.split_samples(["S001C001P001R001A001.skeleton"], "xset",
                                 "train")


def test_constants_match_jax():
    for name in ("TRAINING_SUBJECTS", "TRAINING_CAMERAS", "MAX_BODY_TRUE",
                 "MAX_BODY_KINECT", "NUM_JOINTS", "MAX_FRAMES"):
        assert getattr(skeleton, name) == getattr(jax_skeleton, name)


def raw_clips(n, t=40, seed=2):
    """``(n, 3, 300, 25, 2)`` float32 joints as ``gen_joint_data`` stores
    them (frames past ``t`` zero), from corpus_lib's class skeletons, with
    the degenerate cases: an all-zero clip (0), an empty second body (1),
    an empty first frame and interior empty frames in both bodies (2), a
    first body that starts late (3)."""
    rng = np.random.default_rng(seed)
    x = np.zeros((n, 3, 300, 25, 2), np.float32)
    for i in range(n):
        for m in range(2):
            clip = corpus_lib.make_clip(i % 60, rng, t, difficulty=0.5)
            x[i, :, :t, :, m] = clip.transpose(2, 0, 1)
    x[0] = 0.0
    x[1, ..., 1] = 0.0
    x[2, :, 0] = 0.0
    x[2, :, 5:8] = 0.0
    x[3, :, :10, :, 0] = 0.0
    return x


def test_pre_normalize_np_is_jax_bit_for_bit():
    x = raw_clips(8)
    got = preprocess.pre_normalize_np(x)
    want = jax_preprocess.pre_normalize_np(x)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], 0.0)


@pytest.mark.parametrize("case", ["clips", "all_zero", "empty_second_body",
                                  "empty_first_frame", "late_first_body"])
def test_torch_pre_normalize_matches_jax(case):
    x = raw_clips(5)
    x = {"clips": x[1:], "all_zero": x[:1], "empty_second_body": x[1:2],
         "empty_first_frame": x[2:3], "late_first_body": x[3:4]}[case]
    got = preprocess.pre_normalize(torch.from_numpy(x))
    want = np.asarray(jax_preprocess.pre_normalize(jnp.asarray(x)))
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # the numpy version, in float64, is the oracle of both
    oracle = preprocess.pre_normalize_np(x.astype(np.float64))
    np.testing.assert_allclose(got.numpy(), oracle, rtol=0, atol=1e-5)


@pytest.mark.parametrize("axis,theta", [
    ([0.3, -0.2, 0.9], 0.7), ([0.0, 0.0, 0.0], 1.0),
    ([1e-7, 0.0, 0.0], 1.0), ([0.0, 1.0, 0.0], 1e-7), ([1.0, 2.0, 3.0], -2.5),
])
def test_rotation_matches_jax(axis, theta):
    axis = np.asarray(axis)
    want = np.asarray(jax_rotation.rotation_matrix(
        jnp.asarray(axis, jnp.float32), jnp.float32(theta)))
    np.testing.assert_array_equal(
        rotation.rotation_matrix_np(axis, theta),
        jax_rotation.rotation_matrix_np(axis, theta))
    got = rotation.rotation_matrix(torch.tensor(axis, dtype=torch.float32),
                                   torch.tensor(theta))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    v2 = np.asarray([0.0, 0.0, 1.0])
    assert rotation.angle_between_np(axis, v2) == (
        jax_rotation.angle_between_np(axis, v2))
    got = rotation.angle_between(torch.tensor(axis, dtype=torch.float32),
                                 torch.tensor(v2, dtype=torch.float32))
    want = jax_rotation.angle_between(jnp.asarray(axis, jnp.float32),
                                      jnp.asarray(v2, jnp.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def write_raw_corpus(raw):
    """corpus_lib's clips (4 classes x 3: every camera, subjects 1-3) and
    the hand-written multi-body files, named into both benchmarks'
    parts."""
    corpus_lib.synthesize_corpus(str(raw), clips_per_class=3, seed=3,
                                 num_classes=4, difficulty=0.3)
    cases = hand_written_cases(np.random.default_rng(4))
    for i, name in enumerate(HAND_WRITTEN):
        cam, subject = (1, 2, 3, 1, 2)[i], (3, 1, 5, 2, 9)[i]
        write_skeleton(
            str(raw / f"S002C{cam:03d}P{subject:03d}R001A{i + 5:03d}"
                      ".skeleton"), cases[name])


def tree_bytes(root):
    out = {}
    for directory, _, files in os.walk(root):
        for name in files:
            path = os.path.join(directory, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


STREAMS = ["joint", "bone", "joint_motion", "bone_motion"]


@pytest.mark.parametrize("jax_parser", ["default", "python"])
def test_data_gen_artifacts_equal_jax_byte_for_byte(tmp_path, monkeypatch,
                                                    jax_parser):
    """Both benchmarks, both parts, all four streams. ``default``: the JAX
    package reads with its C++ parser where it loads (else its Python
    one); ``python``: its Python tokenizer, the port's route (its crc32c
    stays native where it loads: the Python one takes minutes here)."""
    raw = tmp_path / "raw"
    write_raw_corpus(raw)
    skip = tmp_path / "missing.txt"
    skip.write_text("S002C002P002R002A002\n")
    argv = ["--data-path", str(raw), "--ignored-sample-path", str(skip),
            "--benchmarks", "xview", "xsub", "--streams", *STREAMS,
            "--num-shards", "3"]
    data_gen.main(argv + ["--out-folder", str(tmp_path / "port")])
    if jax_parser == "python":
        monkeypatch.setattr(jax_skeleton, "read_xyz", functools.partial(
            jax_skeleton.read_xyz, use_native=False))
    jax_data_gen.main(argv + ["--out-folder", str(tmp_path / "jax")])

    got, want = tree_bytes(tmp_path / "port"), tree_bytes(tmp_path / "jax")
    assert sorted(got) == sorted(want)
    # 2 benchmarks x 2 parts x (label, 4 stream arrays, 4 x 3 shards)
    assert len(got) == 2 * 2 * (1 + 4 + 4 * 3)
    for name in sorted(want):
        assert got[name] == want[name], name

    xview = tmp_path / "port" / "xview"
    for part, cameras in (("train", (2, 3)), ("val", (1,))):
        with open(xview / f"{part}_label.pkl", "rb") as f:
            names, labels = pickle.load(f)
        joint = np.load(xview / f"{part}_data_joint.npy")
        assert joint.shape == (len(names), 3, 300, 25, 2)
        assert np.isfinite(joint).all() and len(names) > 0
        for name, label in zip(names, labels):
            _, camera, _, _, action = skeleton.sample_metadata(name)
            assert camera in cameras and label == action - 1
        assert "S002C002P002R002A002.skeleton" not in names


def test_parser_has_the_jax_flags_and_defaults(monkeypatch):
    """``main`` parses the same flags as the JAX CLI, with the same
    defaults."""
    seen = {}

    def record(store):
        def fake(data_path, out_path, ignored, benchmark, part):
            store.append((data_path, out_path, ignored, benchmark, part))
        return fake

    for name, module in (("port", data_gen), ("jax", jax_data_gen)):
        seen[name] = []
        monkeypatch.setattr(module, "gen_joint_data", record(seen[name]))
        monkeypatch.setattr(module, "gen_streams", lambda *a: None)
        monkeypatch.setattr(module, "gen_tfrecords",
                            lambda *a: seen[name].append(a))
        module.main([])
    assert seen["port"] == seen["jax"] and len(seen["port"]) == 4


def test_data_exports_what_the_jax_data_package_exports():
    from skeleton_action_recognition_tpu import data as jax_data

    assert port_data.__all__ == jax_data.__all__
    for name in port_data.__all__:
        assert getattr(port_data, name) is not None
