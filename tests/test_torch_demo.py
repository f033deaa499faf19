"""The port's VirtualRadar demo (``examples/virtual_radar_demo_torch.py``)
and its loaders (``data/demo.py``, ``graphs/azure_kinect.py``) against the
JAX package's, on seeded synthetic inputs (the reference's data files are
not in the repository): the loaders on a synthetic Azure Kinect JSON and a
``.skeleton`` file, the demo's route (joint smoothing, the radar return
against the cubic operator, the STFT log-magnitude; plain versions on the
CPU) against the JAX demo's (``pad_frames``, then
``virtual_radar_spectrogram``) for its three inputs at a few frames, and
``main`` on a synthetic ``--data-root``.
"""

import importlib.util
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skeleton_action_recognition_tpu import ops as jax_ops
from skeleton_action_recognition_tpu.data import demo as jax_demo
from skeleton_action_recognition_tpu.graphs import (
    AZURE_KINECT_EDGES as JAX_AZURE_KINECT_EDGES,
)
from skeleton_action_recognition_tpu_torch import graphs
from skeleton_action_recognition_tpu_torch.data import demo
from test_torch_data_gen import body_frames, write_skeleton
import torch_parity_helpers  # noqa: F401  (caps torch's threads)

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location(
    "virtual_radar_demo_torch",
    REPO_ROOT / "examples" / "virtual_radar_demo_torch.py")
radar_demo = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(radar_demo)

# Spectrograms are compared as magnitudes |S| = exp(log(|S| + eps)) - eps,
# relative to the largest (log(|S| + 1e-6) is ill-conditioned at the
# smallest bins: PERF.md section 7). At the demo's wavelengths two f32
# routes round the positions apart by ~1e-7 m, which the phase (4 pi /
# lambda, up to 2.5e4 rad/m) turns into up to 1.2e-2 of the return's scale
# (measured on these frames: the NTU input at 9e-4) and 8.9e-3 of the
# magnitudes' (gait, 5e-4); at a damped wavelength the routes agree to f32
# rounding (measured 1.4e-6)
MAG_TOL = {"demo": 2e-2, "damped": 1e-5}
LAM_DAMPED = 10.0
FRAMES = {"cmu_mocap": 20, "simulated_gait": 40, "ntu_example": 12}
JOINTS = {"cmu_mocap": 42, "simulated_gait": 17, "ntu_example": 25}


def trajectories(t, v, seed, scale=1.0):
    """``(t, v, 3)`` smooth seeded joint trajectories about rest positions
    3 m in front of the origin, in metres times ``scale``."""
    rng = np.random.default_rng(seed)
    rest = 0.4 * rng.normal(size=(1, v, 3)) + [0.0, 0.0, 3.0]
    freq = rng.uniform(0.05, 0.3, size=(1, v, 3))
    phase = rng.uniform(0, 2 * np.pi, size=(1, v, 3))
    steps = np.arange(t)[:, None, None]
    return scale * (rest + 0.1 * np.sin(freq * steps + phase))


def write_inputs(root):
    """The demo's three files, of the reference's layouts, under
    ``root``; returns the frames the demo reads from each, in metres."""
    frames = {name: trajectories(FRAMES[name], JOINTS[name], i)
              for i, name in enumerate(radar_demo.DEMOS)}
    np.save(root / "cmu_mocap.npy", frames["cmu_mocap"] * 1000.0)
    np.save(root / "simulated_gait.npy", frames["simulated_gait"])
    ntu = np.zeros((2, 3, FRAMES["ntu_example"], 25, 2))
    ntu[0, ..., 0] = frames["ntu_example"].transpose(2, 0, 1)
    ntu[0, ..., 1] = trajectories(FRAMES["ntu_example"], 25, 9).transpose(
        2, 0, 1)
    np.save(root / "NTU_preprocessed_skeleton_examples.npy", ntu)
    return frames


def test_azure_kinect_edges_match_jax():
    assert graphs.AZURE_KINECT_EDGES == JAX_AZURE_KINECT_EDGES
    assert len(graphs.AZURE_KINECT_EDGES) == 26


def test_load_azure_kinect_matches_jax(tmp_path):
    """Frames without a body are dropped; the first body's 32 joints, mm
    to metres."""
    rng = np.random.default_rng(0)
    bodies = [0, 1, 2, 0, 1, 1]
    doc = {"frames": [
        {"num_bodies": n, "bodies": [
            {"joint_positions": rng.normal(0, 500, (32, 3)).tolist()}
            for _ in range(n)]}
        for n in bodies]}
    path = tmp_path / "kinect.json"
    path.write_text(json.dumps(doc))
    got, edges = demo.load_azure_kinect(str(path))
    want, want_edges = jax_demo.load_azure_kinect(str(path))
    assert got.shape == (4, 32, 3) and got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    assert edges == want_edges == graphs.AZURE_KINECT_EDGES


def test_load_ntu_file_matches_jax(tmp_path):
    """``(M, T, V, 3)`` and the radar's edges. Both read the file through
    their parser (the port's C++ one rounds the 5-decimal coordinates to
    float32, as the JAX package's native route does): rtol 1e-6."""
    path = str(tmp_path / "S001C001P001R001A001.skeleton")
    write_skeleton(path, body_frames(np.random.default_rng(1), 9,
                                     [0.3, 0.8, 0.1]))
    got, edges = demo.load_ntu_file(path)
    want, want_edges = jax_demo.load_ntu_file(path)
    assert got.shape == (2, 9, 25, 3)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert edges == want_edges == list(graphs.RADAR_EDGES)


def jax_spectrogram(data, edges, wavelength, pad):
    """The JAX demo's route: ``pad_frames``, then
    ``virtual_radar_spectrogram`` from the origin."""
    padded = jax_ops.pad_frames(jnp.asarray(data, jnp.float32),
                                num_pad_frames=pad)
    x = jnp.transpose(padded, (2, 0, 1))[None, ..., None]
    return np.asarray(jax_ops.virtual_radar_spectrogram(
        x, jnp.zeros(3), jnp.asarray(wavelength), edges=edges))[0]


def assert_spectrograms_close(got, want, tol):
    assert got.shape == want.shape
    got, want = np.exp(got) - 1e-6, np.exp(want) - 1e-6
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < tol, err


@pytest.mark.parametrize("wavelength", ["demo", "damped"])
@pytest.mark.parametrize("name", list(radar_demo.DEMOS))
def test_route_matches_the_jax_demo(name, wavelength):
    """Each input's spectrogram ``(256, T * pad // 16 + 1)`` through the
    port's route against the JAX demo's on the same frames, at the demo's
    wavelength and at a damped one."""
    _, edges, lam, pad = radar_demo.DEMOS[name]
    lam = lam if wavelength == "demo" else LAM_DAMPED
    data = trajectories(FRAMES[name], JOINTS[name], 5)
    got, (re, im) = radar_demo.spectrogram(data, edges, lam, pad,
                                           torch.device("cpu"))
    t_out = FRAMES[name] * pad
    assert re.shape == (1, t_out)
    assert got.shape == (256, t_out // 16 + 1)
    assert_spectrograms_close(got.numpy(), jax_spectrogram(
        data, edges, lam, pad), MAG_TOL[wavelength])


def test_main_on_synthetic_data(tmp_path, capsys):
    """``main([... "--cpu"])``: the notebook's anchor lines and the scipy
    cross-check, each spectrogram saved as ``.npy``, equal to the route's
    and close to the JAX demo's on the frames the demo reads."""
    frames = write_inputs(tmp_path)
    out = tmp_path / "out"
    results = radar_demo.main(["--data-root", str(tmp_path), "--out-dir",
                               str(out), "--cpu"])
    printed = capsys.readouterr().out
    for name, (_, edges, wavelength, pad) in radar_demo.DEMOS.items():
        saved = np.load(out / f"{name}.npy")
        np.testing.assert_array_equal(saved, results[name])
        assert f"{name}: shape {saved.shape} min {saved.min():.3f}" in printed
        assert_spectrograms_close(saved, jax_spectrogram(
            frames[name], edges, wavelength, pad), MAG_TOL["demo"])
    mean, p99 = results["scipy_cross_check"]
    assert "scipy cross-check: mean |dlog|" in printed
    assert np.isfinite([mean, p99]).all()


def test_missing_data_names_the_files(tmp_path):
    np.save(tmp_path / "cmu_mocap.npy", np.zeros((4, 42, 3)))
    with pytest.raises(FileNotFoundError) as err:
        radar_demo.main(["--data-root", str(tmp_path), "--out-dir",
                         str(tmp_path / "out"), "--cpu"])
    assert "simulated_gait.npy" in str(err.value)
    assert "NTU_preprocessed_skeleton_examples.npy" in str(err.value)
    assert "cmu_mocap.npy" not in str(err.value)
    assert not (tmp_path / "out").exists()
