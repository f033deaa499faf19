"""The port's sequence-parallel radar ops (``ops/virtual_radar.py``'s
``radar_return_sharded`` and ``radar_spectrogram_sharded``) on 2 and 4 gloo
ranks on the CPU, against the JAX package's ops on meshes of 2 and 4 CPU
devices (``tests/conftest.py``'s virtual devices) at the JAX tests' shapes
(``tests/test_parallel.py``: T_in 30 upsampled 20x; T_in 32 upsampled 64x),
and their gradients against the port's single-process routes. Each world
size spawns its ranks once (``torch_parity_helpers.Ranks``, a job of
``test_torch_parallel_worker.py``); the tests read the ranks' results.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skeleton_action_recognition_tpu import parallel as jax_parallel
from skeleton_action_recognition_tpu.ops import virtual_radar as jax_vr
from skeleton_action_recognition_tpu_torch import ops
from skeleton_action_recognition_tpu_torch.ops import radar, stft_logmag
from torch_parity_helpers import Ranks, cotangent

WORLDS = (2, 4)
LOC = np.asarray([0.1, -0.2, 0.3], np.float32)
# The JAX test's wavelength and a damped one. At 5e-4 f32 positions rounded
# apart by ~1e-7 m move the phase (2.5e4 rad/m) by ~2.5e-3 rad a term: on
# these joints JAX's own sharded and single-device routes lie 9.7e-3 of the
# signal's scale apart, and each f32 route 6e-3 to 9e-3 from float64
# (JAX's 2e-3, tests/test_parallel.py:136-141, holds on its NTU clips). At
# the damped wavelength the phase stays below a radian and the routes
# agree to f32 rounding: the gradients are held there.
LAM, LAM_DAMPED = 5e-4, 10.0
RETURN_TOL = {LAM: 2e-2, LAM_DAMPED: 1e-5}  # of scale
GRAD_TOL = 1e-4  # relative, in norm, at LAM_DAMPED
# relative, in norm, at LAM, through the above-median bins: the
# single-process f32 route's own gradients lie 6.8e-3 (loc) to 3.1e-2
# (lambda) from the same route in float64 there
SPEC_GRAD_TOL = 5e-2


def joints(n, t, seed):
    """``(n, 3, t, 25, 2)`` skeleton-like joints: each joint about its own
    rest position 3 m in front of the radar, moving smoothly."""
    rng = np.random.default_rng(seed)
    rest = 0.5 * rng.normal(size=(n, 3, 1, 25, 2))
    rest[:, 2] += 3.0
    steps = rng.normal(size=(n, 3, t, 25, 2)) * 0.02
    return (rest + np.cumsum(steps, 2)).astype(np.float32)


def cases():
    """The job's cases: the JAX tests' two shapes at the JAX test's
    wavelength (forward), and at the damped one with cotangents
    (gradients); the return also at T_out = 630, which 4 ranks pad with
    two zero rows."""
    x30, x32 = joints(2, 30, 0), joints(2, 32, 1)
    w600 = ops.pad_frames_operator(30, 20)
    w630 = ops.pad_frames_operator(30, 21)
    w2048 = ops.pad_frames_operator(32, 64)
    spec_shape = (2, 256, 2048 // 16 + 1)
    return {
        "return": dict(op="return", x=x30, w=w600, loc=LOC, lam=LAM),
        "return_damped": dict(
            op="return", x=x30, w=w630, loc=LOC, lam=LAM_DAMPED,
            cotangents=[cotangent((2, 630), 2), cotangent((2, 630), 3)]),
        "spectrogram": dict(op="spectrogram", x=x32, w=w2048, loc=LOC,
                            lam=LAM),
        "spectrogram_grad": dict(
            op="spectrogram", x=x32, w=w2048, loc=LOC, lam=LAM,
            cotangents=[cotangent(spec_shape, 4) * energetic(x32, w2048)]),
    }


def energetic(x, w):
    """The above-median bins of the single-process spectrogram of ``x``
    at ``LAM``, as a float mask. log(|S| + 1e-6) is ill-conditioned at
    the smallest bins (two f32 STFTs' gradients lie percents apart there),
    so the spectrogram's gradients are held through these bins alone."""
    spec = single_process(dict(x=x, w=w, loc=LOC, lam=LAM), True)[0][0]
    return (spec > np.median(spec)).astype(np.float32)


# operators whose T_out does not split into hop-aligned blocks at 2 and 4
# ranks (600 / 4 = 150 samples), or whose blocks are shorter than a halo
REFUSED = {"not_hop_aligned": ops.pad_frames_operator(30, 20),
           "short_blocks": ops.pad_frames_operator(32, 4)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``{world: [rank results]}``: every world size's ranks started at
    once, then waited for."""
    started = {
        world: Ranks(tmp_path_factory.mktemp(f"seqpar{world}"),
                     {"model": "seqpar", "cases": cases(),
                      "refused": REFUSED}, world)
        for world in WORLDS
    }
    return {world: r.wait() for world, r in started.items()}


def jax_mesh(world):
    return jax_parallel.create_mesh(devices=jax.devices()[:world])


def close(got, want, tol, what):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def single_process(case, spectrogram=False):
    """The port's single-process route on the case's inputs (plain torch on
    the CPU): ``radar_return_upsampled``, then for the spectrogram the STFT
    log-magnitude; its result and, with cotangents, its gradients."""
    x = torch.tensor(case["x"], requires_grad=True)
    loc = torch.tensor(case["loc"], requires_grad=True)
    lam = torch.tensor(case["lam"], requires_grad=True)
    re, im = ops.radar_return_upsampled(x, torch.from_numpy(case["w"]), loc,
                                        lam)
    out = [re, im]
    if spectrogram:
        cos, sin = (torch.from_numpy(b) for b in ops.stft_basis(256))
        out = [stft_logmag.stft_logmag(re, im, 16, cos, sin)]
    grads = None
    if "cotangents" in case:
        sum((o * torch.from_numpy(g)).sum()
            for o, g in zip(out, case["cotangents"])).backward()
        grads = [t.grad.numpy() for t in (x, loc, lam)]
    return [o.detach().numpy() for o in out], grads


def assert_ranks_alike(results, name):
    for other in results[1:]:
        for a, b in zip(other[name]["out"], results[0][name]["out"]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(other[name].get("grads", []),
                        results[0][name].get("grads", [])):
            np.testing.assert_array_equal(a, b)


def assert_grads_close(got, want, tol):
    for what, g, w in zip(("x", "loc", "lambda"), got, want):
        err = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert err <= tol, f"{what} gradient {err} from one process"


@pytest.mark.parametrize("name", ["return", "return_damped"])
@pytest.mark.parametrize("world", WORLDS)
def test_return_matches_jax_sharded(ranks, world, name):
    """Against JAX's ``radar_return_sharded`` on a mesh of as many devices,
    at both wavelengths (``RETURN_TOL``; 630 rows padded on 4 ranks)."""
    case = cases()[name]
    assert_ranks_alike(ranks[world], name)
    want = jax.jit(lambda x: jax_vr.radar_return_sharded(
        x, jnp.asarray(case["w"]), jnp.asarray(LOC), jnp.asarray(case["lam"]),
        jax_mesh(world)))(jnp.asarray(case["x"]))
    for what, got, w in zip(("re", "im"), ranks[world][0][name]["out"],
                            want):
        close(got, np.asarray(w), RETURN_TOL[case["lam"]], what)


@pytest.mark.parametrize("world", WORLDS)
def test_return_gradients_match_one_process(ranks, world):
    """Every rank ends with the single-process gradient: the port's
    ``radar_return_upsampled`` (plain autograd) on the same inputs, with
    the operator's rows padded on 4 ranks."""
    case = cases()["return_damped"]
    assert_ranks_alike(ranks[world], "return_damped")
    got = ranks[world][0]["return_damped"]
    want, want_grads = single_process(case)
    for what, g, w in zip(("re", "im"), got["out"], want):
        close(g, w, RETURN_TOL[LAM_DAMPED], what)
    assert_grads_close(got["grads"], want_grads, GRAD_TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_return_gradients_match_jax_sharded(ranks, world):
    """JAX's gradients through its ``radar_return_sharded`` (``shard_map``
    with ``check_vma=False``) on a mesh of as many devices equal the
    single-device ones (scripts/seqpar_jax_grads.py), and the ranks' equal
    JAX's, at the damped wavelength (``GRAD_TOL``)."""
    case = cases()["return_damped"]
    w = jnp.asarray(case["w"])

    def loss(x, loc, lam):
        re, im = jax_vr.radar_return_sharded(x, w, loc, lam, jax_mesh(world))
        return jnp.sum(re * case["cotangents"][0]) + jnp.sum(
            im * case["cotangents"][1])

    want = jax.jit(jax.grad(loss, (0, 1, 2)))(
        jnp.asarray(case["x"]), jnp.asarray(LOC), jnp.asarray(LAM_DAMPED))
    assert_grads_close(ranks[world][0]["return_damped"]["grads"],
                       [np.asarray(g) for g in want], GRAD_TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_spectrogram_matches_jax_sharded(ranks, world):
    """The JAX test's criterion on the above-median bins: largest
    difference under 0.15, mean under 0.01."""
    case = cases()["spectrogram"]
    assert_ranks_alike(ranks[world], "spectrogram")
    want = np.asarray(jax.jit(lambda x: jax_vr.radar_spectrogram_sharded(
        x, jnp.asarray(case["w"]), jnp.asarray(LOC), jnp.asarray(LAM),
        jax_mesh(world)))(jnp.asarray(case["x"])))
    got = ranks[world][0]["spectrogram"]["out"][0]
    assert got.shape == want.shape == (2, 256, 129)
    diff = np.abs(got - want)[want > np.median(want)]
    assert diff.max() < 0.15 and diff.mean() < 0.01


@pytest.mark.parametrize("world", WORLDS)
def test_spectrogram_gradients_match_one_process(ranks, world):
    """The frames of every rank, the halos and the last rank's final frame
    carry the single-process gradient back to the joints."""
    case = cases()["spectrogram_grad"]
    assert_ranks_alike(ranks[world], "spectrogram_grad")
    got = ranks[world][0]["spectrogram_grad"]
    want, want_grads = single_process(case, spectrogram=True)
    diff = np.abs(got["out"][0] - want[0])[want[0] > np.median(want[0])]
    assert diff.max() < 0.15 and diff.mean() < 0.01
    assert_grads_close(got["grads"], want_grads, SPEC_GRAD_TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_unsplittable_shapes_raise_as_in_jax(ranks, world):
    for name, w in REFUSED.items():
        with pytest.raises(ValueError) as jax_err:
            jax_vr.radar_spectrogram_sharded(
                jnp.zeros((1, 3, w.shape[1], 25, 2)), jnp.asarray(w),
                jnp.zeros(3), jnp.asarray(5e-4), jax_mesh(world))
        assert all(r[name] == str(jax_err.value) for r in ranks[world]), name


def test_world_size_one_is_the_single_process_route():
    """Without a process group: ``radar_return_fused``'s result (1e-6 of
    scale: the same computation, whose threaded sums on the CPU need not
    repeat bit for bit), within f32 rounding of ``radar_return_upsampled``
    (gradients too), and the centered STFT of that return; JAX's errors on
    a mesh of one device."""
    case = cases()["return_damped"]
    x = torch.tensor(case["x"], requires_grad=True)
    loc = torch.tensor(LOC, requires_grad=True)
    lam = torch.tensor(LAM_DAMPED, requires_grad=True)
    w = torch.from_numpy(case["w"])
    got = ops.radar_return_sharded(x, w, loc, lam)
    fused = radar.radar_return_fused(x, w, loc, lam)
    for g, f in zip(got, fused):
        close(g.detach().numpy(), f.detach().numpy(), 1e-6, "fused")
    sum((o * torch.from_numpy(g)).sum()
        for o, g in zip(got, case["cotangents"])).backward()
    want, want_grads = single_process(case)
    for g, w_ in zip(got, want):
        close(g.detach().numpy(), w_, RETURN_TOL[LAM_DAMPED], "return")
    assert_grads_close([t.grad.numpy() for t in (x, loc, lam)], want_grads,
                       GRAD_TOL)

    spec_case = cases()["spectrogram"]
    spec = ops.radar_spectrogram_sharded(
        torch.from_numpy(spec_case["x"]), torch.from_numpy(spec_case["w"]),
        torch.from_numpy(LOC), torch.tensor(LAM))
    re, im = radar.radar_return_fused(
        torch.from_numpy(spec_case["x"]), torch.from_numpy(spec_case["w"]),
        torch.from_numpy(LOC), torch.tensor(LAM))
    cos, sin = (torch.from_numpy(b) for b in ops.stft_basis(256))
    torch.testing.assert_close(
        spec, stft_logmag.stft_logmag(re, im, 16, cos, sin),
        rtol=0, atol=1e-5)

    for w_ in (ops.pad_frames_operator(30, 20),  # 600 % 16 = 8
               ops.pad_frames_operator(6, 16)):  # 96 < a 128-sample halo
        with pytest.raises(ValueError) as jax_err:
            jax_vr.radar_spectrogram_sharded(
                jnp.zeros((1, 3, w_.shape[1], 25, 2)), jnp.asarray(w_),
                jnp.zeros(3), jnp.asarray(5e-4), jax_mesh(1))
        with pytest.raises(ValueError, match=str(jax_err.value)):
            ops.radar_spectrogram_sharded(
                torch.zeros(1, 3, w_.shape[1], 25, 2), torch.from_numpy(w_),
                torch.zeros(3), torch.tensor(5e-4))
