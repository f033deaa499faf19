"""The spectrogram model (VirtualRadar + ResNet-18) of the PyTorch port
against the JAX package's, from the same bridged weights, on seeded
skeleton-like inputs. The JAX model runs its Pallas kernels as its own
tests run them on the CPU (interpret mode); the port runs the kernels'
plain versions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skeleton_action_recognition_tpu.models import resnet18 as jax_resnet
from skeleton_action_recognition_tpu.models import spectrogram as jax_spec
from skeleton_action_recognition_tpu_torch import interop
from skeleton_action_recognition_tpu_torch.models import resnet, resnet18
from skeleton_action_recognition_tpu_torch.models import spectrogram
from torch_parity_helpers import randomized_variables

# the test size of the model: 8 filters, 64 x 64 images, 4 classes, 30
# frames upsampled 20x (600 radar samples, 38 STFT frames)
SMALL = dict(num_classes=4, num_filters=8, image_size=64, num_pad_frames=20)
# f32 through a radar return at lambda = 5e-4 (phase ~1e4 rad, f32 rounding
# of the positions moves it by ~1e-3 rad; the JAX package's own
# Pallas-vs-XLA tolerance for the return is 2e-3 of its scale,
# tests/test_pallas.py), an STFT whose log-magnitude amplifies that
# wherever a bin is near zero, and eight BatchNorm'd blocks: logits to
# 5e-3 of their scale (measured 1.4e-3).
LOGIT_TOL = 5e-3


def skeletons(n=2, t=30, seed=0, empty_second_body=True):
    """Skeleton-like joints ``(n, 3, t, 25, 2)`` from a numpy seed (the JAX
    bench's ``normal x 0.3``), the second body all zero in the last clip
    when ``empty_second_body``."""
    x = (np.random.default_rng(seed).normal(size=(n, 3, t, 25, 2))
         * 0.3).astype(np.float32)
    if empty_second_body:
        x[-1, ..., 1] = 0.0
    return x


def _bridged(seed=3, **kw):
    """The JAX model's variables (BatchNorm statistics and biases redrawn
    from ``seed``) and the port's model holding them."""
    x = skeletons()
    jm = jax_spec.Model(**SMALL, use_pallas=True, use_pallas_stft=True, **kw)
    variables = randomized_variables(jm, x, seed)
    port = spectrogram.Model(**SMALL, use_pallas=True, use_pallas_stft=True,
                             **kw)
    port.load_state_dict(interop.flax_to_state_dict(variables))
    return jm, variables, port, x


def _assert_logits(got, want, tol=LOGIT_TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want,
                               atol=tol * np.abs(want).max())


def test_resnet_matches_jax_eval_and_train():
    """NHWC images through ResNet-18 at width 8: eval logits, train-mode
    logits and the BatchNorm running statistics after the train-mode
    forward (f32 convs in other orders: 1e-5 of the scale)."""
    img = np.random.default_rng(1).normal(size=(3, 64, 64, 1))
    img = img.astype(np.float32)
    jm = jax_resnet.ResNet(num_classes=5, num_filters=8)
    variables = randomized_variables(jm, img, seed=4)
    port = resnet18.ResNet(num_classes=5, num_filters=8)
    port.load_state_dict(interop.flax_to_state_dict(variables))

    port.eval()
    _assert_logits(port(torch.from_numpy(img)),
                   jm.apply(variables, jnp.asarray(img)), 1e-5)
    port.train()
    got = port(torch.from_numpy(img))
    want, mutated = jm.apply(variables, jnp.asarray(img), train=True,
                             mutable=["batch_stats"])
    _assert_logits(got, want, 1e-5)
    stats = interop.flax_to_state_dict(
        {"batch_stats": jax.device_get(mutated["batch_stats"])}
    )
    state = port.state_dict()
    assert stats.keys() <= state.keys() and len(stats) == 40
    for name, w in stats.items():
        np.testing.assert_allclose(state[name].numpy(), w.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_resnet_init_follows_the_jax_initializers():
    """KAIMING conv weights (normal, std sqrt(2 / fan_out)), the fc kernel
    uniform in +-sqrt(1 / fan_in), zero fc bias, BatchNorm at 1 and 0, all
    from the generator: two models from one seed are equal."""
    make = lambda: resnet18.ResNet(  # noqa: E731
        num_classes=60, generator=torch.Generator().manual_seed(0))
    a, b = make(), make()
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), name
    w = a.layer4_1.conv2.weight
    assert abs(w.std().item() / (2.0 / (512 * 9)) ** 0.5 - 1) < 0.01
    assert a.fc.weight.abs().max() <= (1 / 512) ** 0.5
    assert a.fc.bias.abs().max() == 0
    assert a.bn1.epsilon == 1e-5 and a.bn1.momentum == 0.9


def test_model_matches_jax_eval_and_train():
    """Eval logits, train-mode logits and the BatchNorm running statistics
    of the whole model at lambda = 5e-4 with an empty second body."""
    jm, variables, port, x = _bridged()
    port.eval()
    _assert_logits(port(torch.from_numpy(x)), jm.apply(variables,
                                                       jnp.asarray(x)))
    port.train()
    got = port(torch.from_numpy(x))
    want, mutated = jm.apply(variables, jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
    _assert_logits(got, want)
    stats = interop.flax_to_state_dict(
        {"batch_stats": jax.device_get(mutated["batch_stats"])}
    )
    state = port.state_dict()
    for name, w in stats.items():
        w = w.numpy()
        np.testing.assert_allclose(state[name].numpy(), w, err_msg=name,
                                   atol=LOGIT_TOL * np.abs(w).max())


@pytest.mark.parametrize("use_pallas,use_pallas_stft,num_pad_frames", [
    (True, True, 20), (False, False, 20), (True, False, 20),
    (False, True, 1),
], ids=["kernels", "plain", "radar-kernel-only", "raw-frames"])
def test_virtual_radar_routes_match_jax(use_pallas, use_pallas_stft,
                                        num_pad_frames):
    """Each route of the layer against the JAX layer on the same route, at
    its default lambda = 1e-3. Compared as magnitudes ``exp(out) = |S| +
    eps``, to 1e-3 of their largest: the log of a bin near zero is
    ill-conditioned (a 1e-6 change of |S| moves it by O(1)), and a few
    bins of any radar spectrogram are."""
    x = skeletons(t=30 if num_pad_frames > 1 else 600)
    kw = dict(num_pad_frames=num_pad_frames, use_pallas=use_pallas,
              use_pallas_stft=use_pallas_stft)
    jl = jax_spec.VirtualRadar(**kw)
    variables = jl.init(jax.random.key(0), jnp.asarray(x[:1]))
    want = np.asarray(jl.apply(variables, jnp.asarray(x)))
    layer = spectrogram.VirtualRadar(**kw)
    got = layer(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (2, 256, 38)
    got, want = np.exp(got), np.exp(want)
    np.testing.assert_allclose(got, want, atol=1e-3 * want.max())


def test_trainable_stft_bases_take_the_plain_route():
    """With ``train_stft_kernel`` the bases are parameters (named as in
    flax) and get gradients, which the fused op would zero."""
    layer = spectrogram.VirtualRadar(num_pad_frames=20, use_pallas=True,
                                     use_pallas_stft=True,
                                     train_stft_kernel=True)
    names = dict(layer.named_parameters())
    assert set(names) == {"radar_lambda", "radar_loc", "stft_cos",
                          "stft_sin"}
    layer(torch.from_numpy(skeletons())).sum().backward()
    assert layer.stft_cos.grad.abs().max() > 0


def test_nearest_resize_matches_jax():
    x = np.random.default_rng(2).normal(size=(2, 256, 38)).astype(np.float32)
    want = jax_spec.nearest_resize_torch(jnp.asarray(x), 64, 64)
    got = spectrogram.nearest_resize_torch(torch.from_numpy(x), 64, 64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ref = torch.nn.functional.interpolate(torch.from_numpy(x)[None], (64, 64))
    np.testing.assert_array_equal(got.numpy(), ref[0].numpy())


def test_interop_round_trip_keeps_the_radar_parameters():
    """The scalar ``radar_lambda``, the ``(3,)`` ``radar_loc``, convs, BN
    and ``fc`` go back to the flax tree unchanged; the rank rule for
    ``weight`` does not touch the radar leaves."""
    _, variables, port, _ = _bridged()
    back = interop.state_dict_to_flax(port.state_dict())
    flat = lambda t: {  # noqa: E731
        jax.tree_util.keystr(k): np.asarray(v)
        for k, v in jax.tree_util.tree_flatten_with_path(t)[0]
    }
    want, got = flat(variables), flat(back)
    assert want.keys() == got.keys()
    for key, w in want.items():
        np.testing.assert_array_equal(got[key], w, err_msg=key)
    assert got["['params']['virtual_radar']['radar_lambda']"].shape == ()
    assert got["['params']['virtual_radar']['radar_loc']"].shape == (3,)


def test_bf16_backbone_keeps_the_radar_in_f32():
    """``dtype=bfloat16`` computes the ResNet in bf16 (the logits in f32)
    while the spectrogram it reads is the f32 one."""
    port = spectrogram.Model(**SMALL, use_pallas=True, use_pallas_stft=True,
                             dtype=torch.bfloat16,
                             generator=torch.Generator().manual_seed(0))
    f32 = spectrogram.Model(**SMALL, use_pallas=True, use_pallas_stft=True,
                            generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(skeletons())
    port.eval(), f32.eval()
    got, want = port(x), f32(x)
    assert got.dtype == torch.float32
    # bf16 convs: 8 significant bits through 17 layers
    assert (got - want).abs().max() <= 0.1 * want.abs().max()
    assert port.virtual_radar(x).dtype == torch.float32


def test_resnet_alias_is_the_spectrogram_model():
    assert resnet.Model is spectrogram.Model
