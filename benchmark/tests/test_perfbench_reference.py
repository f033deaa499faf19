"""Each plain reference against the port's CPU route at a tiny size, from
the benchmark's seeded weights (a test may import both)."""

import numpy as np
import pytest
import torch

from harness import compare, inputs, manifest

STGCN = {"name": "stgcn_ntu60", **manifest.config("stgcn_ntu60"),
         "frames": 16}
VRADAR = {"name": "vradar_resnet18", **manifest.config("vradar_resnet18"),
          "frames": 20, "upsample": 16, "image": 64}
F32 = {"dtype": "float32", "remat": False}


def clips(builder, config, n, seed=3):
    g = inputs.generator(seed, inputs.DATA_STREAM, "cpu")
    return (builder.make_clips(config, n, g, "cpu"),
            inputs.one_hot_labels(n, config["num_classes"], g, "cpu"))


def test_stgcn_forward_and_gradients():
    builder = manifest.module("models", "stgcn_ntu60")
    ref = manifest.module("reference", "stgcn_ntu60")
    w = builder.make_weights(STGCN, 7, "cpu")
    x, y = clips(builder, STGCN, 4)
    model = builder.model(STGCN, F32, w, "cpu")
    model.eval()
    with torch.no_grad():
        torch.testing.assert_close(model(x), ref.forward(STGCN, w, x, False),
                                   rtol=1e-4, atol=1e-5)
    model.train()
    names = [n for n, _ in model.named_parameters()]
    loss = ref.cross_entropy(model(x), y)
    got = {n: g.norm().item() for n, g in zip(names, torch.autograd.grad(
        loss, list(model.parameters())))}
    wr = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    keys = ref.trainable(ref.parameter_spec(STGCN))
    want_loss = ref.cross_entropy(ref.forward(STGCN, wr, x, True), y)
    want = {k: g.norm().item() for k, g in zip(keys, torch.autograd.grad(
        want_loss, [wr[k] for k in keys]))}
    assert loss.item() == pytest.approx(want_loss.item(), rel=1e-5)
    assert compare.leaf_gap(got, want, compare.moved_leaves(want)) < 1e-2


def test_stgcn_probabilities():
    builder = manifest.module("models", "stgcn_ntu60")
    ref = manifest.module("reference", "stgcn_ntu60")
    x, _ = clips(builder, STGCN, 3)
    w = ref.calibrate_statistics(STGCN, builder.make_weights(STGCN, 8, "cpu"),
                                 x)
    want = ref.probabilities(STGCN, w, x).numpy()
    serve = manifest.module("drivers", "serve_closed")
    for fused, limit in ((False, 1e-4), (True, 0.5)):
        predictor = builder.build_predictor(
            STGCN, {"request": 3, "fused": fused}, w, "cpu")
        assert serve.logprob_gap(predictor(x.numpy()), want) < limit


def test_radar_spectrogram():
    from skeleton_action_recognition_tpu_torch.models import spectrogram

    ref = manifest.module("reference", "vradar_resnet18")
    builder = manifest.module("models", "vradar_resnet18")
    x, _ = clips(builder, VRADAR, 2)
    x[1, ..., 1] = 0.0  # a clip with one body
    layer = spectrogram.VirtualRadar(
        wavelength=VRADAR["wavelength"], num_pad_frames=VRADAR["upsample"],
        use_pallas=True, use_pallas_stft=True)
    got = spectrogram.nearest_resize_torch(layer(x), VRADAR["image"],
                                           VRADAR["image"])
    loc = torch.zeros(3)
    lam = torch.tensor(VRADAR["wavelength"])
    want = ref.spectrogram(VRADAR, x.double(), loc, lam)
    # |S| + eps (the log of the smallest bins is rounding in float32), of
    # the return's scale: the float32 phase 4 pi d / lambda (~1.3e4 rad)
    # rounds by ~1e-3 rad, and the spline's and the dense operator's
    # positions round apart by as much again
    scale = want.exp().amax()
    assert ((got.exp() - want.exp()).abs().max() / scale).item() < 1e-2


def test_resnet_forward_and_gradients():
    ref = manifest.module("reference", "vradar_resnet18")
    builder = manifest.module("models", "vradar_resnet18")
    w = builder.make_weights(VRADAR, 9, "cpu")
    model, _, _ = builder.build_train(
        VRADAR, {**manifest.workload("vradar_train_b64_unfrozen")["params"],
                 "batch": 2, "kernels": False}, w, "cpu")
    g = torch.Generator().manual_seed(1)
    image = torch.randn(3, VRADAR["image"], VRADAR["image"], generator=g)
    base = model.base_model.train()
    torch.testing.assert_close(base(image[..., None]),
                               ref.resnet(VRADAR, w, image, True),
                               rtol=1e-4, atol=1e-4)


def test_reference_schedule_matches_the_trainers():
    from skeleton_action_recognition_tpu_torch.train import schedules

    ref = manifest.module("reference", "vradar_resnet18")
    params = manifest.workload("vradar_train_b64_unfrozen")["params"]
    theirs = schedules.cyclic_triangular(params["lr_min"], params["lr"],
                                         params["lr_cycle"])
    for count in range(25):
        assert ref.lr_schedule(params, count) == pytest.approx(
            theirs(count), rel=1e-6)


def test_resample_operator_matches_the_ports():
    from skeleton_action_recognition_tpu_torch.ops import resample

    ref = manifest.module("reference", "vradar_resnet18")
    np.testing.assert_allclose(ref.resample_operator(20, 16, 3.0),
                               resample.pad_frames_operator(20, 16, 3.0),
                               rtol=0, atol=1e-6)
