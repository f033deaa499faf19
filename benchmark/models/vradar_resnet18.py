"""The port's VirtualRadar + ResNet-18 (``vradar_resnet18``) as the cells
run it, from the benchmark's seeded weights: ``models.spectrogram.Model``
on the spline radar and STFT kernels, its training step and optimizer as
``main_spectrogram`` builds them. The reference gets the same weights
(``reference/vradar_resnet18.py``)."""

from __future__ import annotations

from harness import inputs, manifest

REFERENCE = manifest.module("reference", "vradar_resnet18")
COUNTS = {op: manifest.module("counts", op) for op in ("radar", "stft")}


def make_weights(config, seed, device) -> dict:
    return inputs.seeded_weights(REFERENCE.parameter_spec(config), seed,
                                 device, config)


def make_clips(config, n, g, device):
    return inputs.skeleton_clips(n, config["frames"], config["joints"],
                                 config["bodies"], g, device)


def build_train(config, params, weights, device):
    """``(model, optimizer, step)``: ``step(x, y)`` is one call of
    ``train.steps.make_radar_train_step``'s step under
    ``train.optim.RadarOptimizer`` at the trainer's triangular cycle, the
    radar's wavelength and location training as ``train_radar`` says."""
    from skeleton_action_recognition_tpu_torch.models import spectrogram
    from skeleton_action_recognition_tpu_torch.train import (
        optim,
        schedules,
        steps,
    )

    model = spectrogram.Model(
        num_classes=config["num_classes"], num_filters=config["filters"],
        image_size=config["image"], wavelength=config["wavelength"],
        num_pad_frames=config["upsample"], use_pallas=params["kernels"],
        use_pallas_stft=params["kernels"], device=device,
    )
    model.load_state_dict(weights, strict=True)
    lr = schedules.cyclic_triangular(params["lr_min"], params["lr"],
                                     params["lr_cycle"])
    opt = optim.RadarOptimizer(
        model.named_parameters(), lr,
        lambda_rel_step=params["lambda_rel_step"],
        loc_step=params["loc_step"], lambda_step_decay=1.0)
    train = params["train_radar"]
    step = steps.make_radar_train_step(model, opt, params["batch"],
                                       train_lambda=train, train_loc=train)
    return model, opt, step


def first_gradients(model, optimizer, params) -> dict:
    """Each ResNet leaf's first gradient as Adam got it, on the host, from
    its state after one step: the first moment is ``(1 - b1) g`` then
    (zeros for a leaf the step left without state; the radar's leaves keep
    no gradient in theirs)."""
    import torch

    from skeleton_action_recognition_tpu_torch.train.optim import ADAM_B1

    state = optimizer.state
    return {name: (state[p]["mu"] / (1.0 - ADAM_B1)).float().cpu()
            if "mu" in state.get(p, {}) else torch.zeros(p.shape)
            for name, p in model.named_parameters()
            if not name.startswith("virtual_radar.")}


def step_flops(config, params) -> int:
    """A training step's operations: the ResNet's (the reference's count)
    and the radar's and STFT's forwards (``counts/``), with their
    backwards while the radar trains."""
    total = REFERENCE.flops(config, params["batch"], True)
    for op, records in op_shapes(config, params).items():
        for shape in records:
            total += COUNTS[op].fwd(**shape)[0]
            if params["train_radar"]:
                total += COUNTS[op].bwd(**shape)[0]
    return total


def op_shapes(config, params) -> dict:
    """The kernels' work in one training step, by op."""
    n, t = params["batch"], config["frames"]
    t_out = t * config["upsample"]
    return {
        "radar": [dict(n=n, t_in=t, t_out=t_out,
                       pairs_per_sample=len(config["edges"])
                       * config["bodies"])],
        "stft": [dict(n=n, t=t_out, hop=config["hop"],
                      n_fft=config["n_fft"])],
    }
