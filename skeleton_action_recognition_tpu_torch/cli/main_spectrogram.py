"""Spectrogram trainer CLI: the port's counterpart of the JAX package's
``cli/main_spectrogram.py``, on one CUDA device (``main(device="cpu")``
for the CPU).

The same flags with the same defaults, except ``--steps-per-dispatch`` (a
TPU dispatch knob). The flow is the JAX trainer's: ``.npy`` clips and
pickled labels in; the VirtualRadar + ResNet-18 model (``--model-type
resnet``) with the 250x upsampling on the device, through the spline radar
and STFT log-magnitude CUDA kernels (``--use-pallas``,
``--use-pallas-stft``, both on by default; the flags keep the JAX names);
Adam on the triangular cyclic schedule, taken per optimizer step, with the
radar's wavelength and location on their own relative-step rule
(:class:`..train.optim.RadarOptimizer`), frozen until ``epoch >
--lambda-train-epoch`` (``--loc-train-epoch``); an eval over the whole
validation set each epoch, its last partial batch padded; TensorBoard
scalars, the confusion matrix and the per-epoch ``radar_lambda``;
checkpoints every ``--save-freq`` epochs and at the last; ``--resume``
from the latest checkpoint of the same run directory, falling back to the
model's state alone when the optimizer's does not fit.

Numerics, as the JAX package's choices on a GPU: float32 matrix products
in full float32 (the spline coefficients, the plain routes' upsampling and
STFT, which JAX pins at HIGHEST: the trainer turns
``torch.backends.cuda.matmul.allow_tf32`` off, and the VirtualRadar layer
refuses to run with it on), the ResNet's convolutions through cuDNN as
torch's ``torch.backends.cudnn.allow_tf32`` leaves them (on by default:
JAX's default convolution precision). The radar and STFT kernels compute
in float32 on the CUDA cores.

Run:
    python -m skeleton_action_recognition_tpu_torch.cli.main_spectrogram \\
        --data-path 'DIR/{}_data_joint.npy' --label-path 'DIR/{}_label.pkl'
"""

from __future__ import annotations

import argparse
import importlib
import os
import time

import numpy as np
import torch

from skeleton_action_recognition_tpu_torch.data.pipeline import NumpyDataset
from skeleton_action_recognition_tpu_torch.parallel.sharding import (
    prefetch_to_device,
    resolve_device,
)
from skeleton_action_recognition_tpu_torch.train import (
    checkpoint as ckpt_lib,
    metrics as metrics_lib,
    schedules,
    steps as steps_lib,
)
from skeleton_action_recognition_tpu_torch.train.optim import RadarOptimizer
from skeleton_action_recognition_tpu_torch.utils import (
    config as config_lib,
    confusion as confusion_lib,
    tb_writer,
)


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=(
            "Skeleton-Based Action Recognition from VirtualRadar "
            "spectrograms (PyTorch, one CUDA device)"
        )
    )
    parser.add_argument("--base-lr", type=float, default=1e-1)
    parser.add_argument("--num-classes", type=int, default=60)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--num-epochs", type=int, default=80)
    parser.add_argument("--num-filters", type=int, default=64)
    parser.add_argument("--log-dir", default="logs/")
    parser.add_argument(
        "--data-path", default="data/ntu/xview/{}_data_joint.npy"
    )
    parser.add_argument(
        "--label-path", default="data/ntu/xview/{}_label.pkl"
    )
    parser.add_argument("--notes", default="")
    parser.add_argument("--model-type", default="resnet")
    parser.add_argument(
        "--save-freq", type=int, default=5,
        help="checkpoint every N epochs (the last epoch always saves)",
    )
    parser.add_argument("--lr_cycle", type=int, default=10)
    parser.add_argument("--lambda-train-epoch", type=int, default=1000)
    parser.add_argument("--loc-train-epoch", type=int, default=1000)
    parser.add_argument(
        "--lambda-rel-step", type=float, default=1e-2,
        help="per-step relative change of radar_lambda once unfrozen",
    )
    parser.add_argument(
        "--lambda-step-decay", type=float, default=1.0,
        help="geometric per-step decay of the radar_lambda step once "
        "unfrozen (1.0 = constant step)",
    )
    parser.add_argument(
        "--loc-step", type=float, default=1e-2,
        help="per-step radar_loc move in meters once unfrozen",
    )
    parser.add_argument(
        "--wavelength", type=float, default=None,
        help="initial radar wavelength (model default 5e-4)",
    )
    parser.add_argument("--num-pad-frames", type=int, default=250)
    parser.add_argument(
        "--use-pallas", action=argparse.BooleanOptionalAction,
        default=True,
        help="the spline radar return through its CUDA kernels, forward "
        "and backward (--no-use-pallas: the dense operator in plain torch)",
    )
    parser.add_argument(
        "--use-pallas-stft", action=argparse.BooleanOptionalAction,
        default=True,
        help="the STFT log-magnitude through its CUDA kernels, forward and "
        "backward (--no-use-pallas-stft: plain torch). Models with "
        "trainable STFT bases always take plain torch",
    )
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--profile-dir", default="",
        help="write a torch.profiler trace of one train step here",
    )
    parser.add_argument(
        "--dtype", default="float32", choices=["float32", "bfloat16"],
        help="ResNet backbone compute dtype (params stay f32; the radar "
        "return and the STFT always run in f32)",
    )
    return parser


def build_log_dir(arg) -> str:
    """The run directory, named as the JAX trainer names it (so that
    ``--resume`` with a raised ``--num-epochs`` finds the same one)."""
    run_params = dict(vars(arg))
    for k in (
        "data_path", "label_path", "log_dir", "resume", "seed",
        "lambda_rel_step", "lambda_step_decay", "loc_step",
        "num_epochs", "save_freq",
    ):
        run_params.pop(k, None)
    if arg.lambda_train_epoch > arg.num_epochs:
        run_params.pop("lambda_train_epoch", None)
    if arg.loc_train_epoch > arg.num_epochs:
        run_params.pop("loc_train_epoch", None)
    name = config_lib.run_name_from_args(run_params, notes=arg.notes)
    return os.path.join(arg.log_dir, name)


def _restore(manager, model, optimizer):
    """``(extra, step)`` of the latest checkpoint, loaded into ``model``
    and ``optimizer``; when the optimizer's state does not fit (another
    optimizer wrote it), the model's alone, the optimizer starting anew."""
    try:
        return manager.restore(model, optimizer)
    except (ValueError, KeyError):
        extra, step = manager.restore(model)
        print("resume: the optimizer state does not fit; restored the "
              "model's parameters and statistics only, the optimizer "
              "starts anew")
        return extra, step


def main(argv=None, *, device="cuda") -> list[dict]:
    """Train on ``device``; returns one dict per epoch run: its index, the
    train and validation loss and accuracy, the train clips/s and
    ``radar_lambda`` after the epoch. Without a CUDA device,
    ``device="cuda"`` raises before anything is set up."""
    arg = get_parser().parse_args(argv)
    device = resolve_device(device)
    print(f"device: {device}")
    torch.backends.cuda.matmul.allow_tf32 = False

    log_dir = build_log_dir(arg)
    arg.log_dir = log_dir
    config_lib.save_arg(vars(arg), log_dir)

    module = importlib.import_module(
        "skeleton_action_recognition_tpu_torch.models."
        + arg.model_type.strip()
    )
    config_lib.snapshot_sources(log_dir, [module.Model])
    model_kwargs = dict(
        num_classes=arg.num_classes,
        num_filters=arg.num_filters,
        num_pad_frames=arg.num_pad_frames,
        use_pallas=arg.use_pallas,
        use_pallas_stft=arg.use_pallas_stft,
        dtype=torch.bfloat16 if arg.dtype == "bfloat16" else None,
        device=device,
        generator=torch.Generator().manual_seed(arg.seed),
    )
    if arg.wavelength is not None:
        model_kwargs["wavelength"] = arg.wavelength
    model = module.Model(**model_kwargs)

    datasets = {
        part: NumpyDataset(
            arg.data_path.format(part),
            arg.label_path.format(part),
            batch_size=arg.batch_size,
            num_classes=arg.num_classes,
            shuffle=(part == "train"),
            drop_remainder=(part == "train"),
            seed=arg.seed,
        )
        for part in ("train", "val")
    }
    # the JAX trainer draws one batch to initialize its model; drawing it
    # here too keeps the two trainers' epoch permutations in step
    next(iter(datasets["train"].batches()))

    lr = schedules.cyclic_triangular(1e-4, arg.base_lr, arg.lr_cycle)
    optimizer = RadarOptimizer(
        model.named_parameters(), lr,
        lambda_rel_step=arg.lambda_rel_step, loc_step=arg.loc_step,
        lambda_step_decay=arg.lambda_step_decay,
    )

    manager = ckpt_lib.CheckpointManager(os.path.join(log_dir, "checkpoints"))
    start_epoch = 0
    if arg.resume:
        extra, step = _restore(manager, model, optimizer)
        if step is not None:
            start_epoch = (extra or {}).get("epoch", 0) + 1
            print(f"resumed from checkpoint {step} (epoch {start_epoch})")

    def train_step_for(train_lambda: bool, train_loc: bool):
        return steps_lib.make_radar_train_step(
            model, optimizer, arg.batch_size, train_lambda, train_loc
        )

    eval_step = steps_lib.make_eval_step(model)
    writer = tb_writer.SummaryWriter(log_dir)

    if arg.profile_dir:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        (xs, ys), = prefetch_to_device(
            [next(iter(datasets["train"].batches()))], device
        )
        with profile(activities=activities) as prof:
            train_step_for(False, False)(xs, ys)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        os.makedirs(arg.profile_dir, exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(arg.profile_dir, "train_step.trace.json")
        )
        print(f"profiler trace written to {arg.profile_dir}")

    history = []
    for epoch in range(start_epoch, arg.num_epochs):
        print(f"Epoch {epoch + 1}/{arg.num_epochs}")
        train_step = train_step_for(epoch > arg.lambda_train_epoch,
                                    epoch > arg.loc_train_epoch)
        record = {"epoch": epoch}
        for phase in ("train", "val"):
            data = datasets[phase]
            loss_m = metrics_lib.Mean()
            acc_m = metrics_lib.Accuracy()
            cm = metrics_lib.ConfusionMatrix(arg.num_classes)
            t0 = time.time()
            if phase == "train":
                # metrics stay on the device until the epoch ends: a fetch
                # per step would stall the device after every step
                pending = [train_step(xs, ys) for xs, ys in
                           prefetch_to_device(data.batches(), device)]
                for i, m in enumerate(pending):
                    m = {k: v.item() for k, v in m.items()}
                    loss_m.update(m["loss"])
                    acc_m.update(m["correct"], m["count"])
                    step_idx = epoch * len(data) + i
                    writer.add_scalar(f"{phase}_cross_entropy_loss",
                                      loss_m.result(), step_idx)
                    writer.add_scalar(f"{phase}_acc", acc_m.result(),
                                      step_idx)
            else:
                pending = []
                for xb, yb in data.batches():
                    n = len(xb)
                    if n < arg.batch_size:
                        # pad the last partial batch to the batch size, as
                        # the JAX trainer does; the pad rows are cut below
                        xb = np.concatenate([xb, np.zeros(
                            (arg.batch_size - n,) + xb.shape[1:], xb.dtype)])
                    ((xs,),) = prefetch_to_device([(xb,)], device)
                    pending.append((eval_step(xs), n, yb))
                for i, (probs, n, yb) in enumerate(pending):
                    probs = probs.cpu().numpy()[:n]
                    preds = probs.argmax(-1)
                    labels = np.asarray(yb).argmax(-1)
                    acc_m.update(int((preds == labels).sum()), len(labels))
                    ce = -np.log(np.maximum(
                        probs[np.arange(len(labels)), labels], 1e-12))
                    loss_m.update(float(ce.mean()), len(labels))
                    cm.update(labels, preds)
                    step_idx = epoch * len(data) + i
                    writer.add_scalar(f"{phase}_cross_entropy_loss",
                                      loss_m.result(), step_idx)
                    writer.add_scalar(f"{phase}_acc", acc_m.result(),
                                      step_idx)
                png, h, w = confusion_lib.confusion_matrix_png(cm.result())
                writer.add_image_png("confusion_matrix", png, h, w, epoch)
            writer.add_scalar(f"{phase}_epoch_cross_entropy_loss",
                              loss_m.result(), epoch)
            writer.add_scalar(f"{phase}_epoch_acc", acc_m.result(), epoch)
            dt = time.time() - t0
            print(
                f"{phase} Loss: {loss_m.result():.4f} "
                f"Acc: {acc_m.result():.4f} "
                f"({dt:.1f}s, {acc_m.count / max(dt, 1e-9):.1f} clips/s)"
            )
            record[f"{phase}_loss"] = loss_m.result()
            record[f"{phase}_acc"] = acc_m.result()
            if phase == "train":
                record["train_clips_per_s"] = acc_m.count / max(dt, 1e-9)
        # the staged unfreeze must be observable: one scalar fetch an epoch
        lam = model.virtual_radar.radar_lambda.item()
        writer.add_scalar("radar_lambda", lam, epoch)
        print(f"radar_lambda: {lam:.6g}")
        record["radar_lambda"] = lam
        history.append(record)
        if (epoch + 1) % arg.save_freq == 0 or epoch == arg.num_epochs - 1:
            manager.save(epoch, model, optimizer, {"epoch": epoch})
            print(f"  checkpoint saved at epoch {epoch + 1}")
    writer.close()
    return history


if __name__ == "__main__":
    main()
