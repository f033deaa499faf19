"""Standalone checkpoint evaluation: the port's counterpart of the JAX
package's ``cli/evaluate.py``, on every visible CUDA device
(``main(device="cpu")`` for the CPU).

The same flags with the same defaults, and the same report. It evaluates a
checkpoint written by the port's trainers: GNN-family models on a TFRecord
directory (with optional stream derivation, ``--stream``), or
spectrogram-family models on the ``.npy`` + pickled-label files their
trainer reads. Differences from the JAX CLI:

* with more than one card visible, a replica of the model (or of its
  folded predictor) on each and each batch split across them in order
  (:class:`..serving.Replicas`), as the JAX CLI shards the batch over
  every chip. Eager PyTorch runs a part or a partial last batch as it
  is, so nothing is padded (and ``--batch-size`` need not divide by the
  cards);
* ``--predictor folded`` serves the folded stock ST-GCN in bfloat16 and
  ``int8`` its W8 form (``models/export.py``), as in JAX; any other model
  raises ``ValueError`` before any data is read (the JAX CLI reads the
  stock parameter names of whatever model it gets, and folds ST-PGCN
  without its projection), and a spectrogram-family model exits as in
  JAX;
* a spectrogram-family model runs its radar and STFT through the CUDA
  kernels (``use_pallas`` and ``use_pallas_stft``, as the port's
  spectrogram trainer does by default), with TF32 off in matrix products
  (the VirtualRadar layer refuses it). The JAX CLI sets ``use_pallas``
  alone and leaves its STFT to XLA. A model without these options (ST-GCN)
  is the stock model, as in JAX;
* ``--model <name>`` loads ``models.<name>.Model`` (``stgcn``, ``stgin``,
  ``stpgcn``, ``stpgcnp``, ``experimental``, ``spectrogram``); a name
  without one raises ``ValueError``, listing the models there are.

Run:
    python -m skeleton_action_recognition_tpu_torch.cli.evaluate \\
        --model stgcn --checkpoint logs/run/checkpoints \\
        --test-data-path data/ntu/xview/val_data_joint [--stream bone] \\
        [--predictor folded|int8|stock]

    python -m skeleton_action_recognition_tpu_torch.cli.evaluate \\
        --model spectrogram --checkpoint logs/run/checkpoints \\
        --data-path data/ntu/xview/val_data_joint.npy \\
        --label-path data/ntu/xview/val_label.pkl
"""

from __future__ import annotations

import argparse
import inspect
import json

import numpy as np
import torch

from skeleton_action_recognition_tpu_torch.data.pipeline import (
    NumpyDataset,
    TFRecordDataset,
    stream_transform,
)
from skeleton_action_recognition_tpu_torch.models import export, model_class
from skeleton_action_recognition_tpu_torch.parallel.sharding import (
    prefetch_to_device,
    resolve_device,
)
from skeleton_action_recognition_tpu_torch.serving import Replicas, replicate
from skeleton_action_recognition_tpu_torch.train import checkpoint as ckpt_lib


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Evaluate a checkpoint")
    parser.add_argument("--model", default="stgcn")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument(
        "--test-data-path", default=None,
        help="TFRecord directory (GNN-family models)",
    )
    parser.add_argument(
        "--data-path", default=None,
        help=".npy data file (spectrogram-family models; pairs with "
        "--label-path, mirroring the trainer's input surface)",
    )
    parser.add_argument("--label-path", default=None)
    parser.add_argument("--num-classes", type=int, default=60)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--num-filters", type=int, default=64)
    parser.add_argument("--num-pad-frames", type=int, default=250)
    parser.add_argument(
        "--stream", default="joint",
        choices=["joint", "bone", "joint_motion", "bone_motion"],
    )
    parser.add_argument(
        "--predictor", default="stock",
        choices=["stock", "folded", "int8"],
    )
    return parser


def is_spectrogram_family(cls) -> bool:
    return "num_pad_frames" in inspect.signature(cls).parameters


def build_model(cls, device, num_classes: int, num_filters: int,
                num_pad_frames: int):
    """``cls`` with the options of the evaluated model that it takes, on
    ``device``. A spectrogram-family model runs its radar and STFT through
    the kernels, and turns TF32 off in matrix products for the process,
    as the spectrogram trainer does."""
    params = inspect.signature(cls).parameters
    kwargs = {"num_classes": num_classes}
    for name, value in (
        ("num_filters", num_filters),
        ("num_pad_frames", num_pad_frames),
        ("use_pallas", True),
        ("use_pallas_stft", True),
    ):
        if name in params:
            kwargs[name] = value
    if is_spectrogram_family(cls):
        torch.backends.cuda.matmul.allow_tf32 = False
    return cls(**kwargs).to(device)


def eval_devices(device, devices=None) -> list:
    """The devices an evaluation runs on: ``devices`` where given, else
    every visible card for a CUDA ``device`` without an index (as the JAX
    CLIs take ``jax.devices()``), else ``[device]``; each resolved."""
    if devices is None:
        device = torch.device(device)
        count = torch.cuda.device_count() if device.type == "cuda" else 0
        if device.index is None and count > 1:
            devices = [torch.device("cuda", i) for i in range(count)]
        else:
            devices = [device]
    return [resolve_device(d) for d in devices]


def main(argv=None, *, device="cuda", devices=None) -> dict:
    """Evaluate on ``device``, or on each of ``devices`` (see
    :func:`eval_devices`); prints and returns the report. Without a CUDA
    device, ``device="cuda"`` raises before any data is read."""
    arg = get_parser().parse_args(argv)
    if (arg.test_data_path is None) == (arg.data_path is None):
        raise SystemExit(
            "exactly one of --test-data-path (TFRecords) or "
            "--data-path/--label-path (.npy) is required"
        )
    if arg.data_path is not None and arg.label_path is None:
        raise SystemExit("--data-path requires --label-path")
    cls = model_class(arg.model)
    if arg.predictor != "stock" and is_spectrogram_family(cls):
        raise SystemExit(
            "folded/int8 predictors fold the ST-GCN family's BN and "
            "adjacency constants; use --predictor stock for "
            "spectrogram-family models"
        )
    devices = eval_devices(device, devices)
    device = devices[0]
    model = build_model(cls, device, arg.num_classes, arg.num_filters,
                        arg.num_pad_frames)
    if arg.predictor != "stock":
        export.check_foldable(model)

    if arg.data_path is not None:
        dataset = NumpyDataset(
            arg.data_path,
            arg.label_path,
            batch_size=arg.batch_size,
            num_classes=arg.num_classes,
            shuffle=False,
        )
    else:
        dataset = TFRecordDataset(
            arg.test_data_path,
            batch_size=arg.batch_size,
            num_classes=arg.num_classes,
            shuffle=False,
            transform=stream_transform(arg.stream),
        )
    step = ckpt_lib.restore_latest_for_eval(model, arg.checkpoint)
    fwds = [m.eval() for m in replicate(model, devices)]
    if arg.predictor == "folded":
        fwds = [export.fused_stgcn_predictor(m, device=d)
                for m, d in zip(fwds, devices)]
    elif arg.predictor == "int8":
        fwds = [export.quantized_stgcn_predictor(m, device=d)
                for m, d in zip(fwds, devices)]
    if len(devices) == 1:
        fwd, batches = fwds[0], prefetch_to_device(dataset.batches(), device)
    else:
        fwd, batches = Replicas(fwds, devices), dataset.batches()

    correct = top5 = total = 0
    with torch.inference_mode():
        for xb, yb in batches:
            logits = fwd(xb).float().cpu().numpy()
            labels = torch.as_tensor(yb).argmax(-1).cpu().numpy()
            correct += int((logits.argmax(-1) == labels).sum())
            t5 = np.argsort(logits, axis=-1)[:, -5:]
            top5 += int((t5 == labels[:, None]).any(-1).sum())
            total += len(labels)

    report = {
        "checkpoint_step": step,
        "stream": arg.stream,
        "predictor": arg.predictor,
        "samples": total,
        "top1": round(correct / max(total, 1), 4),
        "top5": round(top5 / max(total, 1), 4),
    }
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
