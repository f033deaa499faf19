"""Standalone checkpoint evaluation: the port's counterpart of the JAX
package's ``cli/evaluate.py``, on one CUDA device (``main(device="cpu")``
for the CPU).

The same flags with the same defaults, and the same report. It evaluates a
checkpoint written by the port's trainers: GNN-family models on a TFRecord
directory (with optional stream derivation, ``--stream``), or
spectrogram-family models on the ``.npy`` + pickled-label files their
trainer reads. Differences from the JAX CLI:

* one device; the JAX CLI shards the batch over every chip. Eager PyTorch
  runs a partial last batch as it is, so nothing is padded;
* ``--predictor`` takes only ``stock``: the folded and int8 predictors
  (``models/export.py``) are not ported, and asking for them raises;
* a spectrogram-family model runs its radar and STFT through the CUDA
  kernels (``use_pallas`` and ``use_pallas_stft``, as the port's
  spectrogram trainer does by default), with TF32 off in matrix products
  (the VirtualRadar layer refuses it). The JAX CLI sets ``use_pallas``
  alone and leaves its STFT to XLA. A model without these options (ST-GCN)
  is the stock model, as in JAX;
* only the models the port has load (``models.<name>.Model``); another
  ``--model`` raises.

Run:
    python -m skeleton_action_recognition_tpu_torch.cli.evaluate \\
        --model stgcn --checkpoint logs/run/checkpoints \\
        --test-data-path data/ntu/xview/val_data_joint [--stream bone]

    python -m skeleton_action_recognition_tpu_torch.cli.evaluate \\
        --model spectrogram --checkpoint logs/run/checkpoints \\
        --data-path data/ntu/xview/val_data_joint.npy \\
        --label-path data/ntu/xview/val_label.pkl
"""

from __future__ import annotations

import argparse
import importlib
import inspect
import json

import numpy as np
import torch

from skeleton_action_recognition_tpu_torch.data.pipeline import (
    NumpyDataset,
    TFRecordDataset,
    stream_transform,
)
from skeleton_action_recognition_tpu_torch.parallel.sharding import (
    prefetch_to_device,
    resolve_device,
)
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


def model_class(name: str):
    """``Model`` of the port's ``models.<name>``; ``ValueError`` for a
    model the port does not have yet."""
    module_name = "skeleton_action_recognition_tpu_torch.models." + name
    try:
        module = importlib.import_module(module_name)
    except ModuleNotFoundError as err:
        if err.name != module_name:
            raise
        module = None
    cls = getattr(module, "Model", None)
    if cls is None:
        raise ValueError(
            f"--model {name!r} is not ported yet: 'stgcn' and "
            "'spectrogram' are (the other GNN models are ROADMAP.md "
            "Queue 1, item 15)"
        )
    return cls


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


def main(argv=None, *, device="cuda") -> dict:
    """Evaluate on ``device``; prints and returns the report. Without a
    CUDA device, ``device="cuda"`` raises before any data is read."""
    arg = get_parser().parse_args(argv)
    if (arg.test_data_path is None) == (arg.data_path is None):
        raise SystemExit(
            "exactly one of --test-data-path (TFRecords) or "
            "--data-path/--label-path (.npy) is required"
        )
    if arg.data_path is not None and arg.label_path is None:
        raise SystemExit("--data-path requires --label-path")
    cls = model_class(arg.model)
    if arg.predictor != "stock":
        if is_spectrogram_family(cls):
            raise SystemExit(
                "folded/int8 predictors fold the ST-GCN family's BN and "
                "adjacency constants; use --predictor stock for "
                "spectrogram-family models"
            )
        raise ValueError(
            f"--predictor {arg.predictor} is not ported yet: only 'stock' "
            "is (the folded and int8 predictors are ROADMAP.md Queue 1, "
            "item 16b)"
        )
    device = resolve_device(device)

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
    model = build_model(cls, device, arg.num_classes, arg.num_filters,
                        arg.num_pad_frames)
    step = ckpt_lib.restore_latest_for_eval(model, arg.checkpoint)
    model.eval()

    correct = top5 = total = 0
    with torch.inference_mode():
        for xb, yb in prefetch_to_device(dataset.batches(), device):
            logits = model(xb).float().cpu().numpy()
            labels = yb.argmax(-1).cpu().numpy()
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
