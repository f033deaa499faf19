"""Multi-stream ensemble evaluation: the port's counterpart of the JAX
package's ``cli/ensemble.py``, on one CUDA device (``main(device="cpu")``
for the CPU).

Combines the softmax scores of independently trained stream models (joint /
bone / joint_motion / bone_motion GNNs, optionally the VirtualRadar
spectrogram branch) with per-stream weights, over one TFRecord directory of
joint data: the GNN streams derive theirs from it, the spectrogram branch
reads the joints. The same flags, defaults and report as the JAX CLI. As in
``cli/evaluate.py``: one device, no padding of the last batch, the models
the port has, and a spectrogram stream through the radar and STFT kernels
(the JAX ensemble builds it with neither).

Run:
    python -m skeleton_action_recognition_tpu_torch.cli.ensemble \\
        --model stgcn \\
        --streams joint bone \\
        --checkpoints logs/run_joint/checkpoints logs/run_bone/checkpoints \\
        --weights 1.0 1.0 \\
        --test-data-path data/ntu/xview/val_data_joint
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from skeleton_action_recognition_tpu_torch.cli import evaluate
from skeleton_action_recognition_tpu_torch.data.pipeline import (
    TFRecordDataset,
    stream_transform,
)
from skeleton_action_recognition_tpu_torch.parallel.sharding import (
    prefetch_to_device,
    resolve_device,
)
from skeleton_action_recognition_tpu_torch.train import checkpoint as ckpt_lib
from skeleton_action_recognition_tpu_torch.train.steps import make_eval_step


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Multi-stream ensemble evaluation (PyTorch, one CUDA "
        "device)"
    )
    parser.add_argument("--model", default="stgcn")
    parser.add_argument(
        "--streams", nargs="+", required=True,
        help="stream per checkpoint: joint/bone/joint_motion/bone_motion "
        "or 'spectrogram'",
    )
    parser.add_argument("--checkpoints", nargs="+", required=True)
    parser.add_argument("--weights", nargs="+", type=float, default=None)
    parser.add_argument("--num-classes", type=int, default=60)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--test-data-path", required=True)
    parser.add_argument("--num-filters", type=int, default=64)
    parser.add_argument("--num-pad-frames", type=int, default=250)
    return parser


def stream_scores(model, ckpt_dir, dataset, device) -> np.ndarray:
    """Restore a checkpointed model and return its softmax scores over the
    dataset (iteration order is deterministic: shuffle off)."""
    ckpt_lib.restore_latest_for_eval(model, ckpt_dir)
    eval_step = make_eval_step(model)
    return np.concatenate([
        eval_step(xb).cpu().numpy()
        for xb, _ in prefetch_to_device(dataset.batches(), device)
    ])


def main(argv=None, *, device="cuda") -> dict:
    """Score every stream on ``device``; prints and returns the report.
    Without a CUDA device, ``device="cuda"`` raises before any data is
    read."""
    arg = get_parser().parse_args(argv)
    if arg.weights is None:
        arg.weights = [1.0] * len(arg.streams)
    if not (
        len(arg.streams) == len(arg.checkpoints) == len(arg.weights)
    ):
        raise ValueError(
            "--streams, --checkpoints, --weights must have equal length"
        )
    device = resolve_device(device)

    labels = None
    combined = None
    report = {}
    for stream, ckpt, weight in zip(
        arg.streams, arg.checkpoints, arg.weights
    ):
        if stream == "spectrogram":
            cls = evaluate.model_class("spectrogram")
            transform = None
        else:
            cls = evaluate.model_class(arg.model)
            transform = stream_transform(stream)
        model = evaluate.build_model(cls, device, arg.num_classes,
                                     arg.num_filters, arg.num_pad_frames)

        dataset = TFRecordDataset(
            arg.test_data_path,
            batch_size=arg.batch_size,
            num_classes=arg.num_classes,
            shuffle=False,
            transform=transform,
        )
        _, raw_labels = dataset._load_all()
        if labels is None:
            labels = raw_labels
        scores = stream_scores(model, ckpt, dataset, device)
        acc = float((scores.argmax(-1) == labels).mean())
        report[f"{stream}_top1"] = round(acc, 4)
        print(f"{stream}: top1 {acc:.4f} (weight {weight})")
        contribution = weight * scores
        combined = (
            contribution if combined is None else combined + contribution
        )

    top1 = float((combined.argmax(-1) == labels).mean())
    top5_idx = np.argsort(combined, axis=-1)[:, -5:]
    top5 = float((top5_idx == labels[:, None]).any(-1).mean())
    report["ensemble_top1"] = round(top1, 4)
    report["ensemble_top5"] = round(top5, 4)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
