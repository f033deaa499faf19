"""GNN trainer CLI: the port's counterpart of the JAX package's
``cli/main_gnn.py``, on one CUDA device (``main(device="cpu")`` for the
CPU), or data-parallel on several, one process per card under ``torchrun``.

The same flags with the same defaults, except ``--steps-per-dispatch``
(a TPU dispatch knob). The flow is the JAX trainer's: TFRecords in, the
train-mode forward and backward with Keras-2 SGD on the piecewise schedule
(10x decays at ``--steps`` epochs), an eval over the whole test set each
epoch, TensorBoard scalars, checkpoints every ``--save-freq`` epochs and
at the end, and ``--resume`` from the latest checkpoint of the same run
directory. ``--model <name>`` trains ``models.<name>.Model`` (``stgcn``,
``stgin``, ``stpgcn``, ``stpgcnp``, ``experimental``), built with only the
options its signature takes, as the JAX trainer passes only the fields its
dataclass has: ``--dtype bfloat16``, ``--trainable-adjacency`` and
``--fused-sgcn`` with its min-channels are dropped for a model without
them.

Data parallelism (:class:`..parallel.sharding.DataParallel`): under
``torchrun`` each process takes the card ``LOCAL_RANK`` and joins an NCCL
process group. ``--batch-size`` is per card, as in JAX (per chip): the
global batch is ``--batch-size`` times the world size. Each rank reads its
own shards of the training set (``records[rank::world]``, seeded ``seed +
rank``) and runs as many steps an epoch as the rank with the fewest; the
gradients are summed over the ranks and the BatchNorm statistics taken over
the global batch, so a step equals one process's step on the whole global
batch. Every rank reads the whole test set and scores its rows of each
global batch. Rank 0 prints, writes the TensorBoard summaries and the
checkpoints. Without ``WORLD_SIZE`` in the environment there is no process
group.

Run:
    python -m skeleton_action_recognition_tpu_torch.cli.main_gnn \\
        --model stgcn --fused-sgcn --train-data-path ... --test-data-path ...
    torchrun --nproc_per_node=8 -m \\
        skeleton_action_recognition_tpu_torch.cli.main_gnn --model stgcn ...
"""

from __future__ import annotations

import argparse
import inspect
import itertools
import os
import time

import numpy as np
import torch

from skeleton_action_recognition_tpu_torch.data.pipeline import (
    TFRecordDataset,
    stream_transform,
)
from skeleton_action_recognition_tpu_torch.models import model_class
from skeleton_action_recognition_tpu_torch.parallel import distributed
from skeleton_action_recognition_tpu_torch.parallel.sharding import (
    DataParallel,
    prefetch_to_device,
    resolve_device,
)
from skeleton_action_recognition_tpu_torch.train import (
    checkpoint as ckpt_lib,
    metrics as metrics_lib,
    schedules,
    steps as steps_lib,
)
from skeleton_action_recognition_tpu_torch.train.optim import TFSGD
from skeleton_action_recognition_tpu_torch.utils import (
    config as config_lib,
    confusion as confusion_lib,
    tb_writer,
)


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=(
            "Graph Convolutional Neural Network for Skeleton-Based "
            "Action Recognition (PyTorch, one CUDA device per process)"
        )
    )
    parser.add_argument("--model", required=True, help="model used to train")
    parser.add_argument("--base-lr", type=float, default=1e-1)
    parser.add_argument("--num-classes", type=int, default=60)
    parser.add_argument(
        "--batch-size", type=int, default=64, help="per-card batch size"
    )
    parser.add_argument("--num-epochs", type=int, default=80)
    parser.add_argument("--save-freq", type=int, default=10)
    parser.add_argument(
        "--freeze-graph-until",
        type=int,
        default=80,
        help="adjacency matrices train only after this epoch",
    )
    parser.add_argument("--log-dir", default="logs/")
    parser.add_argument(
        "--train-data-path", default="data/ntu/xview/train_data_joint"
    )
    parser.add_argument(
        "--test-data-path", default="data/ntu/xview/val_data_joint"
    )
    parser.add_argument("--notes", default="")
    parser.add_argument(
        "--steps", type=int, default=[10, 50], nargs="+",
        help="epochs at which LR decays 10x",
    )
    parser.add_argument(
        "--stream",
        default="joint",
        choices=["joint", "bone", "joint_motion", "bone_motion"],
        help="derive this stream from the joint TFRecords on the fly",
    )
    parser.add_argument(
        "--trainable-adjacency", action="store_true",
        help="make the adjacency stack a trainable parameter (it then "
        "obeys --freeze-graph-until)",
    )
    parser.add_argument("--resume", action="store_true")
    parser.add_argument(
        "--l2-weight", type=float, default=0.0,
        help="L2 penalty over conv and dense weights (the reference "
        "declares 1e-4 but never applies it; 0 = reference behavior)",
    )
    parser.add_argument(
        "--profile-dir", default="",
        help="write a torch.profiler trace of one warm-up step here",
    )
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--dtype", default="float32", choices=["float32", "bfloat16"],
        help="compute dtype of the blocks (params stay f32)",
    )
    parser.add_argument(
        "--precision", default="default",
        choices=["default", "high", "highest"],
        help="float32 matmul and convolution precision on the GPU: "
        "'default' and 'high' allow TF32 in cuBLAS and cuDNN (as JAX's "
        "default f32 matmul on a GPU does); 'highest' turns TF32 off "
        "(torch.backends.cuda.matmul.allow_tf32 and "
        "torch.backends.cudnn.allow_tf32), for f32-exact math",
    )
    parser.add_argument(
        "--fused-sgcn", action="store_true",
        help="run the spatial graph conv, forward and backward, through "
        "the hand-written CUDA kernels (the K*C_out intermediate stays in "
        "shared memory). Incompatible with --trainable-adjacency; "
        "checkpoints stay interchangeable",
    )
    parser.add_argument(
        "--fused-sgcn-min-channels", type=int, default=128,
        help="with --fused-sgcn: use the kernels only on blocks with at "
        "least this many output channels. 0 = fuse every block",
    )
    return parser


def build_log_dir(arg) -> str:
    """The run directory, named as the JAX trainer names it (so that
    ``--resume`` with a raised ``--num-epochs`` finds the same one)."""
    run_params = dict(vars(arg))
    for k in (
        "train_data_path", "test_data_path", "log_dir", "save_freq",
        "freeze_graph_until", "resume", "profile_dir", "seed",
        "num_epochs", "fused_sgcn_min_channels",
    ):
        run_params.pop(k, None)
    if run_params.get("precision") == "default":
        run_params.pop("precision")
    name = config_lib.run_name_from_args(run_params, notes=arg.notes)
    return os.path.join(arg.log_dir, name)


def set_precision(precision: str) -> None:
    """``highest``: TF32 off in cuBLAS and cuDNN; otherwise on."""
    allow = precision != "highest"
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow


def model_options(model_cls, arg) -> dict:
    """The keyword arguments of ``model_cls`` that the flags set, among
    those its signature takes (the JAX trainer's rule over dataclass
    fields)."""
    params = inspect.signature(model_cls).parameters
    kwargs = {"num_classes": arg.num_classes}
    if arg.dtype == "bfloat16" and "dtype" in params:
        kwargs["dtype"] = torch.bfloat16
    if arg.trainable_adjacency and "trainable_adjacency" in params:
        kwargs["trainable_adjacency"] = True
    if arg.fused_sgcn and "fused_sgcn" in params:
        kwargs["fused_sgcn"] = True
        if "fused_sgcn_min_channels" in params:
            kwargs["fused_sgcn_min_channels"] = arg.fused_sgcn_min_channels
    return kwargs


def main(argv=None, *, device="cuda") -> list[dict]:
    """Train on ``device``; returns one dict per epoch run: its index, mean
    train loss, train and test accuracy, and train clips/s (the global
    batch's, on every rank). Without a CUDA device, ``device="cuda"``
    raises before anything is set up. With ``WORLD_SIZE`` set, the process
    joins its process group first (NCCL for a CUDA ``device``, gloo for the
    CPU) and raises if it cannot; a CUDA ``device`` without an index is
    then card ``LOCAL_RANK``."""
    arg = get_parser().parse_args(argv)
    model_cls = model_class(arg.model)
    device = resolve_device(device)
    distributed.maybe_initialize_distributed(
        "nccl" if device.type == "cuda" else "gloo")
    device = distributed.local_device(device)
    dp = DataParallel()
    lead = dp.rank == 0
    say = print if lead else (lambda *args, **kwargs: None)
    set_precision(arg.precision)
    say(f"device: {device}, {dp.world_size} process(es)")
    global_batch = arg.batch_size * dp.world_size

    log_dir = build_log_dir(arg)
    arg.log_dir = log_dir
    if lead:
        config_lib.save_arg(vars(arg), log_dir)
        config_lib.snapshot_sources(log_dir, [model_cls])

    model = model_cls(
        **model_options(model_cls, arg), device=device,
        generator=torch.Generator().manual_seed(arg.seed),
    )

    transform = stream_transform(arg.stream)
    # each rank reads its own shards, arg.batch_size rows of each global
    # batch; every rank runs the fewest steps any rank has (collectives)
    train_data = TFRecordDataset(
        arg.train_data_path,
        batch_size=arg.batch_size,
        num_classes=arg.num_classes,
        shuffle=True,
        drop_remainder=True,
        seed=arg.seed + dp.rank,
        process_index=dp.rank,
        process_count=dp.world_size,
        transform=transform,
    )
    steps_per_epoch = dp.min_over_ranks(len(train_data))
    # every rank reads the whole test set, in global batches
    test_data = TFRecordDataset(
        arg.test_data_path,
        batch_size=global_batch,
        num_classes=arg.num_classes,
        shuffle=False,
        transform=transform,
    )

    # --steps are epochs; the boundaries count the actual steps per epoch
    boundaries = [e * steps_per_epoch for e in arg.steps]
    lr = schedules.piecewise_constant(arg.base_lr, boundaries)
    optimizer = TFSGD(model.parameters(), lr, momentum=0.9, nesterov=True)

    # the JAX trainer draws one batch to initialize its model; drawing it
    # here too keeps the two trainers' epoch permutations in step
    next(iter(train_data.batches()))

    manager = ckpt_lib.CheckpointManager(os.path.join(log_dir, "checkpoints"))
    start_epoch = 0
    if arg.resume:
        distributed.barrier()
        extra, step = manager.restore(model, optimizer)
        if step is not None:
            start_epoch = (extra or {}).get("epoch", 0) + 1
            say(f"resumed from step {step} (epoch {start_epoch})")
    dp.broadcast_module(model)

    train_step = steps_lib.make_train_step(
        model, optimizer, global_batch, arg.l2_weight,
        dp=dp if dp.active else None,
    )
    eval_step = steps_lib.make_eval_step(model)

    writer = (tb_writer.SummaryWriter(log_dir) if lead
              else tb_writer.NullWriter())
    ce_m = metrics_lib.Mean()
    acc_m = metrics_lib.Accuracy()
    acc5_m = metrics_lib.Accuracy()

    if arg.profile_dir:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        xb, yb = next(iter(train_data.batches()))
        (xs, ys), = prefetch_to_device([(xb, yb)], device)
        with profile(activities=activities) as prof:
            train_step(xs, ys, False)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        if lead:
            os.makedirs(arg.profile_dir, exist_ok=True)
            prof.export_chrome_trace(
                os.path.join(arg.profile_dir, "train_step.trace.json")
            )
            print(f"profiler trace written to {arg.profile_dir}")

    train_iter = 0
    test_iter = 0
    history = []
    for epoch in range(start_epoch, arg.num_epochs):
        say(f"Epoch: {epoch + 1}")
        t0 = time.time()
        samples = 0
        epoch_loss = metrics_lib.Mean()
        epoch_train_acc = metrics_lib.Accuracy()
        # metrics stay on the device until the epoch ends: a fetch per
        # step would stall the device after every step
        pending = []
        batches = itertools.islice(train_data.batches(), steps_per_epoch)
        for xs, ys in prefetch_to_device(batches, device):
            pending.append(
                train_step(xs, ys, epoch > arg.freeze_graph_until)
            )
        for m in pending:
            m = {k: v.item() for k, v in m.items()}
            ce_m.update(m["loss"])
            acc_m.update(m["correct"], m["count"])
            acc5_m.update(m["correct_top5"], m["count"])
            samples += m["count"]
            epoch_loss.update(m["loss"])
            epoch_train_acc.update(m["correct"], m["count"])
            writer.add_scalar("cross_entropy_loss", ce_m.result(), train_iter)
            writer.add_scalar("train_acc", acc_m.result(), train_iter)
            writer.add_scalar("train_acc_top_5", acc5_m.result(), train_iter)
            ce_m.reset(), acc_m.reset(), acc5_m.reset()
            train_iter += 1
        dt = time.time() - t0
        say(
            f"  train: {samples} clips in {dt:.1f}s "
            f"({samples / max(dt, 1e-9):.1f} clips/s)"
        )

        cm = metrics_lib.ConfusionMatrix(arg.num_classes)
        epoch_acc = metrics_lib.Accuracy()
        epoch_acc5 = metrics_lib.Accuracy()
        # each rank scores its rows of a global batch (the last one padded
        # to a multiple of the ranks), and every rank gathers them all
        local = ((dp.local_rows(dp.pad_rows(xb)), yb)
                 for xb, yb in test_data.batches())
        pending_eval = [
            (dp.gather_rows(eval_step(xs)), ys)
            for xs, ys in prefetch_to_device(local, device)
        ]
        for probs, ys in pending_eval:
            labels = ys.cpu().numpy().argmax(-1)
            probs = probs.cpu().numpy()[:len(labels)]
            preds = probs.argmax(-1)
            top5 = np.argsort(probs, axis=-1)[:, -5:]
            epoch_acc.update(int((preds == labels).sum()), len(labels))
            epoch_acc5.update(
                int((top5 == labels[:, None]).any(-1).sum()), len(labels)
            )
            cm.update(labels, preds)
            writer.add_scalar("test_acc", epoch_acc.result(), test_iter)
            writer.add_scalar(
                "test_acc_top_5", epoch_acc5.result(), test_iter
            )
            test_iter += 1
        writer.add_scalar("epoch_test_acc", epoch_acc.result(), epoch)
        writer.add_scalar(
            "epoch_test_acc_top_5", epoch_acc5.result(), epoch
        )
        say(
            f"  test: top1 {epoch_acc.result():.4f} "
            f"top5 {epoch_acc5.result():.4f}"
        )
        history.append({
            "epoch": epoch, "train_loss": epoch_loss.result(),
            "train_acc": epoch_train_acc.result(),
            "test_acc": epoch_acc.result(),
            "test_acc_top5": epoch_acc5.result(),
            "train_clips_per_s": samples / max(dt, 1e-9),
        })

        if (epoch + 1) % arg.save_freq == 0 and lead:
            png, h, w = confusion_lib.confusion_matrix_png(cm.result())
            writer.add_image_png("Test Confusion Matrix", png, h, w, epoch)
            manager.save(epoch, model, optimizer, {"epoch": epoch})
            print(f"  checkpoint saved at epoch {epoch + 1}")

    if lead:
        manager.save(
            arg.num_epochs, model, optimizer, {"epoch": arg.num_epochs - 1}
        )
    writer.close()
    # no rank returns before rank 0's last checkpoint is written
    distributed.barrier()
    return history


if __name__ == "__main__":
    main()
