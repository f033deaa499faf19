"""Data-generation CLI: raw ``.skeleton`` -> joint/bone/motion -> TFRecord.

Counterpart of the JAX package's ``cli/data_gen.py``, with the same flags,
defaults and artifacts, byte for byte:

    <out>/<benchmark>/{train,val}_data_joint.npy
    <out>/<benchmark>/{train,val}_label.pkl
    <out>/<benchmark>/{train,val}_data_{bone,joint_motion,bone_motion}.npy
    <out>/<benchmark>/{train,val}_data_<stream>/*.tfrecord

Host code: it takes no device. The ``.skeleton`` files are read by the C++
parser of :mod:`..native` (:func:`..data.skeleton.read_xyz`), as in the
JAX package, and the TFRecords' crcs are taken there too.

Run:
    python -m skeleton_action_recognition_tpu_torch.cli.data_gen \\
        --data-path .../nturgb+d_skeletons \\
        --ignored-sample-path .../samples_with_missing_skeletons.txt \\
        --out-folder data/ntu --benchmarks xview xsub
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

from skeleton_action_recognition_tpu_torch.data import (
    preprocess,
    skeleton,
    streams,
    tfrecord,
)


def gen_joint_data(
    data_path: str,
    out_path: str,
    ignored_sample_path: str | None,
    benchmark: str,
    part: str,
    max_frames: int = skeleton.MAX_FRAMES,
) -> None:
    ignored = skeleton.load_ignored_samples(ignored_sample_path)
    files = sorted(os.listdir(data_path))
    names, labels = skeleton.split_samples(files, benchmark, part, ignored)

    os.makedirs(out_path, exist_ok=True)
    with open(os.path.join(out_path, f"{part}_label.pkl"), "wb") as f:
        pickle.dump((names, list(labels)), f)

    fp = np.zeros(
        (len(labels), 3, max_frames, skeleton.NUM_JOINTS,
         skeleton.MAX_BODY_TRUE),
        np.float32,
    )
    for i, name in enumerate(names):
        data = skeleton.read_xyz(os.path.join(data_path, name))
        t = min(data.shape[1], max_frames)
        fp[i, :, :t] = data[:, :t]
        if (i + 1) % 500 == 0:
            print(f"  parsed {i + 1}/{len(names)}")

    fp = preprocess.pre_normalize_np(fp)
    np.save(os.path.join(out_path, f"{part}_data_joint.npy"), fp)


def gen_streams(out_path: str, part: str) -> None:
    joint = np.load(os.path.join(out_path, f"{part}_data_joint.npy"))
    np.save(
        os.path.join(out_path, f"{part}_data_bone.npy"),
        streams.bone_stream(joint),
    )
    for stream in ("joint", "bone"):
        data = np.load(
            os.path.join(out_path, f"{part}_data_{stream}.npy")
        )
        np.save(
            os.path.join(out_path, f"{part}_data_{stream}_motion.npy"),
            streams.motion_stream(data),
        )


def gen_tfrecords(
    out_path: str, part: str, stream: str = "joint", num_shards: int = 40
) -> None:
    data = np.load(os.path.join(out_path, f"{part}_data_{stream}.npy"))
    with open(os.path.join(out_path, f"{part}_label.pkl"), "rb") as f:
        _, labels = pickle.load(f, encoding="latin1")
    tfrecord.write_dataset(
        data,
        np.asarray(labels),
        os.path.join(out_path, f"{part}_data_{stream}"),
        f"{part}_data_{stream}",
        num_shards=num_shards,
        shuffle=(part == "train"),
    )


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="NTU RGB+D data converter")
    parser.add_argument(
        "--data-path", default="data/nturgbd_raw/nturgb+d_skeletons/"
    )
    parser.add_argument(
        "--ignored-sample-path",
        default="data/nturgbd_raw/samples_with_missing_skeletons.txt",
    )
    parser.add_argument("--out-folder", default="data/ntu/")
    parser.add_argument(
        "--benchmarks", nargs="+", default=["xview"],
        choices=["xview", "xsub"],
    )
    parser.add_argument("--parts", nargs="+", default=["train", "val"])
    parser.add_argument(
        "--streams", nargs="+", default=["joint"],
        help="streams to export as TFRecords",
    )
    parser.add_argument("--num-shards", type=int, default=40)
    return parser


def main(argv=None) -> None:
    arg = get_parser().parse_args(argv)
    for benchmark in arg.benchmarks:
        out_path = os.path.join(arg.out_folder, benchmark)
        for part in arg.parts:
            print(benchmark, part)
            gen_joint_data(
                arg.data_path, out_path, arg.ignored_sample_path,
                benchmark, part,
            )
            gen_streams(out_path, part)
            for stream in arg.streams:
                gen_tfrecords(out_path, part, stream, arg.num_shards)


if __name__ == "__main__":
    main()
