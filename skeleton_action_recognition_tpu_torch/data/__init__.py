"""Data layer: NTU parsing, normalization, streams, TFRecord IO and the
batch pipeline (counterparts of the JAX package's ``data/{skeleton,
rotation,preprocess,proto,tfrecord,streams,pipeline}.py``, in numpy and
torch, with no jax). Exports what the JAX package's ``data`` exports."""

from skeleton_action_recognition_tpu_torch.data.skeleton import (
    TRAINING_CAMERAS,
    TRAINING_SUBJECTS,
    parse_skeleton_file,
    read_xyz,
    sample_metadata,
)
from skeleton_action_recognition_tpu_torch.data.preprocess import (
    pre_normalize,
    pre_normalize_np,
)
from skeleton_action_recognition_tpu_torch.data.streams import (
    bone_stream,
    motion_stream,
)
from skeleton_action_recognition_tpu_torch.data.tfrecord import (
    TFRecordReader,
    TFRecordWriter,
    parse_example,
    serialize_example,
)

__all__ = [
    "TFRecordReader",
    "TFRecordWriter",
    "TRAINING_CAMERAS",
    "TRAINING_SUBJECTS",
    "bone_stream",
    "motion_stream",
    "parse_example",
    "parse_skeleton_file",
    "pre_normalize",
    "pre_normalize_np",
    "read_xyz",
    "sample_metadata",
    "serialize_example",
]
