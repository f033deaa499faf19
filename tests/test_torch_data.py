"""The port's data layer against the JAX package's: TFRecord bytes, crc32c,
stream transforms and seeded batches."""

import os

import numpy as np
import pytest

from skeleton_action_recognition_tpu.data import pipeline as jax_pipeline
from skeleton_action_recognition_tpu.data import tfrecord as jax_tfrecord
from skeleton_action_recognition_tpu_torch.data import pipeline, tfrecord


def _clips(seed, n, t=12):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3, t, 25, 2)).astype(np.float32)
    return x, rng.integers(0, 5, size=n)


@pytest.mark.parametrize("length", [0, 1, 3, 4, 5, 64, 1000, 4097])
def test_crc32c_rows_matches_the_jax_crc(length):
    rows = np.random.default_rng(length).integers(
        0, 256, size=(6, length), dtype=np.uint8
    )
    got = tfrecord.crc32c_rows(rows)
    assert got.dtype == np.uint32
    assert [int(c) for c in got] == [
        jax_tfrecord.crc32c(r.tobytes()) for r in rows
    ]
    assert tfrecord.crc32c(b"123456789") == 0xE3069283  # the check value


def test_writer_bytes_equal_the_jax_writer(tmp_path):
    x, y = _clips(0, 7)
    port = tfrecord.write_dataset(x, y, str(tmp_path / "port"), "s", 3,
                                  shuffle=True, seed=4)
    ref = jax_tfrecord.write_dataset(x, y, str(tmp_path / "jax"), "s", 3,
                                     shuffle=True, seed=4)
    assert [os.path.basename(p) for p in port] == [
        os.path.basename(p) for p in ref
    ]
    for a, b in zip(port, ref):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()


def test_each_reads_the_others_shards(tmp_path):
    x, y = _clips(1, 5)
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    tfrecord.write_dataset(x, y, port_dir, "s", 2)
    jax_tfrecord.write_dataset(x, y, jax_dir, "s", 2)
    for reader, directory in (
        (tfrecord.read_dataset, jax_dir),
        (jax_tfrecord.read_dataset, port_dir),
    ):
        got = list(reader(directory))
        assert len(got) == 5
        for (f, label), want_f, want_l in zip(got, x, y):
            np.testing.assert_array_equal(f, want_f)
            assert label == want_l
    shard = os.path.join(jax_dir, "s-0.tfrecord")
    feats, labels = tfrecord.decode_shard(shard)
    want_f, want_l = jax_tfrecord.decode_shard(shard)
    np.testing.assert_array_equal(feats, want_f)
    np.testing.assert_array_equal(labels, want_l)


@pytest.mark.parametrize("where", [9, -2], ids=["length", "payload"])
def test_reader_refuses_a_corrupt_record(tmp_path, where):
    x, y = _clips(2, 2)
    (path,) = tfrecord.write_dataset(x, y, str(tmp_path), "s", 1)
    data = bytearray(open(path, "rb").read())
    data[where] ^= 0x01
    open(path, "wb").write(bytes(data))
    with pytest.raises(IOError):
        list(tfrecord.TFRecordReader(path))


@pytest.mark.parametrize(
    "stream", ["joint", "bone", "joint_motion", "bone_motion"]
)
def test_stream_transforms_equal_jax(stream):
    x, _ = _clips(3, 2)
    np.testing.assert_array_equal(
        pipeline.stream_transform(stream)(x),
        np.asarray(jax_pipeline.stream_transform(stream)(x)),
    )


def test_dataset_yields_the_jax_datasets_batches(tmp_path):
    """Same shards, same seed: the same batches in the same order over two
    epochs, with drop_remainder, a transform and one-hot labels."""
    x, y = _clips(4, 11)
    tfrecord.write_dataset(x, y, str(tmp_path), "s", 3)
    kwargs = dict(batch_size=3, num_classes=5, shuffle=True,
                  drop_remainder=True, seed=7)
    port = pipeline.TFRecordDataset(
        str(tmp_path), transform=pipeline.stream_transform("bone"), **kwargs
    )
    ref = jax_pipeline.TFRecordDataset(
        str(tmp_path), transform=jax_pipeline.stream_transform("bone"),
        **kwargs
    )
    assert len(port) == len(ref) == 3
    for _ in range(2):
        got, want = list(port.batches()), list(ref.batches())
        assert len(got) == len(want) == 3
        for (gx, gy), (wx, wy) in zip(got, want):
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)
    test = pipeline.TFRecordDataset(str(tmp_path), batch_size=4)
    assert [len(b) for b, _ in test.batches()] == [4, 4, 3]


def test_dataset_stops_its_thread_when_left_early(tmp_path):
    import threading

    x, y = _clips(5, 12)
    tfrecord.write_dataset(x, y, str(tmp_path), "s", 1)
    data = pipeline.TFRecordDataset(str(tmp_path), batch_size=1,
                                    prefetch=1)
    before = threading.active_count()
    batches = data.batches()
    next(batches)
    batches.close()
    assert threading.active_count() == before


def test_dataset_raises_what_its_thread_raised(tmp_path):
    x, y = _clips(6, 4)
    tfrecord.write_dataset(x, y, str(tmp_path), "s", 1)
    data = pipeline.TFRecordDataset(str(tmp_path), batch_size=2,
                                    num_classes=2)  # labels reach 4
    with pytest.raises(IndexError):
        list(data.batches())
