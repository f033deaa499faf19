"""``TFRecordDataset``'s streaming mode and per-process shard split against
the JAX package's: ``stream=True`` (shard by shard, the shard order and
each shard's records shuffled, a cross-shard reservoir of
``shuffle_buffer`` samples) and ``records[process_index::process_count]``,
batch for batch and bit for bit from one seed, over two epochs."""

import threading

import numpy as np
import pytest

from skeleton_action_recognition_tpu.data.pipeline import (
    TFRecordDataset as JaxTFRecordDataset,
)
from skeleton_action_recognition_tpu.data.pipeline import (
    stream_transform as jax_stream_transform,
)
from skeleton_action_recognition_tpu_torch.data import tfrecord
from skeleton_action_recognition_tpu_torch.data.pipeline import (
    TFRecordDataset,
    stream_transform,
)

NUM_CLASSES = 7


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """23 seeded clips ``(3, 4, 25, 1)`` in 5 shards of 4, 4, 4, 4 and 7
    records."""
    root = tmp_path_factory.mktemp("stream")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(23, 3, 4, 25, 1)).astype(np.float32)
    tfrecord.write_dataset(x, rng.integers(0, NUM_CLASSES, 23), str(root),
                           "s", num_shards=5)
    return str(root)


def epochs(ds, n=2):
    return [list(ds.batches()) for _ in range(n)]


def assert_same_batches(got, want):
    assert len(got) == len(want)
    for epoch_got, epoch_want in zip(got, want):
        assert [len(x) for x, _ in epoch_got] == [
            len(x) for x, _ in epoch_want]
        for (x, y), (wx, wy) in zip(epoch_got, epoch_want):
            assert x.dtype == wx.dtype and y.dtype == wy.dtype
            np.testing.assert_array_equal(x, wx)
            np.testing.assert_array_equal(y, wy)


@pytest.mark.parametrize("shuffle,shuffle_buffer", [
    (False, 1024), (True, 0), (True, 5), (True, 1024),
], ids=["ordered", "within_shard", "reservoir_5", "reservoir_whole"])
@pytest.mark.parametrize("drop_remainder", [False, True])
def test_stream_batches_equal_jax(shards, shuffle, shuffle_buffer,
                                  drop_remainder):
    kwargs = dict(batch_size=4, num_classes=NUM_CLASSES, shuffle=shuffle,
                  drop_remainder=drop_remainder, seed=3, stream=True,
                  shuffle_buffer=shuffle_buffer)
    got = epochs(TFRecordDataset(shards, **kwargs))
    want = epochs(JaxTFRecordDataset(shards, **kwargs))
    assert_same_batches(got, want)
    rows = sum(len(x) for x, _ in got[0])
    assert rows == (20 if drop_remainder else 23)
    if shuffle:  # the second epoch draws anew
        assert not np.array_equal(got[0][0][0], got[1][0][0])


def test_stream_takes_the_transform(shards):
    kwargs = dict(batch_size=5, num_classes=NUM_CLASSES, shuffle=True,
                  seed=1, stream=True, shuffle_buffer=6)
    got = epochs(TFRecordDataset(shards, transform=stream_transform("bone"),
                                 **kwargs), 1)
    want = epochs(JaxTFRecordDataset(
        shards, transform=jax_stream_transform("bone"), **kwargs), 1)
    assert_same_batches(got, want)


@pytest.mark.parametrize("stream", [False, True], ids=["in_ram", "stream"])
@pytest.mark.parametrize("process_count", [2, 3])
def test_process_split_equals_jax(shards, stream, process_count):
    """Each process's shards and batches (seeded ``seed + index``, as the
    trainers seed them) are JAX's."""
    for index in range(process_count):
        kwargs = dict(batch_size=3, num_classes=NUM_CLASSES, shuffle=True,
                      drop_remainder=True, seed=10 + index,
                      process_index=index, process_count=process_count,
                      stream=stream, shuffle_buffer=4)
        ds, jax_ds = TFRecordDataset(shards, **kwargs), JaxTFRecordDataset(
            shards, **kwargs)
        assert ds.records == jax_ds.records
        assert ds.records == sorted(ds.records)
        assert len(ds) == len(jax_ds) and ds.num_samples() == (
            jax_ds.num_samples())
        assert_same_batches(epochs(ds), epochs(jax_ds))
    every = [r for i in range(process_count) for r in TFRecordDataset(
        shards, 3, process_index=i, process_count=process_count).records]
    assert sorted(every) == TFRecordDataset(shards, 3).records


def test_sample_shape_and_decoded_records_equal_jax(shards):
    ds, jax_ds = TFRecordDataset(shards, 4), JaxTFRecordDataset(shards, 4)
    assert ds._sample_shape() == jax_ds._sample_shape() == (3, 4, 25, 1)
    got, want = list(ds.iter_decoded()), list(jax_ds.iter_decoded())
    assert len(got) == len(want) == 23
    for (x, y), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(x, wx)
        assert y == wy


def test_a_consumer_that_stops_ends_the_stream_thread(shards):
    before = threading.active_count()
    ds = TFRecordDataset(shards, 2, shuffle=True, stream=True, prefetch=1)
    batches = ds.batches()
    next(batches)
    batches.close()
    assert threading.active_count() == before


def test_a_corrupt_shard_raises_in_the_consumer(tmp_path):
    x = np.zeros((4, 2, 3), np.float32)
    (path,) = tfrecord.write_dataset(x, np.zeros(4, int), str(tmp_path),
                                     "c", num_shards=1)
    data = bytearray(open(path, "rb").read())
    data[-6] ^= 0xFF  # inside the last payload
    open(path, "wb").write(bytes(data))
    with pytest.raises(IOError, match="code -3"):
        list(TFRecordDataset(str(tmp_path), 2, stream=True).batches())
