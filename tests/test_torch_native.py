"""The port's native tpurecord reader (``tpucfn_torch/data/native.py`` over
``tpucfn_torch/data/csrc/tpurecord.cc``, built here with g++ into
``tpucfn_torch/data/_build/``): the eight cases of
``tests/test_native_loader.py`` on the port, the port's reader against the
JAX package's on the same shards, and the dataset's choice of reader,
which it records (the fallback to the pure-Python reader is visible)."""

import numpy as np
import pytest

from tpucfn.data import ShardedDataset as JaxShardedDataset
from tpucfn.data.records import read_record_shard as jax_read_record_shard
from tpucfn_torch.data import (RecordShardWriter, ShardedDataset,
                               synthetic_cifar10, write_dataset_shards)
from tpucfn_torch.data import native
from tpucfn_torch.data.records import read_record_shard


@pytest.fixture(autouse=True)
def _native_library():
    """The library is built (or found) when a test runs, not while this
    module is imported: a machine without g++ skips, naming why."""
    if not native.native_available():
        pytest.skip(f"native reader not built: {native.native_error()}")


def _shard(tmp_path, payloads):
    p = tmp_path / "s.tpurec"
    with RecordShardWriter(p) as w:
        for b in payloads:
            w.write(b)
    return p


def test_native_matches_python_reader(tmp_path):
    payloads = [b"a", b"bb" * 500, b"", b"xyz" * 33]
    p = _shard(tmp_path, payloads)
    assert list(native.read_record_shard_native(p)) == payloads
    assert list(read_record_shard(p)) == payloads


def test_native_random_access_and_batch(tmp_path):
    payloads = [bytes([i]) * (i + 1) for i in range(20)]
    p = _shard(tmp_path, payloads)
    r = native.NativeShardReader(p)
    assert len(r) == 20
    assert r.read(7) == payloads[7]
    assert r.read_batch([3, 1, 19]) == [payloads[3], payloads[1], payloads[19]]
    assert r.read_batch([]) == []
    r.close()


def test_native_crc_detection(tmp_path):
    p = _shard(tmp_path, [b"payload-payload"])
    raw = bytearray(p.read_bytes())
    raw[-3] ^= 0xFF
    p.write_bytes(bytes(raw))
    r = native.NativeShardReader(p)
    with pytest.raises(ValueError, match="CRC"):
        r.read(0)


def test_native_truncation_detection(tmp_path):
    p = _shard(tmp_path, [b"x" * 100] * 10)
    p.write_bytes(p.read_bytes()[:-50])
    with pytest.raises(ValueError, match="truncated"):
        native.NativeShardReader(p)


def test_native_bad_magic(tmp_path):
    p = tmp_path / "junk.tpurec"
    p.write_bytes(b"\x00" * 64)
    with pytest.raises(ValueError, match="magic"):
        native.NativeShardReader(p)


def test_native_out_of_range(tmp_path):
    p = _shard(tmp_path, [b"one"])
    r = native.NativeShardReader(p)
    with pytest.raises(IndexError):
        r.read(5)


def test_dataset_uses_native_reader(tmp_path, monkeypatch):
    paths = write_dataset_shards(synthetic_cifar10(32), tmp_path, num_shards=2)
    calls = []
    orig = native.read_record_shard_native

    def spy(path):
        calls.append(path)
        return orig(path)

    monkeypatch.setattr(native, "read_record_shard_native", spy)
    ds = ShardedDataset(paths, batch_size_per_process=8)
    assert ds.reader is None  # nothing read yet
    batches = list(ds.epoch(0))
    assert len(batches) == 4
    assert len(calls) == 2  # both shards went through the native reader
    assert ds.reader == "native"


def test_native_and_python_agree_on_dataset(tmp_path):
    paths = write_dataset_shards(synthetic_cifar10(16), tmp_path, num_shards=1)
    a = list(native.read_record_shard_native(paths[0]))
    b = list(read_record_shard(paths[0]))
    assert a == b
    assert len(a) == 16
    from tpucfn_torch.data.records import decode_example

    ex = decode_example(a[0])
    assert ex["image"].shape == (32, 32, 3)
    np.testing.assert_array_equal(ex["image"], decode_example(b[0])["image"])


# -- against the JAX package ------------------------------------------------


def test_records_equal_the_jax_packages_reader(tmp_path):
    """Shards written by the port: the port's native reader returns the
    records the JAX package's reader does, byte for byte."""
    paths = write_dataset_shards(synthetic_cifar10(24), tmp_path,
                                 num_shards=3)
    for p in paths:
        ours = [bytes(v) for v in native.read_record_shard_native(p)]
        theirs = list(jax_read_record_shard(p))
        assert ours == theirs and len(ours) == 8


@pytest.mark.parametrize("cache_in_memory", [True, False])
def test_dataset_batches_equal_the_jax_packages(tmp_path, cache_in_memory):
    """The same shards and seed: the port's dataset on the native reader
    gives the JAX package's batches, in order (in memory, and streamed
    through the shuffle buffer)."""
    paths = write_dataset_shards(synthetic_cifar10(32), tmp_path,
                                 num_shards=2)
    kw = dict(batch_size_per_process=8, seed=3, process_index=0,
              process_count=1, cache_in_memory=cache_in_memory,
              shuffle_buffer=10)
    ours = list(ShardedDataset(paths, **kw).epoch(1))
    theirs = list(JaxShardedDataset(paths, **kw).epoch(1))
    assert len(ours) == len(theirs) == 4
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_fallback_is_recorded(tmp_path, monkeypatch):
    """Without the library (no toolchain) the dataset reads with the
    Python reader, gives the same batches, and says so."""
    paths = write_dataset_shards(synthetic_cifar10(16), tmp_path,
                                 num_shards=2)
    native_batches = list(ShardedDataset(paths, batch_size_per_process=8)
                          .epoch(0))
    monkeypatch.setattr(native, "native_available", lambda: False)
    ds = ShardedDataset(paths, batch_size_per_process=8)
    batches = list(ds.epoch(0))
    assert ds.reader == "python"
    for a, b in zip(batches, native_batches):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
