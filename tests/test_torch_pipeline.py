"""The port's record shards, sharded dataset, device prefetch and token
packer against the JAX package's.

Shards written by either package are read by the other; the port's
``ShardedDataset`` yields the JAX package's batches, process by process,
for (index, count) in {(0, 1), (0, 2), (1, 2)} over two epochs with the
same seed (in memory and streaming); ``prefetch_to_device`` keeps order
and values on the CPU and hands on producer errors; ``convert_token_jsonl``
writes the same packed rows.
"""

import json

import numpy as np
import pytest
import torch

from tpucfn.data.convert import convert_token_jsonl as jax_convert
from tpucfn.data.pipeline import ShardedDataset as JaxDataset
from tpucfn.data.records import decode_example as jax_decode
from tpucfn.data.records import read_record_shard as jax_read
from tpucfn.data.records import write_dataset_shards as jax_write
from tpucfn_torch.data import (ShardedDataset, convert_token_jsonl,
                               prefetch_to_device, synthetic_tokens,
                               write_dataset_shards)
from tpucfn_torch.data.records import decode_example, read_record_shard


def _examples(n=40):
    rs = np.random.RandomState(0)
    for i, ex in enumerate(synthetic_tokens(n, seq_len=12, vocab=97, seed=1)):
        yield {**ex, "label": np.int32(i), "w": rs.rand(3).astype(np.float32)}


def _decoded(read, decode, paths):
    return [decode(p) for path in paths for p in read(path)]


def _same_examples(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k])


def test_port_shards_read_by_jax_and_back(tmp_path):
    port = write_dataset_shards(_examples(), tmp_path / "p", num_shards=3)
    jax_ = jax_write(_examples(), tmp_path / "j", num_shards=3)
    want = _decoded(jax_read, jax_decode, jax_)
    _same_examples(_decoded(jax_read, jax_decode, port), want)
    _same_examples(_decoded(read_record_shard, decode_example, jax_), want)
    for p, j in zip(port, jax_):
        assert p.read_bytes() == j.read_bytes()


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    return write_dataset_shards(_examples(44), tmp_path_factory.mktemp("s"),
                                num_shards=4)


@pytest.mark.parametrize("index,count", [(0, 1), (0, 2), (1, 2)])
@pytest.mark.parametrize("cache_in_memory", [True, False])
def test_sharded_dataset_matches_jax(shards, index, count, cache_in_memory):
    kw = dict(batch_size_per_process=4, seed=5, process_index=index,
              process_count=count, cache_in_memory=cache_in_memory,
              shuffle_buffer=8)
    port, jax_ = ShardedDataset(shards, **kw), JaxDataset(shards, **kw)
    assert len(port) == len(jax_)
    got, want = list(port.batches(2)), list(jax_.batches(2))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert np.array_equal(g[k], w[k])


def test_default_identity_without_a_group(shards):
    ds = ShardedDataset(shards, batch_size_per_process=4)
    assert (ds.pi, ds.pc) == (0, 1) and ds.local_shards == ds.all_shards


def test_prefetch_keeps_order_and_values(shards):
    ds = ShardedDataset(shards, batch_size_per_process=4, seed=2,
                        process_index=0, process_count=1)
    want = list(ds.batches(2))
    got = list(prefetch_to_device(ds.batches(2), "cpu", depth=3))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in w:
            assert isinstance(g[k], torch.Tensor)
            assert np.array_equal(g[k].numpy(), w[k])


def test_prefetch_hands_on_producer_errors():
    def broken():
        yield {"x": np.zeros(2)}
        raise ValueError("bad shard")

    it = prefetch_to_device(broken(), "cpu")
    assert next(it)["x"].tolist() == [0.0, 0.0]
    with pytest.raises(ValueError, match="bad shard"):
        next(it)


def test_convert_token_jsonl_matches_jax(tmp_path):
    rs = np.random.RandomState(4)
    src = tmp_path / "corpus.jsonl"
    with src.open("w") as f:
        for i in range(30):
            toks = rs.randint(1, 500, rs.randint(3, 20)).tolist()
            f.write(json.dumps(toks if i % 2 else {"tokens": toks}) + "\n")
        f.write("\n")
    port = convert_token_jsonl(src, tmp_path / "p", seq_len=32, num_shards=3)
    jax_ = jax_convert(src, tmp_path / "j", seq_len=32, num_shards=3)
    assert [p.name for p in port] == [p.name for p in jax_]
    _same_examples(_decoded(read_record_shard, decode_example, port),
                   _decoded(jax_read, jax_decode, jax_))


def test_closing_the_prefetch_stops_its_thread():
    import itertools
    import threading

    def endless():
        for i in itertools.count():
            yield {"x": np.full(2, i)}

    it = prefetch_to_device(endless(), "cpu", depth=2)
    assert next(it)["x"].tolist() == [0, 0]
    it.close()
    assert not [t for t in threading.enumerate()
                if t.name == "tpucfn-prefetch"]
