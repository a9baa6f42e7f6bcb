"""Host-sharded input with device prefetch (the port of
``ShardedDataset`` and ``prefetch_to_mesh`` in ``tpucfn/data/pipeline.py``).

:class:`ShardedDataset` is the JAX package's class with two changes:
the process index and count default to the process group's rank and
world size (:mod:`tpucfn_torch.launch`) instead of ``jax.process_index()``
and ``jax.process_count()``, and shards are read by the pure-Python
reader (the native reader, ``MultiProcessLoader``, the input service and
``TPUCFN_INPUT_DEVICE_SHARDED`` are not ported; ROADMAP A6).  The same
seed gives the same batches as the JAX package's, process by process.

:func:`prefetch_to_device` keeps the training step fed: a daemon thread
stays ``depth`` batches ahead, copies each from pinned host memory to the
card on a side CUDA stream, and records an event that the consuming
stream waits on before it uses the batch, so the copy of batch n+1
overlaps the step on batch n.
"""

from __future__ import annotations

import queue
import threading
from pathlib import Path
from typing import Iterator, Sequence

import numpy as np
import torch

from tpucfn_torch.data import records


def _process_identity() -> tuple[int, int]:
    from tpucfn_torch.launch import process_count, process_index

    return process_index(), process_count()


class ShardedDataset:
    """Deterministic, per-process-sharded, shuffled batch iterator over
    tpurecord shards.

    Shard ``i`` is owned by process ``i % num_processes`` — the same
    ownership rule the reference applied to RecordIO parts listed in the
    hostfile order. Shuffling is seeded per epoch so every process draws
    from a common permutation schedule and global batches are reproducible
    run-to-run (the reference's implicit input order was not — SURVEY.md
    §7.4 item 1 calls out exactly this divergence risk).
    """

    def __init__(
        self,
        shard_paths: Sequence[str | Path],
        *,
        batch_size_per_process: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_remainder: bool = True,
        process_index: int | None = None,
        process_count: int | None = None,
        transform=None,  # per-example Transform (tpucfn.data.transforms)
        cache_in_memory: bool = True,
        shuffle_buffer: int = 2048,
        num_workers: int = 0,
    ):
        """``cache_in_memory=False`` streams shards instead of
        materializing every decoded example in host RAM — required for
        ImageNet-scale datasets (~140 GB encoded; SURVEY.md §3.2's
        DataIter streamed the same way).  Shuffling then uses shard-order
        shuffling + a ``shuffle_buffer``-sized reservoir, seeded per
        (seed, epoch, process) so batches stay reproducible.

        ``num_workers>0`` applies ``transform`` across that many threads
        per batch (PIL decode and numpy release the GIL) — the measured
        answer to one chip consuming ~2500 img/s while a single-threaded
        decode delivers ~650/s.  Still deterministic: per-example
        augmentation seeds are drawn sequentially from the epoch stream
        and order is preserved, so batches are reproducible for a given
        ``num_workers`` setting (0 keeps the exact legacy draw stream;
        >0 uses the per-example-seed stream regardless of worker
        count)."""
        if not shard_paths:
            raise ValueError("no shard paths given")
        self.all_shards = sorted(str(p) for p in shard_paths)
        if process_index is None or process_count is None:
            pi, pc = _process_identity()
            process_index = pi if process_index is None else process_index
            process_count = pc if process_count is None else process_count
        self.pi = process_index
        self.pc = process_count
        self.local_shards = self.all_shards[self.pi :: self.pc]
        if not self.local_shards:
            raise ValueError(
                f"process {self.pi}/{self.pc} owns no shards out of "
                f"{len(self.all_shards)} — stage more shards than processes"
            )
        self.batch = batch_size_per_process
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.transform = transform
        self.cache_in_memory = cache_in_memory
        self.shuffle_buffer = shuffle_buffer
        self.num_workers = num_workers
        self._pool = None
        self._cache: list[dict[str, np.ndarray]] | None = None
        self._len: int | None = None

    def _executor(self):
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(
                max_workers=self.num_workers,
                thread_name_prefix="tpucfn-decode")
        return self._pool

    def _load(self) -> list[dict[str, np.ndarray]]:
        if self._cache is None:
            read = records.read_record_shard
            out = []
            for p in self.local_shards:
                out.extend(records.decode_example(b) for b in read(p))
            if not out:
                raise ValueError(f"shards {self.local_shards} contain no examples")
            self._cache = out
        return self._cache

    def _num_examples(self) -> int:
        if self._len is None:
            if self.cache_in_memory:
                self._len = len(self._load())
            else:
                self._len = sum(records.shard_record_count(p)
                                for p in self.local_shards)
        return self._len

    def __len__(self) -> int:
        n = self._num_examples()
        return n // self.batch if self.drop_remainder else -(-n // self.batch)

    def epoch(self, epoch: int) -> Iterator[dict[str, np.ndarray]]:
        """One epoch of host-local batches (dicts of stacked arrays)."""
        # One augmentation stream per (seed, epoch, process): consumed in
        # iteration order, so any batch is reproducible from its epoch.
        aug_rs = np.random.RandomState((self.seed, epoch, self.pi, 7))

        def emit(chosen):
            if self.transform is not None:
                if self.num_workers > 0:
                    # Per-example seeds drawn sequentially from the epoch
                    # stream keep the result independent of thread timing;
                    # executor.map preserves order.
                    seeds = aug_rs.randint(0, 2**31 - 1, size=len(chosen))
                    chosen = list(self._executor().map(
                        lambda ex_s: self.transform(
                            ex_s[0], np.random.RandomState(ex_s[1])),
                        zip(chosen, seeds)))
                else:
                    chosen = [self.transform(ex, aug_rs) for ex in chosen]
            return {k: np.stack([ex[k] for ex in chosen]) for k in chosen[0]}

        if not self.cache_in_memory:
            yield from self._epoch_streaming(epoch, emit)
            return

        examples = self._load()
        order = np.arange(len(examples))
        if self.shuffle:
            # Epoch-keyed seed, offset by process so local orders differ
            # but are reproducible.
            np.random.RandomState((self.seed, epoch, self.pi)).shuffle(order)

        for start in range(0, len(order) - self.batch + 1, self.batch):
            yield emit([examples[i] for i in order[start:start + self.batch]])
        if not self.drop_remainder and len(order) % self.batch:
            yield emit([examples[i]
                        for i in order[len(order) - len(order) % self.batch:]])

    def _epoch_streaming(self, epoch: int, emit) -> Iterator[dict[str, np.ndarray]]:
        """Constant-memory epoch: shuffled shard order + reservoir
        shuffle over ``shuffle_buffer`` decoded examples (≈ one shard's
        worth) instead of the whole dataset in RAM."""
        read = records.read_record_shard
        rs = np.random.RandomState((self.seed, epoch, self.pi))
        shard_order = list(self.local_shards)
        if self.shuffle:
            rs.shuffle(shard_order)

        def examples():
            for p in shard_order:
                for payload in read(p):
                    yield records.decode_example(payload)

        buf: list = []
        pending: list = []

        def drain_into_batches(ex_iter):
            for ex in ex_iter:
                pending.append(ex)
                if len(pending) == self.batch:
                    out = list(pending)
                    pending.clear()
                    yield emit(out)

        def sampled():
            for ex in examples():
                if not self.shuffle:
                    yield ex
                elif len(buf) < self.shuffle_buffer:
                    buf.append(ex)
                else:
                    j = rs.randint(len(buf))
                    out, buf[j] = buf[j], ex
                    yield out
            if self.shuffle:
                rs.shuffle(buf)
            while buf:
                yield buf.pop()

        yield from drain_into_batches(sampled())
        if not self.drop_remainder and pending:
            yield emit(list(pending))

    def batches(self, num_epochs: int | None = None) -> Iterator[dict[str, np.ndarray]]:
        e = 0
        while num_epochs is None or e < num_epochs:
            yield from self.epoch(e)
            e += 1


def prefetch_to_device(
    it: Iterator[dict[str, np.ndarray]],
    device: str | torch.device,
    *,
    depth: int = 2,
) -> Iterator[dict[str, torch.Tensor]]:
    """Wrap a host-batch iterator so the copy to ``device`` overlaps
    compute; yields dicts of tensors on ``device``, in order.

    On the card each batch goes through pinned memory to the device on a
    side stream; the consumer's current stream waits on the copy's event
    (and the tensors are marked as used by that stream) before the batch
    is handed over.  On the CPU the thread only stacks the arrays into
    tensors.  An exception in the producer is raised to the consumer."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    if on_card and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    side = torch.cuda.Stream(device) if on_card else None
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    _END = object()

    def place(host_batch):
        if not on_card:
            return {k: torch.as_tensor(v) for k, v in host_batch.items()}, None
        with torch.cuda.device(device), torch.cuda.stream(side):
            out = {k: torch.as_tensor(v).pin_memory().to(device,
                                                         non_blocking=True)
                   for k, v in host_batch.items()}
            ready = torch.cuda.Event()
            ready.record(side)
        return out, ready

    def producer():
        try:
            for host_batch in it:
                if stop.is_set():
                    return
                q.put(place(host_batch))
        except Exception as e:  # surface pipeline errors to the consumer
            q.put(e)
            return
        q.put(_END)

    t = threading.Thread(target=producer, daemon=True,
                         name="tpucfn-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, Exception):
                raise item
            batch, ready = item
            if ready is not None:
                stream = torch.cuda.current_stream(device)
                stream.wait_event(ready)
                for v in batch.values():
                    v.record_stream(stream)
            yield batch
    finally:
        # Closed early (the loop reached its step target): let a producer
        # blocked on the full queue finish its put and stop.
        stop.set()
        while t.is_alive():
            try:
                q.get(timeout=0.1)
            except queue.Empty:
                pass
