"""Host-sharded input with device prefetch (the port of
``ShardedDataset`` and ``prefetch_to_mesh`` in ``tpucfn/data/pipeline.py``).

:class:`ShardedDataset` is the JAX package's class with two changes:
the process index and count default to the process group's rank and
world size (:mod:`tpucfn_torch.launch`) instead of ``jax.process_index()``
and ``jax.process_count()``, and shards are read by the pure-Python
reader (the native reader and ``TPUCFN_INPUT_DEVICE_SHARDED`` are not
ported; ROADMAP A6).  The same seed gives the same batches as the JAX
package's, process by process.

:class:`MultiProcessLoader` (decode across spawn worker processes, what
``data serve --mp-workers W`` runs on an input host) and its worker entry
are copies of the JAX package's, held equal by
``tests/test_torch_isolation.py`` but for the process identity, which
comes from :func:`_process_identity`.

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


def _mp_worker_main(out_q, shard_paths, ds_kwargs, worker_index,
                    num_workers, num_epochs):
    """MultiProcessLoader worker entry point (module-level so spawn can
    pickle it by reference).  Owns shard_paths[worker_index::num_workers]
    via ShardedDataset's process-sharding logic; streams
    ("batch", dict) items, an ("end", epoch) marker per epoch, and a
    final ("done", None) — or ("error", traceback)."""
    try:
        ds = ShardedDataset(shard_paths, process_index=worker_index,
                            process_count=num_workers, **ds_kwargs)
        e = 0
        while num_epochs is None or e < num_epochs:
            for batch in ds.epoch(e):
                out_q.put(("batch", batch))
            out_q.put(("end", e))
            e += 1
        out_q.put(("done", None))
    except Exception:  # noqa: BLE001 — surface the traceback to the parent
        import traceback

        out_q.put(("error", traceback.format_exc()))


class MultiProcessLoader:
    """Decode across worker PROCESSES — the answer when one Python
    process cannot feed the chips (measured: a single PIL decode core
    delivers ~550 img/s against a v5e consuming 2524; threads don't
    help, the decode path is GIL/core-bound).  The process analogue of
    the reference's MXNet DataIter decode threads (SURVEY.md §3.2), in
    the shape of a PyTorch DataLoader:

    * this host's shards are sharded again across ``num_workers`` spawn
      processes (worker w owns ``local_shards[w::W]`` with its own
      deterministic shuffle/augmentation stream);
    * each worker streams finished host batches through a bounded queue
      (so memory is ``num_workers * prefetch`` batches);
    * the parent interleaves workers round-robin in a fixed order, so
      the global batch sequence is deterministic for a given
      (seed, num_workers) — like torch, the sequence differs between
      worker counts, never between runs.

    Workers never touch jax devices (pure numpy/PIL), so spawn is safe
    next to an initialized TPU client.  User scripts need the standard
    ``if __name__ == "__main__"`` guard (spawn re-imports __main__).
    Pair with :func:`prefetch_to_mesh` for the host→device overlap leg.
    """

    def __init__(
        self,
        shard_paths: Sequence[str | Path],
        *,
        num_workers: int,
        batch_size_per_process: int,
        seed: int = 0,
        prefetch: int = 4,
        process_index: int | None = None,
        process_count: int | None = None,
        **ds_kwargs,
    ):
        if num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, got {num_workers}")
        if process_index is None or process_count is None:
            jpi, jpc = _process_identity()
            process_index = jpi if process_index is None else process_index
            process_count = jpc if process_count is None else process_count
        pi, pc = process_index, process_count
        local = sorted(str(p) for p in shard_paths)[pi::pc]
        if len(local) < num_workers:
            raise ValueError(
                f"process {pi} owns {len(local)} shards < num_workers="
                f"{num_workers} — stage more shards or fewer workers")
        self.local_shards = local
        self.num_workers = num_workers
        self.prefetch = prefetch
        self._len: int | None = None
        # Offset the seed per host process so worker w here and worker w
        # on another host draw different augmentation streams.
        self.ds_kwargs = dict(ds_kwargs, seed=seed + 100003 * pi,
                              batch_size_per_process=batch_size_per_process)
        self._procs: list = []
        self._queues: list = []

    def _start(self, num_epochs):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.close()
        self._procs, self._queues = [], []
        for w in range(self.num_workers):
            q = ctx.Queue(maxsize=self.prefetch)
            p = ctx.Process(
                target=_mp_worker_main,
                args=(q, self.local_shards, self.ds_kwargs, w,
                      self.num_workers, num_epochs),
                daemon=True, name=f"tpucfn-loader-{w}")
            p.start()
            self._procs.append(p)
            self._queues.append(q)

    def close(self) -> None:
        for p in self._procs:
            if p.is_alive():
                p.terminate()
        for p in self._procs:
            p.join(timeout=5)
        self._procs, self._queues = [], []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __len__(self) -> int:
        """Host batches per epoch: the sum of each worker's per-epoch
        batch count (each worker rounds its own remainder, exactly as
        its in-worker ShardedDataset will). Lets epoch-driven training
        loops compute total steps without consuming the stream
        (ADVICE r3: ``len(ds) * num_epochs`` crashed here)."""
        if self._len is None:
            self._len = sum(
                len(ShardedDataset(self.local_shards, process_index=w,
                                   process_count=self.num_workers,
                                   **self.ds_kwargs))
                for w in range(self.num_workers))
        return self._len

    def _get(self, w: int, timeout_s: float = 10.0):
        """Queue read that notices a dead worker: a spawn process killed
        without posting (OOM SIGKILL) would otherwise block the parent
        forever on Queue.get (ADVICE r3).  A ``close()`` that raced the
        read (another thread shutting the loader down mid-iteration —
        the input service's stream teardown path) surfaces as a clean
        RuntimeError instead of an IndexError on the torn queue list."""
        while True:
            if w >= len(self._queues):
                raise RuntimeError(
                    f"loader closed while reading worker {w} — "
                    "close() raced an in-flight iteration")
            try:
                return self._queues[w].get(timeout=timeout_s)
            except queue.Empty:
                if w >= len(self._procs):
                    raise RuntimeError(
                        f"loader closed while reading worker {w} — "
                        "close() raced an in-flight iteration") from None
                p = self._procs[w]
                if not p.is_alive():
                    raise RuntimeError(
                        f"loader worker {w} died (exitcode {p.exitcode}) "
                        "without posting a batch or an error — likely "
                        "killed by the OS (OOM?)") from None

    def batches(self, num_epochs: int | None = None
                ) -> Iterator[dict[str, np.ndarray]]:
        """Round-robin-merged batch stream across workers; epochs stay in
        lockstep (a worker that finished epoch e is skipped until every
        worker has)."""
        self._start(num_epochs)
        w_count = self.num_workers
        done = [False] * w_count
        epoch_ended = [False] * w_count
        try:
            while not all(done):
                for w in range(w_count):
                    if done[w] or epoch_ended[w]:
                        continue
                    tag, payload = self._get(w)
                    if tag == "batch":
                        yield payload
                    elif tag == "end":
                        epoch_ended[w] = True
                    elif tag == "done":
                        done[w] = True
                    else:
                        raise RuntimeError(
                            f"loader worker {w} failed:\n{payload}")
                if all(e or d for e, d in zip(epoch_ended, done)):
                    epoch_ended = [False] * w_count
        finally:
            self.close()


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
