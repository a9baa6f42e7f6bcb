"""Checkpoint and resume on ``torch.distributed.checkpoint`` (the port of
``CheckpointManager`` in ``tpucfn/ckpt/manager.py``).

The same semantics as the JAX package's Orbax-backed manager:

* one directory per step, ``<directory>/<step>``;
* a save counts only once it is finalized: it is written into
  ``<step>.ckpt-tmp-<pid>-<ns>`` and renamed into place when complete, so
  a killed save never becomes the latest step;
* ``save_interval_steps`` as Orbax applies it: a save runs when forced,
  or when the step is past the latest one and either a multiple of the
  interval or the first save of the directory; ``save`` of a step that
  exists is a no-op (``False``);
* ``max_to_keep`` finalized steps, the oldest removed first;
* ``async_save``: the call copies the state to host memory (buffers
  kept from one save to the next, pinned for device tensors) and returns;
  a thread writes and finalizes it.  The next save, ``wait`` and leaving
  the ``with`` block wait for it;
* temp dirs that nothing has touched for 30 s (a killed process's) are
  swept at start; a peer's live save is spared;
* ``latest_step`` skips the steps of ``TPUCFN_CKPT_BLACKLIST``;
* ``restore`` copies the step's tensors into a live
  :class:`tpucfn_torch.train.TrainState` in place: the params, the AdamW
  moments, step counts and update count, the step, the EMA and the step
  generator's state.

Every rank of a data-parallel group holds the same state, so rank 0
writes the step (through ``FileSystemWriter``) and every rank reads it
back.  A state placed by sharding rules with some tensor split over an
axis of size > 1 (``TrainState.shardings``) is saved by every rank
together, synchronously: each tensor as a ``DTensor`` of its placement,
each block written once, the step's directory named by rank 0 and renamed
into place after the last rank's write.  A restore reads the step into
whatever layout the live state has (a ``DTensor`` of each split tensor's
placement, or whole tensors): the restore onto another mesh that
``Trainer.abstract_state`` is for in the JAX package.  With a ``tracer``
each finalized save writes a ``ckpt_write`` span (from the call to
durable, with its bytes) and each restore a ``ckpt_restore`` span.
"""

from __future__ import annotations

import os
import shutil
import threading
import time
from pathlib import Path
from typing import Iterable

import torch

from tpucfn_torch.ft.policy import CKPT_BLACKLIST_ENV, parse_ckpt_blacklist

_TMP = ".ckpt-tmp-"
# One writer thread: the writer serializes each tensor through torch.save
# holding the interpreter lock, and eight of them starved the training
# loop's host thread (its step ran 4x slower during the write), while one
# writes about as fast to one disk.
_WRITER_THREADS = 1


def _dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def _split(state) -> bool:
    """Whether any tensor of ``state`` is a block of a split placement."""
    shardings = getattr(state, "shardings", None) or {}
    return any(sh.is_split() for sh in shardings.values())


def _placed(state) -> dict:
    """``state.state_dict()`` with every split tensor as a ``DTensor`` of
    its placement over the live block (no copy)."""
    from torch.distributed.tensor import DTensor

    out = {}
    for key, t in state.state_dict().items():
        sh = state.shardings[key]
        out[key] = DTensor.from_local(t.detach(), sh.mesh, sh.placements(),
                                      run_check=False) \
            if sh.is_split() else t
    return out


class CheckpointManager:
    """Step-directory checkpoints of a ``TrainState``."""

    def __init__(self, directory: str | Path, *, max_to_keep: int = 3,
                 save_interval_steps: int = 1, async_save: bool = True,
                 blacklist_steps: Iterable[int] | None = None,
                 tracer=None):
        """``blacklist_steps``: steps the manager treats as nonexistent
        when it picks the latest one (default: ``TPUCFN_CKPT_BLACKLIST``,
        which the gang coordinator sets after a failed restore).  A save
        or restore that names such a step is still honored."""
        from tpucfn_torch.launch import process_index

        if blacklist_steps is None:
            blacklist_steps = parse_ckpt_blacklist(
                os.environ.get(CKPT_BLACKLIST_ENV))
        self.blacklist_steps = frozenset(int(s) for s in blacklist_steps)
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        self.async_save = async_save
        self.tracer = tracer
        self.writer = process_index() == 0
        self._pending: threading.Thread | None = None
        self._pending_step: int | None = None
        self._error: BaseException | None = None
        self._staging: dict[str, torch.Tensor] = {}
        self._sweep_stale_tmp(self.directory)

    @staticmethod
    def _sweep_stale_tmp(directory: Path, *, stale_age_s: float = 30.0) -> None:
        """Remove abandoned temp dirs (a killed rank's half-written save):
        only those where nothing was modified for ``stale_age_s``, so a
        peer's live write is never swept; every OSError is swallowed, as
        concurrent sweepers race each other by construction."""
        now = time.time()
        try:
            tmp_dirs = [p for p in directory.iterdir()
                        if p.is_dir() and _TMP in p.name]
        except OSError:
            return
        for p in tmp_dirs:
            try:
                newest = max((f.stat().st_mtime
                              for f in [p, *p.rglob("*")]), default=0.0)
            except OSError:
                continue  # a peer is mutating it right now — not stale
            if now - newest >= stale_age_s:
                shutil.rmtree(p, ignore_errors=True)

    # ---- listing -----------------------------------------------------------

    def all_steps(self) -> list[int]:
        """Finalized steps, ascending (an in-flight save is not one)."""
        try:
            names = [p.name for p in self.directory.iterdir() if p.is_dir()]
        except OSError:
            return []
        return sorted(int(n) for n in names if n.isdigit())

    def latest_step(self) -> int | None:
        steps = [s for s in self.all_steps() if s not in self.blacklist_steps]
        return max(steps, default=None)

    def _known_steps(self) -> list[int]:
        """Finalized steps plus the one being written."""
        steps = self.all_steps()
        if self._pending_step is not None:
            steps.append(self._pending_step)
        return steps

    def should_save(self, step: int) -> bool:
        known = self._known_steps()
        if known and max(known) >= step:
            return False
        return step % self.save_interval_steps == 0 or not known

    # ---- save --------------------------------------------------------------

    def save(self, step: int, state, *, force: bool = False) -> bool:
        """Save ``state`` as step ``step``; ``True`` when a save ran."""
        step = int(step)
        if step in self._known_steps():
            return False  # idempotent: final force-save may race an interval save
        if not force and not self.should_save(step):
            return False
        self.wait()
        t0 = time.monotonic()
        if _split(state):
            self._save_split(step, state, t0)
            return True
        if not self.writer:
            return True
        snapshot = self._stage(state)
        stage_s = time.monotonic() - t0
        self._pending_step = step
        if self.async_save:
            self._pending = threading.Thread(
                target=self._write, args=(step, snapshot, t0, stage_s),
                daemon=True, name="tpucfn-ckpt-save")
            self._pending.start()
        else:
            self._write(step, snapshot, t0, stage_s)
            self._raise_pending_error()
        return True

    def _stage(self, state) -> dict[str, torch.Tensor]:
        """Host copies of the state's tensors (the step mutates the state
        in place), in buffers kept from one save to the next, pinned for
        device tensors: only the first save allocates them."""
        snapshot, on_card = {}, False
        for k, v in state.state_dict().items():
            buf = self._staging.get(k)
            if buf is None or buf.shape != v.shape or buf.dtype != v.dtype:
                buf = torch.empty(v.shape, dtype=v.dtype, pin_memory=v.is_cuda)
                self._staging[k] = buf
            buf.copy_(v.detach(), non_blocking=v.is_cuda)
            on_card |= v.is_cuda
            snapshot[k] = buf
        if on_card:
            torch.cuda.synchronize()
        return snapshot

    def _write(self, step: int, snapshot: dict, t0: float,
               stage_s: float) -> None:
        import torch.distributed.checkpoint as dcp

        tmp = self.directory / f"{step}{_TMP}{os.getpid()}-{time.time_ns()}"
        try:
            dcp.save(snapshot, storage_writer=dcp.FileSystemWriter(
                tmp, thread_count=_WRITER_THREADS), no_dist=True)
            os.rename(tmp, self.directory / str(step))
            nbytes = _dir_bytes(self.directory / str(step))
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self.directory / str(old), ignore_errors=True)
            if self.tracer is not None:
                self.tracer.record("ckpt_write", start=t0,
                                   dur_s=time.monotonic() - t0,
                                   trace_id=step, bytes=nbytes,
                                   stage_s=stage_s)
        except BaseException as e:  # noqa: BLE001 — raised by wait()
            shutil.rmtree(tmp, ignore_errors=True)
            self._error = e
        finally:
            self._pending_step = None

    def _save_split(self, step: int, state, t0: float) -> None:
        """Every rank's blocks into one step directory, synchronously."""
        import torch.distributed as dist
        import torch.distributed.checkpoint as dcp

        name = [f"{step}{_TMP}{os.getpid()}-{time.time_ns()}"]
        dist.broadcast_object_list(name, src=0)
        tmp = self.directory / name[0]
        try:
            dcp.save(_placed(state), storage_writer=dcp.FileSystemWriter(
                tmp, thread_count=_WRITER_THREADS))
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        dist.barrier()
        if self.writer:
            os.rename(tmp, self.directory / str(step))
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self.directory / str(old), ignore_errors=True)
            if self.tracer is not None:
                self.tracer.record(
                    "ckpt_write", start=t0, dur_s=time.monotonic() - t0,
                    trace_id=step,
                    bytes=_dir_bytes(self.directory / str(step)),
                    stage_s=0.0)
        dist.barrier()  # every rank sees the step once it is final

    def _raise_pending_error(self) -> None:
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError("checkpoint save failed") from e

    def wait(self) -> None:
        """Block until the in-flight save is finalized (raises if it
        failed)."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        self._raise_pending_error()

    # ---- restore -----------------------------------------------------------

    def restore(self, state, step: int | None = None):
        """Copy step ``step`` (default: the latest) into ``state`` in place
        and return it.  Any failure to read the step raises."""
        import torch.distributed.checkpoint as dcp
        from torch.distributed.checkpoint.api import CheckpointException

        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint found under {self.directory}")
        path = self.directory / str(step)
        t0 = time.monotonic()
        if _split(state):
            # Each rank reads its blocks straight into the live state.
            placed = _placed(state)
            try:
                dcp.load(placed, storage_reader=dcp.FileSystemReader(path))
            except CheckpointException as e:
                raise OSError(f"reading checkpoint {path} failed") from e
            host = {k: v.to_local() if hasattr(v, "to_local") else v
                    for k, v in placed.items()}
        else:
            # Read into host tensors, then copy into the live (device)
            # state.
            host = {k: torch.empty(v.shape, dtype=v.dtype)
                    for k, v in state.state_dict().items()}
            try:
                dcp.load(host, storage_reader=dcp.FileSystemReader(path),
                         no_dist=True)
            except CheckpointException as e:  # a BaseException
                raise OSError(f"reading checkpoint {path} failed") from e
        state.load_state_dict(host)
        if self.tracer is not None:
            self.tracer.record("ckpt_restore", start=t0,
                               dur_s=time.monotonic() - t0, trace_id=step,
                               bytes=_dir_bytes(path))
        return state

    def close(self) -> None:
        self.wait()
        self._staging = {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        import torch.distributed as dist

        if dist.is_initialized() and dist.get_world_size() > 1:
            dist.barrier()  # no rank leaves before rank 0's save is durable
