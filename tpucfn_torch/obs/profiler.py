"""Profiling hooks (the port of ``tpucfn/obs/profiler.py``) on
``torch.profiler``.

:class:`ProfileCapture` is the on-demand capture behind the obs server's
``POST /profile``; :func:`profile_steps` traces a training loop for
``--profile``.  Both trace the CPU ops and, on a card, CUPTI's CUDA
activity (every kernel, the flash kernels by name) and write a Chrome
trace (``chrome://tracing``, Perfetto) named ``trace.json`` in a
capture's numbered directory, or ``trace-<pid>.json`` for
``--profile``.  :class:`ProfilerBusy` and :meth:`ProfileCapture.__call__`
are copies held equal to the JAX package's by
``tests/test_torch_isolation.py``.

Not ported: ``start_profiler_server`` (XProf's live attach has no
PyTorch counterpart: a capture is asked for with ``POST /profile``
instead), and ``enable_compile_cache`` with ``CompileCacheProbe``, which
go with the compile cache (ROADMAP Queue 1 B4).
"""

from __future__ import annotations

import contextlib
import itertools
import math
import os
import threading
import time
from pathlib import Path

# torch is imported at the trace call sites: the obs server imports this
# module for ProfilerBusy, and the launch process that serves it never
# profiles.


def _start_profiler():
    """A started ``torch.profiler.profile`` over the CPU ops of the
    calling thread and, with a card present, the process's CUDA
    activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


class ProfilerBusy(RuntimeError):
    """A capture is already running (jax allows one active trace per
    process); the obs server maps this to HTTP 409."""



class _Handoff:
    """One capture that the training loop runs between step boundaries."""

    def __init__(self, seconds: float):
        self.seconds = seconds
        self.prof = None
        self.t0 = 0.0
        self.error: BaseException | None = None
        self.done = threading.Event()


def _stop_quietly(req: _Handoff) -> None:
    """Stop the profiler of a capture whose caller has given up; its
    trace is dropped."""
    try:
        req.prof.stop()
    except Exception:  # noqa: BLE001 — nobody is waiting for this trace
        pass


class ProfileCapture:
    """On-demand profiler capture behind ``POST /profile``.

    Each call traces for ``seconds`` into a fresh numbered subdirectory
    of ``log_dir`` (``trace.json``, a Chrome trace) and — when a
    ``tracer`` is attached — records a ``profile_capture`` span whose
    attrs link the artifact path into the merged timeline.

    ``torch.profiler`` records the CPU ops of the thread that starts it
    (CUPTI's CUDA activity is process-wide), and the obs server calls
    this from its own thread.  So the capture is handed to the training
    loop (:meth:`attach_loop`): it starts the profiler at its next step
    boundary and stops it at the first boundary ``seconds`` later
    (:meth:`step_boundary`), and the call blocks until the trace is
    written.  With no loop attached (boot, restore, the final save) a
    call fails at once: a trace without the trainer's ops would mislead.
    A loop that reaches no boundary within ``seconds + GRACE_S`` (a hung
    collective, a long save) fails the call, and frees the next one;
    a profiler it had started is stopped at its next boundary.

    One capture at a time: a second concurrent request raises
    :class:`ProfilerBusy` (HTTP 409).  ``capture_fn`` is injectable
    (tests swap the real profiler for a recorder).
    """

    MAX_SECONDS = 600.0
    # How long past ``seconds`` a call waits for the loop to start and
    # stop its capture: a step boundary at each end, at most two steps.
    GRACE_S = 30.0

    def __init__(self, log_dir: str | Path, *, tracer=None,
                 capture_fn=None):
        self.log_dir = Path(log_dir)
        self.tracer = tracer
        self._capture_fn = capture_fn
        self._lock = threading.Lock()
        self._n = itertools.count(1)
        # guards the handoff between the server's and the loop's threads
        self._loop_lock = threading.Lock()
        self._loop_attached = False
        self._handoff: _Handoff | None = None
        # a capture whose caller timed out after the loop started it:
        # only the loop's thread can stop its profiler
        self._orphan: _Handoff | None = None

    def _capture(self, d: Path, seconds: float) -> None:
        if self._capture_fn is not None:
            self._capture_fn(d, seconds)
            return
        req = _Handoff(seconds)
        with self._loop_lock:
            if not self._loop_attached:
                raise RuntimeError("no training loop to capture; retry "
                                   "once it is running")
            self._handoff = req
        if not req.done.wait(seconds + self.GRACE_S):
            with self._loop_lock:
                if not req.done.is_set():
                    if self._handoff is req:
                        self._handoff = None
                    if req.prof is not None:
                        self._orphan = req
                    req.done.set()
                    raise TimeoutError(
                        f"the training loop reached no step boundary to "
                        f"{'stop' if req.prof is not None else 'start'} "
                        f"the capture within {seconds + self.GRACE_S:g} s "
                        f"(hung or blocked); no trace written")
        if req.error is not None:
            raise req.error
        req.prof.export_chrome_trace(str(d / "trace.json"))

    def __call__(self, seconds: float) -> dict:
        if not math.isfinite(seconds) or not 0 < seconds <= self.MAX_SECONDS:
            raise ValueError(
                f"seconds must be in (0, {self.MAX_SECONDS:g}], "
                f"got {seconds}")
        if not self._lock.acquire(blocking=False):
            raise ProfilerBusy("a profiler capture is already running")
        try:
            d = self.log_dir / f"capture-{os.getpid()}-{next(self._n):03d}"
            d.mkdir(parents=True, exist_ok=True)
            t0 = time.monotonic()
            self._capture(d, seconds)
            t1 = time.monotonic()
            if self.tracer is not None:
                self.tracer.record("profile_capture", start=t0, end=t1,
                                   artifact=str(d), seconds=seconds)
            return {"artifact": str(d), "seconds": seconds,
                    "dur_s": round(t1 - t0, 4)}
        finally:
            self._lock.release()

    @contextlib.contextmanager
    def attach_loop(self):
        """While the context lasts, captures run on the calling (training)
        thread, between the :meth:`step_boundary` calls it makes after
        each step.  On exit a capture in flight stops where it is, and
        one not yet started fails (HTTP 500) rather than wait for a loop
        that has ended."""
        with self._loop_lock:
            self._loop_attached = True
        try:
            yield self
        finally:
            with self._loop_lock:
                self._loop_attached = False
                orphan, self._orphan = self._orphan, None
                if orphan is not None:
                    _stop_quietly(orphan)
                req = self._handoff
                if req is not None:
                    self._finish(req, None if req.prof is not None else
                                 RuntimeError("the training loop ended "
                                              "before the capture started"))

    def step_boundary(self) -> None:
        """Called by the attached loop after every step: starts a handed-
        over capture, or stops it once ``seconds`` have passed."""
        if self._handoff is None and self._orphan is None:
            return
        with self._loop_lock:
            orphan, self._orphan = self._orphan, None
            if orphan is not None:
                _stop_quietly(orphan)
            req = self._handoff
            if req is None:
                return
            error = None
            try:
                if req.prof is None:
                    req.prof = _start_profiler()
                    req.t0 = time.monotonic()
                    return
                if time.monotonic() - req.t0 < req.seconds:
                    return
            except Exception as e:  # noqa: BLE001 — reported to the caller
                error = e
            self._finish(req, error)

    def _finish(self, req: _Handoff, error: BaseException | None) -> None:
        """Stop ``req``'s profiler and wake its caller; ``_loop_lock`` is
        held."""
        self._handoff = None
        try:
            if req.prof is not None:
                req.prof.stop()
        except Exception as e:  # noqa: BLE001 — reported to the caller
            error = error or e
        req.error = error
        req.done.set()


@contextlib.contextmanager
def profile_steps(log_dir: str | Path, *, enabled: bool = True):
    """Trace everything inside the context (the calling thread's CPU ops
    and the card's activity) into ``log_dir/trace-<pid>.json``.  Use
    around a small steady-state step range, not a long run: the trace is
    held in memory until the context ends."""
    if not enabled:
        yield
        return
    d = Path(log_dir)
    d.mkdir(parents=True, exist_ok=True)
    prof = _start_profiler()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(str(d / f"trace-{os.getpid()}.json"))
