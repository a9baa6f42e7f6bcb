"""Profiling hooks (the port of ``tpucfn/obs/profiler.py``) on
``torch.profiler``.

:class:`ProfileCapture` is the on-demand capture behind the obs server's
``POST /profile`` (run by the training loop between steps, or, with
:func:`capture_here`, on the server's thread for the serve CLI);
:func:`profile_steps` traces a training loop for ``--profile``.  Each
traces the CPU ops of the thread that starts it and, on a card, CUPTI's
CUDA activity of every thread (every kernel, the flash kernels by name),
and writes a Chrome trace (``chrome://tracing``, Perfetto) named
``trace.json`` in a capture's numbered directory, or ``trace-<pid>.json``
for ``--profile``.  :class:`ProfilerBusy` and :meth:`ProfileCapture.__call__`
are copies held equal to the JAX package's by
``tests/test_torch_isolation.py``.

:class:`CompileCacheProbe` is the port's own, on the reference's protocol
(``mark``, ``outcome``, ``hit``, ``rearm``): what the first step paid for
its kernel libraries.

Not ported: ``start_profiler_server`` (XProf's live attach has no
PyTorch counterpart: a capture is asked for with ``POST /profile``
instead), and ``enable_compile_cache`` (there is no XLA compile cache;
the kernel directory is the port's persistent cache).
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


def capture_here(d: Path, seconds: float) -> None:
    """Trace ``seconds`` on the calling thread into ``d/trace.json``: the
    process's CUDA activity (CUPTI records the kernels every thread
    launches) and this thread's CPU ops.  The ``capture_fn`` of a
    :class:`ProfileCapture` in a process with no step loop to hand its
    captures to: the serve CLI, whose decode steps run in the serving
    threads of the copied ``Server``."""
    prof = _start_profiler()
    try:
        time.sleep(seconds)
    finally:
        prof.stop()
    prof.export_chrome_trace(str(d / "trace.json"))


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
    :class:`ProfilerBusy` (HTTP 409).  ``capture_fn(dir, seconds)``
    replaces the handoff: :func:`capture_here` in a process with no step
    loop (the serve CLI), a recorder in tests.
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


class CompileCacheProbe:
    """Did the first step's kernel libraries come from a cache?

    The counterpart of the reference's probe, which watches jax's
    persistent compile cache: here the persistent cache is the kernel
    directory (``kernels/_build/``), and a step loads each library it
    has not loaded yet at its first launch.  Over the first step
    (:meth:`rearm` at its entry, :meth:`outcome` after):

    * explicit marks from the kernel-library cache
      (:mod:`tpucfn_torch.compilecache.kernels`) win: ``"compile"``
      (``nvcc`` ran) over ``"fetch"`` (a fleet peer's library) over
      ``"store"`` (the kernel directory or the local artifact store),
      since a step that built one library paid a build whatever the
      others cost;
    * without marks: new libraries appeared in the directory, so
      ``nvcc`` ran: **miss**; libraries were loaded and none appeared:
      **hit**; neither (nothing loaded, e.g. on the CPU): unknown.

    :meth:`outcome` is the goodput split: ``"fetch"`` →
    ``compile_fetched``, ``"hit"`` → ``compile_cached``, ``"miss"`` or
    None → ``compile``."""

    def __init__(self, cache_dir: str | Path | None = None):
        if cache_dir is None:
            from tpucfn_torch.kernels._build import BUILD_DIR as cache_dir
        self.cache_dir = Path(cache_dir)
        self._marks: set[str] = set()
        self._before = self._snapshot()

    def _snapshot(self) -> tuple[int, int]:
        """(libraries in the directory, libraries loaded by this
        process): builds move the first, loads the second."""
        from tpucfn_torch.kernels import _build

        try:
            count = sum(1 for _ in self.cache_dir.glob("*.so"))
        except OSError:
            count = 0
        return count, len(_build._loaded)

    def rearm(self) -> None:
        """Re-snapshot and clear the marks (``TrainerObs`` calls this at
        the first step's entry)."""
        self._before = self._snapshot()
        self._marks = set()

    def mark(self, outcome: str) -> None:
        """One library's verdict from the kernel-library cache:
        ``"compile"``, ``"fetch"`` or ``"store"``."""
        self._marks.add(outcome)

    def hit(self) -> bool | None:
        out = self.outcome()
        return None if out is None else out in ("fetch", "hit")

    def outcome(self) -> str | None:
        if "compile" in self._marks:
            return "miss"
        if "fetch" in self._marks:
            return "fetch"
        if "store" in self._marks:
            return "hit"
        count, loaded = self._snapshot()
        if count > self._before[0]:
            return "miss"
        if loaded > self._before[1]:
            return "hit"
        return None


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
