"""Metric instruments and the training loop's step timer and JSONL
logger (the port of ``tpucfn/obs/metrics.py``).

``nearest_rank``, :class:`Counter`, :class:`Gauge`,
:class:`ComputedGauge` and :class:`Summary` are copied definition for
definition (the port imports nothing of the JAX package); a drift test
holds each equal to its original.  :class:`StepTimer` and
:class:`MetricLogger` differ: the process index and the card count come
from the process group (:mod:`tpucfn_torch.launch`), not from JAX, and
the logger writes no TensorBoard events.  The device gauges are not
ported (ROADMAP A9).
"""

from __future__ import annotations

import json
import threading
import time
from pathlib import Path
from typing import Any, Mapping


def nearest_rank(xs_sorted: list, p: float):
    """Nearest-rank percentile over an already-sorted sample list (None
    when empty) — the one formula Summary, and the fleet aggregator in
    ``obs.aggregate``, must agree on."""
    if not xs_sorted:
        return None
    last = len(xs_sorted) - 1
    return xs_sorted[min(last, max(0, round(p / 100.0 * last)))]


class Counter:
    """Monotonic, thread-safe counter (requests served, tokens emitted,
    rejections...).  Serving-side instrumentation shares the training
    stack's metrics vocabulary so one JSONL/snapshot pipeline carries
    both (SURVEY.md §5 metrics row)."""

    def __init__(self, name: str = ""):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def add(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Last-write-wins instantaneous value (queue depth, cache
    occupancy).  Thread-safe by virtue of atomic float assignment; the
    lock-free write is deliberate — gauges are sampled, not summed."""

    def __init__(self, name: str = ""):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class ComputedGauge(Gauge):
    """Gauge whose value is computed at read time by a callback.

    For series that must reflect live state as of the scrape instant —
    a rolling-window burn rate frozen at the last write would keep an
    alert firing on dead traffic forever.  Registered via
    ``MetricRegistry.computed_gauge``; exposition treats it exactly
    like a :class:`Gauge`."""

    def __init__(self, name: str = "", fn=lambda: 0.0):
        self._fn = fn
        super().__init__(name)
        self._init_done = True

    @property
    def value(self) -> float:
        return float(self._fn())

    @value.setter
    def value(self, v):
        # Gauge.__init__ assigns 0.0 — tolerated; afterwards a write is
        # a name collision (someone fetched this via registry.gauge()
        # and called set()) and must NOT vanish silently.
        if getattr(self, "_init_done", False):
            raise AttributeError(
                f"gauge {self.name!r} is computed at read time; set() "
                "writes would be silently shadowed — it is registered "
                "via computed_gauge() elsewhere")


class Summary:
    """Streaming distribution (TTFT, per-request latency): count/sum
    always exact; percentiles over a bounded reservoir of the most
    recent ``keep`` samples — serving runs are long, memory must not
    grow with request count."""

    def __init__(self, name: str = "", keep: int = 4096):
        self.name = name
        self.count = 0
        self.sum = 0.0
        self._keep = keep
        self._recent: list[float] = []
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        with self._lock:
            self.count += 1
            self.sum += v
            self._recent.append(float(v))
            if len(self._recent) > self._keep:
                del self._recent[: len(self._recent) - self._keep]

    def read(self) -> tuple[int, float, list[float]]:
        """``(count, sum, sorted reservoir)`` under ONE lock acquisition
        — exposition must not pair a count with a sum from a different
        moment (rate(x_sum)/rate(x_count) assumes they move together)."""
        with self._lock:
            return self.count, self.sum, sorted(self._recent)

    def percentiles(self, ps: tuple[float, ...]) -> dict[float, float | None]:
        """All requested percentiles from ONE sorted copy taken under ONE
        lock acquisition — a snapshot is three percentiles, and sorting
        the reservoir per percentile (re-taking the lock each time) both
        triples the work and lets samples land between reads."""
        _, _, xs = self.read()
        return {p: nearest_rank(xs, p) for p in ps}

    def percentile(self, p: float) -> float | None:
        return self.percentiles((p,))[p]

    @property
    def mean(self) -> float | None:
        return self.sum / self.count if self.count else None

    def snapshot(self) -> dict:
        count, total, xs = self.read()
        return {"count": count, "mean": (total / count if count else None),
                "p50": nearest_rank(xs, 50), "p95": nearest_rank(xs, 95),
                "p99": nearest_rank(xs, 99)}


class StepTimer:
    """Tracks step wall time and derives throughput.

    Call :meth:`tick` once per completed (synchronized) step.  The first
    ``warmup`` ticks are excluded from the running average: they hold the
    kernels' build and the allocator's warm-up."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self._count = 0
        self._t0 = None
        self._total = 0.0
        self._last = None

    def tick(self) -> float | None:
        now = time.perf_counter()
        dt = None if self._t0 is None else now - self._t0
        self._t0 = now
        if dt is not None:
            self._count += 1
            self._last = dt
            if self._count > self.warmup:
                self._total += dt
        return dt

    @property
    def mean_step_time(self) -> float | None:
        steady = self._count - self.warmup
        return self._total / steady if steady > 0 else None

    def throughput(self, items_per_step: int) -> float | None:
        """items/sec over steady-state steps (e.g. global-batch tokens/sec)."""
        mst = self.mean_step_time
        return items_per_step / mst if mst else None

    def per_chip_throughput(self, items_per_step: int) -> float | None:
        from tpucfn_torch.launch import process_count

        tp = self.throughput(items_per_step)
        return tp / process_count() if tp else None


class MetricLogger:
    """One JSONL file per process (``{name}-host{index:03d}.jsonl`` in
    ``log_dir``) and, every ``stdout_every`` steps, a readable line on
    rank 0's stdout."""

    def __init__(self, log_dir: str | Path | None = None, *,
                 stdout_every: int = 10, name: str = "train"):
        from tpucfn_torch.launch import process_index

        self.path = None
        self._f = None
        self._rank = process_index()
        if log_dir is not None:
            d = Path(log_dir)
            d.mkdir(parents=True, exist_ok=True)
            self.path = d / f"{name}-host{self._rank:03d}.jsonl"
            self._f = open(self.path, "a", buffering=1)
        self.stdout_every = stdout_every
        self.name = name
        self._closed = False
        # log() and close() can race (serving thread vs shutdown path);
        # the flag alone is check-then-act, so writes and the close both
        # happen under this lock.
        self._lock = threading.Lock()

    def log(self, step: int, metrics: Mapping[str, Any]) -> None:
        record = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            try:
                record[k] = float(v)
            except (TypeError, ValueError):
                record[k] = str(v)
        with self._lock:
            if self._closed:  # late log() after close() is a no-op
                return
            if self._f is not None:
                self._f.write(json.dumps(record) + "\n")
        if (self.stdout_every and step % self.stdout_every == 0
                and self._rank == 0):
            body = " ".join(
                f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in record.items()
                if k not in ("time",)
            )
            print(f"[{self.name}] {body}", flush=True)

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            if self._f is not None:
                self._f.close()
