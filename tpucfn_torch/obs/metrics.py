"""Metric instruments and the training loop's step timer and JSONL
logger (the port of ``tpucfn/obs/metrics.py``).

``nearest_rank``, :class:`Counter`, :class:`Gauge`,
:class:`ComputedGauge` and :class:`Summary` are copied definition for
definition (the port imports nothing of the JAX package); a drift test
holds each equal to its original.  :class:`StepTimer` and
:class:`MetricLogger` differ: the process index and the card count come
from the process group (:mod:`tpucfn_torch.launch`), not from JAX, and
the logger writes no TensorBoard events.  :func:`device_memory_stats`
and :func:`register_device_gauges` read the card through ``torch.cuda``
and keep the JAX package's gauge names; :func:`register_kernel_gauges`
is the port's own: the flash kernels' launch counters on ``/metrics``.
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


def device_memory_stats(device=None) -> dict | None:
    """The card's memory in the JAX package's ``memory_stats()`` keys
    (``bytes_in_use``, ``peak_bytes_in_use``, ``bytes_limit``), from
    ``torch.cuda.memory_stats`` (the caching allocator's allocated bytes,
    current and peak) and ``torch.cuda.mem_get_info`` (the card's total).
    None for a CPU device, on a machine without a card, and for
    ``device=None`` (the current card) in a process that has not
    initialized CUDA, so a process training on the CPU never touches the
    card; telemetry callers sample or skip."""
    import torch

    try:
        if device is None:
            if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
                return None
            device = torch.device("cuda", torch.cuda.current_device())
        device = torch.device(device)
        if device.type != "cuda":
            return None
        stats = torch.cuda.memory_stats(device)
        _, total = torch.cuda.mem_get_info(device)
    except Exception:  # noqa: BLE001 — telemetry is best-effort
        return None
    return {"bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": total}


# Exposition name -> device_memory_stats() key (the JAX package's names,
# so readers of either package parse the same series).
_HBM_GAUGES = (
    ("device_hbm_used_bytes", "bytes_in_use",
     "device memory in use right now"),
    ("device_hbm_peak_bytes", "peak_bytes_in_use",
     "high-water device memory since process start"),
    ("device_hbm_limit_bytes", "bytes_limit",
     "device memory capacity visible to the allocator"),
)


def register_device_gauges(registry, device=None, *,
                           jit_sources=()) -> list[str]:
    """``device_hbm_*`` computed gauges on ``registry`` reading
    :func:`device_memory_stats` at scrape time.  Returns the registered
    names; empty for a CPU device or without a card (``device=None``
    means the current card, when CUDA is initialized).

    ``jit_sources`` is accepted and ignored: the JAX package sums the
    compiled-program counts of its jitted entry points into a
    ``jit_cache_programs`` gauge, and the port compiles no programs (its
    kernels are built once per process by ``nvcc``)."""
    del jit_sources
    stats = device_memory_stats(device)
    if stats is None:
        return []
    names = []
    for name, key, help_ in _HBM_GAUGES:
        def _read(key=key, device=device) -> float:
            return float((device_memory_stats(device) or {}).get(key, 0))

        registry.computed_gauge(name, _read, help_)
        names.append(name)
    return names


def register_kernel_gauges(registry) -> list[str]:
    """``kernel_launches_<wrapper>[_<variant>]`` computed gauges: the
    flash kernels' launch counters (``flash_attention.flash_fwd.
    launches_by_variant`` and the backward wrappers'), read at scrape
    time, so ``/metrics`` shows which kernels a live process runs."""
    from tpucfn_torch.kernels import flash_attention as fa

    names = []
    for f in (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv):
        for variant in f.launches_by_variant:
            name = f"kernel_launches_{f.__name__}_{variant}"
            registry.computed_gauge(
                name, lambda f=f, v=variant: float(f.launches_by_variant[v]),
                f"{f.__name__} launches on its {variant} kernel")
            names.append(name)
    name = "kernel_launches_flash_bwd_delta"
    registry.computed_gauge(
        name, lambda: float(fa.flash_bwd_delta.launches),
        "flash_bwd_delta launches")
    return names + [name]


def kernel_launch_counts() -> dict[str, int]:
    """The flash kernels' launch counters now, under the names of
    :func:`register_kernel_gauges`' gauges."""
    from tpucfn_torch.kernels import flash_attention as fa

    out = {f"kernel_launches_{f.__name__}_{variant}": n
           for f in (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
           for variant, n in f.launches_by_variant.items()}
    out["kernel_launches_flash_bwd_delta"] = fa.flash_bwd_delta.launches
    return out


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
