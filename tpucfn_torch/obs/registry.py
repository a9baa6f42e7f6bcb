"""Metric registry + Prometheus text exposition.

Every instrument (Counter/Gauge/Summary from ``obs.metrics`` plus the
bucketed :class:`Histogram` below) lives under one per-process
:class:`MetricRegistry` so a single scrape surface can expose them all —
the fleet story the JSONL files alone cannot tell (ISSUE 2: dashboards
and scrapers, not tailing 64 JSONL files).  The registry renders the
`Prometheus text exposition format
<https://prometheus.io/docs/instrumenting/exposition_formats/>`_
(``# HELP`` / ``# TYPE`` headers, ``_bucket{le=...}`` cumulative
histograms, ``{quantile=...}`` summaries) and a JSON ``/varz`` snapshot;
``obs.server`` serves both over per-host HTTP.
"""

from __future__ import annotations

import bisect
import math
import re
import threading

from tpucfn_torch.obs.metrics import (Counter, ComputedGauge, Gauge, Summary,
                                nearest_rank)

# Latency-flavored defaults (seconds): sub-ms to tens of seconds, the
# span of a TTFT or a training step on real hardware.
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0)

_NAME_OK = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_OK = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


class Histogram:
    """Bucketed distribution with exact count/sum — the Prometheus
    histogram: fixed upper bounds chosen up front, O(#buckets) memory
    forever, mergeable across hosts by plain addition (which is what the
    ``tpucfn obs`` aggregator does).  Complements :class:`Summary`:
    summaries give exact recent percentiles per host but cannot be
    aggregated across the fleet; histograms can."""

    def __init__(self, name: str = "",
                 buckets: tuple[float, ...] = DEFAULT_BUCKETS):
        bs = tuple(float(b) for b in buckets)
        if not bs:
            raise ValueError("histogram needs at least one bucket bound")
        if any(b2 <= b1 for b1, b2 in zip(bs, bs[1:])):
            raise ValueError(f"bucket bounds must strictly increase: {bs}")
        if math.isinf(bs[-1]):
            bs = bs[:-1]  # +Inf is implicit (the overflow bucket)
        self.name = name
        self.bounds = bs
        self.count = 0
        self.sum = 0.0
        self._counts = [0] * (len(bs) + 1)  # last = overflow (+Inf)
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        i = bisect.bisect_left(self.bounds, v)  # le semantics: v <= bound
        with self._lock:
            self.count += 1
            self.sum += v
            self._counts[i] += 1

    def read(self) -> tuple[list[tuple[float, int]], int, float]:
        """``((upper_bound, cumulative_count) pairs with +Inf last,
        count, sum)`` — all read under ONE lock acquisition so the
        Prometheus invariant ``_count == _bucket{le="+Inf"}`` holds even
        while another thread observes (a scrape that copied buckets,
        then read count separately, could expose count > +Inf)."""
        with self._lock:
            counts = list(self._counts)
            count, total = self.count, self.sum
        out, running = [], 0
        for b, c in zip(self.bounds, counts):
            running += c
            out.append((b, running))
        out.append((math.inf, running + counts[-1]))
        return out, count, total

    def cumulative(self) -> list[tuple[float, int]]:
        """The ``_bucket{le=...}`` series alone (see :meth:`read`)."""
        return self.read()[0]

    def snapshot(self) -> dict:
        cum, count, total = self.read()
        return {"count": count, "sum": total,
                "buckets": {("+Inf" if math.isinf(b) else repr(b)): c
                            for b, c in cum}}


def _fmt_value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    return repr(float(v))


def _fmt_labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    body = ",".join(
        '%s="%s"' % (k, str(v).replace("\\", r"\\").replace('"', r"\"")
                     .replace("\n", r"\n"))
        for k, v in labels.items())
    return "{%s}" % body


class MetricRegistry:
    """Name → instrument, with get-or-create constructors and one
    exposition surface.

    ``labels`` are constant labels stamped on every exposed series —
    per-host identity (``host``, ``role``) lives here, so fleet scrapes
    can tell 64 hosts' series apart without 64 metric names.  Each
    registry is independent; :func:`default_registry` is the per-process
    shared one that the trainer, the serving frontend, and the HTTP
    endpoint all meet at (pass an explicit registry for isolation, as
    tests and benches do).
    """

    def __init__(self, labels: dict[str, str] | None = None):
        for k in (labels or {}):
            if not _LABEL_OK.match(k):
                raise ValueError(f"invalid label name {k!r}")
        self.labels = dict(labels or {})
        self._metrics: dict[str, object] = {}
        self._help: dict[str, str] = {}
        self._lock = threading.Lock()

    # -- registration ------------------------------------------------------
    def register(self, name: str, metric, help: str = ""):
        """Adopt an existing instrument under ``name`` (the path by which
        ``ServingMetrics`` publishes its already-constructed dashboard).
        Re-registering the same name requires the same object — two
        owners silently splitting one series is the bug this raises on."""
        name = sanitize_metric_name(name)
        with self._lock:
            prev = self._metrics.get(name)
            if prev is not None and prev is not metric:
                raise ValueError(
                    f"metric {name!r} already registered to a different "
                    f"{type(prev).__name__}")
            self._metrics[name] = metric
            if help:
                self._help[name] = help
        return metric

    def _get_or_create(self, name: str, cls, help: str, factory):
        name = sanitize_metric_name(name)
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise ValueError(
                        f"metric {name!r} is a {type(m).__name__}, "
                        f"not a {cls.__name__}")
                return m
            m = factory(name)
            self._metrics[name] = m
            if help:
                self._help[name] = help
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(name, Counter, help, Counter)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(name, Gauge, help, Gauge)

    def computed_gauge(self, name: str, fn, help: str = "") -> ComputedGauge:
        """Gauge whose value is ``fn()`` at read time.  Get-or-create
        like every other instrument, but the callback is rebound on
        every call: when a component is rebuilt against a shared
        registry (a new ``Server`` on ``default_registry()``), the LIVE
        object's state must back the series, not the dead one's."""
        g = self._get_or_create(name, ComputedGauge, help,
                                lambda n: ComputedGauge(n, fn))
        g._fn = fn
        return g

    def summary(self, name: str, help: str = "", *, keep: int = 4096) -> Summary:
        s = self._get_or_create(name, Summary, help,
                                lambda n: Summary(n, keep=keep))
        if s._keep != keep:
            # Same no-silent-splitting stance as register(): returning an
            # instrument whose reservoir differs from what the caller
            # asked for would misconfigure their percentiles invisibly.
            raise ValueError(
                f"summary {name!r} exists with keep={s._keep}, "
                f"requested keep={keep}")
        return s

    def histogram(self, name: str, help: str = "",
                  buckets: tuple[float, ...] = DEFAULT_BUCKETS) -> Histogram:
        h = self._get_or_create(name, Histogram, help,
                                lambda n: Histogram(n, buckets=buckets))
        want = tuple(float(b) for b in buckets)
        if want and math.isinf(want[-1]):
            want = want[:-1]
        if h.bounds != want:
            raise ValueError(
                f"histogram {name!r} exists with bounds {h.bounds}, "
                f"requested {want} — bucket bounds cannot change after "
                "creation")
        return h

    def metrics(self) -> dict[str, object]:
        with self._lock:
            return dict(self._metrics)

    # -- exposition --------------------------------------------------------
    def to_prometheus(self) -> str:
        """The text exposition body ``GET /metrics`` returns."""
        lines: list[str] = []
        for name, m in sorted(self.metrics().items()):
            help_ = self._help.get(name)
            if help_:
                lines.append(f"# HELP {name} {help_}")
            base = _fmt_labels(self.labels)
            if isinstance(m, Counter):
                lines.append(f"# TYPE {name} counter")
                lines.append(f"{name}{base} {_fmt_value(m.value)}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {name} gauge")
                lines.append(f"{name}{base} {_fmt_value(m.value)}")
            elif isinstance(m, Summary):
                lines.append(f"# TYPE {name} summary")
                count, total, xs = m.read()  # one lock: count/sum coherent
                for p in (50.0, 95.0, 99.0):
                    v = nearest_rank(xs, p)
                    if v is not None:
                        q = {**self.labels, "quantile": repr(p / 100.0)}
                        lines.append(f"{name}{_fmt_labels(q)} {_fmt_value(v)}")
                lines.append(f"{name}_sum{base} {_fmt_value(total)}")
                lines.append(f"{name}_count{base} {_fmt_value(count)}")
            elif isinstance(m, Histogram):
                lines.append(f"# TYPE {name} histogram")
                cum, count, total = m.read()  # one lock: _count == +Inf
                for b, c in cum:
                    le = {**self.labels, "le": _fmt_value(b)}
                    lines.append(
                        f"{name}_bucket{_fmt_labels(le)} {_fmt_value(c)}")
                lines.append(f"{name}_sum{base} {_fmt_value(total)}")
                lines.append(f"{name}_count{base} {_fmt_value(count)}")
            else:  # pragma: no cover - register() accepts any instrument
                continue
        return "\n".join(lines) + "\n"

    def varz(self) -> dict:
        """JSON-able snapshot of every instrument — the ``/varz`` body
        and the per-host dict the aggregator merges."""
        out: dict[str, object] = {}
        for name, m in sorted(self.metrics().items()):
            if isinstance(m, (Counter, Gauge)):
                out[name] = m.value
            elif isinstance(m, (Summary, Histogram)):
                out[name] = m.snapshot()
        return {"labels": dict(self.labels), "metrics": out}


def sanitize_metric_name(name: str) -> str:
    """Coerce ``name`` into a legal Prometheus metric name (invalid
    chars → ``_``; leading digit gets a ``_`` prefix)."""
    if _NAME_OK.match(name):
        return name
    name = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    if not name or name[0].isdigit():
        name = "_" + name
    return name


_default_lock = threading.Lock()
_default: MetricRegistry | None = None


def default_registry() -> MetricRegistry:
    """The per-process shared registry (created on first use).  Hosts
    stamp their identity on it lazily via :func:`set_default_labels`
    once the cluster contract is known."""
    global _default
    with _default_lock:
        if _default is None:
            _default = MetricRegistry()
        return _default


def set_default_labels(**labels: str) -> MetricRegistry:
    reg = default_registry()
    reg.labels.update({k: str(v) for k, v in labels.items()})
    return reg
