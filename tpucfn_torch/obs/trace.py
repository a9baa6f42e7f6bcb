"""Request/step span tracing: *why* was it slow, not just *that* it was.

Counters say a request took 900 ms; spans say 700 ms of it was queue
wait.  Each completed span is one JSONL line (append-only, per host —
the same shippable-file contract as the metrics JSONL), carrying:

    {"kind": "span", "name": "prefill", "trace_id": 7, "span_id": 3,
     "parent_id": null, "start": <monotonic>, "dur_s": 0.012,
     "ts": <wall clock>, "mono": <monotonic at write>, "host": 0,
     "role": "server", "attrs": {...}}

* ``trace_id`` groups one logical unit — a serve request (its req_id)
  or a training step (the step number).
* ``start`` is ``time.monotonic()`` so spans from one process compare
  and sum exactly (the TTFT-decomposition acceptance check); ``ts`` is
  wall clock so hosts can be merged approximately on one timeline.
* Parent links propagate through a contextvar, so a span opened inside
  another nests without any plumbing (within one thread — a new
  ``threading.Thread`` starts with a fresh context, so hand it
  ``contextvars.copy_context()`` if cross-thread nesting matters);
  ``record()`` is the escape hatch for spans whose start was observed
  before the tracer call (queue wait: the submit happened on a caller
  thread, the admission happens on the serve loop).

``Tracer(None)`` is a full no-op writer (spans still time, nothing is
written) so instrumentation points can call unconditionally.

Cross-host causality (ISSUE 20): span_ids are only unique within one
process, so a span on host A names a span on host B by the pair
``(origin, span_id)`` where ``origin = origin_id(role, host_id)`` — a
deterministic 64-bit hash of the emitting process's fleet identity
that any reader can recompute from the ``host``/``role`` fields
already on every line.  A receiver-side span records the sender's
context as ``"rp": {"trace_id", "span_id", "origin"}`` (remote
parent); ``obs.timeline`` resolves those links when merging per-host
files onto one clock.  The three u64s ride the fleet planes' framed
op headers — see ``data.service`` for the wire layout.

Wired into the serve request lifecycle in ``serve/frontend.py``
(queue_wait → prefill → decode_round → request_done) and into the
trainer loop via ``train.trainer.TrainerObs`` (data_wait / step / ckpt).
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import threading
import time
from pathlib import Path
from typing import Any

# Canonical kind of a timed trace record (ISSUE 10): every span line
# carries kind "span"; Tracer.event() lines carry their event NAME as
# the kind (an open vocabulary — request_submitted, preemption, ...),
# so consumers select spans by this tuple and treat everything else as
# point events.
SPAN_KINDS = ("span",)

_current_span: contextvars.ContextVar[int | None] = contextvars.ContextVar(
    "tpucfn_current_span", default=None)


def origin_id(role: str, host_id: int | None) -> int:
    """Deterministic 64-bit fleet identity of one tracing process:
    FNV-1a over ``"role:host"``.  Stable across runs and recomputable
    from the ``role``/``host`` fields on any span line, which is what
    makes an ``(origin, span_id)`` pair resolvable by an offline
    merger with no registry.  Host ids are fleet-unique across roles
    (the launcher assigns input hosts the ids AFTER the trainers), so
    the pair never collides within one fleet."""
    h = 0xCBF29CE484222325
    for b in f"{role or 'proc'}:{0 if host_id is None else host_id}".encode():
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    # 0 is the wire sentinel for "no context" — never a real origin.
    return h or 1


def current_span_id() -> int | None:
    """The innermost open ``Tracer.span`` id on this thread (None
    outside any span) — what a plane client injects into a framed op
    header as the causal parent of the server-side work."""
    return _current_span.get()


class Tracer:
    """JSONL span writer for one process (one file per host+role)."""

    def __init__(self, path: str | Path | None, *, host_id: int | None = None,
                 role: str = "", truncate: bool = False):
        """``truncate`` decides run scoping and must match how the
        role's trace_ids behave across process restarts: a serving
        process numbers requests from 0 every run, so appending would
        fuse run 1's request 0 with run 2's into a row belonging to
        neither — serve passes ``truncate=True``.  A trainer's trace_id
        is the global step, monotonic across resume-from-checkpoint, so
        the restart supervisor's relaunch must NOT erase the pre-crash
        spans — append is the default."""
        self.path: Path | None = None
        self._f = None
        self.host_id = host_id
        self.role = role
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        if path is not None:
            p = Path(path)
            if p.suffix != ".jsonl":  # a directory: derive the file name
                p.mkdir(parents=True, exist_ok=True)
                hid = 0 if host_id is None else host_id
                p = p / f"trace-{role or 'proc'}-host{hid:03d}.jsonl"
            else:
                p.parent.mkdir(parents=True, exist_ok=True)
            self.path = p
            self._f = open(p, "w" if truncate else "a", buffering=1)

    @property
    def enabled(self) -> bool:
        return self._f is not None

    @property
    def origin(self) -> int:
        """This process's :func:`origin_id` — the third u64 of any wire
        context it injects."""
        return origin_id(self.role, self.host_id)

    def next_span_id(self) -> int:
        """Mint a span id BEFORE the span is written, so it can ride a
        wire header (or be handed to children) while the span is still
        open; pass it back via ``record(..., span_id=...)``.  Safe on a
        disabled tracer (ids still advance, nothing is written)."""
        return next(self._ids)

    # -- low level ---------------------------------------------------------
    def record(self, name: str, *, start: float, end: float | None = None,
               dur_s: float | None = None, trace_id: int | str | None = None,
               kind: str = "span", parent_id: int | None = None,
               span_id: int | None = None,
               remote_parent: dict | tuple | None = None,
               **attrs: Any) -> None:
        """Write one already-timed span (``start``/``end`` in
        ``time.monotonic()`` seconds; pass ``dur_s`` instead of ``end``
        when that's what was measured).  ``span_id`` accepts an id
        pre-drawn with :meth:`next_span_id`; ``remote_parent`` is a
        cross-host causal link — ``(trace_id, span_id, origin)`` as
        carried on a plane's wire header, or the equivalent dict —
        written as the span's ``rp`` field."""
        if self._f is None:
            return
        if dur_s is None:
            dur_s = 0.0 if end is None else end - start
        if parent_id is None:
            parent_id = _current_span.get()
        row = {
            "kind": kind,
            "name": name,
            "trace_id": trace_id,
            "span_id": next(self._ids) if span_id is None else span_id,
            "parent_id": parent_id,
            "start": start,
            "dur_s": dur_s,
            "ts": time.time() - (time.monotonic() - start),
            # the write instant on this host's monotonic clock: within
            # one process it orders events exactly even when the wall
            # clock steps; the merged timeline orders on skew-corrected
            # wall time and uses this to break same-instant ties
            # (obs.aggregate.apply_clock_skew).
            "mono": time.monotonic(),
            "host": self.host_id,
            "role": self.role,
            "attrs": attrs,
        }
        rp = _normalize_rp(remote_parent)
        if rp is not None:
            row["rp"] = rp
        line = json.dumps(row)
        with self._lock:
            if self._f is not None:
                self._f.write(line + "\n")

    def event(self, name: str, *, trace_id: int | str | None = None,
              **attrs: Any) -> None:
        """Zero-duration marker (request_submitted, request_done...)."""
        self.record(name, start=time.monotonic(), dur_s=0.0,
                    trace_id=trace_id, kind="event", **attrs)

    # -- context-managed spans --------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str, *, trace_id: int | str | None = None,
             **attrs: Any):
        """Time the enclosed block; children opened inside it get this
        span as their parent.  Yields a dict whose entries are merged
        into the span's attrs at close (fill in results as you learn
        them, e.g. ``s["tokens"] = n``)."""
        span_id = next(self._ids)
        parent = _current_span.get()
        token = _current_span.set(span_id)
        extra: dict[str, Any] = {}
        t0 = time.monotonic()
        try:
            yield extra
        except BaseException as e:
            extra.setdefault("error", type(e).__name__)
            raise
        finally:
            end = time.monotonic()
            _current_span.reset(token)
            if self._f is not None:
                # span_id was pre-drawn so children could have pointed at
                # us; write with it rather than drawing a fresh one.
                self._write_span(name, span_id, parent, t0, end, trace_id,
                                 {**attrs, **extra})

    def _write_span(self, name, span_id, parent_id, start, end, trace_id,
                    attrs) -> None:
        line = json.dumps({
            "kind": "span", "name": name, "trace_id": trace_id,
            "span_id": span_id, "parent_id": parent_id,
            "start": start, "dur_s": end - start,
            "ts": time.time() - (time.monotonic() - start),
            "mono": time.monotonic(),
            "host": self.host_id, "role": self.role, "attrs": attrs,
        })
        with self._lock:
            if self._f is not None:
                self._f.write(line + "\n")

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None


def _normalize_rp(remote_parent) -> dict | None:
    """A wire context tuple/dict → the canonical ``rp`` dict, or None
    when absent / all-zero (a peer with tracing off sends zeros)."""
    if remote_parent is None:
        return None
    if isinstance(remote_parent, dict):
        tid = remote_parent.get("trace_id")
        sid = remote_parent.get("span_id")
        org = remote_parent.get("origin")
    else:
        tid, sid, org = remote_parent
    if not sid or not org:
        return None
    return {"trace_id": tid if tid else None,
            "span_id": int(sid), "origin": int(org)}


def read_trace_file(path: str | Path) -> list[dict]:
    """All events of one trace JSONL (skips torn/partial last lines —
    the file may still be appended to while we read)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return out


def read_trace_dir(d: str | Path) -> list[dict]:
    """Merge every ``trace-*.jsonl`` under ``d`` (the Tracer's dir-mode
    naming — a co-located metrics JSONL is not a trace and is not
    ingested), each file's events sorted by monotonic start so
    retroactively-recorded spans (queue_wait) land in timeline order;
    cross-host order is approximate by design."""
    events: list[dict] = []
    for p in sorted(Path(d).glob("trace-*.jsonl")):
        events.extend(sorted(read_trace_file(p),
                             key=lambda e: e.get("start", 0.0)))
    return events
