"""Per-plane deadline autotune — ADVISORY ONLY (ISSUE 20 satellite,
the ROADMAP PR 15 follow-on).

The ``net/`` deadlines (one end-to-end budget per frame/op) shipped
with conservative defaults sized for the worst plausible fleet; the
merged span timeline now records what frames ACTUALLY take, so this
module turns observed frame-time percentiles into suggested values.
Report-only by design: a deadline is a safety bound against gray
peers, and auto-shrinking it from a healthy run's percentiles would
turn the first slow-but-honest step into a storm of false stalls —
the operator reads the table, the operator changes the flag.

Suggestion rule: ``clamp(p99 * headroom, floor, current_default)`` —
never suggest RAISING a deadline above its shipped default (the
defaults already bound the tolerable worst case; the advisory exists
to tighten gray-failure detection, not loosen it).
"""

from __future__ import annotations

from typing import Iterable

# plane -> (span names observed, knob, shipped default seconds).
# The spans are the client/server sides of one frame exchange: their
# durations bound how long a healthy frame needs, which is what a
# deadline must comfortably exceed.
_KNOBS = (
    ("input", ("input_serve",), "InputService(send_deadline_s=...)",
     120.0),
    ("input", ("data_wait",),
     "TPUCFN_INPUT_OP_DEADLINE_S / ServiceBatchStream(op_deadline_s=...)",
     120.0),
    ("compilecache", ("compile_fetch",),
     "CompileCacheClient(op_deadline_s=...)", 60.0),
    ("compilecache", ("artifact_serve",),
     "ArtifactServer(send_deadline_s=...)", 60.0),
)

DEFAULT_HEADROOM = 8.0
FLOOR_S = 1.0


def _percentile(sorted_vals: list[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted list —
    deterministic and numpy-free (this module must run on jax-free
    hosts)."""
    if not sorted_vals:
        return 0.0
    k = max(0, min(len(sorted_vals) - 1,
                   int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[k]


def suggest_deadlines(events: Iterable[dict], *,
                      headroom: float = DEFAULT_HEADROOM,
                      min_samples: int = 8) -> list[dict]:
    """Observed frame-time percentiles per plane knob → suggested
    deadline values.  Pure over the merged span events; rows carry the
    evidence (n, p50, p99) alongside the verdict so the operator can
    judge the sample, and ``suggested_s`` is None below
    ``min_samples`` — eight frames is not a distribution."""
    by_name: dict[str, list[float]] = {}
    for e in events:
        if e.get("kind") != "span":
            continue
        name = e.get("name")
        dur = e.get("dur_s")
        if isinstance(dur, (int, float)) and dur >= 0:
            by_name.setdefault(name, []).append(float(dur))
    rows = []
    for plane, names, knob, default_s in _KNOBS:
        vals = sorted(v for n in names for v in by_name.get(n, []))
        p50 = round(_percentile(vals, 0.50), 6)
        p99 = round(_percentile(vals, 0.99), 6)
        if len(vals) >= min_samples:
            suggested = round(
                min(default_s, max(FLOOR_S, p99 * headroom)), 3)
        else:
            suggested = None
        rows.append({"plane": plane, "spans": "/".join(names),
                     "knob": knob, "n": len(vals),
                     "p50_s": p50, "p99_s": p99,
                     "current_default_s": default_s,
                     "suggested_s": suggested})
    return rows


def render_advice(rows: list[dict]) -> str:
    from tpucfn_torch.obs.aggregate import render_table

    lines = ["deadline autotune (ADVISORY — report-only; suggestions "
             "never exceed the shipped default)", ""]
    lines.append(render_table(
        rows, ["plane", "spans", "n", "p50_s", "p99_s",
               "current_default_s", "suggested_s", "knob"]))
    return "\n".join(lines) + "\n"
