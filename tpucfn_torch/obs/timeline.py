"""Fleet timeline plane (ISSUE 20): one clock, one span tree, one verdict.

Per-host span JSONL (``obs.trace``) answers "what did host H do"; this
module answers "what did the FLEET do, and which plane bounded step N":

* **Clock alignment** — :func:`probe_clock` estimates a host's wall
  offset NTP-style over its obs ``/clock`` route: the probe brackets
  the server's wall read between two local monotonic reads, so
  ``offset = server_wall - local_midpoint`` with an RTT/2 uncertainty
  bound.  The coordinator refreshes probes on its heartbeat cadence
  into ``clock-offsets.jsonl``; :func:`fleet_skew` prefers those
  measurements and falls back to the step-anchored estimator
  (``obs.aggregate.estimate_clock_skew``) for unprobed hosts —
  re-based onto the probes' reference so the two sources share one
  fleet clock.
* **Causality** — :func:`resolve_links` matches each span's ``rp``
  (remote parent: the ``(trace_id, span_id, origin)`` triple carried
  on a plane's framed op header) against the emitting process's
  ``origin_id(role, host)``, recomputed per file — no registry, the
  span lines are self-describing.
* **Export** — :func:`export_chrome_trace` renders the merged events
  as Chrome/Perfetto trace-event JSON, one process lane per
  (host, role), flow arrows on every resolved cross-host link.
* **Attribution** — :func:`critical_path` walks each trainer step's
  merged tree and attributes wall time to planes (compute /
  remote-serve / input-local / artifact-fetch / ckpt / coordinator),
  prints per-step "bounded by" verdicts, and cross-checks aggregate
  plane shares against the goodput ledger's bucket shares
  (:func:`crosscheck_goodput`).

Everything here is pure and deterministic: the same span files produce
byte-identical reports (pinned by test) — no wall-clock reads, no dict
iteration order dependence, explicit sorts throughout.
"""

from __future__ import annotations

import dataclasses
import json
import time
import urllib.request
from pathlib import Path
from typing import Callable

from tpucfn_torch.obs.aggregate import (apply_clock_skew, estimate_clock_skew,
                                        render_table)
from tpucfn_torch.obs.trace import origin_id, read_trace_dir

# The cross-host span vocabulary (ISSUE 20): every span name that may
# appear as an ``rp`` carrier or target on the fleet timeline.  The
# ``spans`` analysis rule pins emission sites passing ``remote_parent=``
# to this tuple (same contract as event kinds), so a typo'd name is a
# finding, not a silently unresolvable flow arrow.
CROSS_HOST_SPAN_NAMES = ("data_wait", "input_serve", "compile_fetch",
                         "artifact_serve")

# Record-kind vocabulary of the coordinator's ``clock-offsets.jsonl``
# (the canonical-*_KINDS contract the vocab rule enforces).
CLOCK_FILE_KINDS = ("clock_probe",)

# Coordinator-plane span vocabulary the critical path charges to the
# "coordinator" plane: recovery actions plus the write-ahead journal's
# fsync'd commits (ISSUE 20 — the coordinator-ops leg of the tentpole).
COORDINATOR_SPAN_NAMES = ("ft_recover", "ft_give_up", "journal_commit")

# Plane attribution vocabulary: where a step's wall time can go.
PLANES = ("compute", "remote-serve", "input-local", "artifact-fetch",
          "ckpt", "coordinator")

# Span name -> plane, for unambiguous names.  ``data_wait`` is decided
# per span: a remote parent link means the batch came over the input
# plane (remote-serve); no link means the local loader fed it
# (input-local).
_SPAN_PLANE = {
    "step": "compute",
    "ckpt": "ckpt",
    "compile_fetch": "artifact-fetch",
    "artifact_serve": "artifact-fetch",
    "input_serve": "remote-serve",
    "ft_recover": "coordinator",
    "ft_give_up": "coordinator",
    "journal_commit": "coordinator",
}


# -- clock offsets (NTP-style over GET /clock) ------------------------------

@dataclasses.dataclass(frozen=True)
class ClockProbe:
    """One offset measurement of a host's wall clock.

    ``offset_s`` is positive when the probed host's clock runs AHEAD of
    the prober's — the same sign convention as the step-anchored
    estimator's skew, so ``ts - offset`` maps the host's timestamps
    onto the prober's clock.  ``unc_s`` is the RTT/2 bound: the true
    offset lies within ``offset_s ± unc_s`` (the server's wall read
    happened somewhere inside the round trip)."""

    host: int
    role: str
    offset_s: float
    unc_s: float
    rtt_s: float


def probe_clock(url: str, *,
                fetch: Callable[[str], dict] | None = None,
                mono: Callable[[], float] = time.monotonic,
                wall: Callable[[], float] = time.time,
                timeout_s: float = 2.0) -> ClockProbe:
    """One NTP-style probe of ``GET /clock`` at ``url``.

    The server's single wall read is bracketed between two local
    clock reads; assuming symmetric network halves, the server read
    happened at the local midpoint, so the offset is
    ``server_wall - local_wall_midpoint`` and the worst-case
    asymmetry error is RTT/2.  ``fetch``/``mono``/``wall`` are
    injectable so the estimator tests with synthetic clocks and zero
    sockets."""
    if fetch is None:
        def fetch(u: str) -> dict:
            with urllib.request.urlopen(u, timeout=timeout_s) as r:
                return json.loads(r.read().decode())
    m0, w0 = mono(), wall()
    body = fetch(url)
    m1 = mono()
    rtt = max(0.0, m1 - m0)
    # local wall at the bracket midpoint, reconstructed from the one
    # wall read plus monotonic deltas (immune to a wall step mid-probe)
    local_mid = w0 + rtt / 2.0
    server_wall = float(body["wall"])
    return ClockProbe(host=body.get("host_id"),
                      role=str(body.get("role") or ""),
                      offset_s=server_wall - local_mid,
                      unc_s=rtt / 2.0,
                      rtt_s=rtt)


def read_clock_offsets(path: str | Path) -> dict[str, dict]:
    """The coordinator's ``clock-offsets.jsonl`` reduced to one offset
    per host label (``host{N}``): the minimum-uncertainty probe wins —
    a tight RTT bounds the truth better than any average over loose
    ones — with the probe count kept for the report."""
    best: dict[str, dict] = {}
    counts: dict[str, int] = {}
    p = Path(path)
    if not p.exists():
        return {}
    with open(p) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if rec.get("kind") != "clock_probe" or rec.get("host") is None:
                continue
            label = f"host{rec['host']}"
            counts[label] = counts.get(label, 0) + 1
            cur = best.get(label)
            if cur is None or rec.get("unc_s", 1e9) < cur["unc_s"]:
                best[label] = {"offset_s": float(rec.get("offset_s", 0.0)),
                               "unc_s": float(rec.get("unc_s", 0.0)),
                               "role": rec.get("role", "")}
    for label, rec in best.items():
        rec["probes"] = counts[label]
    return best


def fleet_skew(events: list[dict],
               offsets: dict[str, dict] | None = None,
               heartbeats_by_host: dict | None = None) -> dict[str, float]:
    """Per-host skew for :func:`~tpucfn.obs.aggregate.apply_clock_skew`.

    Probe offsets (measured, with an uncertainty bound) win for every
    host that has one; hosts without probes fall back to the
    step-anchored estimate (``heartbeats_by_host`` passes through as
    its secondary anchor source).  The two sources use different
    references — probes are relative to the PROBER's clock, the
    estimator to the fleet median — so the estimates are re-based by
    the mean (probe - estimate) difference over the probed hosts
    before mixing; with no overlap the estimator's base is kept (a
    constant shift of the whole timeline is invisible to ordering and
    durations)."""
    est = estimate_clock_skew(events, heartbeats_by_host)
    if not offsets:
        return est
    probed = {h: o["offset_s"] for h, o in sorted(offsets.items())}
    common = [h for h in sorted(probed) if h in est]
    base = (sum(probed[h] - est[h] for h in common) / len(common)
            if common else 0.0)
    out = {h: s + base for h, s in est.items()}
    out.update(probed)
    return out


# -- merged timeline --------------------------------------------------------

def resolve_links(events: list[dict]) -> tuple[list[tuple[int, int]], dict]:
    """Match every span's ``rp`` against the fleet's span index.

    Returns ``(links, stats)``: ``links`` is a list of
    ``(parent_index, child_index)`` pairs into ``events`` (the parent
    is the remote span the child's ``rp`` names), deterministic order;
    ``stats`` counts carriers and resolutions per span name — the
    trace-smoke gate reads ``stats["by_name"]["data_wait"]``."""
    index: dict[tuple[int, int], int] = {}
    for i, e in enumerate(events):
        if e.get("kind") != "span" or e.get("span_id") is None:
            continue
        key = (origin_id(e.get("role") or "", e.get("host")),
               int(e["span_id"]))
        # first writer wins: span ids are unique per process, so a
        # duplicate key means a re-read of the same line — keep stable
        index.setdefault(key, i)
    links: list[tuple[int, int]] = []
    by_name: dict[str, dict[str, int]] = {}
    unpinned = 0
    for i, e in enumerate(events):
        rp = e.get("rp")
        if not isinstance(rp, dict) or e.get("kind") != "span":
            continue
        name = e.get("name")
        if name not in CROSS_HOST_SPAN_NAMES:
            # runtime vocab drift: a link carrier outside the pinned
            # tuple resolves fine but escaped the static rule's
            # contract — surfaced in the stats, not dropped
            unpinned += 1
        c = by_name.setdefault(name or "?", {"carriers": 0, "resolved": 0})
        c["carriers"] += 1
        j = index.get((int(rp.get("origin") or 0),
                       int(rp.get("span_id") or 0)))
        if j is not None and j != i:
            c["resolved"] += 1
            links.append((j, i))
    links.sort()
    total_c = sum(c["carriers"] for c in by_name.values())
    total_r = sum(c["resolved"] for c in by_name.values())
    return links, {"carriers": total_c, "resolved": total_r,
                   "unpinned": unpinned,
                   "by_name": dict(sorted(by_name.items()))}


def merge_timeline(trace_dir: str | Path, *,
                   offsets_path: str | Path | None = None) -> dict:
    """Load a run's per-host span files onto one fleet clock.

    Returns ``{"events", "links", "link_stats", "skew", "offsets"}``:
    events are skew-corrected (``ts_adj``) and fleet-ordered, links
    index into them."""
    events = read_trace_dir(trace_dir)
    offsets = (read_clock_offsets(offsets_path)
               if offsets_path is not None else {})
    skew = fleet_skew(events, offsets)
    events = apply_clock_skew(events, skew)
    links, stats = resolve_links(events)
    return {"events": events, "links": links, "link_stats": stats,
            "skew": skew, "offsets": offsets}


# -- Chrome/Perfetto export -------------------------------------------------

def export_chrome_trace(merged: dict) -> dict:
    """The merged timeline as Chrome trace-event JSON (load in
    Perfetto / chrome://tracing).

    One process lane per (host, role) — pid = host id, tid = a stable
    per-role index — complete ("X") events for spans on the corrected
    fleet clock, instant ("i") events for markers, and flow arrows
    ("s"/"f") on every resolved cross-host link.  Deterministic: same
    merged input, byte-identical JSON."""
    events = merged["events"]
    lanes = sorted({(e.get("host"), e.get("role") or "")
                    for e in events if e.get("host") is not None})
    roles = sorted({r for _, r in lanes})
    role_tid = {r: 1 + i for i, r in enumerate(roles)}
    out: list[dict] = []
    for host, role in lanes:
        out.append({"ph": "M", "name": "process_name", "pid": host,
                    "tid": 0,
                    "args": {"name": f"host{host} ({role or 'proc'})"}})
        out.append({"ph": "M", "name": "thread_name", "pid": host,
                    "tid": role_tid[role], "args": {"name": role or "proc"}})
    for e in events:
        ts = e.get("ts_adj")
        if ts is None or e.get("host") is None:
            continue
        pid = e["host"]
        tid = role_tid.get(e.get("role") or "", 1)
        args = {k: v for k, v in (e.get("attrs") or {}).items()}
        if e.get("trace_id") is not None:
            args["trace_id"] = e["trace_id"]
        if e.get("kind") == "span":
            out.append({"ph": "X", "name": e.get("name") or "?",
                        "cat": _SPAN_PLANE.get(e.get("name"), "span"),
                        "pid": pid, "tid": tid,
                        "ts": int(round(ts * 1e6)),
                        "dur": max(1, int(round((e.get("dur_s") or 0.0)
                                                * 1e6))),
                        "args": args})
        else:
            out.append({"ph": "i", "s": "t", "name": e.get("name")
                        or e.get("kind") or "?",
                        "cat": "event", "pid": pid, "tid": tid,
                        "ts": int(round(ts * 1e6)), "args": args})
    for flow_id, (pi, ci) in enumerate(merged.get("links") or (), start=1):
        p, c = events[pi], events[ci]
        if p.get("ts_adj") is None or c.get("ts_adj") is None:
            continue
        p_end = int(round((p["ts_adj"] + (p.get("dur_s") or 0.0)) * 1e6))
        c_start = int(round(c["ts_adj"] * 1e6))
        out.append({"ph": "s", "id": flow_id, "name": "xhost",
                    "cat": "link", "pid": p["host"],
                    "tid": role_tid.get(p.get("role") or "", 1),
                    "ts": p_end})
        out.append({"ph": "f", "bp": "e", "id": flow_id, "name": "xhost",
                    "cat": "link", "pid": c["host"],
                    "tid": role_tid.get(c.get("role") or "", 1),
                    "ts": max(c_start, p_end)})
    unc = {h: o.get("unc_s") for h, o in
           sorted((merged.get("offsets") or {}).items())}
    return {"traceEvents": out, "displayTimeUnit": "ms",
            "otherData": {"clock_offset_uncertainty_s": unc,
                          "link_stats": merged.get("link_stats") or {}}}


def write_chrome_trace(merged: dict, out_path: str | Path) -> Path:
    p = Path(out_path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(export_chrome_trace(merged), sort_keys=True,
                            separators=(",", ":")) + "\n")
    return p


# -- per-step critical-path attribution -------------------------------------

def critical_path(merged: dict) -> dict:
    """Walk each trainer step's merged span tree and attribute its wall
    to planes.

    Per (trainer host, step): the step's own phases (``data_wait`` →
    remote-serve or input-local by link presence, ``step`` → compute,
    ``ckpt`` → ckpt) plus cross-plane spans claimed by the step —
    ``compile_fetch`` carrying the step's trace_id, coordinator spans
    overlapping the step's window.  Server-side spans (input_serve /
    artifact_serve) are evidence for the arrows, not added time: their
    cost is already inside the client-side span that waited on them.

    ``wall_s`` is the measured step wall — the fleet-clock gap between
    consecutive ``step`` spans' ends on the same host (the first step
    falls back to its phases' sum) — and ``coverage`` is
    attributed/wall: the acceptance gate wants it within 10% of 1.
    """
    events = merged["events"]
    links = merged.get("links") or []
    linked_children = {ci for _, ci in links}
    by_key: dict[tuple[int, int], dict[str, float]] = {}
    step_end: dict[tuple[int, int], float] = {}
    for i, e in enumerate(events):
        if e.get("kind") != "span" or e.get("host") is None:
            continue
        name = e.get("name")
        tid = e.get("trace_id")
        if name not in ("data_wait", "step", "ckpt", "compile_fetch") \
                or not isinstance(tid, int):
            continue
        if name == "compile_fetch" and (e.get("role") or "") != "trainer":
            # a fetch recorded by a non-trainer role has no step tree
            continue
        key = (e["host"], tid)
        planes = by_key.setdefault(key, {p: 0.0 for p in PLANES})
        dur = float(e.get("dur_s") or 0.0)
        if name == "data_wait":
            remote = i in linked_children or isinstance(e.get("rp"), dict)
            planes["remote-serve" if remote else "input-local"] += dur
        else:
            planes[_SPAN_PLANE[name]] += dur
        if name == "step" and e.get("ts_adj") is not None:
            step_end[key] = e["ts_adj"] + dur
    # coordinator spans: attributed to every step whose window overlaps
    coord = [(e.get("ts_adj"), float(e.get("dur_s") or 0.0))
             for e in events
             if e.get("kind") == "span"
             and e.get("name") in COORDINATOR_SPAN_NAMES
             and e.get("ts_adj") is not None]
    rows = []
    for key in sorted(by_key):
        host, step = key
        planes = by_key[key]
        prev = step_end.get((host, step - 1))
        end = step_end.get(key)
        attributed = sum(planes.values())
        if prev is not None and end is not None and end > prev:
            wall = end - prev
            for c_ts, c_dur in coord:
                if prev <= c_ts <= end:
                    planes["coordinator"] += c_dur
                    attributed += c_dur
        else:
            wall = attributed
        bounded = max(PLANES, key=lambda p: (planes[p], p)) \
            if attributed > 0 else "compute"
        rows.append({
            "host": host, "step": step,
            **{p: round(planes[p], 6) for p in PLANES},
            "wall_s": round(wall, 6),
            "coverage": round(attributed / wall, 4) if wall > 0 else 1.0,
            "bounded_by": bounded,
        })
    totals = {p: round(sum(r[p] for r in rows), 6) for p in PLANES}
    total = sum(totals.values())
    shares = {p: round(totals[p] / total, 4) if total > 0 else 0.0
              for p in PLANES}
    coverages = sorted(r["coverage"] for r in rows)
    cov_median = (coverages[len(coverages) // 2] if coverages else 1.0)
    return {"steps": rows, "totals": totals, "shares": shares,
            "coverage_median": cov_median,
            "max_offset_unc_s": max(
                [o.get("unc_s", 0.0)
                 for o in (merged.get("offsets") or {}).values()] or [0.0])}


# Plane -> goodput bucket, for the aggregate cross-check.  Both sides
# are renormalized over the mapped subset so the comparison is
# apples-to-apples: the ledger also accounts compile/idle/downtime,
# which have no per-step span.
_PLANE_BUCKET = {
    "compute": "productive_step",
    "remote-serve": "data_wait",
    "input-local": "data_wait",
    "artifact-fetch": "compile_fetched",
    "ckpt": "ckpt",
}


def crosscheck_goodput(cp: dict, goodput_report: dict) -> list[dict]:
    """Aggregate critpath plane shares vs the goodput ledger's bucket
    shares, renormalized over the buckets both sides can see.  Rows of
    ``{bucket, critpath_share, goodput_share, delta}`` — report-only;
    a large delta means the spans and the ledger disagree about where
    the wall went (clock trouble or missing instrumentation)."""
    plane_s = {}
    for p, b in _PLANE_BUCKET.items():
        plane_s[b] = plane_s.get(b, 0.0) + cp["totals"].get(p, 0.0)
    fleet = goodput_report.get("fleet_buckets") or \
        goodput_report.get("buckets") or {}
    led_s = {b: float(fleet.get(b, 0.0)) for b in plane_s}
    pt, lt = sum(plane_s.values()), sum(led_s.values())
    rows = []
    for b in sorted(plane_s):
        a = plane_s[b] / pt if pt > 0 else 0.0
        z = led_s[b] / lt if lt > 0 else 0.0
        rows.append({"bucket": b, "critpath_share": round(a, 4),
                     "goodput_share": round(z, 4),
                     "delta": round(a - z, 4)})
    return rows


def render_critpath(cp: dict, crosscheck: list[dict] | None = None) -> str:
    """Deterministic text report (byte-identical for identical span
    files — pinned by test): per-step plane attribution with the
    "bounded by" verdict, then aggregate shares."""
    lines = ["critical path (per step)", ""]
    cols = ["host", "step", *PLANES, "wall_s", "coverage", "bounded_by"]
    lines.append(render_table(cp["steps"], cols))
    lines.append("")
    lines.append("aggregate plane shares")
    lines.append(render_table(
        [{"plane": p, "seconds": cp["totals"][p], "share": cp["shares"][p]}
         for p in PLANES], ["plane", "seconds", "share"]))
    lines.append("")
    lines.append(f"coverage median: {cp['coverage_median']:.4f}  "
                 f"(attributed / measured step wall)")
    lines.append(f"clock offset uncertainty bound: "
                 f"{cp['max_offset_unc_s']:.6f}s")
    if crosscheck:
        lines.append("")
        lines.append("goodput cross-check (shares renormalized over "
                     "span-visible buckets)")
        lines.append(render_table(
            crosscheck,
            ["bucket", "critpath_share", "goodput_share", "delta"]))
    return "\n".join(lines) + "\n"
