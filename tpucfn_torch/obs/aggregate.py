"""Fleet aggregation over per-host JSONL metrics and trace files.

The write side (MetricLogger, Tracer) produces one file per host; this
is the read side ``tpucfn obs`` uses to answer the three questions you
otherwise tail 64 files for:

* **merged step timeline** — for each global step, every host's wall
  time fused into min/median/max + which host was slowest;
* **per-host straggler report** — mean step/data-wait time per host
  relative to the fleet median (the Podracer-style per-actor timing
  decomposition: a 1.3x host is a hardware or input-pipeline problem,
  not a model problem);
* **request latency breakdown** — per-request queue-wait / prefill /
  decode reconstructed from serve trace spans, with fleet aggregates.

Everything here is pure functions over parsed dicts so the CLI, tests,
and notebooks share one implementation.
"""

from __future__ import annotations

import json
import statistics
from pathlib import Path
from typing import Iterable

from tpucfn_torch.obs.goodput import parse_jsonl_line
from tpucfn_torch.obs.trace import read_trace_file


def read_metrics_dir(d: str | Path) -> dict[str, list[dict]]:
    """``host label -> [records]`` for every ``*.jsonl`` under ``d``
    (one file per host by MetricLogger convention; torn lines skipped —
    same still-being-appended tolerance as the trace reader)."""
    return {p.stem: read_trace_file(p)
            for p in sorted(Path(d).glob("*.jsonl"))}


def merge_step_timeline(by_host: dict[str, list[dict]],
                        key: str = "step_time",
                        last: int | None = None) -> list[dict]:
    """One row per global step seen on any host: per-step fleet spread
    of ``key`` plus the slowest host — the merged timeline view."""
    per_step: dict[int, dict[str, float]] = {}
    for host, rows in by_host.items():
        for r in rows:
            if key in r and "step" in r:
                per_step.setdefault(int(r["step"]), {})[host] = float(r[key])
    steps = sorted(per_step)
    if last is not None:
        steps = steps[-last:]
    out = []
    for s in steps:
        vals = per_step[s]
        straggler = max(vals, key=vals.get)
        out.append({
            "step": s,
            "hosts": len(vals),
            "min": min(vals.values()),
            "median": statistics.median(vals.values()),
            "max": vals[straggler],
            "straggler": straggler,
        })
    return out


def host_straggler_report(by_host: dict[str, list[dict]],
                          keys: tuple[str, ...] = ("step_time",),
                          slow_factor: float = 1.2) -> list[dict]:
    """Per-host means of ``keys`` with each host's ratio to the fleet
    median of the first key; ``slow`` flags ratios above
    ``slow_factor`` (the "go look at that host" bit)."""
    rows = []
    for host, recs in sorted(by_host.items()):
        row: dict = {"host": host, "records": len(recs)}
        for k in keys:
            vals = [float(r[k]) for r in recs if k in r]
            row[f"mean_{k}"] = statistics.fmean(vals) if vals else None
            row[f"n_{k}"] = len(vals)
        rows.append(row)
    primary = f"mean_{keys[0]}"
    meds = [r[primary] for r in rows if r[primary] is not None]
    fleet_median = statistics.median(meds) if meds else None
    for r in rows:
        if fleet_median and r[primary] is not None:
            r["vs_fleet_median"] = r[primary] / fleet_median
            r["slow"] = r["vs_fleet_median"] > slow_factor
        else:
            r["vs_fleet_median"], r["slow"] = None, False
    return rows


def request_breakdown(events: Iterable[dict]) -> tuple[list[dict], dict]:
    """Per-request latency decomposition from serve trace events.

    Returns ``(rows, aggregate)``: one row per request with queue_wait /
    prefill (first, non-resumed) / decode (sum of the decode rounds
    whose batch contained this sequence) / ttft / total and the
    outcome; aggregate carries fleet percentiles of each part.

    Requests are keyed by ``(host, trace_id)``: each server process
    numbers its requests from 0, so in a multi-host serve gang the same
    trace_id appears once per host and keying on it alone would fuse
    different hosts' requests into one wrong row.
    """
    per_req: dict = {}
    decode_rounds: list[dict] = []

    def req(host, tid):
        return per_req.setdefault((host, tid), {
            "host": host, "request": tid,
            "queue_wait_s": None, "prefill_s": None,
            "re_prefill_s": 0.0, "decode_s": 0.0, "decode_rounds": 0,
            "spec_propose_s": 0.0, "spec_verify_s": 0.0,
            "ttft_s": None, "total_s": None, "generated": None,
            "outcome": None})

    for e in events:
        name, tid, host = e.get("name"), e.get("trace_id"), e.get("host")
        attrs = e.get("attrs", {})
        if name == "queue_wait" and tid is not None:
            req(host, tid)["queue_wait_s"] = e["dur_s"]
        elif name == "prefill" and tid is not None:
            if attrs.get("resumed"):
                req(host, tid)["re_prefill_s"] += e["dur_s"]
            else:
                req(host, tid)["prefill_s"] = e["dur_s"]
        elif name in ("decode_round", "spec_propose", "spec_verify"):
            # Round-level spans (one per decode batch, fanned out to
            # each member request below).  spec_propose/spec_verify are
            # the propose-verify halves of a speculative round (ISSUE
            # 14): per request, decode_s splits into draft time and
            # target-verify time, so a TPOT regression names its layer.
            decode_rounds.append(e)
        elif name == "request_done" and tid is not None:
            r = req(host, tid)
            r["outcome"] = attrs.get("outcome")
            r["total_s"] = attrs.get("latency_s")
            r["ttft_s"] = attrs.get("ttft_s")
            r["generated"] = attrs.get("generated")
    for e in decode_rounds:
        for sid in e.get("attrs", {}).get("seqs", ()):
            key = (e.get("host"), sid)
            if key not in per_req:
                continue
            if e.get("name") == "spec_propose":
                per_req[key]["spec_propose_s"] += e["dur_s"]
            elif e.get("name") == "spec_verify":
                per_req[key]["spec_verify_s"] += e["dur_s"]
            else:
                per_req[key]["decode_s"] += e["dur_s"]
                per_req[key]["decode_rounds"] += 1
    rows = [per_req[k] for k in sorted(per_req,
                                       key=lambda k: (str(k[0]), str(k[1])))]

    from tpucfn_torch.obs.metrics import nearest_rank

    agg: dict = {"requests": len(rows),
                 "completed": sum(1 for r in rows if r["outcome"] == "ok")}
    for part in ("queue_wait_s", "prefill_s", "decode_s", "ttft_s", "total_s"):
        xs = sorted(r[part] for r in rows if r[part] is not None)
        agg[part] = {"p50": nearest_rank(xs, 50), "p95": nearest_rank(xs, 95),
                     "max": xs[-1] if xs else None}
    for part in ("spec_propose_s", "spec_verify_s"):
        # only when speculation ran — a plain run's aggregate is
        # byte-identical to the pre-spec shape
        xs = sorted(r[part] for r in rows if r[part])
        if xs:
            agg[part] = {"p50": nearest_rank(xs, 50),
                         "p95": nearest_rank(xs, 95), "max": xs[-1]}
    return rows, agg


# Control-plane span families the fleet view surfaces (one canonical
# tuple — the span-balance rule of `tpucfn check` reads consumers by
# ast, and a scattered literal here would be exactly the drift it
# exists to catch): recovery spans from the gang coordinator, on-demand
# profiler captures, and the compile-artifact fetch leg of the fleet
# warm start (ISSUE 13).
CONTROL_SPAN_NAMES = ("ft_recover", "ft_give_up", "profile_capture",
                      "compile_fetch")


def control_timeline(events: Iterable[dict]) -> list[dict]:
    """One row per control-plane span, fleet-ordered: when a recovery,
    profiler capture, or compile-artifact fetch ran relative to the
    steps around it — the read side that makes those spans part of the
    merged story instead of write-only trace lines."""
    rows = []
    for e in events:
        if e.get("kind") != "span" or e.get("name") not in \
                CONTROL_SPAN_NAMES:
            continue
        attrs = e.get("attrs") or {}
        detail = {k: attrs[k] for k in ("action", "hosts", "rc", "key",
                                        "label", "addr", "bytes",
                                        "artifact", "seconds")
                  if k in attrs}
        rows.append({
            "ts": e.get("ts_adj", e.get("ts")),
            "host": e.get("host"),
            "role": e.get("role"),
            "span": e.get("name"),
            "dur_s": e.get("dur_s"),
            "trace_id": e.get("trace_id"),
            "detail": json.dumps(detail, sort_keys=True) if detail else "",
        })
    rows.sort(key=lambda r: (r["ts"] is None, r["ts"] or 0.0))
    return rows


def step_spans_by_host(events: Iterable[dict]) -> dict[str, list[dict]]:
    """Regroup trainer trace spans into the by-host record shape the
    timeline/straggler views consume (span name -> ``<name>_time``
    column, trace_id -> step) — so traces alone, without the metrics
    JSONL, still feed the fleet views."""
    by_host: dict[str, list[dict]] = {}
    for e in events:
        if e.get("kind") != "span" or e.get("name") not in (
                "data_wait", "step", "ckpt"):
            continue
        host = f"host{e.get('host')}" if e.get("host") is not None else "host?"
        rec: dict = {f"{e['name']}_time": e["dur_s"]}
        if e.get("trace_id") is not None:
            rec["step"] = e["trace_id"]
        by_host.setdefault(host, []).append(rec)
    return by_host


def select_skew_reference_beats(
        recs: Iterable[dict],
        state: tuple = (None, None)) -> tuple[list[dict], tuple]:
    """The heartbeats usable as clock-skew reference points: the first
    beat at each ``step`` value, plus any ``seq`` reset (incarnation
    boundary — the reset beat must survive so downstream incarnation
    counting still sees the boundary).  Single source of truth shared
    by :func:`estimate_clock_skew` and the watch-mode compaction in
    ``tpucfn obs`` — if the two drifted apart, compaction would discard
    beats the estimator needs and silently bias the skew.

    Returns ``(kept, new_state)``; thread ``new_state`` back in for
    incremental (tailing) use.  Selection is idempotent: running it
    over an already-selected stream keeps every beat.
    """
    prev_seq, prev_step = state
    kept = []
    for r in recs:
        seq = r.get("seq")
        if not isinstance(seq, int) or "t" not in r:
            continue
        reset = prev_seq is not None and seq <= prev_seq
        step = r.get("step")
        if reset or (step is not None and step != prev_step):
            kept.append(r)
            prev_step = step
        prev_seq = seq
    return kept, (prev_seq, prev_step)


def estimate_clock_skew(events: Iterable[dict],
                        heartbeats_by_host: dict[int, list[dict]]
                        | None = None) -> dict[str, float]:
    """Per-host wall-clock skew estimate (seconds; positive = that
    host's clock runs ahead of the fleet median).

    Cross-host span ordering rides on each host's wall ``ts``; hosts'
    clocks drift, so raw ``ts`` ordering lies.  The reference points
    must be events that truly happen fleet-simultaneously, and the only
    such anchor in the record streams is the **global training step**:
    an SPMD gang executes step N in lockstep (the collectives force
    it).  Two sources carry it, preferred in order:

    * **Heartbeats** — each beat stamps the loop's current ``step``;
      the first beat observing step N lands within one heartbeat
      interval of the host reaching N.  (Pairing beats by ``seq``
      instead would conflate writer *start stagger* — a host whose jax
      import ran seconds longer — with clock skew and mis-order events
      whose raw timestamps were correct, so beats without a step, e.g.
      a serve host's, contribute nothing.)
    * **Step spans** — the per-step trace spans' wall times, same
      lockstep argument without the beat-interval quantization.

    Returns ``{host_label: skew_s}``; subtract the skew from a host's
    ``ts`` to place its events on the fleet's median clock
    (:func:`apply_clock_skew`).
    """
    # reference_points: host -> {key: wall_t}
    points: dict[str, dict] = {}
    if heartbeats_by_host:
        for host, recs in heartbeats_by_host.items():
            # HeartbeatWriter restarts seq from 1 per incarnation while
            # appending to the SAME file, and a restarted trainer REWINDS
            # to the checkpoint step — so key by (incarnation, step):
            # a restarted host's post-downtime re-run of step N must not
            # overwrite its first-incarnation reference point (it would
            # read as tens of seconds of phantom skew), and its second
            # incarnation only matches peers that restarted with it
            # (gang restart) — a solo restart's unmatched points are
            # simply dropped by the >=2-hosts filter below.
            pts = {}
            incarnation, prev_seq, prev_step = 0, None, None
            kept, _ = select_skew_reference_beats(recs)
            for r in kept:
                if prev_seq is not None and r["seq"] <= prev_seq:
                    incarnation += 1
                    prev_step = None
                prev_seq = r["seq"]
                step = r.get("step")
                if step is not None and step != prev_step:
                    pts[(incarnation, step)] = float(r["t"])
                    prev_step = step
            if pts:
                points[f"host{host}"] = pts
    if len(points) < 2:
        # Fewer than two hosts have usable heartbeats (one hb file
        # missing/torn still means NO cross-host reference) — fall back
        # to step spans wholesale rather than mixing point sources.
        points = {}
        for e in events:
            if (e.get("kind") == "span" and e.get("name") == "step"
                    and e.get("trace_id") is not None
                    and e.get("ts") is not None):
                host = (f"host{e['host']}" if e.get("host") is not None
                        else "host?")
                points.setdefault(host, {})[e["trace_id"]] = float(e["ts"])
    if len(points) < 2:
        return {h: 0.0 for h in points}
    # per shared key, the fleet median; per host, median offset from it
    all_keys: dict = {}
    for pts in points.values():
        for k, t in pts.items():
            all_keys.setdefault(k, []).append(t)
    medians = {k: statistics.median(ts) for k, ts in all_keys.items()
               if len(ts) >= 2}
    skew = {}
    for host, pts in sorted(points.items()):
        offsets = [t - medians[k] for k, t in pts.items() if k in medians]
        skew[host] = statistics.median(offsets) if offsets else 0.0
    return skew


def apply_clock_skew(events: list[dict],
                     skew: dict[str, float]) -> list[dict]:
    """Events sorted on the skew-corrected fleet clock, each annotated
    with ``ts_adj`` — the cross-host-comparable timestamp the merged
    timeline orders by (original dicts are not mutated).

    Each event's ``mono`` (the write instant on its host's monotonic
    clock) breaks same-instant ties within a host: wall ``ts`` is
    reconstructed from two clock reads and can collide or invert for
    back-to-back writes (retroactively recorded spans, a stepping NTP
    clock), while ``mono`` strictly orders one process's writes.
    Monotonic origins are per-process, so ``mono`` is only consulted
    when the corrected wall times actually tie."""
    out = []
    for e in events:
        host = f"host{e['host']}" if e.get("host") is not None else "host?"
        ts = e.get("ts")
        adj = (ts - skew.get(host, 0.0)) if ts is not None else None
        out.append({**e, "ts_adj": adj})
    out.sort(key=lambda e: (e["ts_adj"] is None, e["ts_adj"] or 0.0,
                            e.get("mono") is None, e.get("mono") or 0.0))
    return out


def window_events(events: Iterable[dict], start: float,
                  end: float) -> list[dict]:
    """The skew-corrected events inside ``[start, end]`` — the slice a
    postmortem renders around an incident.  Operates on ``ts_adj`` (the
    :func:`apply_clock_skew` annotation) so the window means the same
    instant on every host; events without one (no wall clock recorded)
    cannot be placed and are excluded."""
    return [e for e in events
            if e.get("ts_adj") is not None and start <= e["ts_adj"] <= end]


class JsonlTailer:
    """Incremental multi-file JSONL reader for ``--watch`` mode.

    ``tpucfn obs --watch`` used to re-read every metrics/trace file from
    byte 0 on each tick — O(run length) per refresh.  This keeps a byte
    offset per file and yields only complete NEW lines each poll:

    * a torn tail (writer mid-append) is left in place — the offset
      only advances past the last ``\\n``, so the partial line is
      re-read whole on a later tick (same tolerance as the heartbeat
      reader);
    * an undecodable complete line is skipped and counted
      (:attr:`skipped`), never raised on;
    * a file that SHRANK (rotated/truncated) resets to byte 0 — stale
      offsets must not silently hide a restarted writer;
    * a file whose first bytes CHANGED resets too: a restarted writer
      (Tracer opens with truncate) that regrows PAST the stored offset
      between two polls never shrinks from the tailer's point of view,
      so the size check alone would resume mid-stream inside the new
      file — the head signature betrays the swap.
    """

    _HEAD_SIG_LEN = 64

    def __init__(self):
        self._offsets: dict[Path, int] = {}
        self._heads: dict[Path, bytes] = {}  # first-bytes signature
        self.skipped = 0
        # files whose size shrank on the LAST poll: the re-read restarts
        # from byte 0, so a caller holding accumulated records for the
        # file must drop them first or every old record double-counts.
        self.truncated: set[Path] = set()

    def poll(self, paths: Iterable[str | Path]) -> dict[Path, list[dict]]:
        """New records per file since the last poll (files appear in the
        result only when they produced records).  Check
        :attr:`truncated` after each call for files that restarted."""
        out: dict[Path, list[dict]] = {}
        self.truncated = set()
        for p in paths:
            p = Path(p)
            try:
                size = p.stat().st_size
            except OSError:
                continue
            off = self._offsets.get(p, 0)
            if size < off:  # truncated/rotated: start over
                # Persist the reset NOW: if the regrown file has no
                # complete line yet this poll, the stale offset would
                # otherwise survive, and a file that later regrows PAST
                # it would resume mid-stream — silently dropping the new
                # file's head (and starting mid-line).
                off = self._offsets[p] = 0
                self.truncated.add(p)
                self._heads.pop(p, None)
            head = self._heads.get(p) if off else None
            if size == off and not head:
                continue
            try:
                with open(p, "rb") as f:
                    if head and f.read(len(head)) != head:
                        # Truncate-then-regrow past the stored offset:
                        # size never dipped below `off`, only the first
                        # bytes changed.  Restart from byte 0.
                        off = self._offsets[p] = 0
                        self.truncated.add(p)
                        self._heads.pop(p, None)
                    if size == off:
                        continue
                    f.seek(off)
                    chunk = f.read(size - off)
            except OSError:
                continue
            # only consume up to the last complete line
            nl = chunk.rfind(b"\n")
            if nl < 0:
                continue  # torn tail only; retry next tick
            if off == 0:  # consumed bytes only — immutable once written
                self._heads[p] = chunk[: min(self._HEAD_SIG_LEN, nl + 1)]
            self._offsets[p] = off + nl + 1
            recs = []
            for raw in chunk[: nl + 1].splitlines():
                raw = raw.strip()
                if not raw:
                    continue
                rec = parse_jsonl_line(raw)
                if rec is None:
                    self.skipped += 1
                else:
                    recs.append(rec)
            if recs:
                out[p] = recs
        return out

    def poll_into(self, paths: Iterable[str | Path], store: dict,
                  key_fn=None, extend=None, on_drop=None) -> bool:
        """:meth:`poll` plus the accumulate discipline every ``--watch``
        domain repeats: a truncated file's accumulated records are
        dropped BEFORE its re-read records are appended (the other
        order double-counts history), and the caller learns whether
        anything actually changed (the idle-tick recompute caches key
        off it).

        ``key_fn(path)`` maps a file to its ``store`` key (return None
        to skip the file); ``extend(key, lst, recs)`` appends and
        returns how many records it kept (default keeps all — a
        compacting extend that kept nothing does not dirty the store);
        ``on_drop(key)`` clears caller state beyond the store entry.
        """
        key_fn = key_fn or (lambda p: p)
        dirty = False
        new = self.poll(paths)
        for p in self.truncated:
            k = key_fn(p)
            if k is None:
                continue
            store.pop(k, None)
            if on_drop is not None:
                on_drop(k)
            dirty = True
        for p, recs in new.items():
            k = key_fn(p)
            if k is None:
                continue
            lst = store.setdefault(k, [])
            if extend is not None:
                if extend(k, lst, recs):
                    dirty = True
            else:
                lst.extend(recs)
                dirty = True
        return dirty


def render_table(rows: list[dict], columns: list[str],
                 float_fmt: str = "{:.4f}") -> str:
    """Minimal fixed-width table (no external deps on the hosts)."""
    def cell(v):
        if isinstance(v, bool):
            return "YES" if v else ""
        if isinstance(v, float):
            return float_fmt.format(v)
        return "" if v is None else str(v)

    grid = [columns] + [[cell(r.get(c)) for c in columns] for r in rows]
    widths = [max(len(row[i]) for row in grid) for i in range(len(columns))]
    lines = ["  ".join(c.ljust(w) for c, w in zip(row, widths)).rstrip()
             for row in grid]
    lines.insert(1, "  ".join("-" * w for w in widths))
    return "\n".join(lines)
