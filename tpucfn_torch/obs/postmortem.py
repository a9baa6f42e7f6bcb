"""Incident postmortem assembly: one bundle per incident (ISSUE 6).

The write side of every observability plane already lands per-host
JSONL under the run dir — trace spans, goodput ledgers, heartbeats,
ft events, flight-recorder dumps.  This module is the read side that
turns them into a *diagnosis*: given an incident id (or ``--latest``),
it assembles

* the **incident** itself — the enriched ``goodput_incident`` row plus
  the raw detect/decide/recovered events and the failure verdicts;
* the **skew-corrected merged timeline** windowed around detection
  (every event carries ``ts_adj``, ordered on the fleet's median
  clock — the same correction ``tpucfn obs`` applies);
* the **goodput buckets for the affected span** (the window's phase
  records only, decomposed by the normal merge);
* the **per-host flight-recorder tails** — the coordinator's at-detect
  captures (``<ft_dir>/flight/incident{N}-host*.jsonl``) preferred,
  each process's signal/atexit dump (``<run_dir>/flight/``) as
  fallback — with coverage relative to the detection instant;
* each host's **last heartbeat** before detection.

Everything is pure functions over parsed dicts (the ``tpucfn obs
postmortem`` CLI, tests, and notebooks share one implementation), and
every input is optional-but-reported: a missing trace dir yields an
empty timeline plus a note, not a crash — the postmortem of a broken
run must survive the brokenness it is diagnosing.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Iterable

from tpucfn_torch.ft.heartbeat import HB_GLOB
from tpucfn_torch.obs.aggregate import (apply_clock_skew, render_table,
                                        window_events)
from tpucfn_torch.obs.flight import FLIGHT_GLOB, read_flight_dir
from tpucfn_torch.obs.goodput import (_incidents_from_events,
                                      host_id_from_path, merge_goodput,
                                      read_ft_events, read_goodput_dir,
                                      read_jsonl_counting)
from tpucfn_torch.obs.timeline import fleet_skew, read_clock_offsets
from tpucfn_torch.obs.trace import read_trace_dir, read_trace_file

DEFAULT_WINDOW_S = 15.0


def select_incident(events: Iterable[dict],
                    incident_id: int | None = None) -> dict:
    """The incident row to postmortem: the enriched/fallback row from
    :func:`~tpucfn.obs.goodput._incidents_from_events`, newest when
    ``incident_id`` is None (``--latest``).  Raises ``ValueError`` with
    the known ids when the run has no incidents or the id is unknown —
    the CLI's usage-error text."""
    incidents = _incidents_from_events(events)
    if not incidents:
        raise ValueError(
            "no incidents in the ft events log (nothing failed, or the "
            "run was not launched with --ft)")
    if incident_id is None:
        return incidents[-1]
    for inc in incidents:
        if inc["incident"] == incident_id:
            return inc
    raise ValueError(
        f"unknown incident {incident_id}; this run has "
        f"{[i['incident'] for i in incidents]}")


def _read_heartbeats_full(ft_dir: Path) -> dict[int, list[dict]]:
    out: dict[int, list[dict]] = {}
    if not ft_dir.is_dir():
        return out
    for p in sorted(ft_dir.glob(HB_GLOB)):
        host = host_id_from_path(p)
        if host is None:
            continue
        recs, _ = read_jsonl_counting(p)
        if recs:
            out[host] = recs
    return out


def _flight_rows(sources: dict[str, dict[int, dict]],
                 t_detect: float | None,
                 skew: dict[str, float] | None = None) -> list[dict]:
    """One row per (host, source): sample count, time span, and how far
    short of the detection instant the tail stops — the acceptance
    question is "do the survivors' rings cover the seconds up to
    detection", so answer it as a number, not a feeling.  Sample times
    are placed on the fleet clock via ``skew`` (the same correction the
    timeline gets) before comparing against the detect instant."""
    rows = []
    skew = skew or {}
    for source, by_host in sources.items():
        for host in sorted(by_host):
            d = by_host[host]
            off = skew.get(f"host{host}", 0.0)
            ts = [s["t"] - off for s in d["samples"]
                  if isinstance(s.get("t"), (int, float))]
            header = d.get("header") or {}
            row = {"host": host, "source": source,
                   "samples": len(d["samples"]),
                   "dropped": header.get("dropped"),
                   "t_first": min(ts) if ts else None,
                   "t_last": max(ts) if ts else None,
                   "path": d["path"]}
            if t_detect is not None and ts:
                row["gap_to_detect_s"] = round(t_detect - max(ts), 3)
            else:
                row["gap_to_detect_s"] = None
            rows.append(row)
    return rows


def build_postmortem(run_dir: str | Path, *,
                     incident_id: int | None = None,
                     window_s: float = DEFAULT_WINDOW_S,
                     ft_dir: str | Path | None = None) -> dict:
    """Assemble the postmortem report dict for one incident (see module
    doc for the sections).  Raises ``ValueError`` when there is no ft
    events log or the incident id is unknown; every other missing input
    degrades to an empty section plus a line in ``notes``."""
    run_dir = Path(run_dir)
    ft_dir = Path(ft_dir) if ft_dir is not None else run_dir / "ft"
    notes: list[str] = []

    events_path = ft_dir / "events.jsonl"
    events, ev_skipped = read_ft_events(events_path)
    if not events:
        raise ValueError(f"no ft events at {events_path} — a postmortem "
                         "needs the incident log (launch with --ft)")
    incident = select_incident(events, incident_id)
    inc_id = incident["incident"]
    raw_events = [e for e in events if e.get("incident") == inc_id]
    detect = next((e for e in raw_events if e.get("kind") == "detect"), None)
    recovered = next((e for e in raw_events if e.get("kind") == "recovered"),
                     None)
    t_detect = (detect or {}).get("ts") or incident.get("ts")
    t_end = (recovered or {}).get("ts") or t_detect
    window = (None, None)
    if t_detect is not None:
        window = (t_detect - window_s, (t_end or t_detect) + window_s)
    else:
        notes.append("incident has no usable timestamp; timeline and "
                     "goodput windows are empty")

    # -- skew-corrected timeline around detection -------------------------
    trace_dir = run_dir / "trace"
    trace_events = read_trace_dir(trace_dir) if trace_dir.is_dir() else []
    if not trace_events:
        notes.append(f"no trace spans under {trace_dir}")
    # Span tails (ISSUE 20): the coordinator's at-detect /tracetail
    # captures — the survivors' last spans, pulled before the restart
    # erased nothing (files are durable) but the postmortem may run on
    # a machine that only has ft_dir.  They back-fill the timeline when
    # the run dir's trace files are absent.
    span_tail_rows = []
    tail_events: list[dict] = []
    for p in sorted((ft_dir / "spans").glob(
            f"incident{inc_id:03d}-host*.jsonl")):
        evts = read_trace_file(p)
        tail_events.extend(evts)
        host = host_id_from_path(p)
        profile = p.with_name(p.stem + "-profile.json")
        span_tail_rows.append({
            "host": host, "events": len(evts),
            "profile": str(profile) if profile.is_file() else None,
            "path": str(p)})
    if not trace_events and tail_events:
        trace_events = sorted(tail_events,
                              key=lambda e: (e.get("ts", 0.0),
                                             e.get("mono", 0.0)))
        notes.append("timeline built from the coordinator's at-detect "
                     "span tails (no run-dir trace files)")
    hb_full = _read_heartbeats_full(ft_dir)
    # Measured clock offsets (coordinator /clock probes) win over the
    # step-anchored estimate wherever a probe exists.
    offsets = read_clock_offsets(ft_dir / "clock-offsets.jsonl")
    skew = fleet_skew(trace_events, offsets, hb_full or None)
    corrected = apply_clock_skew(trace_events, skew)
    timeline = (window_events(corrected, window[0], window[1])
                if window[0] is not None else [])

    # -- goodput buckets for the affected span ----------------------------
    # Ledger record times are host wall clocks: window them on the
    # corrected fleet clock (same skew the timeline gets), and hand the
    # merge only THIS incident's events — the full run's event list
    # would make goodput.json's incidents/downtime describe the whole
    # run under a section labeled "the affected span".
    by_host, gp_skipped = read_goodput_dir(run_dir / "goodput")
    if not by_host:
        notes.append(f"no goodput ledgers under {run_dir / 'goodput'}")
    if window[0] is not None:
        windowed = {
            h: [r for r in recs
                if isinstance(r.get("t"), (int, float))
                and window[0] <= r["t"] - skew.get(f"host{h}", 0.0)
                <= window[1]]
            for h, recs in by_host.items()}
    else:
        windowed = {}
    goodput = merge_goodput({h: r for h, r in windowed.items() if r},
                            raw_events, skipped_lines=gp_skipped)

    # -- flight-recorder tails --------------------------------------------
    # Captures first, dumps strictly as FALLBACK: the at-detect capture
    # is incident-scoped by its file name, but run_dir/flight dumps are
    # truncate-overwritten by every incarnation's exit — for a host the
    # coordinator already captured, the dump is a LATER incarnation's
    # ring, and for an earlier-than-latest incident a dump may postdate
    # detection entirely.  Only a dump with samples at or before the
    # detect instant can speak for this incident.
    sources: dict[str, dict[int, dict]] = {}
    captures = read_flight_dir(ft_dir / "flight",
                               glob=f"incident{inc_id:03d}-host*.jsonl")
    if captures:
        sources["incident-capture"] = captures
    dumps = read_flight_dir(run_dir / "flight", glob=FLIGHT_GLOB)
    fallback: dict[int, dict] = {}
    for host, d in dumps.items():
        if host in captures:
            continue
        off = skew.get(f"host{host}", 0.0)
        ts = [s["t"] - off for s in d["samples"]
              if isinstance(s.get("t"), (int, float))]
        if t_detect is not None and (not ts or min(ts) > t_detect):
            notes.append(
                f"host {host}'s process dump starts after detection "
                "(a later incarnation's ring) — excluded from this "
                "incident's coverage")
            continue
        fallback[host] = d
    if fallback:
        sources["process-dump"] = fallback
    if not sources:
        notes.append("no flight-recorder dumps (neither the "
                     "coordinator's at-detect captures nor per-process "
                     "exit dumps) — was the job wired with a "
                     "FlightRecorder and an obs port?")
    flight_rows = _flight_rows(sources, t_detect, skew)

    # -- last heartbeat per host before detection -------------------------
    heartbeats = []
    for host in sorted(hb_full):
        beats = hb_full[host]
        # beat times are this host's wall clock: compare on the fleet
        # clock, or a fast host's perfectly healthy beats would all
        # read as "after detection" and falsely vanish from the table
        off = skew.get(f"host{host}", 0.0)
        before = [b for b in beats
                  if isinstance(b.get("t"), (int, float))
                  and (t_detect is None or b["t"] - off <= t_detect)]
        if not before:
            # every parseable beat postdates detection (host launched
            # after this incident, or torn early lines): listing its
            # later beat under "last heartbeat BEFORE detection" would
            # assert the host was beating before an incident it never
            # saw — say so instead.
            notes.append(f"host {host} has no heartbeat at or before "
                         "detection — omitted from the heartbeat table")
            continue
        last = before[-1]
        heartbeats.append({
            "host": host, "t": last.get("t"), "step": last.get("step"),
            "pid": last.get("pid"), "role": last.get("role"),
            "age_at_detect_s": (round(t_detect - (last["t"] - off), 3)
                                if t_detect is not None else None)})
    if not hb_full:
        notes.append(f"no heartbeat files under {ft_dir}")

    return {
        "run_dir": str(run_dir),
        "ft_dir": str(ft_dir),
        "incident": incident,
        "events": raw_events,
        "detect_ts": t_detect,
        "window": {"start": window[0], "end": window[1],
                   "window_s": window_s},
        "clock_skew_s": skew,
        "clock_offsets": offsets,
        "timeline": timeline,
        "goodput": goodput,
        "flight": flight_rows,
        "span_tails": span_tail_rows,
        "heartbeats": heartbeats,
        "skipped_event_lines": ev_skipped,
        "notes": notes,
    }


def write_bundle(report: dict, out_dir: str | Path) -> Path:
    """Materialize one postmortem bundle directory:

    ``incident.json`` / ``heartbeats.json`` / ``goodput.json`` (the
    report sections), ``timeline.jsonl`` (one skew-corrected event per
    line), ``flight/`` (the source dump files copied in, so the bundle
    stays readable after the run dir is cleaned), and ``report.md``
    (the rendered human summary).  Returns the bundle path."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / "incident.json").write_text(json.dumps(
        {"incident": report["incident"], "events": report["events"],
         "detect_ts": report["detect_ts"], "window": report["window"],
         "clock_skew_s": report["clock_skew_s"],
         "clock_offsets": report.get("clock_offsets") or {},
         "notes": report["notes"]}, indent=2))
    (out / "goodput.json").write_text(json.dumps(report["goodput"],
                                                 indent=2))
    (out / "heartbeats.json").write_text(json.dumps(report["heartbeats"],
                                                    indent=2))
    with open(out / "timeline.jsonl", "w") as f:
        for e in report["timeline"]:
            f.write(json.dumps(e) + "\n")
    flight_dir = out / "flight"
    for row in report["flight"]:
        src = Path(row["path"])
        if src.is_file():
            flight_dir.mkdir(parents=True, exist_ok=True)
            shutil.copy(src, flight_dir / f"{row['source']}-{src.name}")
    # Span tails + their optional profile artifacts (ISSUE 20) ride
    # along the same way the flight dumps do: the bundle must stay
    # readable after ft_dir is cleaned.
    spans_dir = out / "spans"
    for row in report.get("span_tails") or []:
        for src in (row.get("path"), row.get("profile")):
            if src and Path(src).is_file():
                spans_dir.mkdir(parents=True, exist_ok=True)
                shutil.copy(src, spans_dir / Path(src).name)
    (out / "report.md").write_text(render_postmortem(report) + "\n")
    return out


def render_postmortem(report: dict) -> str:
    """The human summary (``report.md`` and the CLI's default output)."""
    inc = report["incident"]
    label = inc.get("action") or "unresolved"
    if inc.get("planned"):
        label += ", planned"
    lines = [f"# postmortem — incident {inc['incident']} ({label})",
             "",
             f"run dir: {report['run_dir']}",
             f"detected at: {report['detect_ts']}",
             f"downtime_s: {inc.get('downtime_s')}  "
             f"detection_s: {inc.get('detection_s')}  "
             f"fleet_step: {inc.get('fleet_step')}  "
             f"lost_steps: {inc.get('lost_steps')}"]
    if inc.get("planned"):
        lines.append("planned restart: preemption notice drained into a "
                     "clean stop — this downtime was chosen, not suffered")
    shrink = inc.get("shrink")
    if shrink:
        lines.append(
            f"elastic shrink: {shrink.get('from_hosts')} -> "
            f"{shrink.get('to_hosts')} hosts "
            f"(lost {shrink.get('lost')}, contract generation "
            f"{shrink.get('generation')})")
    ckpt = inc.get("ckpt")
    if ckpt:
        lines.append(
            f"checkpoint retry: step {ckpt.get('bad_step')} failed to "
            f"restore and was blacklisted; resumed from "
            f"{ckpt.get('retry_from')}")
    detect = next((e for e in report["events"]
                   if e.get("kind") == "detect"), None)
    if detect and detect.get("failures"):
        lines += ["", "## failures"]
        lines.append(render_table(detect["failures"],
                                  ["host", "kind", "rc", "step", "detail"]))
    if report["heartbeats"]:
        lines += ["", "## last heartbeat before detection"]
        lines.append(render_table(
            report["heartbeats"],
            ["host", "step", "age_at_detect_s", "pid", "role"]))
    if report["flight"]:
        lines += ["", "## flight-recorder coverage"]
        lines.append(render_table(
            report["flight"],
            ["host", "source", "samples", "dropped", "gap_to_detect_s"]))
    if report.get("span_tails"):
        lines += ["", "## span tails captured at detect"]
        lines.append(render_table(
            [{**r, "profiled": bool(r.get("profile"))}
             for r in report["span_tails"]],
            ["host", "events", "profiled"]))
    gp = report["goodput"]
    if gp["num_hosts"]:
        lines += ["", f"## goodput over the window "
                      f"({report['window']['window_s']:g}s around the "
                      "incident)"]
        rows = [{"bucket": b, "seconds": v}
                for b, v in gp["buckets"].items() if v]
        lines.append(render_table(rows, ["bucket", "seconds"]))
    n = len(report["timeline"])
    skewed = sum(1 for s in report["clock_skew_s"].values() if s)
    probed = len(report.get("clock_offsets") or {})
    lines += ["", f"## timeline: {n} events in window "
                  f"(skew-corrected; {skewed} host(s) adjusted, "
                  f"{probed} from measured /clock probes) — "
                  "timeline.jsonl"]
    for note in report["notes"]:
        lines.append(f"NOTE: {note}")
    return "\n".join(lines)


# -- bundle diffing (ISSUE 20 satellite) ------------------------------------

def _read_bundle(d: str | Path) -> dict:
    """One :func:`write_bundle` directory parsed back (missing pieces
    degrade to empty, same contract as assembly — a diff of two bundles
    must survive either being partial)."""
    d = Path(d)

    def _json(name: str, default):
        p = d / name
        if not p.is_file():
            return default
        try:
            return json.loads(p.read_text())
        except json.JSONDecodeError:
            return default

    timeline = []
    p = d / "timeline.jsonl"
    if p.is_file():
        for line in p.read_text().splitlines():
            try:
                timeline.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return {"path": str(d),
            "incident": _json("incident.json", {}),
            "goodput": _json("goodput.json", {}),
            "heartbeats": _json("heartbeats.json", []),
            "timeline": timeline}


def diff_bundles(a_dir: str | Path, b_dir: str | Path) -> dict:
    """Two postmortem bundles of the SAME incident class diffed like
    goodput ledger rows (``b - a``): what did the second incident do
    differently?  Sections:

    * ``incident`` — action/planned/downtime/detection/lost-step deltas,
      with ``class_match`` False (and a note) when the two incidents
      are different classes (action+planned differ) — the deltas are
      still printed, the caller just can't read them as a regression;
    * ``buckets`` — the windows' goodput bucket seconds, normalized to
      shares of each bundle's own window so different window widths
      still compare;
    * ``hosts`` — per-host heartbeat-age-at-detect and timeline span
      count deltas (union of hosts, either side may miss one).
    """
    a, b = _read_bundle(a_dir), _read_bundle(b_dir)
    ia = (a["incident"].get("incident") or {})
    ib = (b["incident"].get("incident") or {})
    cls_a = (ia.get("action"), bool(ia.get("planned")))
    cls_b = (ib.get("action"), bool(ib.get("planned")))
    notes = []
    if cls_a != cls_b:
        notes.append(
            f"incident classes differ ({cls_a[0]}/planned={cls_a[1]} vs "
            f"{cls_b[0]}/planned={cls_b[1]}) — deltas below compare "
            "unlike incidents")

    def _delta(key):
        x, y = ia.get(key), ib.get(key)
        return {"a": x, "b": y,
                "delta": (round(y - x, 6)
                          if isinstance(x, (int, float))
                          and isinstance(y, (int, float)) else None)}

    incident = {
        "a_incident": ia.get("incident"), "b_incident": ib.get("incident"),
        "class_match": cls_a == cls_b,
        "action": {"a": cls_a[0], "b": cls_b[0]},
        "downtime_s": _delta("downtime_s"),
        "detection_s": _delta("detection_s"),
        "lost_steps": _delta("lost_steps"),
    }

    def _shares(g):
        buckets = g.get("buckets") or {}
        total = sum(v for v in buckets.values()
                    if isinstance(v, (int, float))) or None
        return {k: (v / total if total else None)
                for k, v in buckets.items()
                if isinstance(v, (int, float))}

    sa, sb = _shares(a["goodput"]), _shares(b["goodput"])
    buckets = []
    for name in sorted(set(sa) | set(sb)):
        x, y = sa.get(name), sb.get(name)
        buckets.append({"bucket": name, "a_share": x, "b_share": y,
                        "delta": (round(y - x, 6)
                                  if x is not None and y is not None
                                  else None)})

    def _hb_age(bundle):
        return {h.get("host"): h.get("age_at_detect_s")
                for h in bundle["heartbeats"] if h.get("host") is not None}

    def _span_counts(bundle):
        out: dict[int, int] = {}
        for e in bundle["timeline"]:
            h = e.get("host")
            if h is not None:
                out[h] = out.get(h, 0) + 1
        return out

    ha, hb = _hb_age(a), _hb_age(b)
    ca, cb = _span_counts(a), _span_counts(b)
    hosts = []
    for h in sorted(set(ha) | set(hb) | set(ca) | set(cb)):
        ax, bx = ha.get(h), hb.get(h)
        hosts.append({
            "host": h,
            "a_hb_age_s": ax, "b_hb_age_s": bx,
            "hb_age_delta_s": (round(bx - ax, 3)
                               if isinstance(ax, (int, float))
                               and isinstance(bx, (int, float)) else None),
            "a_spans": ca.get(h, 0), "b_spans": cb.get(h, 0),
            "span_delta": cb.get(h, 0) - ca.get(h, 0)})

    return {"a": a["path"], "b": b["path"], "incident": incident,
            "buckets": buckets, "hosts": hosts, "notes": notes,
            "window_s": {"a": (a["incident"].get("window") or {})
                         .get("window_s"),
                         "b": (b["incident"].get("window") or {})
                         .get("window_s")}}


def render_bundle_diff(diff: dict) -> str:
    """Human rendering of :func:`diff_bundles` (``tpucfn forensics
    diff``)."""
    inc = diff["incident"]
    lines = [f"# forensics diff — incident {inc['a_incident']} "
             f"({Path(diff['a']).name}) vs incident {inc['b_incident']} "
             f"({Path(diff['b']).name})"]
    if not inc["class_match"]:
        lines.append("WARNING: different incident classes — read deltas "
                     "as context, not regression")
    lines.append(
        f"action: {inc['action']['a']} vs {inc['action']['b']}")
    for key in ("downtime_s", "detection_s", "lost_steps"):
        d = inc[key]
        lines.append(f"{key}: {d['a']} vs {d['b']}"
                     + (f"  (delta {d['delta']:+g})"
                        if d["delta"] is not None else ""))
    if diff["buckets"]:
        lines += ["", "## goodput bucket shares over each bundle's window"]
        lines.append(render_table(
            diff["buckets"], ["bucket", "a_share", "b_share", "delta"]))
    if diff["hosts"]:
        lines += ["", "## per-host deltas (heartbeat age at detect, "
                      "timeline events)"]
        lines.append(render_table(
            diff["hosts"],
            ["host", "a_hb_age_s", "b_hb_age_s", "hb_age_delta_s",
             "a_spans", "b_spans", "span_delta"]))
    for note in diff["notes"]:
        lines.append(f"NOTE: {note}")
    return "\n".join(lines)
