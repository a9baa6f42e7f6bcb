"""Goodput accounting: where did the fleet's paid card-seconds go?

The port of ``tpucfn/obs/goodput.py``: the per-run ledger that splits
each host's wall clock into named buckets,

    productive_step  optimizer steps that advanced the run
    compile          the first step of each process incarnation (the
                     kernel libraries loaded, built or fetched; split
                     into compile_cached / compile_fetched by the
                     CompileCacheProbe)
    data_wait        the step loop blocked on the input pipeline
    ckpt             checkpoint save calls
    lost_work        steps re-run after a rewind to the latest
                     checkpoint (paid twice, credited once)
    restart_downtime gaps between one incarnation's last ledger record
                     and the next incarnation's first
    idle             whatever of the window's wall no bucket claims

which sum to the host's wall span by construction (``idle`` and
``restart_downtime`` are residuals).  The write side is
:class:`GoodputLedger`, one append-only ``goodput-host{NNN}.jsonl`` per
host under ``<run_dir>/goodput``, which the port's loop
(``examples/common.py:run_train_loop``) opens and hands to
``TrainerObs``; the read side (:func:`read_goodput_dir`,
:func:`merge_goodput`, :func:`goodput_report`, the windowed
:func:`fleet_window_observation` the provisioner policy reads, the
cross-run ledger and :func:`render_goodput`) backs ``python -m
tpucfn_torch.cli obs goodput`` and ``obs diff``.

Every definition and constant here but the peak table is a copy held
equal to the JAX package's by ``tests/test_torch_isolation.py``.  The
peak table is the port's own: the JAX package lists TPU generations,
this one the card the port runs on.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from pathlib import Path
from typing import Iterable

# Buckets the writer records explicitly; idle / lost_work /
# restart_downtime are derived by the merge.  ``compile_cached`` is a
# first step whose kernel libraries came from the kernel directory or
# the local artifact store, ``compile_fetched`` one whose libraries a
# fleet peer served (``TrainerObs`` asks the CompileCacheProbe), so warm
# restarts do not inflate ``compile``.
RECORDED_BUCKETS = ("step", "compile", "compile_cached", "compile_fetched",
                    "data_wait", "ckpt", "act", "learn", "refresh")
DERIVED_BUCKETS = ("idle", "lost_work", "restart_downtime")
# ``act``/``learn``/``refresh`` are the RL plane's phases in the JAX
# package; an RL run records those instead of ``step``.
REPORT_BUCKETS = ("productive_step", "compile", "compile_cached",
                  "compile_fetched", "data_wait", "ckpt", "act", "learn",
                  "refresh", "lost_work", "idle", "restart_downtime")

LEDGER_GLOB = "goodput-host*.jsonl"

# Record kinds of the per-host ledger files: "window" opens a process
# incarnation, "phase" attributes one bucketed duration, "close" ends an
# incarnation cleanly.  The cross-run regression ledger (``--ledger``)
# has its own row kind.  The static check's vocabulary rule reads these
# tuples, so a mistyped literal in a reader or writer is a finding.
LEDGER_KINDS = ("window", "phase", "close")
LEDGER_ROW_KINDS = ("goodput_run",)


def ledger_path(d: str | Path, host_id: int) -> Path:
    return Path(d) / f"goodput-host{host_id:03d}.jsonl"


# --------------------------------------------------------------------------
# cost-analysis helpers (the live-MFU side)
# --------------------------------------------------------------------------

def cost_analysis_value(cost, key: str) -> float | None:
    """One value from a ``compiled.cost_analysis()`` result.

    jax <= 0.4.x returns a per-device LIST of dicts, >= 0.5 a single
    dict — the one unwrap the live gauges and bench.py share; ``None``
    when the backend reports nothing (CPU fallback, mock devices).
    """
    if isinstance(cost, (list, tuple)):
        cost = cost[0] if cost else None
    try:
        v = cost.get(key) if cost else None
    except AttributeError:
        return None
    return float(v) if v else None


def cost_analysis_flops(cost) -> float | None:
    """Per-device FLOPs from a ``compiled.cost_analysis()`` result."""
    return cost_analysis_value(cost, "flops")


# Peak dense bf16 TFLOP/s by a substring of torch.cuda.get_device_name(),
# from the public specification: NVIDIA H100 SXM (the H100 80GB HBM3) at
# 989 at its full 700 W.  Differs from the JAX package's TPU table.
PEAK_BF16_TFLOPS = (
    ("h100 80gb hbm3", 989.0),
)


def device_peak_flops(device_kind: str) -> float | None:
    """Peak FLOP/s (not TFLOP/s) for ``device_kind``, or None for
    devices without a published peak (CPU hosts: MFU stays unset rather
    than lying)."""
    kind = device_kind.lower()
    for key, tflops in PEAK_BF16_TFLOPS:
        if key in kind:
            return tflops * 1e12
    return None


# --------------------------------------------------------------------------
# write side
# --------------------------------------------------------------------------

class GoodputLedger:
    """Per-host goodput JSONL writer (see module doc for the schema).

    Opens in append mode and immediately writes a ``window`` marker: a
    restarted incarnation appending to the same file is exactly how the
    merge learns where downtime gaps are.  ``GoodputLedger(None)`` is a
    full no-op so instrumentation points can call unconditionally.
    """

    def __init__(self, d: str | Path | None, host_id: int = 0, *,
                 role: str = "trainer", clock=time.time,
                 pid: int | None = None):
        self.host_id = host_id
        self.role = role
        self.clock = clock
        self.path: Path | None = None
        self._f = None
        self._lock = threading.Lock()
        if d is not None:
            dd = Path(d)
            dd.mkdir(parents=True, exist_ok=True)
            self.path = ledger_path(dd, host_id)
            # Line-buffered append, one write per record — a reader never
            # sees a torn line except at a crash boundary (tolerated).
            self._f = open(self.path, "a", buffering=1)
            self._write({"kind": "window", "host": host_id, "role": role,
                         "pid": os.getpid() if pid is None else pid})

    @property
    def enabled(self) -> bool:
        return self._f is not None

    def _write(self, rec: dict) -> None:
        rec.setdefault("t", self.clock())
        line = json.dumps(rec)
        with self._lock:
            if self._f is not None:
                self._f.write(line + "\n")

    def account(self, bucket: str, dur_s: float, *,
                step: int | None = None) -> None:
        """Attribute ``dur_s`` seconds to ``bucket`` (one of
        ``RECORDED_BUCKETS``; unknown buckets are written as-is and
        merged into ``idle``-adjacent custom columns by nobody — keep to
        the vocabulary)."""
        if self._f is None:
            return
        rec = {"kind": "phase", "bucket": bucket, "dur_s": float(dur_s),
               "host": self.host_id}
        if step is not None:
            rec["step"] = int(step)
        self._write(rec)

    def close(self) -> None:
        if self._f is None:
            return
        self._write({"kind": "close", "host": self.host_id})
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# --------------------------------------------------------------------------
# read side
# --------------------------------------------------------------------------

def parse_jsonl_line(line: str | bytes) -> dict | None:
    """The ONE tolerant JSONL line rule every counting reader shares
    (here and aggregate.JsonlTailer): bytes decode with U+FFFD
    replacement, parse failures and non-dict records -> None — the
    caller counts the skip.  Corruption confined to a JSON string
    value still parses (as U+FFFD text) and the record survives;
    structural corruption is what this rejects without raising."""
    if isinstance(line, bytes):
        line = line.decode("utf-8", errors="replace")
    try:
        rec = json.loads(line)
    except json.JSONDecodeError:
        return None
    return rec if isinstance(rec, dict) else None


def read_jsonl_counting(path: str | Path) -> tuple[list[dict], int]:
    """All records of one JSONL; torn/undecodable lines are skipped AND
    counted (the file may still be appended to, or its writer died
    mid-line), non-UTF-8 bytes tolerated — never raised on."""
    out: list[dict] = []
    skipped = 0
    try:
        with open(path, encoding="utf-8", errors="replace") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rec = parse_jsonl_line(line)
                if rec is None:
                    skipped += 1
                else:
                    out.append(rec)
    except OSError:
        return [], 0
    return out, skipped


def host_id_from_path(p: str | Path) -> int | None:
    """``...host{NNN}.jsonl`` -> ``NNN``, or None when the stem doesn't
    parse.  Every per-host-file reader (ledgers here, heartbeats in the
    CLI) goes through this so the naming convention lives in one place."""
    try:
        return int(Path(p).stem.rsplit("host", 1)[1])
    except (IndexError, ValueError):
        return None


def read_goodput_dir(d: str | Path) -> tuple[dict[int, list[dict]], int]:
    """``host_id -> [records]`` for every ledger under ``d`` plus the
    total count of torn/skipped lines.  Missing/empty dir -> ``({}, 0)``
    — the merge renders an empty report, it does not raise."""
    by_host: dict[int, list[dict]] = {}
    skipped = 0
    dd = Path(d)
    if not dd.is_dir():
        return by_host, skipped
    for p in sorted(dd.glob(LEDGER_GLOB)):
        host = host_id_from_path(p)
        if host is None:
            skipped += 1
            continue
        recs, sk = read_jsonl_counting(p)
        skipped += sk
        if recs:
            by_host[host] = recs
    return by_host, skipped


def read_ft_events(path: str | Path) -> tuple[list[dict], int]:
    """The ft plane's ``events.jsonl`` (torn-tolerant, counted)."""
    p = Path(path)
    if not p.is_file():
        return [], 0
    return read_jsonl_counting(p)


def host_goodput(records: Iterable[dict]) -> dict:
    """Decompose one host's ledger into the bucket report.

    Windows are delimited by ``window`` markers; within a window the
    wall is ``last record t − window t`` and ``idle`` is the residual
    after the recorded phases.  Gaps BETWEEN windows are
    ``restart_downtime``.  A ``step``-bucket record whose step number
    does not exceed the largest step already seen is a post-rewind
    re-run and lands in ``lost_work`` instead of ``productive_step``.
    """
    buckets = {b: 0.0 for b in REPORT_BUCKETS}
    windows: list[dict] = []
    cur: dict | None = None
    max_step = None
    productive_steps = 0
    lost_steps = 0
    lost_occurrences: list[dict] = []
    malformed = 0

    def _close_window(end_t: float) -> None:
        nonlocal cur
        if cur is None:
            return
        wall = max(0.0, end_t - cur["start"])
        idle = max(0.0, wall - cur["accounted"])
        buckets["idle"] += idle
        windows.append({"start": cur["start"], "end": end_t,
                        "wall_s": wall, "idle_s": idle})
        cur = None

    for rec in records:
        t = rec.get("t")
        # json.loads accepts the non-standard NaN/Infinity constants, and
        # one NaN accumulated here poisons every downstream sum AND makes
        # the --json output unparseable by strict readers — non-finite is
        # malformed, same as missing.
        if not isinstance(t, (int, float)) or not math.isfinite(t):
            malformed += 1
            continue
        kind = rec.get("kind")
        if kind == "window":
            if cur is not None:
                # previous incarnation died without a close record: its
                # window ends at its last seen t.
                _close_window(cur["last"])
            if windows:
                # the gap since the previous incarnation's end — whether
                # it closed cleanly or died mid-write — is downtime.
                buckets["restart_downtime"] += max(
                    0.0, t - windows[-1]["end"])
            cur = {"start": t, "last": t, "accounted": 0.0}
        elif kind == "phase":
            if cur is None:  # torn head: phase before any window marker
                cur = {"start": t, "last": t, "accounted": 0.0}
            # Any phase record with a finite t is liveness evidence and
            # extends the window, malformed dur/bucket or not — a torn
            # final record must not shrink the window and inflate the
            # next incarnation's restart_downtime.
            cur["last"] = max(cur["last"], t)
            dur = rec.get("dur_s")
            if (not isinstance(dur, (int, float))
                    or not math.isfinite(dur) or dur < 0):
                malformed += 1
                continue
            bucket = rec.get("bucket")
            if bucket not in RECORDED_BUCKETS:
                malformed += 1
                continue
            cur["accounted"] += dur
            step = rec.get("step")
            if bucket == "step":
                if (step is not None and max_step is not None
                        and step <= max_step):
                    buckets["lost_work"] += dur
                    lost_steps += 1
                    lost_occurrences.append({"step": step, "t": t})
                else:
                    buckets["productive_step"] += dur
                    productive_steps += 1
                if step is not None:
                    max_step = step if max_step is None else max(max_step,
                                                                 step)
            else:  # compile* / data_wait / ckpt
                buckets[bucket] += dur
                # compile of a re-run window still advances max_step so
                # the re-run detector has the right horizon
                if bucket in ("compile", "compile_cached",
                              "compile_fetched") and step is not None:
                    max_step = step if max_step is None else max(max_step,
                                                                 step)
        elif kind == "close":
            if cur is not None:
                cur["last"] = max(cur["last"], t)
                _close_window(cur["last"])
        else:
            malformed += 1
    if cur is not None:
        _close_window(cur["last"])

    wall = (windows[-1]["end"] - windows[0]["start"]) if windows else 0.0
    accounted = sum(buckets.values())
    return {
        "wall_s": wall,
        "buckets": buckets,
        "accounted_s": accounted,
        # residual beyond the derived fillers: float noise only, by
        # construction — the invariant the acceptance test pins.
        "unaccounted_s": wall - accounted,
        "windows": len(windows),
        "productive_steps": productive_steps,
        "lost_steps": lost_steps,
        "lost_occurrences": lost_occurrences,
        "malformed_records": malformed,
        "goodput_ratio": (buckets["productive_step"] / wall) if wall > 0
        else None,
    }


def _incidents_from_events(events: Iterable[dict]) -> list[dict]:
    """Incident attribution rows from the ft plane's events.jsonl.

    Prefers the coordinator's enriched ``goodput_incident`` records;
    falls back to pairing ``detect``/``recovered`` (older event files)
    using recovered's ``mttr_s`` as the downtime.  An incident that
    never recovered — the coordinator gave up (budget exhausted) or
    observed-only — still gets a row: its action comes from the
    ``give_up``/``decide`` event and its downtime is unknown (None),
    because the run ended with it.  Dropping it would hide exactly the
    incident whose cost was the whole tail of the run.
    """
    enriched: dict[int, dict] = {}
    detects: dict[int, dict] = {}
    recovered: dict[int, dict] = {}
    give_ups: dict[int, dict] = {}
    decides: dict[int, dict] = {}
    for e in events:
        kind, inc = e.get("kind"), e.get("incident")
        if inc is None:
            continue
        if kind == "goodput_incident":
            enriched[inc] = e
        elif kind == "detect":
            detects[inc] = e
        elif kind == "recovered":
            recovered[inc] = e
        elif kind == "give_up":
            give_ups[inc] = e
        elif kind == "decide":
            decides[inc] = e
    out = []
    for inc in sorted(set(detects) | set(enriched)):
        if inc in enriched:
            e = enriched[inc]
            out.append({"incident": inc, "action": e.get("action"),
                        "ts": e.get("ts"),
                        "downtime_s": e.get("downtime_s"),
                        "detection_s": e.get("detection_s"),
                        "fleet_step": e.get("fleet_step"),
                        "lost_steps": e.get("lost_steps"),
                        # graceful-degradation fields (ISSUE 7): a
                        # planned drain must not read as a downtime
                        # regression; shrink/ckpt carry the N→N-1 and
                        # retried-step detail the renderers show.
                        "planned": bool(e.get("planned", False)),
                        "shrink": e.get("shrink"),
                        "ckpt": e.get("ckpt"),
                        # adopted-coordinator recovery (ISSUE 13
                        # satellite): how much of the downtime was
                        # journal replay — measured by the adopter,
                        # attributed here instead of vanishing into
                        # the restart_downtime residual.
                        "journal_replay_ms": e.get("journal_replay_ms")})
        elif inc in recovered:
            out.append({"incident": inc,
                        "action": recovered[inc].get("action"),
                        "ts": recovered[inc].get("ts"),
                        "downtime_s": recovered[inc].get("mttr_s"),
                        "detection_s": None, "fleet_step": None,
                        "lost_steps": None,
                        "planned": bool(recovered[inc].get("planned",
                                                           False)),
                        "shrink": recovered[inc].get("shrink"),
                        "ckpt": recovered[inc].get("ckpt"),
                        "journal_replay_ms":
                            recovered[inc].get("journal_replay_ms")})
        else:
            e = give_ups.get(inc) or decides.get(inc) or detects[inc]
            action = ("give_up" if inc in give_ups
                      else e.get("action"))
            out.append({"incident": inc, "action": action,
                        "ts": e.get("ts"), "downtime_s": None,
                        "detection_s": None, "fleet_step": None,
                        "lost_steps": None, "planned": False,
                        "shrink": None, "ckpt": None,
                        "journal_replay_ms": None})
    return out


def merge_goodput(by_host: dict[int, list[dict]],
                  ft_events: Iterable[dict] = (),
                  skipped_lines: int = 0) -> dict:
    """Fleet goodput report: per-host decompositions plus the fleet
    average (per-host-mean seconds, so fleet buckets still sum to the
    fleet wall) and the incident attribution rows.

    Hosts with no parseable records are dropped and counted
    (``hosts_empty``) — skip-and-count, never raise.
    """
    hosts = {}
    empty = 0
    for host_id in sorted(by_host):
        rep = host_goodput(by_host[host_id])
        if rep["windows"] == 0:
            empty += 1
            continue
        hosts[host_id] = rep

    fleet_buckets = {b: 0.0 for b in REPORT_BUCKETS}
    n = len(hosts)
    wall = 0.0
    if n:
        for rep in hosts.values():
            wall += rep["wall_s"]
            for b in REPORT_BUCKETS:
                fleet_buckets[b] += rep["buckets"][b]
        wall /= n
        fleet_buckets = {b: v / n for b, v in fleet_buckets.items()}
    incidents = _incidents_from_events(ft_events)
    # Per-incident lost-step attribution: the coordinator cannot know
    # at recovery time how many steps the rewind will cost — the
    # re-runs happen AFTER its goodput_incident event is written — so
    # the ledger answers here, binning by TIME: a re-run executes after
    # its causing incident's recovery (the event's wall ``ts``) and
    # before the next incident's.  Step-number binning would miscredit
    # a later rewind that crosses an earlier incident's fleet_step
    # (incident 1 at step 10 losing nothing, incident 2 rewinding to
    # step 5 — steps 6..10 belong to incident 2).
    occ_times = sorted(o["t"] for rep in hosts.values()
                       for o in rep["lost_occurrences"])
    timed = sorted((i for i in incidents
                    if i.get("ts") is not None
                    and i["lost_steps"] is None),
                   key=lambda i: i["ts"])
    for inc in timed:
        inc["lost_steps"] = 0
    for t in occ_times:
        owner = None
        for inc in timed:
            if inc["ts"] <= t:
                owner = inc
            else:
                break
        if owner is None and timed:
            owner = timed[0]  # clock skew placed the re-run pre-detect
        if owner is not None:
            owner["lost_steps"] += 1
    # lost_occurrences only feeds the binning above: one {step, t} per
    # re-run step is unbounded payload in --json/watch-cached reports,
    # and no renderer reads it (render_goodput shows counts).
    for rep in hosts.values():
        rep.pop("lost_occurrences", None)
    accounted = sum(fleet_buckets.values())
    return {
        "hosts": {str(h): rep for h, rep in hosts.items()},
        "num_hosts": n,
        "hosts_empty": empty,
        "skipped_lines": skipped_lines,
        "wall_s": wall,
        "buckets": fleet_buckets,
        "accounted_s": accounted,
        "unaccounted_s": wall - accounted,
        "goodput_ratio": (fleet_buckets["productive_step"] / wall)
        if wall > 0 else None,
        "productive_steps": sum(r["productive_steps"]
                                for r in hosts.values()),
        "lost_steps": sum(r["lost_steps"] for r in hosts.values()),
        "restart_downtime_s": fleet_buckets["restart_downtime"],
        "lost_work_s": fleet_buckets["lost_work"],
        "incidents": incidents,
        "incident_downtime_s": sum(i["downtime_s"] or 0.0
                                   for i in incidents),
        # Drained preemptions are restarts the fleet CHOSE to make
        # (ISSUE 7) — regression tracking should watch the unplanned
        # number, with the planned share reported alongside.
        "unplanned_downtime_s": sum(i["downtime_s"] or 0.0
                                    for i in incidents
                                    if not i.get("planned")),
        # Of the restart downtime, how much was the adopted
        # coordinator replaying its journal (ISSUE 13 satellite) —
        # the crash-safety plane's own MTTR cost, named.
        "journal_replay_ms": sum(i.get("journal_replay_ms") or 0.0
                                 for i in incidents),
    }


def goodput_report(goodput_dir: str | Path,
                   ft_events_path: str | Path | None = None) -> dict:
    """One-call read+merge: the ``tpucfn obs goodput`` entry point."""
    by_host, skipped = read_goodput_dir(goodput_dir)
    events: list[dict] = []
    if ft_events_path is not None:
        events, ev_skipped = read_ft_events(ft_events_path)
        skipped += ev_skipped
    return merge_goodput(by_host, events, skipped_lines=skipped)


def fleet_window_observation(goodput_dir: str | Path, *,
                             since_t: float | None = None) -> dict | None:
    """Live windowed view of the fleet ledgers for the provisioner
    policy loop (ISSUE 18): bucket *shares* of wall since ``since_t``
    (wall clock, the same clock ledger records carry in ``t``).

    Unlike :func:`merge_goodput` — the end-of-run postmortem — this is
    read mid-run, repeatedly, over ledgers still being appended to, and
    the caller cares about the RECENT window only: a policy must not
    keep acting on starvation that an earlier actuation already fixed.
    Filtering by ``t`` (not by incarnation) is what makes "the window
    since my last actuation" expressible.

    Per host: phase records with finite ``t >= since_t``; the host wall
    is the ``t``-span of its in-window records; ``idle`` is the
    residual.  Shares are averaged across hosts (the same merge rule as
    :func:`merge_goodput`).  Returns ``None`` when no host has a
    usable window (empty dir, all records filtered, zero wall) — the
    policy treats that as "no evidence", never as "healthy".
    """
    by_host, _ = read_goodput_dir(goodput_dir)
    per_host: list[dict] = []
    for records in by_host.values():
        lo = hi = None
        buckets = {b: 0.0 for b in RECORDED_BUCKETS}
        for rec in records:
            t = rec.get("t")
            if not isinstance(t, (int, float)) or not math.isfinite(t):
                continue
            if since_t is not None and t < since_t:
                continue
            lo = t if lo is None else min(lo, t)
            hi = t if hi is None else max(hi, t)
            if rec.get("kind") != "phase":
                continue
            dur = rec.get("dur_s")
            bucket = rec.get("bucket")
            if (isinstance(dur, (int, float)) and math.isfinite(dur)
                    and dur >= 0 and bucket in buckets):
                buckets[bucket] += dur
        if lo is None or hi is None:
            continue
        wall = hi - lo
        if wall <= 0:
            continue
        shares = {b: min(1.0, v / wall) for b, v in buckets.items()}
        shares["idle"] = max(0.0, 1.0 - sum(shares.values()))
        per_host.append({"wall_s": wall, "shares": shares})
    if not per_host:
        return None
    n = len(per_host)
    share_names = set()
    for h in per_host:
        share_names.update(h["shares"])
    shares = {b: sum(h["shares"].get(b, 0.0) for h in per_host) / n
              for b in sorted(share_names)}
    return {
        "wall_s": sum(h["wall_s"] for h in per_host) / n,
        "shares": shares,
        "goodput_ratio": shares.get("step", 0.0),
        "num_hosts": n,
    }


def append_goodput_ledger(path: str | Path, report: dict, *,
                          run_dir: str = "", extra: dict | None = None
                          ) -> Path:
    """Cross-run regression ledger (ISSUE 6 satellite): append ONE
    BENCH-row-style JSON line per run to ``path`` so goodput_ratio and
    bucket shares can be diffed across PRs — a perf change that trades
    step time for data stalls is invisible to MFU alone but obvious
    here.  ``tpucfn obs diff`` compares the last two rows."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    wall = report.get("wall_s") or 0.0
    buckets = report.get("buckets") or {}
    row = {
        "kind": "goodput_run",
        "t": time.time(),
        "run_dir": run_dir,
        "wall_s": wall,
        "goodput_ratio": report.get("goodput_ratio"),
        "num_hosts": report.get("num_hosts"),
        "productive_steps": report.get("productive_steps"),
        "lost_steps": report.get("lost_steps"),
        "incidents": len(report.get("incidents") or ()),
        "planned_incidents": sum(
            1 for i in (report.get("incidents") or ())
            if i.get("planned")),
        "unplanned_downtime_s": report.get("unplanned_downtime_s"),
        "journal_replay_ms": report.get("journal_replay_ms"),
        "buckets": dict(buckets),
        "shares": {b: (v / wall if wall > 0 else None)
                   for b, v in buckets.items()},
        **(extra or {}),
    }
    with open(p, "a") as f:
        f.write(json.dumps(row) + "\n")
    return p


def read_goodput_ledger(path: str | Path) -> tuple[list[dict], int]:
    """The ledger's ``goodput_run`` rows in file order (torn/foreign
    lines skipped and counted — the file is append-shared)."""
    recs, skipped = read_jsonl_counting(path)
    rows = [r for r in recs if r.get("kind") == "goodput_run"]
    skipped += len(recs) - len(rows)
    return rows, skipped


def diff_goodput_rows(prev: dict, last: dict) -> dict:
    """Bucket-share and goodput-ratio deltas between two ledger rows
    (``last - prev``; positive share delta = that bucket ate MORE of the
    wall).  Buckets are the union of both rows, REPORT_BUCKETS order
    first so the table reads the same as ``tpucfn obs goodput``."""
    ps, ls = prev.get("shares") or {}, last.get("shares") or {}
    names = [b for b in REPORT_BUCKETS if b in ps or b in ls]
    names += sorted((set(ps) | set(ls)) - set(names))
    rows = []
    for b in names:
        a, z = ps.get(b), ls.get(b)
        rows.append({"bucket": b, "prev_share": a, "last_share": z,
                     "delta": (z - a) if (a is not None and z is not None)
                     else None})
    pr, lr = prev.get("goodput_ratio"), last.get("goodput_ratio")
    return {
        "prev": {"t": prev.get("t"), "run_dir": prev.get("run_dir"),
                 "goodput_ratio": pr, "wall_s": prev.get("wall_s")},
        "last": {"t": last.get("t"), "run_dir": last.get("run_dir"),
                 "goodput_ratio": lr, "wall_s": last.get("wall_s")},
        "goodput_ratio_delta": (lr - pr) if (pr is not None
                                             and lr is not None) else None,
        "buckets": rows,
    }


def render_goodput(report: dict) -> str:
    """Human rendering of :func:`merge_goodput` (tables live in
    aggregate.render_table; this adds the bucket bar summary)."""
    from tpucfn_torch.obs.aggregate import render_table

    lines = [f"# goodput  hosts={report['num_hosts']} "
             f"wall={report['wall_s']:.2f}s "
             f"goodput_ratio="
             + (f"{report['goodput_ratio']:.3f}"
                if report["goodput_ratio"] is not None else "n/a")]
    wall = report["wall_s"] or math.inf
    rows = [{"bucket": b, "seconds": report["buckets"][b],
             "share": report["buckets"][b] / wall}
            for b in REPORT_BUCKETS]
    lines.append(render_table(rows, ["bucket", "seconds", "share"]))
    host_rows = [{"host": h,
                  "wall_s": rep["wall_s"],
                  "productive_s": rep["buckets"]["productive_step"],
                  "lost_work_s": rep["buckets"]["lost_work"],
                  "downtime_s": rep["buckets"]["restart_downtime"],
                  "steps": rep["productive_steps"],
                  "lost_steps": rep["lost_steps"],
                  "windows": rep["windows"],
                  "goodput": rep["goodput_ratio"]}
                 for h, rep in sorted(report["hosts"].items(),
                                      key=lambda kv: int(kv[0]))]
    if host_rows:
        lines.append("")
        lines.append(render_table(host_rows, [
            "host", "wall_s", "productive_s", "lost_work_s", "downtime_s",
            "steps", "lost_steps", "windows", "goodput"]))
    if report["incidents"]:
        lines.append("")
        planned = sum(1 for i in report["incidents"] if i.get("planned"))
        lines.append(
            "== incidents =="
            + (f"  ({planned} planned; unplanned downtime "
               f"{report.get('unplanned_downtime_s', 0.0):.2f}s)"
               if planned else ""))
        lines.append(render_table(report["incidents"], [
            "incident", "action", "planned", "downtime_s", "detection_s",
            "fleet_step", "lost_steps"]))
    if report["skipped_lines"] or report["hosts_empty"]:
        lines.append(f"\n(skipped {report['skipped_lines']} torn lines, "
                     f"{report['hosts_empty']} empty hosts)")
    return "\n".join(lines)
