"""Durable coordinator run journal — the supervisor's write-ahead log.

The :class:`~tpucfn.ft.coordinator.GangCoordinator` is the component
that makes every other plane of the harness survive its failures — and
until ISSUE 12 it was itself the last single point of failure: its
restart budget, incident counter, host incarnations, and drain state
lived only in memory, so a coordinator crash orphaned a healthy fleet
and lost all failure-handling state.  This module is the durable half
of the fix:

* **Write-ahead journal** — :class:`JournalWriter` appends one
  checksummed, fsync'd record per coordinator state transition to
  ``<ft_dir>/journal/journal.jsonl`` *before* the transition's action
  runs.  Records carry a contiguous ``seq`` so replay can tell a torn
  tail (tolerated — the crash boundary) from a corrupt middle
  (refused loudly — that journal is lying).
* **Replay** — :func:`replay_journal` folds any prefix of the record
  stream into a consistent :class:`CoordinatorState`: budget used,
  incident counter, live host→pid incarnations, finished hosts, any
  restart intent that never saw its commit (the mid-flight incident a
  restarted coordinator must finish exactly once), shrinks, ckpt
  blacklist, input-host restart counts.
* **Adoption plumbing** — :class:`AdoptedProcess` wraps a re-discovered
  child pid in the ``Popen`` duck-type the coordinator and
  ``Launcher.stop_all`` already speak (a restarted coordinator is not
  the parent of the fleet it adopts, so ``waitpid`` is unavailable;
  liveness comes from ``kill(pid, 0)`` and exit codes from the rc
  files the ``--supervise`` reaper writes — see
  :mod:`tpucfn.launch.supervise`).
* **Crash points** — :func:`crash_point` is the deterministic
  crash-injection hook the crash-safety tests use: set
  ``TPUCFN_CRASH_AT=<label>`` and the process SIGKILLs itself the
  first time it passes that label (a marker file makes it once-ever
  per ft_dir, so the relaunched incarnation survives the same label).

jax-free on purpose: the coordinator, the supervise loop, and the
analyzer all import it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import time
import zlib
from pathlib import Path
from typing import Callable

# Canonical vocabulary of journal record kinds (the ``*_KINDS`` naming
# opts into the vocab-drift rule of ``tpucfn check``, like EVENT_KINDS).
JOURNAL_KINDS = (
    "run_start",        # fresh run: argv, hosts, policy, budget max
    "launching",        # spawn imminent for these hosts (pids unknown yet)
    "gang_launched",    # whole-gang (re)launch committed: host→pid map
    "solo_launched",    # one host relaunched: host, pid
    "host_exit",        # a supervised rank left the process table: host, rc
    "incident_open",    # detect: incident number + failure set
    "restart_intent",   # decide committed to act: action, hosts, budget_used
    "restart_commit",   # the act finished; the incident is closed
    "incident_closed",  # observe-only incident closed without an act
    "drain_armed",      # drain file written for a drain_restart intent
    "give_up",          # incident ended the run: rc
    "shrink",           # contract re-converged at N-k: lost, to_hosts
    "ckpt_retry",       # corruption retry: bad_step, blacklist
    "input_degraded",   # input host left the table (no incident)
    "input_restarted",  # input host solo-relaunched: host, restarts
    "provision_decision",  # policy verdict on a goodput window (ISSUE 18)
    "provision_shrink",    # input hosts stopped back to reserved
    "straggler_probation",  # guard fired for a host (eviction inbound)
    "chaos_fired",      # a scripted chaos event fired: index into the spec
    "adopted",          # a restarted coordinator attached to this journal
    "snapshot",         # compaction: a full CoordinatorState, journal's head
    "done",             # the run ended: rc
)

# Compaction threshold (ISSUE 15 satellite): at adoption, a journal
# longer than this folds its replayed state into one checksummed
# `snapshot` record, so week-long runs replay O(recent) instead of
# O(run lifetime).
JOURNAL_COMPACT_RECORDS = 4096

CRASH_AT_ENV = "TPUCFN_CRASH_AT"


class JournalError(RuntimeError):
    """A non-final journal record is torn, checksum-corrupt, or out of
    sequence — the journal cannot be trusted and adoption must refuse
    loudly instead of reconstructing a plausible-but-wrong state."""


def journal_path(ft_dir: str | Path) -> Path:
    return Path(ft_dir) / "journal" / "journal.jsonl"


def repair_torn_tail(path: str | Path) -> bool:
    """Truncate a torn FINAL record (the tolerated crash boundary)
    before appending to an adopted journal: ``JournalWriter`` opens in
    append mode, and writing after a partial line would glue the new
    record onto the torn bytes — one garbled line that is no longer
    final, which the NEXT replay would refuse as corruption.  Returns
    True when bytes were dropped.  A bad record that is not final
    raises :class:`JournalError`, same as replay."""
    p = Path(path)
    try:
        data = p.read_bytes()
    except OSError:
        return False
    lines = data.split(b"\n")
    offsets = []  # (start, end-incl-newline) per line
    off = 0
    for raw in lines:
        offsets.append((off, min(off + len(raw) + 1, len(data))))
        off += len(raw) + 1
    content = [i for i, raw in enumerate(lines) if raw.strip()]
    end = 0  # byte offset just past the last valid record line
    for i in content:
        if decode_record(lines[i].decode("utf-8", "replace")) is None:
            if i == content[-1]:  # torn final record: the crash boundary
                break
            raise JournalError(
                f"journal record at byte {offsets[i][0]} of {p} fails "
                "its checksum but is not the final record — refusing to "
                "repair a corrupt journal")
        end = offsets[i][1]
    if end == len(data):
        return False
    with open(p, "r+b") as f:
        f.truncate(end)
    return True


def rotate_journal(path: str | Path) -> Path | None:
    """Move an existing journal aside (``journal-prev.jsonl``) so a
    fresh run starts a fresh log — the previous run's history stays on
    disk for forensics, but can never be adopted by accident."""
    p = Path(path)
    if not p.exists():
        return None
    dst = p.with_name("journal-prev.jsonl")
    p.replace(dst)
    return dst


# -- record encoding --------------------------------------------------------
#
# One line per record: ``<crc32 hex8> <payload json>``.  The checksum
# covers the payload bytes, so a torn tail (partial final line) and a
# flipped bit both fail validation — position in the file decides
# whether that is tolerated (final record: the crash boundary) or fatal
# (anywhere else: corruption).


def encode_record(rec: dict) -> str:
    payload = json.dumps(rec, separators=(",", ":"), sort_keys=True)
    return f"{zlib.crc32(payload.encode()):08x} {payload}\n"


def decode_record(line: str) -> dict | None:
    """The record, or None when the line fails framing/checksum/json —
    the caller decides whether None is a torn tail or corruption."""
    line = line.rstrip("\n")
    if len(line) < 10 or line[8] != " ":
        return None
    crc_hex, payload = line[:8], line[9:]
    try:
        if int(crc_hex, 16) != zlib.crc32(payload.encode()):
            return None
        rec = json.loads(payload)
    except (ValueError, json.JSONDecodeError):
        return None
    return rec if isinstance(rec, dict) else None


class JournalWriter:
    """Appends checksummed records, fsync'd before :meth:`append`
    returns — the write-ahead property: by the time the coordinator
    acts on a transition, the transition survives the coordinator."""

    def __init__(self, path: str | Path, *, start_seq: int = 0,
                 fsync: bool = True):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.seq = int(start_seq)
        self.fsync = fsync
        # An existing file can end WITHOUT a newline (a crash can
        # truncate at any byte — including exactly at the final
        # record's newline, leaving a VALID record that repair_torn_tail
        # rightly keeps).  Appending straight after it would glue the
        # next record onto that line; terminate it first.
        needs_nl = False
        try:
            with open(self.path, "rb") as rf:
                rf.seek(-1, os.SEEK_END)
                needs_nl = rf.read(1) != b"\n"
        except OSError:
            pass  # missing or empty: nothing to terminate
        self._f = open(self.path, "a")
        if needs_nl:
            self._f.write("\n")
            self._f.flush()

    def append(self, kind: str, **fields) -> dict:
        if kind not in JOURNAL_KINDS:
            raise ValueError(
                f"journal kind {kind!r} is not in JOURNAL_KINDS — add it to "
                "the canonical tuple (and replay) or fix the typo")
        if self._f is None:
            raise JournalError("journal writer is closed")
        self.seq += 1
        rec = {"seq": self.seq, "ts": time.time(), "kind": kind, **fields}
        self._f.write(encode_record(rec))
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())
        return rec

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# -- replay -----------------------------------------------------------------


@dataclasses.dataclass
class PendingIntent:
    """A journaled ``restart_intent`` whose ``restart_commit`` never
    landed: the coordinator crashed mid-act.  ``launched`` tells the
    adopter whether the relaunch half already happened (launch records
    after the intent) — redo the act when False, only write the commit
    when True; either way the restart happens exactly once."""

    incident: int
    action: str
    hosts: tuple[int, ...]
    seq: int
    planned: bool = False
    launched: bool = False
    _solo_done: set[int] = dataclasses.field(default_factory=set)


@dataclasses.dataclass
class CoordinatorState:
    """What a journal prefix reconstructs.  Every field has a safe
    zero value, so replaying an empty (or torn-to-empty) journal is a
    valid no-history state rather than an error."""

    seq: int = 0
    started: bool = False
    argv: list[str] | None = None
    max_restarts: int | None = None
    budget_used: int = 0
    incident: int = 0
    # Hosts with a ``launching`` record but no pid record yet: the
    # coordinator died inside the spawn window (ISSUE 13 satellite —
    # the PR 12 hazard).  Their processes may exist without any journal
    # trace, so adoption must give their first heartbeat a grace period
    # before relaunching over them.
    launching: set[int] = dataclasses.field(default_factory=set)
    procs: dict[int, int] = dataclasses.field(default_factory=dict)
    # Per-host kernel start time of the journaled pid (ISSUE 15
    # satellite, closing the PR 12 cross-reboot hazard): a (pid,
    # starttime) pair survives pid recycling — an adopter that finds
    # the pid alive but with a DIFFERENT start time is looking at an
    # unrelated process, and the rank must read as dead-unwatched.
    proc_starts: dict[int, int] = dataclasses.field(default_factory=dict)
    finished: dict[int, int] = dataclasses.field(default_factory=dict)
    pending: PendingIntent | None = None
    done_rc: int | None = None
    shrinks: list[list[int]] = dataclasses.field(default_factory=list)
    input_restarts: dict[int, int] = dataclasses.field(default_factory=dict)
    ckpt_blacklist: set[int] = dataclasses.field(default_factory=set)
    ckpt_retries: int = 0
    probation: set[int] = dataclasses.field(default_factory=set)
    chaos_fired: set[int] = dataclasses.field(default_factory=set)
    adoptions: int = 0

    def apply(self, rec: dict) -> None:
        seq = int(rec.get("seq", 0))
        if rec.get("kind") == "snapshot":
            # Compaction head (ISSUE 15 satellite): the folded state of
            # every record it replaced.  Only valid as the FIRST record
            # — a snapshot mid-stream means someone spliced journals.
            if self.seq != 0 or self.started:
                raise JournalError(
                    "journal snapshot record is not the first record — "
                    "refusing a spliced journal")
            self.restore(rec.get("state") or {})
            self.seq = seq
            return
        if seq != self.seq + 1:
            raise JournalError(
                f"journal sequence gap: record seq {seq} after {self.seq} — "
                "a middle record is missing or corrupt")
        self.seq = seq
        k = rec.get("kind")
        if k == "run_start":
            self.started = True
            self.argv = rec.get("argv")
            self.max_restarts = rec.get("max_restarts")
        elif k == "launching":
            self.launching.update(int(h) for h in rec.get("hosts") or ())
        elif k == "gang_launched":
            self.procs = {int(h): int(p)
                          for h, p in (rec.get("pids") or {}).items()}
            self.proc_starts = {
                int(h): int(s)
                for h, s in (rec.get("starts") or {}).items()
                if s is not None}
            self.launching.clear()
            if self.pending is not None:
                # A whole-gang launch completes ANY pending act — even a
                # solo intent: the only solo intent a gang launch follows
                # is one the elastic-shrink path upgraded to a gang
                # relaunch (the lost host left the contract), and redoing
                # it solo would double-restart fresh ranks at host_ids
                # the re-converged contract no longer has.
                self.pending.launched = True
        elif k == "solo_launched":
            self.procs[int(rec["host"])] = int(rec["pid"])
            if rec.get("start") is not None:
                self.proc_starts[int(rec["host"])] = int(rec["start"])
            else:
                self.proc_starts.pop(int(rec["host"]), None)
            self.launching.discard(int(rec["host"]))
            self.finished.pop(int(rec["host"]), None)
            if self.pending is not None \
                    and self.pending.action == "solo_restart":
                self.pending._solo_done.add(int(rec["host"]))
                if self.pending._solo_done >= set(self.pending.hosts):
                    self.pending.launched = True
        elif k == "host_exit":
            h = int(rec["host"])
            self.procs.pop(h, None)
            self.proc_starts.pop(h, None)
            self.launching.discard(h)
            self.finished[h] = int(rec.get("rc") or 0)
        elif k == "incident_open":
            self.incident = max(self.incident, int(rec.get("incident", 0)))
        elif k == "restart_intent":
            self.pending = PendingIntent(
                incident=int(rec.get("incident", self.incident)),
                action=str(rec.get("action", "")),
                hosts=tuple(int(h) for h in rec.get("hosts") or ()),
                seq=seq, planned=bool(rec.get("planned", False)))
            self.budget_used = max(self.budget_used,
                                   int(rec.get("budget_used", 0)))
        elif k in ("restart_commit", "incident_closed", "give_up"):
            self.pending = None
        elif k == "shrink":
            self.shrinks.append([int(h) for h in rec.get("lost") or ()])
        elif k == "ckpt_retry":
            self.ckpt_retries += 1
            self.ckpt_blacklist.update(
                int(s) for s in rec.get("blacklist") or ())
        elif k == "input_degraded":
            h = int(rec["host"])
            self.procs.pop(h, None)
            self.proc_starts.pop(h, None)
            self.finished.setdefault(h, 0)
        elif k == "input_restarted":
            self.input_restarts[int(rec["host"])] = int(
                rec.get("restarts", 1))
        elif k == "straggler_probation":
            self.probation.add(int(rec["host"]))
        elif k == "chaos_fired":
            self.chaos_fired.add(int(rec["index"]))
        elif k == "adopted":
            self.adoptions += 1
        elif k == "done":
            self.done_rc = int(rec.get("rc") or 0)
        # "drain_armed" mutates nothing replayable: the drain file on
        # disk is the durable artifact, and the pending intent already
        # carries the drain_restart action.

    # -- snapshot (de)serialization (ISSUE 15 compaction satellite) --------

    def to_json(self) -> dict:
        p = self.pending
        return {
            "seq": self.seq,
            "started": self.started,
            "argv": self.argv,
            "max_restarts": self.max_restarts,
            "budget_used": self.budget_used,
            "incident": self.incident,
            "launching": sorted(self.launching),
            "procs": {str(h): p_ for h, p_ in self.procs.items()},
            "proc_starts": {str(h): s for h, s in self.proc_starts.items()},
            "finished": {str(h): rc for h, rc in self.finished.items()},
            "pending": None if p is None else {
                "incident": p.incident, "action": p.action,
                "hosts": list(p.hosts), "seq": p.seq,
                "planned": p.planned, "launched": p.launched,
                "solo_done": sorted(p._solo_done)},
            "done_rc": self.done_rc,
            "shrinks": [list(s) for s in self.shrinks],
            "input_restarts": {str(h): n
                               for h, n in self.input_restarts.items()},
            "ckpt_blacklist": sorted(self.ckpt_blacklist),
            "ckpt_retries": self.ckpt_retries,
            "probation": sorted(self.probation),
            "chaos_fired": sorted(self.chaos_fired),
            "adoptions": self.adoptions,
        }

    def restore(self, state: dict) -> None:
        self.started = bool(state.get("started", False))
        self.argv = state.get("argv")
        self.max_restarts = state.get("max_restarts")
        self.budget_used = int(state.get("budget_used", 0))
        self.incident = int(state.get("incident", 0))
        self.launching = {int(h) for h in state.get("launching") or ()}
        self.procs = {int(h): int(p)
                      for h, p in (state.get("procs") or {}).items()}
        self.proc_starts = {
            int(h): int(s)
            for h, s in (state.get("proc_starts") or {}).items()}
        self.finished = {int(h): int(rc)
                         for h, rc in (state.get("finished") or {}).items()}
        p = state.get("pending")
        self.pending = None if p is None else PendingIntent(
            incident=int(p.get("incident", 0)),
            action=str(p.get("action", "")),
            hosts=tuple(int(h) for h in p.get("hosts") or ()),
            seq=int(p.get("seq", 0)),
            planned=bool(p.get("planned", False)),
            launched=bool(p.get("launched", False)),
            _solo_done={int(h) for h in p.get("solo_done") or ()})
        self.done_rc = state.get("done_rc")
        self.shrinks = [[int(h) for h in s]
                        for s in state.get("shrinks") or ()]
        self.input_restarts = {
            int(h): int(n)
            for h, n in (state.get("input_restarts") or {}).items()}
        self.ckpt_blacklist = {int(s)
                               for s in state.get("ckpt_blacklist") or ()}
        self.ckpt_retries = int(state.get("ckpt_retries", 0))
        self.probation = {int(h) for h in state.get("probation") or ()}
        self.chaos_fired = {int(i) for i in state.get("chaos_fired") or ()}
        self.adoptions = int(state.get("adoptions", 0))


def compact_journal(path: str | Path, *,
                    max_records: int = JOURNAL_COMPACT_RECORDS,
                    replayed: tuple[CoordinatorState, int] | None = None
                    ) -> bool:
    """Fold a long journal into one checksummed ``snapshot`` record so
    replay stays O(recent) on week-long runs (ISSUE 15 satellite).

    Run at adoption (after :func:`repair_torn_tail`) or at any quiet
    moment: when the record count exceeds ``max_records``, the replayed
    :class:`CoordinatorState` is written as a single ``snapshot``
    record (same seq — appends continue contiguously) via
    tmp-fsync-rename, so a crash mid-compaction leaves either the old
    or the new journal, never neither.  The pre-compaction bytes move
    to ``journal-compacted.jsonl`` for forensics (one generation kept).
    A finished (``done``) journal is rotation's business, not ours; a
    corrupt journal raises exactly like replay.  ``replayed`` is the
    caller's already-built ``(state, record_count)`` — adoption just
    replayed the whole journal, and re-parsing it here would double
    the O(N) cost exactly when the journal is at its largest.  Returns
    True when bytes were folded."""
    p = Path(path)
    if not p.exists():
        return False
    if replayed is not None:
        st, n_records = replayed
    else:
        st, records, _torn = replay_journal(p)
        n_records = len(records)
    if n_records <= max_records or not st.started \
            or st.done_rc is not None:
        return False
    rec = {"seq": st.seq, "ts": time.time(), "kind": "snapshot",
           "state": st.to_json()}
    tmp = p.with_name("journal.compact.tmp")
    with open(tmp, "w") as f:
        f.write(encode_record(rec))
        f.flush()
        os.fsync(f.fileno())
    try:
        # forensics first (best-effort copy — losing it costs history,
        # not correctness), then the atomic swap
        p.with_name("journal-compacted.jsonl").write_bytes(p.read_bytes())
    except OSError:
        pass
    tmp.replace(p)
    return True


def replay_journal(path: str | Path
                   ) -> tuple[CoordinatorState, list[dict], bool]:
    """``(state, records, torn)`` for one journal file.  A torn/corrupt
    FINAL record is dropped (``torn=True``) — that is the crash
    boundary the format is designed around.  A bad record anywhere
    else raises :class:`JournalError`: the journal is corrupt and a
    plausible partial replay would be worse than a loud refusal."""
    state = CoordinatorState()
    records: list[dict] = []
    try:
        lines = Path(path).read_text().splitlines()
    except OSError:
        return state, records, False
    torn = False
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        rec = decode_record(line)
        if rec is None:
            if i == len(lines) - 1:
                torn = True
                break
            raise JournalError(
                f"journal record at line {i + 1} of {path} fails its "
                "checksum but is not the final record — the journal is "
                "corrupt; refusing to reconstruct state from it")
        state.apply(rec)
        records.append(rec)
    return state, records, torn


# -- crash injection --------------------------------------------------------


def crash_point(label: str, marker_dir: str | Path | None = None) -> None:
    """Deterministic crash injection for crash-safety tests: when
    ``TPUCFN_CRASH_AT`` names this label, SIGKILL ourselves — but only
    once per ``marker_dir`` (the marker file is fsync'd *before* the
    kill, so the relaunched incarnation sees it and survives the same
    label).  A no-op in production (env unset)."""
    if os.environ.get(CRASH_AT_ENV, "") != label:
        return
    if marker_dir is not None:
        marker = Path(marker_dir) / f"crashed-{label}"
        if marker.exists():
            return
        marker.parent.mkdir(parents=True, exist_ok=True)
        with open(marker, "w") as f:
            f.write(str(os.getpid()))
            f.flush()
            os.fsync(f.fileno())
    os.kill(os.getpid(), signal.SIGKILL)


# -- adopted children -------------------------------------------------------


def pid_alive(pid: int) -> bool:
    """Best-effort liveness for a process we are not the parent of.
    A recycled pid can alias a dead child to alive — pair with
    :func:`pid_start_time` (the journaled identity) where a false
    positive would be adopted-and-later-killed, not merely observed."""
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def pid_start_time(pid: int) -> int | None:
    """The kernel start time of ``pid`` (clock ticks since boot,
    ``/proc/<pid>/stat`` field 22).  The (pid, starttime) pair is a
    process identity pid recycling cannot forge: across a machine
    reboot — or just a long downtime — the same pid number names a
    DIFFERENT process, and an adopter trusting the pid alone would
    attach to (and later SIGKILL) an unrelated victim.  ``None`` when
    unreadable (no /proc, process gone): identity checking degrades to
    the plain pid, never blocks adoption on a platform quirk."""
    try:
        data = Path(f"/proc/{pid}/stat").read_bytes()
    except OSError:
        return None
    # comm (field 2) is parenthesized and may itself contain spaces or
    # parens — parse from the LAST ')'; starttime is field 22, i.e.
    # index 19 of the post-comm tail (which starts at field 3).
    tail = data.rsplit(b")", 1)[-1].split()
    try:
        return int(tail[19])
    except (IndexError, ValueError):
        return None


def rc_dir(ft_dir: str | Path) -> Path:
    return Path(ft_dir) / "rc"


def rc_path(ft_dir: str | Path, pid: int) -> Path:
    return rc_dir(ft_dir) / f"rc-{pid}.json"


def write_rc(ft_dir: str | Path, pid: int, rc: int) -> Path:
    """The ``--supervise`` reaper's half of the adoption contract: when
    an orphaned grandchild (a rank whose coordinator died) is reaped,
    its real exit status lands here so the adopting coordinator can
    tell a clean exit from a crash (``waitpid`` is the parent's
    privilege, and the adopter is not the parent)."""
    d = rc_dir(ft_dir)
    d.mkdir(parents=True, exist_ok=True)
    p = rc_path(ft_dir, pid)
    tmp = p.with_suffix(".tmp")
    tmp.write_text(json.dumps({"pid": int(pid), "rc": int(rc),
                               "ts": time.time()}))
    tmp.replace(p)
    return p


def read_rc(ft_dir: str | Path, pid: int) -> int | None:
    try:
        rec = json.loads(rc_path(ft_dir, pid).read_text())
    except (OSError, json.JSONDecodeError):
        return None
    rc = rec.get("rc")
    return int(rc) if isinstance(rc, int) else None


def clear_rc_dir(ft_dir: str | Path) -> None:
    d = rc_dir(ft_dir)
    if not d.is_dir():
        return
    for p in d.glob("rc-*.json"):
        try:
            p.unlink()
        except OSError:
            pass


class AdoptedProcess:
    """``Popen`` duck-type over a re-discovered child pid.

    The adopting coordinator is not the parent of the fleet it adopts,
    so there is no ``waitpid``: liveness is ``kill(pid, 0)`` and the
    exit code comes from the supervise reaper's rc file.  When the
    process is gone and no rc file appears within ``rc_grace_s`` (bare
    ``--adopt`` without a supervisor, or the reaper lost the race),
    the exit degrades to the signal we sent it — or to rc 1 (an
    unexplained death is a failure, never silently clean)."""

    def __init__(self, pid: int, *, host_id: int | None = None,
                 ft_dir: str | Path | None = None, rc_grace_s: float = 2.0,
                 start_time: int | None = None,
                 clock: Callable[[], float] = time.monotonic):
        # ``start_time`` is the JOURNALED (pid, starttime) identity
        # (ISSUE 15 satellite): when given, a live pid whose current
        # start time disagrees is a RECYCLED pid — an unrelated process
        # this handle must treat as the dead rank it replaced, and must
        # never signal.
        self.pid = int(pid)
        self.host_id = host_id
        self.ft_dir = ft_dir
        self.rc_grace_s = float(rc_grace_s)
        self.start_time = start_time
        self.clock = clock
        self.returncode: int | None = None
        self._sent: int | None = None  # last signal we delivered
        self._dead_at: float | None = None

    def _alive(self) -> bool:
        if not pid_alive(self.pid):
            return False
        if self.start_time is not None:
            cur = pid_start_time(self.pid)
            if cur is not None and cur != self.start_time:
                return False  # recycled pid: an unrelated live process
        return True

    def _signal(self, sig: int) -> None:
        if self.start_time is not None and not self._alive():
            # never signal a recycled pid — the number now names an
            # innocent process that is not ours to kill
            return
        try:
            os.kill(self.pid, sig)
            self._sent = sig
        except ProcessLookupError:
            pass

    def terminate(self) -> None:
        self._signal(signal.SIGTERM)

    def kill(self) -> None:
        self._signal(signal.SIGKILL)

    def poll(self) -> int | None:
        if self.returncode is not None:
            return self.returncode
        if self._alive():
            return None
        rc = None if self.ft_dir is None else read_rc(self.ft_dir, self.pid)
        if rc is None:
            now = self.clock()
            if self._dead_at is None:
                self._dead_at = now
            if now - self._dead_at < self.rc_grace_s \
                    and self._sent is None and self.ft_dir is not None:
                return None  # give the reaper a beat to land the rc file
            rc = -self._sent if self._sent is not None else 1
        self.returncode = rc
        return rc

    def wait(self, timeout: float | None = None) -> int:
        deadline = None if timeout is None else self.clock() + timeout
        while True:
            rc = self.poll()
            if rc is not None:
                return rc
            if deadline is not None and self.clock() >= deadline:
                raise TimeoutError(
                    f"adopted pid {self.pid} still alive after {timeout}s")
            time.sleep(0.02)
