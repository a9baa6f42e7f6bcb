"""Preemption notices and the drain protocol (ISSUE 7).

TPU preemptions arrive with advance notice; this module is the
file-based contract that turns the notice into a *proactive* drain
instead of a surprise SIGKILL.  Two files, both under the shared
``TPUCFN_FT_DIR`` every rank already watches for heartbeats (same
shippable-file transport as the rest of the planes — no new wire
protocol):

``preempt.json``
    Written by whoever learns of the preemption first — a cloud notice
    daemon, an operator, or the chaos harness: ``{"host": 1,
    "lead_s": 30.0, "t": <wall>}``.  The coordinator consumes it
    (atomically renamed to ``preempt.consumed.json`` so one notice
    fires exactly once) and raises a ``FailureKind.PREEMPT`` for the
    named host.

``drain.json``
    Written by the coordinator when it decides to drain:
    ``{"step": 22, "t": <wall>}``.  Every rank checks
    :func:`drain_requested` once per step and stops cleanly — running
    UP TO the target step first, so a loosely-coupled gang converges on
    one boundary, the final force-save lands at that boundary, and the
    resumed run re-executes nothing (``lost_work == 0``).  A ``null``
    step means "stop at your next boundary" (the right semantics for a
    lockstep SPMD gang, which is always at one step).  The coordinator
    clears the file before relaunching — a relaunched gang must not
    immediately re-drain.

All writes are tmp+rename atomic so a rank polling mid-write never
parses a torn notice.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

NOTICE_FILE = "preempt.json"
NOTICE_CONSUMED_FILE = "preempt.consumed.json"
DRAIN_FILE = "drain.json"


@dataclasses.dataclass(frozen=True)
class PreemptNotice:
    host: int
    lead_s: float | None = None  # advance warning; None = unknown
    t: float | None = None       # when the notice was raised (wall)


def _atomic_write(path: Path, obj: dict) -> Path:
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_text(json.dumps(obj))
    tmp.replace(path)
    return path


# -- notices ---------------------------------------------------------------

def notice_path(ft_dir: str | Path) -> Path:
    return Path(ft_dir) / NOTICE_FILE


def write_notice(ft_dir: str | Path, host: int,
                 lead_s: float | None = None) -> Path:
    """External hook: how a cloud notice daemon (or a test) raises a
    preemption notice for ``host`` with ``lead_s`` of warning."""
    d = Path(ft_dir)
    d.mkdir(parents=True, exist_ok=True)
    return _atomic_write(notice_path(d), {
        "host": int(host),
        "lead_s": None if lead_s is None else float(lead_s),
        "t": time.time()})


def consume_notice(ft_dir: str | Path) -> PreemptNotice | None:
    """Read-and-retire the pending notice (None when there is none, or
    it is unparseable — consumed either way: a garbled notice must not
    re-fire every poll tick)."""
    p = notice_path(ft_dir)
    try:
        raw = p.read_text()
    except OSError:
        return None
    try:
        p.replace(p.with_name(NOTICE_CONSUMED_FILE))
    except OSError:
        try:
            p.unlink()
        except OSError:
            pass
    try:
        rec = json.loads(raw)
    except json.JSONDecodeError:
        return None
    if not isinstance(rec, dict) or not isinstance(rec.get("host"), int):
        return None
    lead = rec.get("lead_s")
    return PreemptNotice(
        host=rec["host"],
        lead_s=float(lead) if isinstance(lead, (int, float)) else None,
        t=rec.get("t") if isinstance(rec.get("t"), (int, float)) else None)


# -- drain -----------------------------------------------------------------

def drain_path(ft_dir: str | Path) -> Path:
    return Path(ft_dir) / DRAIN_FILE


def request_drain(ft_dir: str | Path, step: int | None = None) -> Path:
    """Coordinator side: ask every rank to stop cleanly once it reaches
    ``step`` (None = next boundary)."""
    d = Path(ft_dir)
    d.mkdir(parents=True, exist_ok=True)
    return _atomic_write(drain_path(d), {
        "step": None if step is None else int(step), "t": time.time()})


def clear_drain(ft_dir: str | Path) -> None:
    try:
        drain_path(ft_dir).unlink()
    except OSError:
        pass


def read_drain(ft_dir: str | Path) -> dict | None:
    p = drain_path(ft_dir)
    try:
        raw = p.read_text()
    except OSError:
        return None
    try:
        rec = json.loads(raw)
    except json.JSONDecodeError:
        return None
    return rec if isinstance(rec, dict) else None


def drain_requested(ft_dir: str | Path, step: int | None = None) -> bool:
    """Rank side: should this rank stop cleanly NOW?  Cheap when no
    drain is pending (one stat).  With a target step in the drain file,
    a rank behind the target keeps running until it reaches it — that is
    what converges a loosely-coupled gang onto one save boundary."""
    rec = read_drain(ft_dir)
    if rec is None:
        return False
    target = rec.get("step")
    if target is None or step is None:
        return True
    try:
        return int(step) >= int(target)
    except (TypeError, ValueError):
        return True
