"""Per-host heartbeat writing + fleet liveness classification.

The failure-detection layer of the fault-tolerance plane (ISSUE 4): every
rank appends one JSON line per interval to its own heartbeat file under a
shared directory (the same shippable-file transport the metrics and trace
JSONL already use — no new wire protocol), and a :class:`HeartbeatMonitor`
anywhere with filesystem visibility (the gang coordinator, ``tpucfn ft
status``, a ``/healthz`` probe) classifies each host:

    LIVE      fresh heartbeat, step keeping up with the fleet
    STRAGGLER fresh heartbeat, but ``straggler_step_lag`` steps behind
              the fleet max (alive ≠ making progress)
    SUSPECT   heartbeat older than ``suspect_after_s`` (or none yet,
              within the startup grace window)
    DEAD      heartbeat older than ``dead_after_s``, or still absent
              after the grace window

Heartbeat line schema (one JSON object per line, append-only)::

    {"host_id": 1, "pid": 4242, "step": 1200, "t": <time.time()>,
     "seq": 17, "role": "trainer"}

``t`` is wall-clock on purpose: writer and monitor are different
processes (often after a restart), so monotonic clocks do not compare.
Every timing input is injectable (``clock``) so the classifier is tested
against a fake clock with zero sleeps.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import os
import re
import threading
import time
from pathlib import Path
from typing import Callable

# The heartbeat file-naming convention in its three forms — writer
# (heartbeat_path), reader regex, and directory glob (used by the
# `tpucfn obs` skew-reference ingestion).  They MUST agree; renaming
# one without the others silently degrades skew estimation to its
# span fallback.
_HB_FILE = re.compile(r"^hb-host(\d+)\.jsonl$")
HB_GLOB = "hb-host*.jsonl"

# Read at most this much of a heartbeat file's tail per observe() — the
# monitor only needs the last line, and the files grow for the whole run.
_TAIL_BYTES = 8192


def heartbeat_path(ft_dir: str | Path, host_id: int) -> Path:
    return Path(ft_dir) / f"hb-host{host_id:03d}.jsonl"


class HeartbeatWriter:
    """Appends one heartbeat line per interval for this process.

    ``beat()`` writes immediately; ``start()`` runs beats on a daemon
    thread so liveness keeps flowing while the train loop is inside a
    long step or compile (the loop only has to call
    :meth:`update_step` — cheap, lock-free attribute store — for the
    step-lag signal to stay current).
    """

    def __init__(self, ft_dir: str | Path, host_id: int, *,
                 interval_s: float = 1.0, role: str = "",
                 clock: Callable[[], float] = time.time,
                 pid: int | None = None):
        self.host_id = host_id
        self.interval_s = float(interval_s)
        self.role = role
        self.clock = clock
        self.pid = os.getpid() if pid is None else pid
        self.step: int | None = None
        self._seq = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        d = Path(ft_dir)
        d.mkdir(parents=True, exist_ok=True)
        self.path = heartbeat_path(d, host_id)
        # Line-buffered append: each beat is one write() of one line, so
        # a reader never sees a torn line except at a crash boundary
        # (which read_heartbeats tolerates).
        self._f = open(self.path, "a", buffering=1)

    def update_step(self, step: int) -> None:
        self.step = int(step)

    def beat(self, step: int | None = None) -> dict:
        if step is not None:
            self.update_step(step)
        with self._lock:
            if self._f is None:
                return {}
            self._seq += 1
            rec = {"host_id": self.host_id, "pid": self.pid,
                   "step": self.step, "t": self.clock(), "seq": self._seq,
                   "role": self.role}
            self._f.write(json.dumps(rec) + "\n")
            return rec

    def start(self) -> "HeartbeatWriter":
        if self._thread is None:
            self.beat()  # first beat before the interval elapses
            self._thread = threading.Thread(
                target=self._run, daemon=True,
                name=f"tpucfn-hb:host{self.host_id}")
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.beat()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


def read_heartbeat_file(path: str | Path) -> dict | None:
    """Last valid heartbeat record of one host file (None when the file
    is missing/empty).  Reads only the tail and skips a torn final line —
    the writer may be mid-append, or may have died mid-write."""
    p = Path(path)
    try:
        with open(p, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - _TAIL_BYTES))
            tail = f.read().decode("utf-8", errors="replace")
    except OSError:
        return None
    for line in reversed(tail.splitlines()):
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue  # torn write at the crash/read boundary
        if isinstance(rec, dict) and "t" in rec:
            return rec
    return None


def read_heartbeats(ft_dir: str | Path) -> dict[int, dict]:
    """host_id → latest record for every ``hb-host*.jsonl`` under
    ``ft_dir`` (the file name wins over the record's host_id field — a
    copied file must not impersonate another host)."""
    out: dict[int, dict] = {}
    d = Path(ft_dir)
    if not d.is_dir():
        return out
    for p in sorted(d.iterdir()):
        m = _HB_FILE.match(p.name)
        if not m:
            continue
        rec = read_heartbeat_file(p)
        if rec is not None:
            out[int(m.group(1))] = rec
    return out


class HostState(enum.Enum):
    LIVE = "LIVE"
    STRAGGLER = "STRAGGLER"
    SUSPECT = "SUSPECT"
    DEAD = "DEAD"


@dataclasses.dataclass(frozen=True)
class MonitorConfig:
    """Classification thresholds, all in seconds/steps.

    ``suspect_after_s``/``dead_after_s`` default to 3x/6x the heartbeat
    interval: one missed beat is scheduling noise, three is a problem,
    six is a verdict.  ``startup_grace_s`` covers interpreter + runtime
    start before the first beat (a freshly launched gang must not be
    declared dead while jax imports)."""

    interval_s: float = 1.0
    suspect_after_s: float | None = None
    dead_after_s: float | None = None
    straggler_step_lag: int = 100
    startup_grace_s: float | None = None

    @property
    def suspect_s(self) -> float:
        return (self.suspect_after_s if self.suspect_after_s is not None
                else 3.0 * self.interval_s)

    @property
    def dead_s(self) -> float:
        return (self.dead_after_s if self.dead_after_s is not None
                else 6.0 * self.interval_s)

    @property
    def grace_s(self) -> float:
        return (self.startup_grace_s if self.startup_grace_s is not None
                else 10.0 * self.interval_s)


@dataclasses.dataclass(frozen=True)
class HostVerdict:
    host_id: int
    state: HostState
    age_s: float | None  # None: no heartbeat seen yet
    step: int | None
    pid: int | None
    reason: str = ""


@dataclasses.dataclass(frozen=True)
class FleetView:
    t: float  # monitor clock at observation
    hosts: tuple[HostVerdict, ...]

    def by_host(self) -> dict[int, HostVerdict]:
        return {v.host_id: v for v in self.hosts}

    def counts(self) -> dict[str, int]:
        c = {s.value: 0 for s in HostState}
        for v in self.hosts:
            c[v.state.value] += 1
        return c

    def max_step(self) -> int | None:
        steps = [v.step for v in self.hosts if v.step is not None]
        return max(steps) if steps else None

    def in_state(self, *states: HostState) -> list[HostVerdict]:
        return [v for v in self.hosts if v.state in states]

    def healthy(self) -> tuple[bool, dict]:
        """The ``/healthz`` tuple: healthy while no host is DEAD (a
        STRAGGLER or a transient SUSPECT degrades detail, not status —
        the restart supervisor decides on those, probes should not flap
        a load balancer over one missed beat)."""
        counts = self.counts()
        detail = {"hosts": len(self.hosts), "fleet": counts,
                  "max_step": self.max_step()}
        return counts[HostState.DEAD.value] == 0, detail


class HeartbeatMonitor:
    """Classifies every host under one heartbeat dir (see module doc).

    ``expected_hosts`` adds absent-file detection: a host that never
    produced a heartbeat file is SUSPECT within the startup grace window
    and DEAD after it.  Without it, only hosts that have written at
    least once are judged.
    """

    def __init__(self, ft_dir: str | Path,
                 expected_hosts: int | list[int] | None = None, *,
                 config: MonitorConfig = MonitorConfig(),
                 clock: Callable[[], float] = time.time):
        self.ft_dir = Path(ft_dir)
        if isinstance(expected_hosts, int):
            expected_hosts = list(range(expected_hosts))
        self.expected_hosts = (None if expected_hosts is None
                               else sorted(expected_hosts))
        self.config = config
        self.clock = clock
        self._t0 = clock()
        # chaos-injected heartbeat delay: host → (extra_age_s, until_t)
        self._injected_delay: dict[int, tuple[float, float]] = {}
        # hosts that exited cleanly (the coordinator retires them): no
        # longer judged, or their aging last beat would flip /healthz to
        # 503 for the rest of an otherwise healthy run
        self._retired: set[int] = set()

    def retire_host(self, host_id: int) -> None:
        """Stop judging ``host_id`` — its rank finished cleanly, so its
        heartbeat going stale is retirement, not death."""
        self._retired.add(host_id)

    def set_expected_hosts(self, expected: int | list[int] | None) -> None:
        """Re-scope the judged fleet (elastic shrink, ISSUE 7): after the
        gang re-converges at N-1 the old highest id's heartbeat file
        still exists on disk, and without re-scoping its aging last beat
        would read as a phantom hang of a host the contract no longer
        has."""
        if isinstance(expected, int):
            expected = list(range(expected))
        self.expected_hosts = (None if expected is None
                               else sorted(expected))

    def activate_host(self, host_id: int) -> None:
        """Re-judge ``host_id`` (a retired slot was relaunched)."""
        self._retired.discard(host_id)

    def restart_grace(self, now: float | None = None) -> None:
        """Re-arm the startup grace window (the coordinator calls this
        right after a (re)launch: stale heartbeats from the previous
        incarnation must not instantly re-condemn the fresh gang)."""
        self._t0 = self.clock() if now is None else now

    def inject_heartbeat_delay(self, host_id: int, extra_age_s: float,
                               *, until: float | None = None,
                               duration_s: float | None = None) -> None:
        """Chaos hook (ft/chaos.py ``delay_heartbeats``): make ``host_id``'s
        heartbeats look ``extra_age_s`` older than they are until
        ``until`` (absolute monitor-clock time) or for ``duration_s``."""
        if until is None:
            until = self.clock() + (duration_s if duration_s is not None
                                    else float("inf"))
        self._injected_delay[host_id] = (float(extra_age_s), until)

    def _verdict(self, host_id: int, rec: dict | None,
                 now: float, fleet_max_step: int | None) -> HostVerdict:
        cfg = self.config
        if rec is None:
            age_from_start = now - self._t0
            if age_from_start <= cfg.grace_s:
                return HostVerdict(host_id, HostState.SUSPECT, None, None,
                                   None, "no heartbeat yet (startup grace)")
            return HostVerdict(host_id, HostState.DEAD, None, None, None,
                               f"no heartbeat after {cfg.grace_s:.1f}s grace")
        age = now - float(rec["t"])
        delay = self._injected_delay.get(host_id)
        if delay is not None:
            extra, until = delay
            if now < until:
                age += extra
            else:
                # pop, not del: observe() runs concurrently from the
                # coordinator loop AND /healthz scrape threads — two
                # callers may both see the entry expired.
                self._injected_delay.pop(host_id, None)
        step = rec.get("step")
        pid = rec.get("pid")
        if age > cfg.dead_s:
            return HostVerdict(host_id, HostState.DEAD, age, step, pid,
                               f"heartbeat {age:.1f}s old > {cfg.dead_s:.1f}s")
        if age > cfg.suspect_s:
            return HostVerdict(
                host_id, HostState.SUSPECT, age, step, pid,
                f"heartbeat {age:.1f}s old > {cfg.suspect_s:.1f}s")
        if (step is not None and fleet_max_step is not None
                and fleet_max_step - step > cfg.straggler_step_lag):
            return HostVerdict(
                host_id, HostState.STRAGGLER, age, step, pid,
                f"step {step} lags fleet max {fleet_max_step} by > "
                f"{cfg.straggler_step_lag}")
        return HostVerdict(host_id, HostState.LIVE, age, step, pid)

    def observe(self, now: float | None = None) -> FleetView:
        now = self.clock() if now is None else now
        recs = read_heartbeats(self.ft_dir)
        hosts = set(recs)
        if self.expected_hosts is not None:
            hosts |= set(self.expected_hosts)
        # copy: retire/activate run on the coordinator thread while
        # /healthz scrape threads observe concurrently
        hosts -= set(self._retired)
        steps = [r.get("step") for r in recs.values()
                 if r.get("step") is not None]
        fleet_max = max(steps) if steps else None
        verdicts = tuple(self._verdict(h, recs.get(h), now, fleet_max)
                         for h in sorted(hosts))
        return FleetView(t=now, hosts=verdicts)

    def health(self) -> tuple[bool, dict]:
        """Directly usable as ``obs.server`` ``health_fn`` — the monitor
        feeding the existing ``/healthz`` probe (ISSUE 4 tentpole)."""
        return self.observe().healthy()
