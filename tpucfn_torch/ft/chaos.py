"""Deterministic fault injection — the chaos harness the recovery plane
is tested with.

A :class:`ChaosSpec` is a declarative schedule ("at second T / at fleet
step N: kill host k, hang host k for D seconds, delay heartbeats, corrupt
the latest checkpoint").  A :class:`ChaosEngine` replays it against a
:class:`ChaosTarget`:

* the gang coordinator's real subprocesses (SIGKILL / SIGSTOP+SIGCONT)
  — ft/coordinator.py implements the target over its process table;
* :class:`~tpucfn.provision.control_plane.FakeControlPlane` via
  :class:`ControlPlaneChaosTarget` (``kill_host`` flips the host record
  unhealthy, exercising the provisioning-side monitor/heal path).

Every random choice (unpinned victim host, corruption byte offsets)
comes from a ``random.Random`` seeded by the spec — no wall-clock
randomness anywhere, so a chaos run replays bit-for-bit (ISSUE 4
tentpole).  Time itself is injectable: the engine never reads a clock,
it is *told* the elapsed time and fleet step on each ``tick``.
"""

from __future__ import annotations

import dataclasses
import json
import random
import re
from pathlib import Path
from typing import Any

ACTIONS = ("kill", "hang", "delay_heartbeats", "corrupt_ckpt",
           "preempt_notice", "lose_host",
           # serve-tier ops (ISSUE 9): fired against a ReplicaRouter —
           # `host` addresses the replica index on serve targets
           "kill_replica", "freeze_replica", "slow_replica",
           # crash-safety op (ISSUE 12): SIGKILL the supervisor itself —
           # the fleet must survive its watchman dying (`host` unused)
           "kill_coordinator",
           # network gray-failure ops (ISSUE 15): injected through
           # tpucfn.net.proxy.ChaosProxy instances registered on the
           # target — `host` (optional) is a PROXY index, not a fleet
           # member; unpinned means every registered proxy
           "net_latency", "net_throttle", "net_stall", "net_partition",
           "net_tear", "net_rst", "net_clear")

# Actions that do not target a fleet member: an unpinned `host` must
# NOT draw a victim from the seeded RNG for them, or the spec's other
# events would resolve different victims depending on whether one of
# these precedes them.
_HOSTLESS_ACTIONS = ("corrupt_ckpt", "kill_coordinator",
                     "net_latency", "net_throttle", "net_stall",
                     "net_partition", "net_tear", "net_rst", "net_clear")


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One scheduled fault.  Fires when EITHER trigger is reached:
    ``at_s`` (seconds since the engine's first tick) or ``at_step``
    (fleet max step).  ``host=None`` lets the seeded RNG pick a victim
    at fire time.

    Graceful-degradation ops (ISSUE 7): ``preempt_notice`` raises an
    advance preemption notice for the host (``duration_s`` doubles as
    the notice's lead seconds); ``lose_host`` kills the host AND marks
    it un-reacquirable, so the coordinator's next relaunch must shrink
    to N-1 instead of bringing it back; ``corrupt_ckpt`` with ``step``
    set corrupts that specific step instead of the latest.

    Serve-tier ops (ISSUE 9, fired against a
    :class:`~tpucfn.serve.router.ReplicaRouter`): ``kill_replica``
    fails the replica's serve loop (its in-flight requests complete
    with ReplicaFailed and the router fails over); ``freeze_replica``
    stalls the serve loop — and its heartbeats — for ``duration_s``
    (0 = until unfrozen); ``slow_replica`` adds ``delay_s`` of latency
    to every step for ``duration_s``."""

    action: str
    at_s: float | None = None
    at_step: int | None = None
    host: int | None = None
    duration_s: float = 0.0  # hang / delay_heartbeats / preempt lead / freeze
    step: int | None = None  # corrupt_ckpt: target step (None = latest)
    delay_s: float = 0.0     # slow_replica / net_latency: injected latency
    rate_bps: float = 0.0    # net_throttle: forwarding rate (trickle)
    direction: str = "both"  # net_*: "up" | "down" | "both"
    after_bytes: int | None = None  # net_tear/net_stall arming offset

    def __post_init__(self):
        if self.action not in ACTIONS:
            raise ValueError(
                f"unknown chaos action {self.action!r}; one of {ACTIONS}")
        if self.at_s is None and self.at_step is None:
            raise ValueError("chaos event needs at_s and/or at_step")
        if self.direction not in ("up", "down", "both"):
            raise ValueError(
                f"bad direction {self.direction!r}; one of up/down/both")
        # net_* parameter validation happens HERE, at spec construction
        # — a bad launch-level spec must fail at parse time (rc 2), not
        # unwind the live coordinator's supervision loop (and kill the
        # gang) when the event fires minutes into the run.
        if self.action == "net_latency" and self.delay_s <= 0:
            raise ValueError("net_latency needs delay_s > 0")
        if self.action == "net_throttle" and self.rate_bps <= 0:
            raise ValueError("net_throttle needs rate_bps > 0")

    def to_json(self) -> dict:
        return {k: v for k, v in dataclasses.asdict(self).items()
                if v is not None
                and not (k in ("duration_s", "delay_s", "rate_bps")
                         and v == 0.0)
                and not (k == "direction" and v == "both")}


@dataclasses.dataclass(frozen=True)
class ChaosSpec:
    events: tuple[ChaosEvent, ...]
    seed: int = 0

    @classmethod
    def from_json(cls, obj: str | dict) -> "ChaosSpec":
        if isinstance(obj, str):
            obj = json.loads(obj)
        return cls(events=tuple(ChaosEvent(**e) for e in obj.get("events", ())),
                   seed=int(obj.get("seed", 0)))

    def to_json(self) -> dict:
        return {"seed": self.seed,
                "events": [e.to_json() for e in self.events]}


class ChaosTarget:
    """What the engine acts on.  Implementations: the coordinator's
    subprocess table, ControlPlaneChaosTarget, and test recorders."""

    def num_hosts(self) -> int:
        raise NotImplementedError

    def kill_host(self, host_id: int) -> None:
        raise NotImplementedError

    def hang_host(self, host_id: int) -> None:
        """Freeze the host (SIGSTOP for subprocesses) — heartbeats stop
        but the process stays alive, the HANG failure class."""
        raise NotImplementedError

    def resume_host(self, host_id: int) -> None:
        """Undo hang_host (SIGCONT) once the event's duration elapsed."""
        raise NotImplementedError

    def delay_heartbeats(self, host_id: int, duration_s: float) -> None:
        """Make the monitor see this host's heartbeats as stale without
        touching the process (detector-side fault)."""
        raise NotImplementedError

    def preempt_notice(self, host_id: int, lead_s: float) -> None:
        """Raise an advance preemption notice for the host — the
        graceful path: the coordinator should drain, not die."""
        raise NotImplementedError

    def lose_host(self, host_id: int) -> None:
        """Kill the host AND refuse to ever give it back (a permanently
        revoked machine) — the elastic-shrink trigger."""
        raise NotImplementedError

    def corrupt_latest_checkpoint(self, rng: random.Random,
                                  step: int | None = None) -> None:
        raise NotImplementedError

    # -- serve-tier ops (ISSUE 9: tpucfn.serve.router.ReplicaRouter) -------

    def kill_replica(self, replica: int) -> None:
        """Fail the replica's serve loop: in-flight requests complete
        with ReplicaFailed and the router's failover path takes over."""
        raise NotImplementedError

    def freeze_replica(self, replica: int, duration_s: float) -> None:
        """Stall the replica's serve loop (and its loop-driven
        heartbeats) for ``duration_s`` seconds (0 = indefinitely) —
        the serve-side HANG class."""
        raise NotImplementedError

    def slow_replica(self, replica: int, delay_s: float,
                     duration_s: float) -> None:
        """Add ``delay_s`` of latency to every serve step for
        ``duration_s`` seconds (0 = indefinitely) — the straggler
        class, the hedge path's reason to exist."""
        raise NotImplementedError

    # -- network gray-failure ops (ISSUE 15) --------------------------------

    def net_fault(self, proxy: int | None, kind: str, *,
                  duration_s: float, delay_s: float, rate_bps: float,
                  direction: str, after_bytes: int | None) -> None:
        """Inject one network fault (``kind`` is the short fault name —
        ``latency``/``throttle``/``stall``/``partition``/``tear``/
        ``rst``/``clear``) into the :class:`~tpucfn.net.proxy.
        ChaosProxy` at index ``proxy`` — or into EVERY registered proxy
        when unpinned.  Network faults are hostless by design: they
        target a transport plane, not a fleet member."""
        raise NotImplementedError

    # -- crash-safety op (ISSUE 12) -----------------------------------------

    def kill_coordinator(self) -> None:
        """SIGKILL the supervisor process itself, mid-supervision —
        the chaos op behind the kill-the-watchman drills: the fleet
        must keep training, and a ``--supervise`` relaunch must adopt
        it rather than restart it."""
        raise NotImplementedError


class ControlPlaneChaosTarget(ChaosTarget):
    """Replays kill events against the provisioning fake — the chaos
    path for the ``tpucfn heal`` / Provisioner.ensure_healthy state
    machine rather than live processes."""

    def __init__(self, control_plane, cluster_name: str):
        self.cp = control_plane
        self.name = cluster_name

    def num_hosts(self) -> int:
        return len(self.cp.describe(self.name).hosts)

    def kill_host(self, host_id: int) -> None:
        self.cp.kill_host(self.name, host_id)

    def lose_host(self, host_id: int) -> None:
        # On the control plane a kill IS a loss: the record flips
        # unhealthy and stays so until a re-acquire replaces the slice.
        self.cp.kill_host(self.name, host_id)


@dataclasses.dataclass
class FiredEvent:
    event: ChaosEvent
    host: int | None
    elapsed_s: float
    fleet_step: int | None


class ChaosEngine:
    """Replays one spec against one target.

    Call :meth:`tick` from the supervision loop with the elapsed wall
    seconds (since the run started) and the current fleet max step; the
    engine fires every due, not-yet-fired event in schedule order and
    schedules hang resumes.  Events and their resolved victims land in
    :attr:`fired` — the audit trail tests and benches assert on.
    """

    def __init__(self, spec: ChaosSpec, target: ChaosTarget, *,
                 rng: random.Random | None = None,
                 on_fire=None):
        self.spec = spec
        self.target = target
        self.rng = rng if rng is not None else random.Random(spec.seed)
        self._pending = list(spec.events)
        # spec index by identity (events may compare equal): the stable
        # name a durable journal can record a firing under, so a
        # restarted supervisor replays the spec minus what already fired
        # (ISSUE 12 — without this, an adopted run re-fires every event,
        # and a kill_coordinator spec would kill every incarnation).
        self._index = {id(e): i for i, e in enumerate(spec.events)}
        # on_fire(index, event, host) runs BEFORE the action is applied
        # — the write-ahead hook (a kill_coordinator must be journaled
        # before it kills the journaler).
        self.on_fire = on_fire
        self._resumes: list[tuple[float, int]] = []  # (due_elapsed_s, host)
        self.fired: list[FiredEvent] = []

    def skip_fired(self, indices) -> None:
        """Drop the pending events at these spec indices — they fired
        in a previous coordinator incarnation (journal-replayed)."""
        drop = set(indices)
        self._pending = [e for e in self._pending
                         if self._index[id(e)] not in drop]

    def done(self) -> bool:
        return not self._pending and not self._resumes

    def _due(self, ev: ChaosEvent, elapsed_s: float,
             fleet_step: int | None) -> bool:
        if ev.at_s is not None and elapsed_s >= ev.at_s:
            return True
        return (ev.at_step is not None and fleet_step is not None
                and fleet_step >= ev.at_step)

    def tick(self, elapsed_s: float, fleet_step: int | None = None) -> list[FiredEvent]:
        fired_now: list[FiredEvent] = []
        still = []
        for ev in self._pending:
            if not self._due(ev, elapsed_s, fleet_step):
                still.append(ev)
                continue
            host = ev.host
            if host is None and ev.action not in _HOSTLESS_ACTIONS:
                host = self.rng.randrange(self.target.num_hosts())
            rec = FiredEvent(ev, host, elapsed_s, fleet_step)
            if self.on_fire is not None:
                self.on_fire(self._index[id(ev)], ev, host)
            if ev.action == "kill":
                self.target.kill_host(host)
            elif ev.action == "hang":
                self.target.hang_host(host)
                if ev.duration_s > 0:
                    self._resumes.append((elapsed_s + ev.duration_s, host))
            elif ev.action == "delay_heartbeats":
                self.target.delay_heartbeats(host, ev.duration_s)
            elif ev.action == "preempt_notice":
                self.target.preempt_notice(host, ev.duration_s)
            elif ev.action == "lose_host":
                self.target.lose_host(host)
            elif ev.action == "kill_replica":
                self.target.kill_replica(host)
            elif ev.action == "freeze_replica":
                self.target.freeze_replica(host, ev.duration_s)
            elif ev.action == "slow_replica":
                self.target.slow_replica(host, ev.delay_s, ev.duration_s)
            elif ev.action == "kill_coordinator":
                self.target.kill_coordinator()
            elif ev.action.startswith("net_"):
                self.target.net_fault(
                    host, ev.action[len("net_"):],
                    duration_s=ev.duration_s, delay_s=ev.delay_s,
                    rate_bps=ev.rate_bps, direction=ev.direction,
                    after_bytes=ev.after_bytes)
            elif ev.action == "corrupt_ckpt":
                self.target.corrupt_latest_checkpoint(self.rng, step=ev.step)
            self.fired.append(rec)
            fired_now.append(rec)
        self._pending = still
        ripe = [r for r in self._resumes if elapsed_s >= r[0]]
        if ripe:
            self._resumes = [r for r in self._resumes if elapsed_s < r[0]]
            for _, host in ripe:
                self.target.resume_host(host)
        return fired_now


_STEP_DIR = re.compile(r"^\d+$")


def corrupt_latest_checkpoint(ckpt_dir: str | Path, rng: random.Random,
                              *, garbage_bytes: int = 256,
                              step: int | None = None) -> Path | None:
    """Overwrite the head of the largest file under the latest step's
    checkpoint directory with RNG garbage (and truncate there), so a
    subsequent restore fails loudly instead of resuming from silently
    wrong state.  ``step`` targets a specific finalized step instead of
    the latest (ISSUE 7: deterministic drills need to hit the exact
    checkpoint the retry path will blacklist).  Returns the corrupted
    path, or None when there is no matching checkpoint.

    Works on the Orbax layout (``<dir>/<step>/...``) but only assumes
    "numeric step subdirectories containing files".
    """
    d = Path(ckpt_dir)
    if not d.is_dir():
        return None
    steps = sorted((int(p.name), p) for p in d.iterdir()
                   if p.is_dir() and _STEP_DIR.match(p.name))
    if step is not None:
        steps = [(s, p) for s, p in steps if s == step]
    if not steps:
        return None
    _, latest = steps[-1]
    files = sorted(p for p in latest.rglob("*") if p.is_file())
    if not files:
        return None
    victim = max(files, key=lambda p: (p.stat().st_size, str(p)))
    junk = bytes(rng.randrange(256) for _ in range(garbage_bytes))
    with open(victim, "r+b") as f:
        f.write(junk)
        f.truncate(max(garbage_bytes, 1))
    return victim
