"""Recovery policies: what to do about a detected failure, and at what
cost.

The decision layer between detection (ft/heartbeat.py, process exit
codes) and action (ft/coordinator.py).  Three pieces:

* :class:`RestartBudget` — how many recoveries a run is allowed, and the
  exponential-backoff-with-jitter delay before each one.  Jitter comes
  from a ``random.Random`` the caller seeds (no wall-clock randomness:
  the same seed replays the same delays, which is what makes the chaos
  harness deterministic).
* A **decision table** — failure class → action, overridable per policy
  (the per-failure-class table from ISSUE 4: a crash is not a hang is
  not a straggler — and, since ISSUE 7, a preemption notice is not a
  failure at all).
* :class:`GangRestart` / :class:`SoloRestart` — the two recovery shapes
  for a TPU gang.  A TPU slice runs one SPMD program, so the safe
  default is gang restart: kill all, relaunch all, resume from the
  latest checkpoint.  Solo restart (restart only the dead host into the
  same gang) is the cheaper path for harnesses whose ranks are loosely
  coupled (data-parallel CPU rigs, serving fleets) — it falls back to a
  gang restart when multiple hosts fail at once.
* :class:`StragglerGuard` — the hysteresis window + per-host flap
  budget that makes the STRAGGLER→SOLO_RESTART row safe to have on by
  default (ISSUE 7): a brief lag episode that recovers before the
  window elapses is a *flap*, tolerated up to the budget; sustained lag
  past the window — or a chronic flapper over budget — is evicted.
"""

from __future__ import annotations

import dataclasses
import enum
import random
import time
from typing import Callable, Iterable

# -- graceful-degradation contract (ISSUE 7) -------------------------------
#
# These live here (the ft plane's jax-free decision layer) because both
# sides of each contract need them and only one side may import jax:
# the ckpt manager / trainer (jax side) and the GangCoordinator +
# stdlib-only chaos workers (must stay importable without jax).

# Exit code a rank uses when an EXISTING checkpoint failed to restore
# (corruption, truncation).  Distinguishable from a generic crash so the
# coordinator can retry from the previous finalized step instead of
# crash-looping the same corrupt artifact into give_up.
RESTORE_FAILED_RC = 77

# Env var fanned out by the coordinator on a checkpoint-corruption retry:
# comma-separated step numbers the relaunched ranks' CheckpointManager
# must treat as nonexistent for latest-step/restore selection.
CKPT_BLACKLIST_ENV = "TPUCFN_CKPT_BLACKLIST"


def format_ckpt_blacklist(steps: Iterable[int]) -> str:
    return ",".join(str(s) for s in sorted(set(int(s) for s in steps)))


def parse_ckpt_blacklist(value: str | None) -> frozenset[int]:
    """Tolerant parse of the env value — a garbled entry is skipped, not
    raised on (a wrong blacklist must degrade to a smaller blacklist,
    never to a crashed resume path)."""
    out = set()
    for part in (value or "").split(","):
        part = part.strip()
        if not part:
            continue
        try:
            out.add(int(part))
        except ValueError:
            continue
    return frozenset(out)


class FailureKind(enum.Enum):
    CLEAN_EXIT = "clean_exit"  # rc == 0 — not a failure; never burns budget
    CRASH = "crash"            # process exited nonzero (or was killed)
    HANG = "hang"              # process alive but heartbeats went DEAD
    STRAGGLER = "straggler"    # alive, beating, but step-lagging the fleet
    PREEMPT = "preempt"        # advance notice: host will be taken away


class Action(enum.Enum):
    NONE = "none"
    SOLO_RESTART = "solo_restart"
    GANG_RESTART = "gang_restart"
    # Proactive drain (ISSUE 7): force-save through the ckpt layer, stop
    # the gang cleanly, relaunch as a PLANNED restart — zero lost work,
    # no budget consumed.
    DRAIN_RESTART = "drain_restart"
    GIVE_UP = "give_up"


@dataclasses.dataclass(frozen=True)
class Failure:
    host_id: int
    kind: FailureKind
    rc: int | None = None      # exit code for CRASH/CLEAN_EXIT
    step: int | None = None    # last heartbeat step, when known
    detail: str = ""
    lead_s: float | None = None  # PREEMPT only: advance-notice seconds


@dataclasses.dataclass(frozen=True)
class Decision:
    action: Action
    hosts: tuple[int, ...] = ()  # SOLO_RESTART victims; empty = whole gang
    delay_s: float = 0.0
    reason: str = ""
    # True for restarts the fleet chose to make (preemption drain):
    # they burn no budget and must not read as downtime regressions.
    planned: bool = False


# action each failure class earns by default; CLEAN_EXIT is observe-only.
# STRAGGLER→SOLO_RESTART is on by default since ISSUE 7 — safe because
# the coordinator routes straggler verdicts through a StragglerGuard
# (hysteresis + flap budget) before they ever reach decide().
# PREEMPT→DRAIN_RESTART turns an advance notice into a proactive drain.
DEFAULT_DECISION_TABLE: dict[FailureKind, Action] = {
    FailureKind.CLEAN_EXIT: Action.NONE,
    FailureKind.CRASH: Action.GANG_RESTART,
    FailureKind.HANG: Action.GANG_RESTART,
    FailureKind.STRAGGLER: Action.SOLO_RESTART,
    FailureKind.PREEMPT: Action.DRAIN_RESTART,
}


class RestartBudget:
    """``max_restarts`` recoveries, exponential backoff + jitter between.

    Delay before restart ``k`` (0-based over *consumed* restarts)::

        min(backoff_s * multiplier**k, max_backoff_s) * (1 + U(-j, +j))

    ``backoff_s=0`` disables delays entirely (the unit-test path).  The
    budget is only consumed for actual recoveries — a clean exit after
    prior restarts must not burn a slot (ISSUE 4 satellite: exit-cause
    accounting).
    """

    def __init__(self, max_restarts: int, *, backoff_s: float = 0.0,
                 multiplier: float = 2.0, max_backoff_s: float = 60.0,
                 jitter: float = 0.1, rng: random.Random | None = None):
        if max_restarts < 0:
            raise ValueError(f"max_restarts must be >= 0, got {max_restarts}")
        if not 0.0 <= jitter < 1.0:
            raise ValueError(f"jitter must be in [0, 1), got {jitter}")
        self.max_restarts = max_restarts
        self.backoff_s = float(backoff_s)
        self.multiplier = float(multiplier)
        self.max_backoff_s = float(max_backoff_s)
        self.jitter = float(jitter)
        self.rng = rng if rng is not None else random.Random(0)
        self.used = 0

    @property
    def remaining(self) -> int:
        return max(0, self.max_restarts - self.used)

    def next_delay(self) -> float:
        """The delay the *next* restart would wait (no state change)."""
        if self.backoff_s <= 0.0:
            return 0.0
        base = min(self.backoff_s * self.multiplier ** self.used,
                   self.max_backoff_s)
        if self.jitter:
            base *= 1.0 + self.rng.uniform(-self.jitter, self.jitter)
        return base

    def consume(self) -> bool:
        """Take one restart slot; False when the budget is exhausted."""
        if self.used >= self.max_restarts:
            return False
        self.used += 1
        return True


class RecoveryPolicy:
    """decide(failures) → Decision; owns the budget and the table."""

    name = "base"

    def __init__(self, budget: RestartBudget,
                 table: dict[FailureKind, Action] | None = None):
        self.budget = budget
        self.table = dict(DEFAULT_DECISION_TABLE)
        if table:
            self.table.update(table)

    def _restart_shape(self, actionable: list[Failure]) -> Action:
        raise NotImplementedError

    def decide(self, failures: list[Failure]) -> Decision:
        acts = {id(f): self.table.get(f.kind, Action.NONE) for f in failures}
        drains = [f for f in failures
                  if acts[id(f)] is Action.DRAIN_RESTART]
        actionable = [f for f in failures
                      if acts[id(f)] not in (Action.NONE,
                                             Action.DRAIN_RESTART)]
        if not actionable:
            if drains:
                # A preemption notice with no real failure alongside it is
                # a PLANNED restart: decided before the budget/give-up
                # check on purpose — an exhausted budget must not turn an
                # orderly drain into a give_up, and the drain never
                # consumes a slot (ISSUE 7 budget semantics).
                hosts = tuple(sorted(f.host_id for f in drains))
                return Decision(
                    Action.DRAIN_RESTART, hosts=hosts, planned=True,
                    reason=f"preemption notice for host(s) {hosts}: "
                           "proactive drain + planned restart "
                           "(budget untouched)")
            kinds = ",".join(sorted({f.kind.value for f in failures})) or "none"
            return Decision(Action.NONE, reason=f"table: no action for {kinds}")
        # A real failure arriving with a notice wins: the restart it earns
        # relaunches the preempted host anyway (or shrinks past it).
        if all(acts[id(f)] is Action.SOLO_RESTART for f in actionable):
            # Every actionable failure's table row names SOLO_RESTART
            # (the straggler-eviction row): eviction is inherently
            # targeted, so the per-kind action pins the shape instead of
            # the policy class — a GangRestart fleet still evicts one
            # straggler solo rather than bouncing the whole gang.
            shape = Action.SOLO_RESTART
        else:
            shape = self._restart_shape(actionable)
        # Delay is drawn before consume so it reflects the restart being
        # paid for (restart k waits multiplier**k), and only when the
        # budget actually has a slot (a drawn-then-refused delay would
        # desync the seeded jitter stream between runs that exhaust at
        # different points).
        if self.budget.remaining == 0:
            if all(f.kind is FailureKind.STRAGGLER for f in actionable):
                # An eviction is an optimization, not a rescue: a gang
                # whose only problem is a slow-but-progressing host must
                # never be killed over it.  Out of budget, stragglers
                # degrade to observe-only instead of give_up.
                return Decision(
                    Action.NONE,
                    reason="straggler eviction skipped: restart budget "
                           "exhausted (observe-only)")
            return Decision(
                Action.GIVE_UP,
                reason=f"restart budget exhausted "
                       f"({self.budget.max_restarts} used)")
        delay = self.budget.next_delay()
        self.budget.consume()
        hosts = tuple(sorted(f.host_id for f in actionable))
        if shape is Action.SOLO_RESTART:
            return Decision(Action.SOLO_RESTART, hosts=hosts, delay_s=delay,
                            reason=f"solo restart of host(s) {hosts} "
                                   f"({self.budget.used}/"
                                   f"{self.budget.max_restarts})")
        return Decision(Action.GANG_RESTART, delay_s=delay,
                        reason=f"gang restart for host(s) {hosts} "
                               f"({self.budget.used}/"
                               f"{self.budget.max_restarts})")


class GangRestart(RecoveryPolicy):
    """Kill all, relaunch all, resume from the latest checkpoint — the
    only safe shape when the ranks form one SPMD program (a TPU slice's
    collectives wedge the moment one participant is gone)."""

    name = "gang"

    def _restart_shape(self, actionable: list[Failure]) -> Action:
        return Action.GANG_RESTART


class SoloRestart(RecoveryPolicy):
    """Restart only the dead host back into the same gang (same host_id,
    same env: obs port, heartbeat file).  Correct only for loosely
    coupled ranks; multiple simultaneous failures escalate to a gang
    restart (correlated death usually means the gang state is gone)."""

    name = "solo"

    def _restart_shape(self, actionable: list[Failure]) -> Action:
        if len(actionable) == 1:
            return Action.SOLO_RESTART
        return Action.GANG_RESTART


class StragglerGuard:
    """Hysteresis + flap budget in front of the STRAGGLER→SOLO_RESTART
    row (ISSUE 7): decides when a lag verdict is allowed to become an
    eviction.

    Per host, a contiguous run of straggler observations is an
    *episode*.  :meth:`observe` returns True (fire the eviction) exactly
    once per episode, when either

    * the episode has lasted ``hysteresis_s`` — sustained lag, or
    * the episode STARTS with the host already over its flap budget —
      a chronic flapper whose brief episodes keep dodging the window.

    An episode that ends (the host returns to LIVE) before firing is a
    *flap* and consumes one unit of the budget; the hysteresis window
    re-arms on every return to LIVE.  All timing comes from the
    injectable ``clock`` so every threshold is pinned with fakes.

    The caller only reports LIVE/STRAGGLER transitions — a SUSPECT host
    (stale beat) freezes the episode rather than ending it, so don't
    call :meth:`observe` for it.  :meth:`reset` forgets a host entirely
    (call it when the host is relaunched: a fresh incarnation starts
    with a fresh budget).
    """

    def __init__(self, *, hysteresis_s: float = 30.0, flap_budget: int = 3,
                 clock: Callable[[], float] = time.monotonic):
        if hysteresis_s < 0:
            raise ValueError(f"hysteresis_s must be >= 0, got {hysteresis_s}")
        if flap_budget < 0:
            raise ValueError(f"flap_budget must be >= 0, got {flap_budget}")
        self.hysteresis_s = float(hysteresis_s)
        self.flap_budget = int(flap_budget)
        self.clock = clock
        self._since: dict[int, float] = {}   # host → episode start
        self._fired: set[int] = set()        # episode already evicted
        self.flaps: dict[int, int] = {}      # host → consumed flap budget

    def observe(self, host_id: int, straggling: bool,
                now: float | None = None) -> bool:
        now = self.clock() if now is None else now
        if not straggling:
            if host_id in self._since and host_id not in self._fired:
                # episode ended before the window elapsed: a flap
                self.flaps[host_id] = self.flaps.get(host_id, 0) + 1
            self._since.pop(host_id, None)
            self._fired.discard(host_id)
            return False
        if host_id in self._fired:
            return False  # once per episode; the restart resets us
        if host_id not in self._since:
            self._since[host_id] = now
            if self.flaps.get(host_id, 0) >= self.flap_budget:
                self._fired.add(host_id)
                return True  # over-budget flapper: no more grace
            return False
        if now - self._since[host_id] >= self.hysteresis_s:
            self._fired.add(host_id)
            return True
        return False

    def reset(self, host_id: int) -> None:
        self._since.pop(host_id, None)
        self._fired.discard(host_id)
        self.flaps.pop(host_id, None)

    def reset_all(self) -> None:
        self._since.clear()
        self._fired.clear()
        self.flaps.clear()


POLICIES = {GangRestart.name: GangRestart, SoloRestart.name: SoloRestart}


def policy_from_name(name: str, budget: RestartBudget,
                     table: dict[FailureKind, Action] | None = None
                     ) -> RecoveryPolicy:
    try:
        cls = POLICIES[name]
    except KeyError:
        raise ValueError(
            f"unknown ft policy {name!r}; choose from {sorted(POLICIES)}"
        ) from None
    return cls(budget, table)
