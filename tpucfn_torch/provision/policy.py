"""Goodput-driven provisioner policy (ISSUE 18).

The goodput ledger (tpucfn/obs/goodput.py) has named the thief per run
since ISSUE 10 — ``data_wait`` share for input-bound fleets, ``compile``
share for cold starts — but nothing ever *acted* on it.  This module is
the decision layer that closes the loop: observe the fleet's bucket
shares, classify the run, and pick an actuation through primitives that
already exist:

* **grow the input plane** (activate deferred input hosts, ISSUE 11)
  when the ``data_wait`` share says trainers are starved and the
  projected savings over the policy horizon beat the actuation cost;
* **shrink the input plane** when served batches are no longer the
  bottleneck (PR 11's resilient streams degrade trainers back to local
  loading at the exact batch cursor, so a shrink is trajectory-safe);
* **flag chronic starvation** — accelerator hosts that stay starved
  across consecutive windows even with the input plane up are burning
  reserved capacity; the fleet operator (or a queued-resource resize)
  is the actuator, so the policy only raises the flag.

The actuation-latency model is fetch-warm spin-up (ISSUE 13): a grown
input host costs ``spinup_s`` to fan out plus the trainers' warm
time-to-first-step after the drain-relaunch — ``warm_ttfs_frac *
cold_ttfs_s``, the measured 0.35x bound from compile_bench — not a full
cold compile.  That is what makes growing *worth it* mid-run at all.

Same discipline as :mod:`tpucfn.ft.policy`, which this mirrors: pure
and jax-free (the coordinator imports it; so does the analyzer), no
wall-clock reads outside the injectable ``clock``, and a module-level
decision table the ``decision-totality`` rule audits — every
:class:`GoodputSignal` earns a row, every row's action has an actor.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Callable, Mapping


class GoodputSignal(enum.Enum):
    """Classification of one fleet observation window."""

    HEALTHY = "healthy"          # nothing dominates; leave the fleet alone
    DATA_STARVED = "data_starved"    # data_wait share over threshold
    DATA_RICH = "data_rich"          # input plane up, data_wait ~ zero
    CHRONIC_STARVATION = "chronic_starvation"  # starved across N windows
    COMPILE_BOUND = "compile_bound"  # compile share dominates (warm-start
    #                                  plane's job, not a topology change)


class PolicyAction(enum.Enum):
    HOLD = "hold"
    GROW_INPUT_HOSTS = "grow_input_hosts"
    SHRINK_INPUT_HOSTS = "shrink_input_hosts"
    FLAG_STARVED = "flag_starved"


# signal → action, audited by the decision-totality rule: every signal
# has a row, every action is actuated (or deliberately held) somewhere
# in the coordinator.  COMPILE_BOUND holds on purpose — the compile
# cache (ISSUE 13) already amortizes compiles fleet-wide; resizing the
# input plane would not move that share.
PROVISION_DECISION_TABLE: dict[GoodputSignal, PolicyAction] = {
    GoodputSignal.HEALTHY: PolicyAction.HOLD,
    GoodputSignal.DATA_STARVED: PolicyAction.GROW_INPUT_HOSTS,
    GoodputSignal.DATA_RICH: PolicyAction.SHRINK_INPUT_HOSTS,
    GoodputSignal.CHRONIC_STARVATION: PolicyAction.FLAG_STARVED,
    GoodputSignal.COMPILE_BOUND: PolicyAction.HOLD,
}


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    """Thresholds + the actuation-latency model, all explicit so a test
    pins every branch with a fake ledger and a fake clock."""

    # data_wait share above which trainers count as starved (the bench's
    # input-bound verdict uses the same order of magnitude).
    grow_threshold: float = 0.25
    # data_wait share below which a grown input plane is idle freight.
    shrink_threshold: float = 0.02
    # Observation windows shorter than this are noise, not signal.
    min_window_s: float = 1.0
    # No two actuations closer than this (a drain-relaunch mid-cooldown
    # would measure its own downtime as starvation and oscillate).
    cooldown_s: float = 30.0
    # Topology ceiling: never grow past what the launcher reserved.
    max_input_hosts: int = 1
    # Consecutive starved windows WITH the input plane already at its
    # ceiling before the fleet is flagged chronically starved.
    chronic_windows: int = 3
    # -- actuation-latency model (fetch-warm spin-up, ISSUE 13) --------
    # Fan-out + serve-ready cost of activating one input host.
    spinup_s: float = 5.0
    # Cold time-to-first-step the relaunched trainers would pay bare...
    cold_ttfs_s: float = 60.0
    # ...discounted to the fetch-warm fraction (compile_bench's 0.35x
    # acceptance bound) because the artifact cache serves the relaunch.
    warm_ttfs_frac: float = 0.35
    # Horizon the projected data_wait savings must amortize the
    # actuation latency over.
    horizon_s: float = 600.0

    def actuation_latency_s(self) -> float:
        """What one grow costs the fleet in wall seconds: input-host
        spin-up plus the trainers' fetch-warm relaunch TTFS."""
        return self.spinup_s + self.warm_ttfs_frac * self.cold_ttfs_s


@dataclasses.dataclass(frozen=True)
class FleetObservation:
    """One merged goodput window (obs.goodput.fleet_window_observation)."""

    wall_s: float
    goodput_ratio: float
    shares: Mapping[str, float]  # bucket → share of wall, averaged
    num_hosts: int = 1

    @property
    def data_wait_share(self) -> float:
        return float(self.shares.get("data_wait", 0.0))

    @property
    def compile_share(self) -> float:
        return float(sum(self.shares.get(b, 0.0) for b in
                         ("compile", "compile_cached", "compile_fetched")))


@dataclasses.dataclass(frozen=True)
class PolicyDecision:
    action: PolicyAction
    signal: GoodputSignal
    reason: str
    data_wait_share: float = 0.0
    goodput_ratio: float = 0.0
    # Filled for GROW decisions: the cost model that justified it.
    actuation_latency_s: float = 0.0
    projected_savings_s: float = 0.0


class ProvisionPolicy:
    """Deterministic decide() over fleet goodput windows.

    All state is explicit (consecutive starved-window count, last
    actuation time) and all timing flows through the injectable
    ``clock``, so the full decision surface pins under a fake clock —
    the same testability contract :class:`~tpucfn.ft.policy.StragglerGuard`
    set.
    """

    name = "goodput"

    def __init__(self, config: PolicyConfig | None = None, *,
                 clock: Callable[[], float] = time.monotonic):
        self.config = config or PolicyConfig()
        self.clock = clock
        self._last_actuation_t: float | None = None
        self._starved_windows = 0

    # -- classification ----------------------------------------------------

    def classify(self, obs: FleetObservation, *,
                 input_hosts: int) -> GoodputSignal:
        cfg = self.config
        starved = obs.data_wait_share > cfg.grow_threshold
        if starved and input_hosts >= cfg.max_input_hosts:
            # Input plane already at ceiling and still starved: count
            # the window toward the chronic verdict.
            if self._starved_windows + 1 >= cfg.chronic_windows:
                return GoodputSignal.CHRONIC_STARVATION
            return GoodputSignal.HEALTHY  # still accumulating evidence
        if starved:
            return GoodputSignal.DATA_STARVED
        if input_hosts > 0 and obs.data_wait_share < cfg.shrink_threshold:
            return GoodputSignal.DATA_RICH
        if obs.compile_share > max(cfg.grow_threshold, obs.data_wait_share):
            return GoodputSignal.COMPILE_BOUND
        return GoodputSignal.HEALTHY

    # -- decision ----------------------------------------------------------

    def decide(self, obs: FleetObservation | None, *, input_hosts: int,
               now: float | None = None) -> PolicyDecision:
        now = self.clock() if now is None else now
        cfg = self.config
        if obs is None or obs.wall_s < cfg.min_window_s:
            return PolicyDecision(
                PolicyAction.HOLD, GoodputSignal.HEALTHY,
                reason="window too short to classify"
                       if obs is not None else "no goodput window yet")
        signal = self.classify(obs, input_hosts=input_hosts)
        # Track consecutive at-ceiling starvation for the chronic verdict
        # (grow-eligible starvation resets on actuation, not here).
        at_ceiling = input_hosts >= cfg.max_input_hosts
        if obs.data_wait_share > cfg.grow_threshold and at_ceiling:
            self._starved_windows += 1
        elif obs.data_wait_share <= cfg.grow_threshold:
            self._starved_windows = 0
        action = PROVISION_DECISION_TABLE[signal]
        base = dataclasses.replace(
            PolicyDecision(action, signal, reason=""),
            data_wait_share=obs.data_wait_share,
            goodput_ratio=obs.goodput_ratio)
        if action is PolicyAction.HOLD:
            return dataclasses.replace(
                base, reason=f"{signal.value}: no actuation warranted")
        if self._last_actuation_t is not None \
                and now - self._last_actuation_t < cfg.cooldown_s:
            return dataclasses.replace(
                base, action=PolicyAction.HOLD,
                reason=f"{signal.value} but cooling down "
                       f"({now - self._last_actuation_t:.1f}s of "
                       f"{cfg.cooldown_s:.1f}s)")
        if action is PolicyAction.GROW_INPUT_HOSTS:
            latency = cfg.actuation_latency_s()
            # Project the starved share forward over the horizon; the
            # grow pays off when the reclaimed wall beats the drain-
            # relaunch cost.  data_wait rarely reaches zero post-grow, so
            # credit only the share above the shrink floor.
            reclaimable = max(
                0.0, obs.data_wait_share - cfg.shrink_threshold)
            savings = reclaimable * cfg.horizon_s
            if savings <= latency:
                return dataclasses.replace(
                    base, action=PolicyAction.HOLD,
                    reason=f"data_starved but projected savings "
                           f"{savings:.1f}s over {cfg.horizon_s:.0f}s "
                           f"horizon does not amortize "
                           f"{latency:.1f}s actuation",
                    actuation_latency_s=latency,
                    projected_savings_s=savings)
            self._last_actuation_t = now
            self._starved_windows = 0
            return dataclasses.replace(
                base,
                reason=f"data_wait share {obs.data_wait_share:.2f} > "
                       f"{cfg.grow_threshold:.2f}: grow input plane "
                       f"(savings {savings:.1f}s > actuation "
                       f"{latency:.1f}s)",
                actuation_latency_s=latency,
                projected_savings_s=savings)
        if action is PolicyAction.SHRINK_INPUT_HOSTS:
            self._last_actuation_t = now
            return dataclasses.replace(
                base,
                reason=f"data_wait share {obs.data_wait_share:.2f} < "
                       f"{cfg.shrink_threshold:.2f}: input plane is idle "
                       "freight; trainers degrade to local at the exact "
                       "batch cursor")
        # PolicyAction.FLAG_STARVED — observation-only: the operator (or
        # a queued-resource resize) owns the accelerator topology.
        return dataclasses.replace(
            base,
            reason=f"starved {self._starved_windows} consecutive windows "
                   f"with input plane at ceiling ({input_hosts}): "
                   "accelerator hosts are burning reserved capacity")


PROVISION_POLICIES = {ProvisionPolicy.name: ProvisionPolicy}


def provision_policy_from_name(
        name: str, config: PolicyConfig | None = None, *,
        clock: Callable[[], float] = time.monotonic) -> ProvisionPolicy:
    try:
        cls = PROVISION_POLICIES[name]
    except KeyError:
        raise ValueError(
            f"unknown provision policy {name!r}; choose from "
            f"{sorted(PROVISION_POLICIES)}") from None
    return cls(config, clock=clock)
