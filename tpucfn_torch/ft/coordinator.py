"""Gang supervision: detect → decide → act → recovered.

The :class:`GangCoordinator` owns the launcher's process table and runs
the whole fault-tolerance loop in one place (ISSUE 4 tentpole):

* **detect** — polls every rank's exit code each ``poll_interval`` and,
  when a :class:`~tpucfn.ft.heartbeat.HeartbeatMonitor` is attached,
  consumes its verdicts (a DEAD heartbeat on a live process is a HANG;
  process exit codes are CRASH / CLEAN_EXIT).
* **decide** — hands the failure set to the
  :class:`~tpucfn.ft.policy.RecoveryPolicy` (gang vs solo restart,
  budget + backoff, per-failure-class table).
* **act** — SIGTERM→SIGKILL escalation through
  :meth:`~tpucfn.launch.launcher.Launcher.stop_all`, then relaunch:
  the whole gang (resume happens in the job via its CheckpointManager —
  ``Trainer.init_or_resume``) or just the dead host with its original
  ``host_env`` (same host_id, obs port, heartbeat file).
* **record** — every incident becomes ``ft_*`` registry metrics (MTTR
  included), one line each in ``<ft_dir>/events.jsonl``, a trace span,
  and a refreshed ``<ft_dir>/supervisor.json`` snapshot that ``tpucfn
  ft status`` renders.

``launch.run_with_restarts`` is a thin shim over this class (gang
policy, no monitor), preserving its signature and its ``supervisor_*``
metric names.

Graceful degradation (ISSUE 7) — four paths beyond restart-at-same-size:

* **preemption drain** — an advance notice (chaos op, or an external
  daemon writing ``<ft_dir>/preempt.json``) raises ``FailureKind.
  PREEMPT``; the decision table maps it to a *planned* drain: every
  rank runs to one converged step boundary (``<ft_dir>/drain.json``),
  force-saves through its own ckpt layer, exits clean, and the gang is
  relaunched with zero lost work and zero budget consumed.
* **elastic shrink** — a failed host that cannot be re-acquired (chaos
  ``lose_host``, or ``reacquire_check`` says the control plane lost it)
  shrinks the gang: the ``EnvContract`` re-converges at N-1 with a new
  generation and the smaller gang resumes cross-topology from the
  latest checkpoint.
* **checkpoint-corruption retry** — a rank exiting with
  ``RESTORE_FAILED_RC`` means the latest checkpoint would not restore;
  instead of crash-looping the same artifact into give_up, the
  coordinator quarantines the bad step, blacklists it for the ranks
  (``TPUCFN_CKPT_BLACKLIST`` fan-out), and relaunches to resume from
  the previous finalized step — without touching the restart budget.
* **straggler eviction** — STRAGGLER verdicts pass through a
  :class:`~tpucfn.ft.policy.StragglerGuard` (hysteresis window +
  per-host flap budget, re-armed on return to LIVE) before the
  STRAGGLER→SOLO_RESTART row — on by default since ISSUE 7 — may evict.

Crash-safety (ISSUE 12): every state transition is appended to a
checksummed, fsync'd write-ahead journal under ``<ft_dir>/journal/``
*before* its action runs (:mod:`tpucfn.ft.journal`), restart decisions
carry an intent/commit pair, and a restarted coordinator (``adopt`` —
the default whenever an unfinished journal exists) replays the
journal, re-attaches to the running fleet (journal pids + heartbeat
liveness), finishes any mid-flight incident exactly once, and
continues the *same* restart budget.  ``tpucfn launch --supervise``
wraps the whole loop in a jax-free re-exec supervisor
(:mod:`tpucfn.launch.supervise`); the ``kill_coordinator`` chaos op is
the drill that proves the watchman itself is expendable.

The coordinator is also a :class:`~tpucfn.ft.chaos.ChaosTarget`: a
:class:`~tpucfn.ft.chaos.ChaosSpec` passed in is replayed against the
real subprocess table (SIGKILL / SIGSTOP / heartbeat delay / preemption
notice / host loss / checkpoint corruption) on the same supervision
clock, which is what makes the end-to-end recovery drills deterministic.
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time
from pathlib import Path
from typing import Callable, Sequence

from tpucfn_torch.bootstrap import shrink_contract
from tpucfn_torch.ft.chaos import ChaosEngine, ChaosSpec, ChaosTarget, \
    corrupt_latest_checkpoint
from tpucfn_torch.ft.heartbeat import (
    HeartbeatMonitor,
    HostState,
    read_heartbeats,
)
from tpucfn_torch.ft.journal import (
    AdoptedProcess,
    JournalWriter,
    PendingIntent,
    clear_rc_dir,
    compact_journal,
    crash_point,
    journal_path,
    pid_alive,
    pid_start_time,
    read_rc,
    repair_torn_tail,
    replay_journal,
    rotate_journal,
)
from tpucfn_torch.ft.policy import (
    CKPT_BLACKLIST_ENV,
    RESTORE_FAILED_RC,
    Action,
    Decision,
    Failure,
    FailureKind,
    GangRestart,
    RecoveryPolicy,
    RestartBudget,
    StragglerGuard,
    format_ckpt_blacklist,
)
from tpucfn_torch.ft.preempt import (
    PreemptNotice,
    clear_drain,
    consume_notice,
    request_drain,
)


# How long an adopting coordinator waits for the supervise reaper to
# land a dead rank's rc file before treating the death as unexplained
# (matches AdoptedProcess.poll's default rc_grace_s).
ADOPT_RC_GRACE_S = 2.0

# Spawn-window hazard (ISSUE 13 satellite, closing the PR 12 gap): a
# coordinator killed between the pre-spawn ``launching`` journal record
# and the pid-bearing launch record leaves ranks that may be alive with
# NO journal trace.  Adoption waits this long for such a rank's first
# heartbeat to name a pid before declaring it dead and relaunching over
# it — milliseconds-wide on LocalTransport, seconds on SSH fan-outs.
ADOPT_SPAWN_GRACE_S = 10.0


class GangCoordinator(ChaosTarget):
    def __init__(
        self,
        launcher,
        argv: Sequence[str],
        *,
        policy: RecoveryPolicy | None = None,
        monitor: HeartbeatMonitor | None = None,
        ft_dir: str | Path | None = None,
        registry=None,
        tracer=None,
        poll_interval: float = 0.05,
        term_grace_s: float = 5.0,
        chaos: ChaosSpec | ChaosEngine | None = None,
        kill_host_after: tuple[int, float] | None = None,
        ckpt_dir: str | Path | None = None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        capture_flight: bool = True,
        flight_timeout_s: float = 2.0,
        capture_spans: bool = True,
        span_tail_lines: int = 500,
        profile_on_incident_s: float = 0.0,
        clock_probe_interval_s: float = 30.0,
        drain_grace_s: float = 30.0,
        drain_step_margin: int = 2,
        allow_shrink: bool = True,
        reacquire_check: Callable[[str], bool] | None = None,
        max_ckpt_retries: int = 3,
        straggler_guard: StragglerGuard | None = None,
        restart_input_hosts: bool = False,
        max_input_restarts: int = 1,
        adopt: bool | str = "auto",
        adopt_spawn_grace_s: float = ADOPT_SPAWN_GRACE_S,
        net_proxies: Sequence | None = None,
        journal_compact_records: int = 4096,
        provision_policy=None,
        goodput_dir: str | Path | None = None,
        provision_interval_s: float = 5.0,
    ):
        """Graceful-degradation knobs (ISSUE 7): ``drain_grace_s`` caps
        how long a preemption drain waits for clean exits when the
        notice carried no lead time (a notice's ``lead_s`` wins when
        shorter — the drain must beat the preemption); the drain target
        step is fleet max + ``drain_step_margin`` so every rank can
        still converge on it.  ``reacquire_check(address) -> bool`` asks
        the control plane whether a failed host is coming back; False
        (or a chaos ``lose_host``) routes the restart through an
        elastic N-1 shrink when ``allow_shrink``.  ``max_ckpt_retries``
        bounds the corruption retry-from-previous loop (each retry
        blacklists one more step; past the cap the normal policy
        decides).  ``straggler_guard`` defaults to a 30s-hysteresis,
        3-flap guard on this coordinator's clock."""
        self.launcher = launcher
        self.argv = list(argv)
        self.policy = policy if policy is not None else GangRestart(
            RestartBudget(0))
        self.monitor = monitor
        self.ft_dir = Path(ft_dir) if ft_dir is not None else None
        self.tracer = tracer
        self.poll_interval = poll_interval
        self.term_grace_s = term_grace_s
        self.kill_host_after = kill_host_after
        self.ckpt_dir = Path(ckpt_dir) if ckpt_dir is not None else None
        self.clock = clock
        self.sleep = sleep
        self.capture_flight = capture_flight
        self.flight_timeout_s = flight_timeout_s
        # Fleet timeline plane (ISSUE 20): at detect time the survivors'
        # span tails (and optionally a short jax profile) join the
        # flight rings in the forensics pull; on the heartbeat cadence
        # the coordinator probes every live obs /clock endpoint so the
        # merged timeline aligns hosts on MEASURED offsets instead of
        # the step-anchored estimate.  profile_on_incident_s is 0 (off)
        # by default — a profile capture blocks the incident path for
        # its whole duration, which is an operator's call, not ours.
        self.capture_spans = capture_spans
        self.span_tail_lines = span_tail_lines
        self.profile_on_incident_s = profile_on_incident_s
        self.clock_probe_interval_s = float(clock_probe_interval_s)
        self._next_clock_probe = 0.0
        self._clock_probe_thread: threading.Thread | None = None
        self.drain_grace_s = drain_grace_s
        self.drain_step_margin = drain_step_margin
        self.allow_shrink = allow_shrink
        self.reacquire_check = reacquire_check
        self.max_ckpt_retries = max_ckpt_retries
        self.straggler_guard = (straggler_guard if straggler_guard is not None
                                else StragglerGuard(clock=clock))
        # Disaggregated input plane (ISSUE 11): failures of input-role
        # hosts NEVER restart the gang or burn budget — trainers degrade
        # to local loading on their own (the service client's resilient
        # stream), the coordinator just records it and, optionally,
        # solo-relaunches the input host (bounded per host so a
        # crash-looping service cannot relaunch forever).
        self.input_host_ids = frozenset(
            getattr(launcher, "input_host_ids", ()) or ())
        self.restart_input_hosts = restart_input_hosts
        self.max_input_restarts = max_input_restarts
        self._input_restarts: dict[int, int] = {}
        # Provisioner policy loop (ISSUE 18): a ProvisionPolicy
        # (tpucfn.provision.policy) observing the fleet's goodput
        # ledgers and actuating topology through existing primitives —
        # grow = activate the launcher's deferred input plane via a
        # planned drain-relaunch, shrink = stop input hosts (trainers
        # degrade to local at the exact batch cursor), chronic
        # starvation = flag only.  Validation at construction, same as
        # the chaos/net checks below: a policy with no ledger to read
        # would silently never decide anything.
        self.provision_policy = provision_policy
        self.goodput_dir = Path(goodput_dir) if goodput_dir is not None \
            else None
        self.provision_interval_s = float(provision_interval_s)
        self._next_provision = 0.0
        self._provision_since_t: float | None = None
        self._provision_flagged = False
        if provision_policy is not None and self.goodput_dir is None:
            raise ValueError(
                "provision_policy needs goodput_dir — the policy reads "
                "the fleet goodput ledgers (GoodputLedger files) to "
                "classify the run; without them it can never decide")
        # Crash-safety (ISSUE 12): a write-ahead journal under
        # <ft_dir>/journal/ records every state transition BEFORE the
        # action runs; a restarted coordinator replays it and ADOPTS
        # the running fleet instead of spawning a second one.  `adopt`
        # is "auto" (adopt iff an unfinished journal exists), True
        # (require it when a journal exists), or False (always fresh).
        self.adopt = adopt
        self.adopt_spawn_grace_s = adopt_spawn_grace_s
        # Network fault-injection plane (ISSUE 15): ChaosProxy instances
        # (tpucfn.net.proxy) fronting fleet-plane ports, the targets of
        # the net_* chaos ACTIONS — so launch-level chaos specs schedule
        # gray network failures exactly like kills.
        self.net_proxies = list(net_proxies or ())
        # Journal compaction threshold (ISSUE 15 satellite): at
        # adoption, a journal longer than this folds into one snapshot
        # record so replay stays O(recent) on week-long runs.
        self.journal_compact_records = journal_compact_records
        self._journal: JournalWriter | None = None
        self._adopted = False
        self._adopt_failures: list[Failure] = []
        self._journal_replay_ms: float | None = None

        if registry is None:
            # Throwaway registry: identical flow, nothing exported —
            # keeps the loop free of per-metric None guards.
            from tpucfn_torch.obs.registry import MetricRegistry

            registry = MetricRegistry()
        self.registry = registry
        r = registry
        # supervisor_* names predate the ft plane (obs PR) and stay for
        # dashboard compatibility; ft_* is the recovery-plane surface.
        self.attempts_c = r.counter(
            "supervisor_launch_attempts_total",
            "gang launches (incl. the first)")
        self.restarts_c = r.counter(
            "supervisor_restarts_total", "relaunches after a failure")
        self.failures_c = r.counter(
            "supervisor_failures_total",
            "gang-level failures observed (clean exits excluded)")
        self.hosts_g = r.gauge(
            "supervisor_gang_hosts", "hosts in the launched gang")
        self.rc_g = r.gauge(
            "supervisor_last_exit_code", "exit code of the last finished gang")
        self.ft_failures_c = r.counter(
            "ft_failures_detected_total",
            "host failures detected (crash + hang)")
        self.ft_restarts_c = r.counter(
            "ft_restarts_total", "recovery restarts executed (gang + solo)")
        self.ft_gang_restarts_c = r.counter(
            "ft_gang_restarts_total", "whole-gang restarts")
        self.ft_solo_restarts_c = r.counter(
            "ft_solo_restarts_total", "single-host restarts into a live gang")
        self.ft_incidents_c = r.counter(
            "ft_incidents_total", "detect→decide→act cycles")
        self.ft_give_ups_c = r.counter(
            "ft_give_ups_total", "incidents abandoned (budget exhausted)")
        self.ft_mttr_s = r.summary(
            "ft_mttr_seconds", "detect → relaunch-complete recovery time")
        self.ft_hosts_live_g = r.gauge(
            "ft_hosts_live", "hosts LIVE per the heartbeat monitor")
        self.ft_stragglers_g = r.gauge(
            "ft_stragglers", "hosts flagged STRAGGLER by step lag")
        # Graceful-degradation surface (ISSUE 7)
        self.ft_preempt_drains_c = r.counter(
            "ft_preempt_drains_total",
            "preemption notices drained into planned restarts")
        self.ft_planned_restarts_c = r.counter(
            "ft_planned_restarts_total",
            "planned relaunches (drains) — budget untouched")
        self.ft_planned_mttr_s = r.summary(
            "ft_planned_mttr_seconds",
            "notice → drained-and-relaunched time for planned restarts")
        self.ft_shrinks_c = r.counter(
            "ft_shrinks_total",
            "elastic shrinks (gang re-converged at fewer hosts)")
        self.ft_ckpt_retries_c = r.counter(
            "ft_ckpt_retries_total",
            "checkpoint-corruption retries from a previous step")
        self.ft_evictions_c = r.counter(
            "ft_straggler_evictions_total",
            "stragglers evicted past hysteresis/flap budget")
        # Input-plane surface (ISSUE 11)
        self.ft_input_degraded_c = r.counter(
            "ft_input_degradations_total",
            "input hosts lost; trainers degraded to local loading")
        self.ft_input_restarts_c = r.counter(
            "ft_input_restarts_total",
            "input hosts solo-relaunched (budget untouched)")
        # Crash-safety surface (ISSUE 12)
        self.coord_adoptions_c = r.counter(
            "coordinator_adoptions_total",
            "restarted coordinators that adopted a running fleet")
        self.coord_journal_c = r.counter(
            "coordinator_journal_records_total",
            "write-ahead journal records appended")
        self.coord_pending_g = r.gauge(
            "coordinator_pending_intent",
            "1 while a journaled restart intent awaits its commit")
        # Provisioner policy surface (ISSUE 18)
        self.provision_decisions_c = r.counter(
            "provision_decisions_total",
            "provisioner decisions acted on (grow/shrink/flag)")
        self.provision_grow_c = r.counter(
            "provision_grow_total",
            "input-plane grow actuations (deferred hosts activated)")
        self.provision_shrink_c = r.counter(
            "provision_shrink_total",
            "input-plane shrink actuations (input hosts released)")
        self.provision_flagged_g = r.gauge(
            "provision_flagged",
            "1 while the fleet is flagged chronically starved")
        self.provision_data_wait_share_g = r.gauge(
            "provision_data_wait_share",
            "fleet data_wait share in the last policy window")
        self.provision_goodput_ratio_g = r.gauge(
            "provision_goodput_ratio",
            "fleet step share (goodput) in the last policy window")
        self.provision_actuation_s = r.summary(
            "provision_actuation_seconds",
            "decision → actuated latency of provisioner actuations")
        self.provision_input_hosts_g = r.gauge(
            "provision_input_hosts",
            "input hosts currently active (reserved-but-deferred excluded)")

        hosts = self.launcher.contract.hosts()[
            : self.launcher.contract.workers_count]
        self.host_ids = list(range(len(hosts)))
        self._procs: dict[int, object] = {}  # host_id → live Popen
        self._finished: dict[int, int] = {}  # host_id → clean rc (0)
        self._incident = 0
        # Per-host post-(re)launch window during which monitor verdicts
        # for that host are ignored — a fleet-wide window would let one
        # solo restart blind hang detection for every other host.
        self._blind_until: dict[int, float] = {}
        self._next_observe = 0.0  # monitor read throttle (see _detect)
        self._last_fleet_step: int | None = None
        # HANG/DEAD verdicts the policy already declined to act on
        # (observe-only tables): suppressed until the host beats again,
        # or the detect loop would re-open the same incident every tick.
        self._suppressed_hangs: set[int] = set()
        # Graceful-degradation state (ISSUE 7)
        self._pending_notices: list[PreemptNotice] = []
        self._lost_hosts: set[int] = set()   # chaos lose_host / reacquire
        self._ckpt_blacklist: set[int] = set()
        self._ckpt_retries = 0
        if isinstance(chaos, ChaosSpec):
            chaos = ChaosEngine(chaos, self)
        self.chaos = chaos
        if self.chaos is not None and self.chaos.on_fire is None:
            # Write-ahead: every firing is journaled BEFORE the action
            # runs (a kill_coordinator must be journaled before it kills
            # the journaler), so an adopting restart replays the spec
            # minus what already fired.
            self.chaos.on_fire = self._on_chaos_fire
        if (self.chaos is not None and self.monitor is None
                and any(e.at_step is not None and e.at_s is None
                        for e in self.chaos.spec.events)):
            # Fleet step comes from heartbeat observations; without a
            # monitor an at_step-only event would silently never fire
            # and the drill would pass vacuously.
            raise ValueError(
                "chaos events with only an at_step trigger need a "
                "HeartbeatMonitor attached (fleet step comes from "
                "heartbeats)")
        if (self.chaos is not None and not self.net_proxies
                and any(e.action.startswith("net_")
                        for e in self.chaos.spec.events)):
            # Same discipline as the monitor check above: a net_* event
            # with nowhere to land must refuse at CONSTRUCTION — firing
            # raises mid-supervision, which tears down the gang (and the
            # journaled chaos_fired would make an adopted run silently
            # skip the event forever).
            raise ValueError(
                "chaos net_* events need net_proxies registered on the "
                "coordinator (tpucfn launch --chaos-proxy LISTEN:HOST:"
                "PORT, or pass ChaosProxy instances)")
        if self.ft_dir is not None:
            self.ft_dir.mkdir(parents=True, exist_ok=True)

    # -- ChaosTarget ------------------------------------------------------

    def num_hosts(self) -> int:
        return len(self.host_ids)

    def kill_host(self, host_id: int) -> None:
        p = self._procs.get(host_id)
        if p is not None and p.poll() is None:
            p.kill()

    def hang_host(self, host_id: int) -> None:
        p = self._procs.get(host_id)
        if p is not None and p.poll() is None:
            os.kill(p.pid, signal.SIGSTOP)

    def resume_host(self, host_id: int) -> None:
        p = self._procs.get(host_id)
        if p is not None and p.poll() is None:
            os.kill(p.pid, signal.SIGCONT)

    def delay_heartbeats(self, host_id: int, duration_s: float) -> None:
        if self.monitor is None:
            raise ValueError(
                "chaos delay_heartbeats needs a HeartbeatMonitor attached")
        self.monitor.inject_heartbeat_delay(
            host_id, extra_age_s=duration_s, duration_s=duration_s)

    def preempt_notice(self, host_id: int, lead_s: float) -> None:
        self._pending_notices.append(
            PreemptNotice(host=host_id,
                          lead_s=lead_s if lead_s > 0 else None))
        self._event("chaos_preempt_notice", host=host_id, lead_s=lead_s)

    def lose_host(self, host_id: int) -> None:
        self._lost_hosts.add(host_id)
        self.kill_host(host_id)
        self._event("host_lost", host=host_id)

    def corrupt_latest_checkpoint(self, rng, step=None) -> None:
        if self.ckpt_dir is None:
            raise ValueError(
                "chaos corrupt_ckpt fired but GangCoordinator has no "
                "ckpt_dir configured")
        victim = corrupt_latest_checkpoint(self.ckpt_dir, rng, step=step)
        self._event("chaos_ckpt_corrupted",
                    path=None if victim is None else str(victim))

    def net_fault(self, proxy: int | None, kind: str, *,
                  duration_s: float, delay_s: float, rate_bps: float,
                  direction: str, after_bytes: int | None) -> None:
        """Chaos op (ISSUE 15): inject a network gray failure through
        the registered :class:`~tpucfn.net.proxy.ChaosProxy` instances
        — unpinned hits every proxy, a pinned ``host`` is a proxy
        index.  The firing is journaled by ``_on_chaos_fire`` like any
        other chaos op, so adopted runs never re-fire it."""
        if not self.net_proxies:
            raise ValueError(
                "chaos net_* ops need net_proxies registered on the "
                "coordinator (tpucfn launch --chaos-proxy, or pass "
                "ChaosProxy instances)")
        if proxy is not None and not 0 <= proxy < len(self.net_proxies):
            raise ValueError(
                f"net fault proxy index {proxy} out of range for "
                f"{len(self.net_proxies)} registered proxies")
        targets = ([self.net_proxies[proxy]] if proxy is not None
                   else self.net_proxies)
        for p in targets:
            if kind == "clear":
                p.clear()
            else:
                p.inject(kind, duration_s=duration_s, delay_s=delay_s,
                         rate_bps=rate_bps, direction=direction,
                         after_bytes=after_bytes)
        self._event("chaos_net_fault", fault=kind, proxy=proxy,
                    duration_s=duration_s, delay_s=delay_s,
                    rate_bps=rate_bps, direction=direction,
                    after_bytes=after_bytes)

    def kill_coordinator(self) -> None:
        """Chaos op (ISSUE 12): SIGKILL ourselves mid-supervision.  The
        event row is best-effort bookkeeping; the journal's chaos_fired
        record (written by _on_chaos_fire BEFORE dispatch) is what keeps
        a supervised relaunch from re-firing the same kill forever."""
        self._event("coordinator_killed", pid=os.getpid())
        os.kill(os.getpid(), signal.SIGKILL)

    def _on_chaos_fire(self, index: int, ev, host) -> None:
        self._j("chaos_fired", index=index, action=ev.action, host=host)

    # -- flight capture (ISSUE 6) -----------------------------------------

    def _capture_flight(self, incident: int, failed: set[int]) -> None:
        """Pull every surviving host's flight-recorder ring over its obs
        endpoint BEFORE the gang is stopped — the dead host's last
        seconds are in its own signal/atexit dump, but the survivors'
        rings live only in memory and the restart is about to erase
        them.  Best-effort and CONCURRENT with one shared deadline:
        MTTR includes this call by design (forensics are part of
        incident handling), so its cost must be ~``flight_timeout_s``
        total, not per survivor — a 32-host gang with several
        unreachable endpoints must not serialize 2s timeouts while the
        doomed gang keeps executing steps that will be rewound."""
        base = getattr(self.launcher, "obs_base_port", None)
        if not base or self.ft_dir is None or not self.capture_flight:
            return
        import concurrent.futures
        import urllib.request

        from tpucfn_torch.obs.flight import incident_flight_path, write_flight_dump

        hosts = self.launcher.contract.hosts()[
            : self.launcher.contract.workers_count]
        targets = [(h, hosts[h].rsplit(":", 1)[0])
                   for h, p in sorted(self._procs.items())
                   if h not in failed and p.poll() is None]
        if not targets:
            return

        def fetch(host_id: int, addr: str):
            url = f"http://{addr}:{base + 1 + host_id}/flightrecorder"
            with urllib.request.urlopen(
                    url, timeout=self.flight_timeout_s) as r:
                return json.loads(r.read().decode())

        out_dir = self.ft_dir / "flight"
        captured, errors = [], 0
        # One worker PER survivor, not a smaller pool: with a capped
        # pool, >=cap hung endpoints (plausibly the incident itself)
        # would hold every worker for the whole deadline and the
        # healthy hosts' queued fetches would never start — losing the
        # captures for exactly the hosts that could answer.
        pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=len(targets),
            thread_name_prefix="flight-capture")
        try:
            futs = {pool.submit(fetch, h, addr): h for h, addr in targets}
            done, pending = concurrent.futures.wait(
                futs, timeout=self.flight_timeout_s + 0.5)
            errors += len(pending)
            for f in done:
                host_id = futs[f]
                try:
                    body = f.result()
                except Exception:  # noqa: BLE001 — best-effort
                    errors += 1
                    continue
                if not isinstance(body, dict):
                    errors += 1
                    continue
                out_dir.mkdir(parents=True, exist_ok=True)
                write_flight_dump(
                    incident_flight_path(out_dir, incident, host_id), body)
                captured.append(host_id)
        finally:
            # don't block recovery on stragglers: per-request socket
            # timeouts bound the leaked workers' lifetimes anyway
            pool.shutdown(wait=False)
        captured.sort()
        if captured or errors:
            self._event("flight_capture", incident=incident,
                        hosts=captured, errors=errors)

    # -- span-tail + profile capture (ISSUE 20) ---------------------------

    def _capture_spans(self, incident: int, failed: set[int]) -> None:
        """Pull every surviving host's span tail (``GET /tracetail``)
        — and, when ``profile_on_incident_s`` > 0, a short
        ``POST /profile`` — into ``<ft_dir>/spans/`` BEFORE the gang is
        stopped.  Same concurrency contract as :meth:`_capture_flight`
        (one worker per survivor, one shared deadline): span tails are
        the causal half of the flight rings — the rings say what each
        host was doing, the tails say which remote spans CAUSED it —
        and both die with the restart."""
        base = getattr(self.launcher, "obs_base_port", None)
        if not base or self.ft_dir is None or not self.capture_spans:
            return
        import concurrent.futures
        import urllib.request

        hosts = self.launcher.contract.hosts()[
            : self.launcher.contract.workers_count]
        targets = [(h, hosts[h].rsplit(":", 1)[0])
                   for h, p in sorted(self._procs.items())
                   if h not in failed and p.poll() is None]
        if not targets:
            return
        profile_s = self.profile_on_incident_s
        deadline = self.flight_timeout_s + max(0.0, profile_s)

        def fetch(host_id: int, addr: str) -> dict:
            port = base + 1 + host_id
            url = (f"http://{addr}:{port}/tracetail"
                   f"?lines={self.span_tail_lines}")
            with urllib.request.urlopen(
                    url, timeout=self.flight_timeout_s) as r:
                body = json.loads(r.read().decode())
            if profile_s > 0:
                try:
                    req = urllib.request.Request(
                        f"http://{addr}:{port}/profile?seconds={profile_s}",
                        method="POST")
                    with urllib.request.urlopen(
                            req, timeout=deadline) as r:
                        body["profile"] = json.loads(r.read().decode())
                except Exception:  # noqa: BLE001 — profile is optional
                    pass
            return body

        out_dir = self.ft_dir / "spans"
        captured, errors = [], 0
        pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=len(targets), thread_name_prefix="span-capture")
        try:
            futs = {pool.submit(fetch, h, addr): h for h, addr in targets}
            done, pending = concurrent.futures.wait(
                futs, timeout=deadline + 0.5)
            errors += len(pending)
            for f in done:
                host_id = futs[f]
                try:
                    body = f.result()
                except Exception:  # noqa: BLE001 — best-effort
                    errors += 1
                    continue
                events = body.get("events") if isinstance(body, dict) \
                    else None
                if not isinstance(events, list):
                    errors += 1
                    continue
                out_dir.mkdir(parents=True, exist_ok=True)
                # One JSON line per event — the same shape as the source
                # trace file, so read_trace_file / the postmortem's
                # timeline merge ingest a tail exactly like a full file.
                path = out_dir / (f"incident{incident:03d}"
                                  f"-host{host_id:03d}.jsonl")
                with open(path, "w") as fh:
                    for e in events:
                        fh.write(json.dumps(e) + "\n")
                if isinstance(body.get("profile"), dict):
                    (out_dir / (f"incident{incident:03d}"
                                f"-host{host_id:03d}-profile.json")
                     ).write_text(json.dumps(body["profile"], indent=2))
                captured.append(host_id)
        finally:
            pool.shutdown(wait=False)
        captured.sort()
        if captured or errors:
            self._event("span_capture", incident=incident,
                        hosts=captured, errors=errors,
                        profiled=bool(profile_s > 0))

    # -- clock probes (ISSUE 20) ------------------------------------------

    def _clock_probe_tick(self, now: float) -> None:
        """On the probe cadence, measure every live host's wall-clock
        offset over its obs ``/clock`` route and append the probes to
        ``<ft_dir>/clock-offsets.jsonl`` — the measured half of the
        merged timeline's fleet clock (``obs.timeline.fleet_skew``).
        Probing runs on a background daemon thread (skipped while the
        previous round is still in flight) so a slow endpoint can never
        stretch the supervise loop's poll cadence."""
        base = getattr(self.launcher, "obs_base_port", None)
        if (not base or self.ft_dir is None
                or self.clock_probe_interval_s <= 0
                or now < self._next_clock_probe):
            return
        t = self._clock_probe_thread
        if t is not None and t.is_alive():
            return  # previous round still probing — keep its cadence
        self._next_clock_probe = now + self.clock_probe_interval_s
        hosts = self.launcher.contract.hosts()[
            : self.launcher.contract.workers_count]
        targets = [(h, hosts[h].rsplit(":", 1)[0])
                   for h, p in sorted(self._procs.items())
                   if p.poll() is None]
        if not targets:
            return
        path = self.ft_dir / "clock-offsets.jsonl"

        def probe_round() -> None:
            from tpucfn_torch.obs.timeline import probe_clock

            rows = []
            for host_id, addr in targets:
                url = f"http://{addr}:{base + 1 + host_id}/clock"
                try:
                    pr = probe_clock(url, timeout_s=self.flight_timeout_s)
                except Exception:  # noqa: BLE001 — a dead endpoint is
                    continue       # the incident path's problem, not ours
                rows.append({"kind": "clock_probe",
                             "host": host_id if pr.host is None else pr.host,
                             "role": pr.role,
                             "offset_s": round(pr.offset_s, 9),
                             "unc_s": round(pr.unc_s, 9),
                             "rtt_s": round(pr.rtt_s, 9),
                             "t": time.time()})
            if rows:
                with open(path, "a") as f:
                    for r in rows:
                        f.write(json.dumps(r) + "\n")
            else:
                # nothing answered — almost always startup: the workers'
                # obs servers aren't bound yet.  Retry soon instead of
                # burning the whole cadence (a short run would otherwise
                # never land a single probe).
                self._next_clock_probe = min(
                    self._next_clock_probe,
                    time.monotonic() + min(5.0, self.clock_probe_interval_s))

        self._clock_probe_thread = threading.Thread(
            target=probe_round, daemon=True,
            name="tpucfn-clock-probe")
        self._clock_probe_thread.start()

    # -- event / snapshot plumbing ---------------------------------------

    def _event(self, kind: str, **fields) -> None:
        from tpucfn_torch.ft.events import append_event

        if self.ft_dir is None:
            return
        # append_event flushes AND fsyncs (ISSUE 12 satellite): the
        # detect/decide record of the very incident that kills the
        # coordinator must survive the coordinator.
        append_event(self.ft_dir, kind, **fields)
        self._write_snapshot()

    def _j(self, kind: str, **fields) -> None:
        """Append one write-ahead journal record (no-op without a
        journal — ft_dir unset, or a ctor-only coordinator that never
        entered run()).  The fsync'd commit is timed as a
        ``journal_commit`` span (ISSUE 20): on the merged timeline the
        coordinator plane's cost per incident is visible next to the
        recovery spans it gates."""
        if self._journal is None:
            return
        t0 = time.monotonic()
        self._journal.append(kind, **fields)
        if self.tracer is not None:
            self.tracer.record("journal_commit", start=t0,
                               end=time.monotonic(), journal_kind=kind)
        self.coord_journal_c.add()

    def _write_snapshot(self) -> None:
        if self.ft_dir is None:
            return
        hb = None
        if self.monitor is not None:
            hb = self.monitor.config.interval_s
        snap = {
            "updated_ts": time.time(),
            "pid": os.getpid(),
            "argv": self.argv,
            "gang_hosts": len(self.host_ids),
            "policy": self.policy.name,
            "budget": {"max_restarts": self.policy.budget.max_restarts,
                       "used": self.policy.budget.used},
            "heartbeat_interval_s": hb,
            **self.journal_status(),
            **self.registry.varz(),
        }
        tmp = self.ft_dir / "supervisor.json.tmp"
        tmp.write_text(json.dumps(snap, indent=2))
        tmp.replace(self.ft_dir / "supervisor.json")

    def journal_status(self) -> dict:
        """Crash-safety state for supervisor.json and /healthz detail:
        is this incarnation adopted, how deep is the journal, and is a
        restart intent currently awaiting its commit."""
        j = self._journal
        return {
            "adopted": self._adopted,
            "journal": None if j is None else {
                "path": str(j.path),
                "records": j.seq,
                "pending_intent": bool(self.coord_pending_g.value),
            },
        }

    def health(self) -> tuple[bool, dict]:
        """``obs.server`` HealthFn: the heartbeat monitor's fleet view
        (when attached) plus the journal/adoption state — the probe
        surface that lets an operator see 'this supervisor is a
        restarted incarnation that adopted N hosts'."""
        healthy, detail = (self.monitor.health() if self.monitor is not None
                           else (True, {}))
        return healthy, {**detail, **self.journal_status()}

    # -- supervision loop -------------------------------------------------

    def _launch_gang(self, *, first: bool) -> None:
        inject = self.kill_host_after if first else None
        # Pre-spawn write-ahead (ISSUE 13 satellite): pids exist only
        # after launch() returns, so a coordinator killed mid-spawn
        # would otherwise leave ranks NO journal record and an adoption
        # would relaunch over them.  The `launching` record makes the
        # window visible; adoption gives those hosts a heartbeat grace.
        # Deferred input hosts (ISSUE 18) are reserved in the topology
        # but not spawned until the provisioner activates them — every
        # bookkeeping structure below must cover LAUNCHED hosts only, or
        # the monitor would condemn (and adoption would mourn) ranks
        # that were never supposed to exist yet.
        deferred = set(getattr(self.launcher, "deferred_input_host_ids",
                               ()) or ())
        launched = [h for h in self.host_ids if h not in deferred]
        self._j("launching", hosts=launched, first=first)
        crash_point("during_spawn", self.ft_dir)
        procs = self.launcher.launch(self.argv, kill_host_after=inject)
        self._procs = dict(zip(launched, procs))
        # pids AND their kernel start times: the (pid, starttime) pair
        # is the identity adoption trusts across a machine reboot — a
        # recycled pid alone would adopt (and later kill) a stranger.
        self._j("gang_launched", first=first,
                pids={str(h): p.pid for h, p in self._procs.items()},
                starts={str(h): pid_start_time(p.pid)
                        for h, p in self._procs.items()})
        self._finished.clear()
        self.straggler_guard.reset_all()
        self._suppressed_hangs.clear()
        self._input_restarts.clear()
        self.attempts_c.add()
        self.hosts_g.set(len(procs))
        if self.monitor is not None:
            self.monitor.restart_grace()
            for h in launched:
                self.monitor.activate_host(h)
            blind = self.clock() + self.monitor.config.grace_s
            self._blind_until = {h: blind for h in launched}
        self.provision_input_hosts_g.set(
            sum(1 for h in self.input_host_ids if h not in deferred))
        self._event("launch", first=first, hosts=len(procs),
                    pids=[p.pid for p in procs])

    def _launch_solo(self, host_id: int) -> None:
        # Same host_env as the rank it replaces (host_id, obs port,
        # heartbeat file) — the gang must not notice the substitution.
        self._j("launching", hosts=[host_id])
        self._procs[host_id] = self.launcher.launch_host(self.argv, host_id)
        self._j("solo_launched", host=host_id,
                pid=self._procs[host_id].pid,
                start=pid_start_time(self._procs[host_id].pid))
        self._finished.pop(host_id, None)
        self._suppressed_hangs.discard(host_id)
        self.straggler_guard.reset(host_id)
        if self.monitor is not None:
            self.monitor.activate_host(host_id)
            # Blind only the replaced host: its stale heartbeat must not
            # re-condemn it while it boots, but the REST of the gang
            # keeps full-rate hang detection.
            self._blind_until[host_id] = (self.clock()
                                          + self.monitor.config.grace_s)
        self._event("solo_launch", host=host_id,
                    pid=self._procs[host_id].pid)

    def _straggler_actionable(self) -> bool:
        return self.policy.table.get(
            FailureKind.STRAGGLER, Action.NONE) is not Action.NONE

    def _detect(self, now: float) -> list[Failure]:
        failures: list[Failure] = []
        if self._adopt_failures:
            # Hosts that died while no coordinator was watching
            # (adoption found their pid gone): raised exactly once,
            # through the normal detect→decide path.
            failures.extend(self._adopt_failures)
            self._adopt_failures = []
        # Preemption notices (ISSUE 7): chaos-delivered plus the external
        # sentinel file an out-of-band notice daemon writes.  Consumed
        # here so one notice raises exactly one PREEMPT failure; a
        # notice for a host that already exited is moot.
        if self.ft_dir is not None:
            n = consume_notice(self.ft_dir)
            if n is not None:
                self._pending_notices.append(n)
        if self._pending_notices:
            notices, self._pending_notices = self._pending_notices, []
            for n in notices:
                if n.host in self._procs:
                    failures.append(Failure(
                        n.host, FailureKind.PREEMPT, lead_s=n.lead_s,
                        detail="preemption notice"))
        for host_id, p in list(self._procs.items()):
            rc = p.poll()
            if rc is None:
                continue
            if rc == 0:
                self._j("host_exit", host=host_id, rc=0)
                del self._procs[host_id]
                self._finished[host_id] = 0
                if self.monitor is not None:
                    # a finished rank's heartbeat going stale is
                    # retirement, not death — keep /healthz green
                    self.monitor.retire_host(host_id)
                self._event("host_exit", host=host_id, rc=0)
            else:
                failures.append(Failure(host_id, FailureKind.CRASH, rc=rc))
        if (self.monitor is not None and self._procs
                and now >= self._next_observe):
            # Throttle to half the heartbeat interval: heartbeat files
            # change once per interval, so tail-reading every 50ms poll
            # tick is pure redundant I/O (process-exit CRASH detection
            # above still runs at full poll rate).
            self._next_observe = now + self.monitor.config.interval_s / 2.0
            view = self.monitor.observe()
            self._last_fleet_step = view.max_step()
            counts = view.counts()
            self.ft_hosts_live_g.set(counts[HostState.LIVE.value])
            self.ft_stragglers_g.set(counts[HostState.STRAGGLER.value])
            crashed = {f.host_id for f in failures}
            for v in view.hosts:
                if v.host_id not in self._procs or v.host_id in crashed:
                    continue
                if now < self._blind_until.get(v.host_id, 0.0):
                    # Per-host post-(re)launch blind window: a stale
                    # heartbeat from the previous incarnation must not
                    # condemn a rank that is still importing jax.
                    continue
                if v.state is HostState.DEAD:
                    if v.host_id in self._suppressed_hangs:
                        continue  # policy already declined to act
                    failures.append(Failure(v.host_id, FailureKind.HANG,
                                            step=v.step, detail=v.reason))
                else:
                    # the host came back (fresh beat): re-arm reporting
                    self._suppressed_hangs.discard(v.host_id)
                    # Straggler verdicts go through the guard (ISSUE 7):
                    # hysteresis + flap budget decide when lag becomes
                    # an eviction.  A SUSPECT host (stale beat) freezes
                    # the episode — neither lag evidence nor recovery.
                    if (v.state in (HostState.LIVE, HostState.STRAGGLER)
                            and self._straggler_actionable()
                            and self.straggler_guard.observe(
                                v.host_id,
                                v.state is HostState.STRAGGLER, now=now)):
                        self._j("straggler_probation", host=v.host_id)
                        failures.append(
                            Failure(v.host_id, FailureKind.STRAGGLER,
                                    step=v.step, detail=v.reason))
        return failures

    def _stop_hosts(self, host_ids: Sequence[int]) -> None:
        procs = [self._procs[h] for h in host_ids if h in self._procs]
        self.launcher.stop_all(procs, grace_s=self.term_grace_s,
                               poll_interval=self.poll_interval)
        for h in host_ids:
            self._procs.pop(h, None)

    def _failure_rc(self, failures: list[Failure]) -> int:
        for f in failures:
            if f.rc is not None and f.rc != 0:
                return f.rc
        return 1  # hang/straggler incidents have no exit code

    def run(self) -> int:
        """Supervise until the gang finishes cleanly (0), a failure
        exhausts the policy budget (the failing rc), or the policy
        declines to act on a fatal class.  With a journal on disk from
        a previous incarnation (and ``adopt`` not False), the running
        fleet is adopted instead of relaunched — see
        :meth:`_adopt_fleet`."""
        try:
            if not self._startup_adopt():
                if self.ft_dir is not None:
                    # A previous incarnation aborted mid-drain
                    # (supervisor SIGKILLed inside the wait loop) leaves
                    # drain.json / preempt.json behind; the fresh gang
                    # would self-drain at its first boundary and
                    # "finish" rc 0 having trained nothing.  Stale
                    # protocol files die here — along with stale rc
                    # files and the previous run's journal.
                    clear_drain(self.ft_dir)
                    consume_notice(self.ft_dir)
                    clear_rc_dir(self.ft_dir)
                    rotate_journal(journal_path(self.ft_dir))
                    self._journal = JournalWriter(
                        journal_path(self.ft_dir))
                    self._j("run_start", argv=self.argv,
                            hosts=len(self.host_ids),
                            policy=self.policy.name,
                            max_restarts=self.policy.budget.max_restarts)
                self._launch_gang(first=True)
            start = self.clock()
            while True:
                self.sleep(self.poll_interval)
                now = self.clock()
                if self.chaos is not None and not self.chaos.done():
                    self.chaos.tick(now - start, self._last_fleet_step)
                failures = self._detect(now)
                if failures and self.input_host_ids:
                    # Input-role failures are degradations, not
                    # incidents: handled apart from the policy so they
                    # can never gang-restart trainers or burn budget.
                    failures = self._handle_input_failures(failures)
                if not failures:
                    self._release_idle_input_hosts()
                    if not self._procs:  # every supervised rank exited
                        rc = next((r for r in self._finished.values() if r),
                                  0)
                        self.rc_g.set(rc)
                        self._j("done", rc=rc)
                        self._event("done", rc=rc)
                        return rc
                    self._provision_tick(now)
                    self._clock_probe_tick(now)
                    continue
                rc = self._handle_incident(failures)
                if rc is not None:
                    self._j("done", rc=rc)
                    return rc
        finally:
            if self._procs:
                self.launcher.stop_all(list(self._procs.values()),
                                       grace_s=self.term_grace_s,
                                       poll_interval=self.poll_interval)
                self._procs.clear()
            self._write_snapshot()
            if self._journal is not None:
                self._journal.close()

    # -- crash-safety: fleet adoption (ISSUE 12) --------------------------

    def _startup_adopt(self) -> bool:
        """Fresh launch vs adoption.  True when a previous incarnation's
        unfinished journal was found and the running fleet was adopted
        (the caller must then skip the first launch).  A journal whose
        run already ended (done record) is history, not a fleet — the
        caller rotates it and starts fresh.  A corrupt journal raises
        :class:`~tpucfn.ft.journal.JournalError` loudly: reconstructing
        a plausible-but-wrong fleet state would be worse."""
        if self.ft_dir is None or self.adopt is False:
            return False
        jp = journal_path(self.ft_dir)
        if not jp.exists():
            return False
        t0 = self.clock()
        st, records, torn = replay_journal(jp)
        # Replay time is real restart downtime (ISSUE 13 satellite):
        # measured here, attributed through the recovered /
        # goodput_incident detail so `tpucfn obs goodput` can name the
        # crash-safety plane's own MTTR cost.
        self._journal_replay_ms = round((self.clock() - t0) * 1e3, 3)
        if not st.started or st.done_rc is not None:
            return False
        self._adopt_fleet(st, torn, n_records=len(records))
        return True

    def _adopt_fleet(self, st, torn: bool, *, n_records: int = 0) -> None:
        """Attach to the fleet a dead coordinator left running: restore
        the durable state (budget, incident counter, shrinks, ckpt
        blacklist, input restarts), re-attach to live children by pid
        (journal incarnations first, heartbeat pids as the fallback for
        a crash that landed between spawn and journal append), raise
        exactly one CRASH failure per child that died unwatched, and
        finish any mid-flight restart intent exactly once."""
        t0 = self.clock()
        self._adopted = True
        if torn:
            # The torn final record is the tolerated crash boundary —
            # but JournalWriter appends, and appending after a partial
            # line would glue the next record onto the torn bytes: one
            # garbled line that is no longer final, which the NEXT
            # replay would refuse as corruption.  Drop the tail first.
            repair_torn_tail(journal_path(self.ft_dir))
        # Compaction (ISSUE 15 satellite): a week of incidents replays
        # O(run lifetime) — past the threshold, fold the state we just
        # replayed into one snapshot record so the NEXT adoption (and
        # every tool reading the journal) stays O(recent).
        compacted = False
        if self.journal_compact_records:
            # the (state, count) we JUST replayed — compaction must not
            # pay the O(N) parse a second time on the biggest journals
            compacted = compact_journal(
                journal_path(self.ft_dir),
                max_records=self.journal_compact_records,
                replayed=(st, n_records))
        self._journal = JournalWriter(journal_path(self.ft_dir),
                                      start_seq=st.seq)
        self._incident = st.incident
        self.policy.budget.used = max(self.policy.budget.used,
                                      st.budget_used)
        for lost in st.shrinks:
            # Re-apply recorded shrinks in order: the launcher was
            # rebuilt from the original contract, but the fleet on disk
            # is already the shrunk one.
            self.launcher.contract = shrink_contract(
                self.launcher.contract, sorted(lost))
            self.host_ids = list(
                range(self.launcher.contract.workers_count))
            if self.monitor is not None:
                self.monitor.set_expected_hosts(len(self.host_ids))
        self._input_restarts = dict(st.input_restarts)
        self._ckpt_blacklist = set(st.ckpt_blacklist)
        self._ckpt_retries = st.ckpt_retries
        if self._ckpt_blacklist:
            self.launcher.extra_env[CKPT_BLACKLIST_ENV] = \
                format_ckpt_blacklist(self._ckpt_blacklist)
        self._finished = dict(st.finished)
        if self.chaos is not None and st.chaos_fired:
            # Scripted events that already fired must not re-fire in
            # this incarnation — a kill_coordinator spec would
            # otherwise kill every adoption forever.
            self.chaos.skip_fired(st.chaos_fired)
        beats = read_heartbeats(self.ft_dir)
        pending_failures: list[Failure] = []
        adopted_hosts: list[int] = []
        dead: list[tuple[int, list[int]]] = []
        # Spawn-window hosts (ISSUE 13 satellite): a `launching` record
        # with no pid record means the predecessor died mid-spawn — the
        # rank may be alive with no journal trace.  Wait a heartbeat
        # grace for its beat to name a pid before condemning it; an
        # immediate relaunch here is exactly the double-spawn the
        # hazard describes.  A RELAUNCH window is the same hazard with
        # a twist: st.procs (and the heartbeat file) still carry the
        # dead predecessor incarnation's pid, so the grace must wait
        # for a beat naming a DIFFERENT pid — the spawned rank's first
        # beat — not just any pid.
        stale = {h: st.procs[h] for h in st.launching if h in st.procs}
        spawning = {h for h in st.launching
                    if h in self.host_ids and h not in self._finished}
        if spawning:
            deadline = self.clock() + self.adopt_spawn_grace_s
            while spawning and self.clock() < deadline:
                missing = []
                for h in spawning:
                    pid = (beats.get(h) or {}).get("pid")
                    if not isinstance(pid, int) or pid == stale.get(h):
                        missing.append(h)
                if not missing:
                    break
                self.sleep(0.1)
                beats = read_heartbeats(self.ft_dir)
        deferred = set(getattr(self.launcher, "deferred_input_host_ids",
                               ()) or ())
        for host in self.host_ids:
            if host in deferred and host not in st.procs:
                # Reserved-but-never-activated input host (ISSUE 18):
                # no incarnation ever existed; mourning it as a crash
                # would degrade an input plane that was never up.
                continue
            if host in self._finished:
                if self.monitor is not None:
                    self.monitor.retire_host(host)
                continue
            # candidates are (pid, journaled start time | None): the
            # start time is the recycling guard (ISSUE 15 satellite) —
            # across a machine reboot the same pid number names a
            # stranger, and the stranger must read as a dead rank, not
            # a live one we would adopt and later SIGKILL.
            cands: list[tuple[int, int | None]] = []
            if host in st.procs:
                # A spawn-window host's st.procs pid IS the dead
                # predecessor being replaced (`launching` postdates
                # it): never a candidate — the OS may have recycled it
                # onto an unrelated process we would adopt and later
                # kill.  The grace loop above already distrusts it.
                if host not in st.launching:
                    cands.append((st.procs[host],
                                  st.proc_starts.get(host)))
            hb_pid = (beats.get(host) or {}).get("pid")
            if isinstance(hb_pid, int) \
                    and hb_pid not in [p for p, _ in cands] \
                    and not (host in st.launching
                             and hb_pid == stale.get(host)):
                cands.append((hb_pid, None))
            live = next(((p, s) for p, s in cands
                         if self._cand_alive(p, s)), None)
            if live is not None:
                self._procs[host] = AdoptedProcess(
                    live[0], host_id=host, ft_dir=self.ft_dir,
                    start_time=live[1])
                adopted_hosts.append(host)
                if self.monitor is not None:
                    self.monitor.activate_host(host)
            else:
                dead.append((host, [p for p, _ in cands]))
        # Resolve the unwatched deaths.  The supervise reaper may still
        # be racing us to land their rc files (it reaps our
        # predecessor's orphans only when it re-enters waitpid after
        # spawning us), so give it the same grace AdoptedProcess.poll
        # gives it — without it, a rank that finished rc 0 during the
        # downtime reads as a CRASH and burns a budget slot relaunching
        # a host that was already done.
        rcs: dict[int, int | None] = {}
        for host, cands in dead:
            rcs[host] = next((r for r in (read_rc(self.ft_dir, p)
                                          for p in cands)
                              if r is not None), None)
        waiting = [h for h, c in dead if c and rcs[h] is None]
        if waiting:
            deadline = self.clock() + ADOPT_RC_GRACE_S
            while waiting and self.clock() < deadline:
                self.sleep(0.05)
                for host, cands in dead:
                    if rcs[host] is None:
                        rcs[host] = next(
                            (r for r in (read_rc(self.ft_dir, p)
                                         for p in cands)
                             if r is not None), None)
                waiting = [h for h, c in dead if c and rcs[h] is None]
        for host, cands in dead:
            rc = rcs[host]
            if rc == 0:
                self._j("host_exit", host=host, rc=0)
                self._finished[host] = 0
                if self.monitor is not None:
                    self.monitor.retire_host(host)
            else:
                pending_failures.append(Failure(
                    host, FailureKind.CRASH, rc=rc,
                    detail="died while the coordinator was down"
                           if cands else "no incarnation on record"))
        self.hosts_g.set(len(self._procs))
        self.coord_adoptions_c.add()
        self._j("adopted", hosts=adopted_hosts,
                dead=[f.host_id for f in pending_failures],
                pending=None if st.pending is None else st.pending.incident,
                replay_ms=self._journal_replay_ms,
                compacted=compacted)
        self._event("coordinator_adopted", hosts=adopted_hosts,
                    dead=[f.host_id for f in pending_failures],
                    budget_used=self.policy.budget.used,
                    incident=self._incident,
                    pending_incident=(None if st.pending is None
                                      else st.pending.incident),
                    torn=bool(torn),
                    journal_replay_ms=self._journal_replay_ms)
        if st.pending is None \
                or st.pending.action != Action.DRAIN_RESTART.value:
            # No drain is in flight: drain/notice files (and a notice
            # consumed into memory pre-crash) are stale protocol state.
            clear_drain(self.ft_dir)
            consume_notice(self.ft_dir)
        if st.pending is not None:
            completed = self._complete_pending(st.pending, t0)
            pending_failures = [f for f in pending_failures
                                if f.host_id not in completed]
        self._adopt_failures = pending_failures

    @staticmethod
    def _cand_alive(pid: int, expect_start: int | None) -> bool:
        """Is this candidate pid the journaled incarnation?  Alive AND
        — when the journal recorded a start time — bearing the same
        kernel start time; a live pid with a DIFFERENT start time is a
        recycled number on an unrelated process (machine rebooted, or
        a long downtime), and the rank it claimed is dead-unwatched."""
        if not pid_alive(pid):
            return False
        if expect_start is not None:
            cur = pid_start_time(pid)
            if cur is not None and cur != expect_start:
                return False
        return True

    def _complete_pending(self, p: PendingIntent, t0: float) -> set[int]:
        """Finish a restart intent whose commit never landed — exactly
        once: when the launch half already ran (launch records after
        the intent), only the commit is written; otherwise the act runs
        now.  Either way the budget draw journaled with the intent is
        never re-drawn.  Returns the hosts the completion relaunched
        (their unwatched deaths are moot)."""
        action = p.action
        self.coord_pending_g.set(1)
        if not p.launched:
            if action == Action.SOLO_RESTART.value:
                # Hosts whose solo_launched already landed pre-crash got
                # their restart — redoing them would be the double the
                # intent/commit pair exists to prevent.
                todo = [h for h in p.hosts if h not in p._solo_done]
                for h in todo:
                    if h in self._procs:
                        self._stop_hosts([h])
                    self._launch_solo(h)
                self.ft_solo_restarts_c.add(len(todo))
                self.ft_restarts_c.add(len(todo))
                self.restarts_c.add(len(todo))
                completed = set(todo)
            else:  # gang-shaped: gang_restart / drain_restart / ckpt_retry
                self._stop_hosts(list(self._procs))
                if self.ft_dir is not None:
                    clear_drain(self.ft_dir)
                if action == "provision_grow":
                    # The predecessor died between its grow intent and
                    # the relaunch: the activation must still happen or
                    # the completed relaunch would re-defer the input
                    # plane the decision already paid for.
                    self.launcher.activate_input_plane()
                self._launch_gang(first=False)
                if action == Action.DRAIN_RESTART.value:
                    self.ft_preempt_drains_c.add()
                    self.ft_planned_restarts_c.add()
                else:
                    self.ft_gang_restarts_c.add()
                    self.ft_restarts_c.add()
                    self.restarts_c.add()
                completed = set(self.host_ids)
        else:
            completed = set()  # acted pre-crash; only the commit is owed
        crash_point("adopt_before_commit", self.ft_dir)
        self._j("restart_commit", incident=p.incident, action=action)
        self.coord_pending_g.set(0)
        mttr = self.clock() - t0
        planned = p.planned or action == Action.DRAIN_RESTART.value
        (self.ft_planned_mttr_s if planned else self.ft_mttr_s).observe(mttr)
        self._event("recovered", incident=p.incident, action=action,
                    planned=planned, mttr_s=round(mttr, 4), adopted=True,
                    journal_replay_ms=self._journal_replay_ms)
        # Goodput attribution for the adoption-completed incident: the
        # pre-crash coordinator died before it could write this row, and
        # the replay share of the downtime is named (ISSUE 13 satellite).
        self._event("goodput_incident", incident=p.incident, action=action,
                    planned=planned, downtime_s=round(mttr, 4),
                    detection_s=round(self.poll_interval, 4),
                    fleet_step=self._last_fleet_step,
                    journal_replay_ms=self._journal_replay_ms)
        return completed

    def _handle_input_failures(self, failures: list[Failure]
                               ) -> list[Failure]:
        """Strip and absorb failures of input-role hosts (ISSUE 11).

        A dead input host is a capacity loss, not a gang failure: the
        trainers' resilient streams fail over to the surviving input
        hosts and then degrade to LOCAL loading from the exact batch
        cursor — the run's trajectory is unchanged, only its input
        throughput.  So: stop/reap the host, retire its heartbeat,
        record ``input_degraded``, optionally solo-relaunch (bounded,
        budget untouched), and hand everything else back to the normal
        detect→decide path."""
        inputs = [f for f in failures if f.host_id in self.input_host_ids]
        if not inputs:
            return failures
        for f in inputs:
            self._j("input_degraded", host=f.host_id)
            if f.host_id in self._procs:
                # a hung service still holds its socket: stop it so
                # trainer recv calls fail fast instead of timing out
                self._stop_hosts([f.host_id])
            self._finished.setdefault(f.host_id, 0)
            self._suppressed_hangs.discard(f.host_id)
            if self.monitor is not None:
                self.monitor.retire_host(f.host_id)
            self.ft_input_degraded_c.add()
            self._event("input_degraded", host=f.host_id,
                        failure=f.kind.value, rc=f.rc, detail=f.detail)
            used = self._input_restarts.get(f.host_id, 0)
            if self.restart_input_hosts and used < self.max_input_restarts:
                self._input_restarts[f.host_id] = used + 1
                self._j("input_restarted", host=f.host_id,
                        restarts=used + 1)
                self._launch_solo(f.host_id)
                self.ft_input_restarts_c.add()
                self._event("input_recovered", host=f.host_id,
                            restarts=used + 1)
        return [f for f in failures if f.host_id not in self.input_host_ids]

    def _release_idle_input_hosts(self) -> None:
        """Once every trainer rank has finished, surviving input hosts
        are holding the run open for nobody — stop them cleanly so the
        supervisor can declare the run done (the trainer rc decides)."""
        if not self.input_host_ids or not self._procs:
            return
        if any(h not in self.input_host_ids for h in self._procs):
            return  # a trainer is still running
        ids = sorted(self._procs)
        self._stop_hosts(ids)
        for h in ids:
            self._j("host_exit", host=h, rc=0)
            self._finished.setdefault(h, 0)
            if self.monitor is not None:
                self.monitor.retire_host(h)
            self._event("host_exit", host=h, rc=0,
                        note="input host stopped after trainers finished")

    # -- provisioner policy loop (ISSUE 18) --------------------------------

    def _provision_tick(self, now: float) -> None:
        """One observe→decide→actuate cycle of the provisioner policy,
        throttled to ``provision_interval_s`` and run only from the
        no-failure branch of the supervision loop (an incident in
        flight owns the fleet; resizing under it would race the
        restart).

        The observation window is filtered by wall-clock ``t`` (the
        clock ledger records carry) from the last actuation forward —
        NOT this coordinator's injectable monotonic clock — so a grow
        is judged by post-grow evidence only."""
        if self.provision_policy is None or self.goodput_dir is None:
            return
        if now < self._next_provision:
            return
        self._next_provision = now + self.provision_interval_s
        from tpucfn_torch.obs.goodput import fleet_window_observation
        from tpucfn_torch.provision.policy import FleetObservation, PolicyAction

        raw = fleet_window_observation(self.goodput_dir,
                                       since_t=self._provision_since_t)
        obs = None
        if raw is not None:
            obs = FleetObservation(
                wall_s=raw["wall_s"], goodput_ratio=raw["goodput_ratio"],
                shares=raw["shares"], num_hosts=raw["num_hosts"])
            self.provision_data_wait_share_g.set(
                round(obs.data_wait_share, 6))
            self.provision_goodput_ratio_g.set(
                round(obs.goodput_ratio, 6))
        deferred = set(getattr(self.launcher, "deferred_input_host_ids",
                               ()) or ())
        active_inputs = sum(1 for h in self.input_host_ids
                            if h not in deferred)
        self.provision_input_hosts_g.set(active_inputs)
        decision = self.provision_policy.decide(
            obs, input_hosts=active_inputs, now=now)
        if decision.action is PolicyAction.HOLD:
            return
        self.provision_decisions_c.add()
        self._j("provision_decision", action=decision.action.value,
                signal=decision.signal.value,
                data_wait_share=round(decision.data_wait_share, 6))
        self._event("provision_decision", action=decision.action.value,
                    signal=decision.signal.value, reason=decision.reason,
                    data_wait_share=round(decision.data_wait_share, 6),
                    goodput_ratio=round(decision.goodput_ratio, 6),
                    input_hosts=active_inputs)
        if decision.action is PolicyAction.GROW_INPUT_HOSTS:
            self._provision_grow(decision, sorted(deferred))
        elif decision.action is PolicyAction.SHRINK_INPUT_HOSTS:
            self._provision_shrink(decision)
        elif decision.action is PolicyAction.FLAG_STARVED:
            self.provision_flagged_g.set(1)
            if not self._provision_flagged:
                # one event per chronic episode; the gauge stays up
                self._provision_flagged = True
                self._event(
                    "provision_flagged", reason=decision.reason,
                    data_wait_share=round(decision.data_wait_share, 6))

    def _provision_grow(self, decision, deferred: list[int]) -> None:
        """Actuate a grow decision: drain the trainers to one step
        boundary (the force-save lands there; the relaunch re-executes
        nothing), activate the launcher's reserved input plane, and
        relaunch the gang — trainers now see TPUCFN_INPUT_ADDRS and
        stream served batches.  A PLANNED restart: zero budget, and the
        latency is the real-world measurement of the policy's
        actuation-latency model (fetch-warm relaunch, ISSUE 13)."""
        if not deferred:
            return  # nothing reserved to activate
        t0 = self.clock()
        self._incident += 1
        incident = self._incident
        self._j("restart_intent", incident=incident,
                action="provision_grow", hosts=[],
                budget_used=self.policy.budget.used, planned=True)
        self.coord_pending_g.set(1)
        crash_point("after_intent", self.ft_dir)
        target = None
        if self._last_fleet_step is not None:
            target = self._last_fleet_step + self.drain_step_margin
        drain_file = None
        if self.ft_dir is not None:
            drain_file = request_drain(self.ft_dir, step=target)
            self._j("drain_armed", incident=incident, step=target)
        self._event("drain", incident=incident, hosts=deferred,
                    step=target, grace_s=round(self.drain_grace_s, 3),
                    file=None if drain_file is None else str(drain_file))
        if drain_file is not None:
            deadline = self.clock() + self.drain_grace_s
            while (any(p.poll() is None for p in self._procs.values())
                   and self.clock() < deadline):
                self.sleep(self.poll_interval)
        leftovers = [p for p in self._procs.values() if p.poll() is None]
        if leftovers:
            self.launcher.stop_all(leftovers, grace_s=self.term_grace_s,
                                   poll_interval=self.poll_interval)
        self._procs.clear()
        if self.ft_dir is not None:
            clear_drain(self.ft_dir)
        self.launcher.activate_input_plane()
        self._launch_gang(first=False)
        crash_point("before_commit", self.ft_dir)
        self._j("restart_commit", incident=incident,
                action="provision_grow")
        self.coord_pending_g.set(0)
        latency = self.clock() - t0
        self.provision_grow_c.add()
        self.ft_planned_restarts_c.add()
        self.ft_planned_mttr_s.observe(latency)
        self.provision_actuation_s.observe(latency)
        # Judge the grow by post-grow evidence only.
        self._provision_since_t = time.time()
        self._event("provision_actuated", incident=incident,
                    action="grow_input_hosts", hosts=deferred,
                    latency_s=round(latency, 4),
                    model_latency_s=round(decision.actuation_latency_s, 4))
        self._event("recovered", incident=incident,
                    action="provision_grow", planned=True,
                    mttr_s=round(latency, 4))
        self._event("goodput_incident", incident=incident,
                    action="provision_grow", planned=True,
                    downtime_s=round(latency, 4),
                    detection_s=round(self.provision_interval_s, 4),
                    fleet_step=self._last_fleet_step)

    def _provision_shrink(self, decision) -> None:
        """Actuate a shrink decision: stop the live input hosts.  No
        trainer restart — the resilient service streams (ISSUE 11)
        degrade to local loading at the exact batch cursor, so the
        trajectory is untouched; only the input topology changes.  The
        hosts go back to reserved-but-deferred, so a later starvation
        verdict can grow them again."""
        live = sorted(h for h in self._procs if h in self.input_host_ids)
        if not live:
            return
        t0 = self.clock()
        self._j("provision_shrink", hosts=live)
        self._stop_hosts(live)
        for h in live:
            self._j("host_exit", host=h, rc=0)
            self._finished.setdefault(h, 0)
            if self.monitor is not None:
                self.monitor.retire_host(h)
        if hasattr(self.launcher, "defer_input_plane"):
            self.launcher.defer_input_plane = True
        latency = self.clock() - t0
        self.provision_shrink_c.add()
        self.provision_actuation_s.observe(latency)
        self.provision_input_hosts_g.set(0)
        self._provision_since_t = time.time()
        self._event("provision_actuated", action="shrink_input_hosts",
                    hosts=live, latency_s=round(latency, 4))

    def _handle_incident(self, failures: list[Failure]) -> int | None:
        """One detect→decide→act→recovered cycle; returns the run's exit
        code when the incident ends the run, else None."""
        t_detect = self.clock()
        self._incident += 1
        incident = self._incident
        self.ft_incidents_c.add()
        self._refresh_ckpt_blacklist()
        real = [f for f in failures if f.kind in (FailureKind.CRASH,
                                                  FailureKind.HANG)]
        if real:
            self.ft_failures_c.add(len(real))
            self.failures_c.add()
            self.rc_g.set(self._failure_rc(real))
        fail_json = [{"host": f.host_id, "kind": f.kind.value, "rc": f.rc,
                      "step": f.step, "detail": f.detail,
                      **({"lead_s": f.lead_s} if f.lead_s is not None
                         else {})} for f in failures]
        self._j("incident_open", incident=incident, failures=[
            {"host": f.host_id, "kind": f.kind.value, "rc": f.rc}
            for f in failures])
        self._event("detect", incident=incident, failures=fail_json)
        crash_point("after_detect", self.ft_dir)
        if self.tracer is not None:
            self.tracer.event("ft_detect", trace_id=incident,
                              failures=fail_json)
        if real:
            # Forensics before recovery: the survivors' flight rings
            # and span tails are about to be killed with the gang
            # (ISSUE 6 tentpole; span tails ISSUE 20).
            self._capture_flight(incident, {f.host_id for f in real})
            self._capture_spans(incident, {f.host_id for f in real})
        # Checkpoint-corruption retry (ISSUE 7): a gang whose ranks exit
        # with the restore-failure rc is not a fleet failure — the
        # artifact is bad.  Retry from the previous finalized step
        # instead of crash-looping the same corrupt checkpoint through
        # the restart budget into give_up.  Handled before the policy so
        # the budget is untouched; past max_ckpt_retries (or with no
        # finalized step left to blacklist) the normal table decides.
        if (real and self.ckpt_dir is not None
                and self._ckpt_retries < self.max_ckpt_retries
                and all(f.kind is FailureKind.CRASH
                        and f.rc == RESTORE_FAILED_RC for f in real)):
            bad = _latest_finalized_step(self.ckpt_dir,
                                         exclude=self._ckpt_blacklist)
            # Retry only when there is BOTH a step to blacklist and an
            # earlier finalized step to resume from.  Quarantining the
            # last remaining checkpoint would make the relaunch init
            # fresh and "succeed" from step 0 — recovery must not
            # silently retrain; crash-looping into a loud give_up (the
            # restore-failure rc) is the honest outcome, and the
            # quarantined steps are plain renames under corrupt/ the
            # operator can move back.
            if bad is not None and _latest_finalized_step(
                    self.ckpt_dir,
                    exclude=self._ckpt_blacklist | {bad}) is not None:
                return self._ckpt_retry(incident, bad, t_detect)
        decision = self.policy.decide(failures)
        self._event("decide", incident=incident,
                    action=decision.action.value,
                    hosts=list(decision.hosts),
                    delay_s=round(decision.delay_s, 3),
                    planned=decision.planned,
                    reason=decision.reason)

        if decision.action is Action.NONE:
            # A table can declare a failure non-actionable (observe-
            # only); the incident must then be closed, not re-detected
            # every poll tick: reap crashed hosts with their rc, and
            # suppress further HANG verdicts until the host beats again.
            for f in failures:
                if f.kind is FailureKind.CRASH and f.host_id in self._procs:
                    self._j("host_exit", host=f.host_id,
                            rc=f.rc if f.rc else 1)
                    del self._procs[f.host_id]
                    self._finished[f.host_id] = f.rc if f.rc else 1
                elif f.kind is FailureKind.HANG:
                    self._suppressed_hangs.add(f.host_id)
            self._j("incident_closed", incident=incident, action="none")
            return None
        if decision.action is Action.GIVE_UP:
            rc = self._failure_rc(failures)
            self._j("give_up", incident=incident, rc=rc)
            self.ft_give_ups_c.add()
            self._stop_hosts(list(self._procs))
            self.rc_g.set(rc)
            self._event("give_up", incident=incident, rc=rc,
                        reason=decision.reason)
            if self.tracer is not None:
                self.tracer.record("ft_give_up", start=t_detect,
                                   end=self.clock(), trace_id=incident,
                                   rc=rc)
            return rc

        # Write-ahead intent (ISSUE 12): the decision — including the
        # budget slot it drew — is durable BEFORE any process is
        # touched.  A coordinator crash anywhere between here and the
        # matching restart_commit leaves a pending intent the adopting
        # incarnation completes exactly once.
        self._j("restart_intent", incident=incident,
                action=decision.action.value, hosts=list(decision.hosts),
                budget_used=self.policy.budget.used,
                planned=decision.planned)
        self.coord_pending_g.set(1)
        crash_point("after_intent", self.ft_dir)

        if decision.action is Action.DRAIN_RESTART:
            return self._drain_restart(incident, decision, failures,
                                       t_detect)

        if decision.delay_s > 0:
            self.sleep(decision.delay_s)
        # A preemption notice that arrived in the same tick as a real
        # failure lost the decision to the restart — but the machine is
        # still going away, and the notice was already one-shot
        # consumed.  Re-queue it so the next tick raises a PREEMPT-only
        # incident against the relaunched gang and the drain still
        # happens ahead of the actual preemption.  (Only on restart
        # shapes: an observe-only NONE table would re-fire forever, and
        # after GIVE_UP there is nothing left to drain.)
        for f in failures:
            if f.kind is FailureKind.PREEMPT:
                self._pending_notices.append(
                    PreemptNotice(host=f.host_id, lead_s=f.lead_s))
        extra: dict = {}
        # Elastic shrink (ISSUE 7): a restart cannot bring back a host
        # the fleet has lost for good (chaos lose_host, or the control
        # plane reports it gone) — re-converge the contract at N-k and
        # relaunch the smaller gang instead of crash-looping relaunches
        # of a machine that no longer exists.
        failed_hosts = {f.host_id for f in real} | set(decision.hosts)
        lost = {h for h in failed_hosts
                if h in self.host_ids and self._host_lost(h)}
        if lost and self.allow_shrink:
            if len(self.host_ids) - len(lost) < 1:
                rc = self._failure_rc(failures)
                self._j("give_up", incident=incident, rc=rc)
                self.coord_pending_g.set(0)
                self.ft_give_ups_c.add()
                self._stop_hosts(list(self._procs))
                self.rc_g.set(rc)
                self._event("give_up", incident=incident, rc=rc,
                            reason=f"all {len(self.host_ids)} host(s) "
                                   "lost — nothing left to shrink to")
                if self.tracer is not None:
                    self.tracer.record("ft_give_up", start=t_detect,
                                       end=self.clock(), trace_id=incident,
                                       rc=rc)
                return rc
            self._stop_hosts(list(self._procs))
            extra["shrink"] = self._do_shrink(incident, lost)
            self._launch_gang(first=False)
            self.ft_gang_restarts_c.add()
            self.ft_restarts_c.add()
            self.restarts_c.add()
        elif decision.action is Action.SOLO_RESTART:
            self._stop_hosts(decision.hosts)
            for h in decision.hosts:
                self._launch_solo(h)
            evicted = sum(1 for f in failures
                          if f.kind is FailureKind.STRAGGLER
                          and f.host_id in decision.hosts)
            if evicted:
                self.ft_evictions_c.add(evicted)
            self.ft_solo_restarts_c.add(len(decision.hosts))
            self.ft_restarts_c.add(len(decision.hosts))
            self.restarts_c.add(len(decision.hosts))
        else:  # GANG_RESTART
            self._stop_hosts(list(self._procs))
            self._launch_gang(first=False)
            self.ft_gang_restarts_c.add()
            self.ft_restarts_c.add()
            self.restarts_c.add()
        crash_point("before_commit", self.ft_dir)
        self._j("restart_commit", incident=incident,
                action=decision.action.value)
        self.coord_pending_g.set(0)
        mttr = self.clock() - t_detect
        self.ft_mttr_s.observe(mttr)
        self._event("recovered", incident=incident,
                    action=decision.action.value, mttr_s=round(mttr, 4),
                    **extra)
        # Goodput attribution (ISSUE 5): one ledger row per incident so
        # `tpucfn obs goodput` can name who stole the fleet's seconds.
        # detection_s is the estimated failure→detect latency: a HANG is
        # by construction dead_after_s of silent heartbeats old when the
        # verdict lands; a CRASH is caught within one poll tick.
        detection_s = self.poll_interval
        if self.monitor is not None and any(
                f.kind is FailureKind.HANG for f in failures):
            detection_s = self.monitor.config.dead_s
        self._event("goodput_incident", incident=incident,
                    action=decision.action.value,
                    planned=False,
                    downtime_s=round(mttr, 4),
                    detection_s=round(detection_s, 4),
                    fleet_step=self._last_fleet_step,
                    **extra)
        if self.tracer is not None:
            self.tracer.record("ft_recover", start=t_detect, dur_s=mttr,
                               trace_id=incident,
                               action=decision.action.value,
                               hosts=list(decision.hosts))
        return None

    # -- graceful degradation (ISSUE 7) -----------------------------------

    def _refresh_ckpt_blacklist(self) -> None:
        """Expire the corruption blacklist once the run has finalized a
        step NEWER than everything on it: the re-run has re-saved past
        the quarantined artifact, and keeping the stale blacklist would
        make every later ordinary restart skip a perfectly good latest
        checkpoint and silently rewind a full interval of real work.
        The retry budget re-arms with it — its job is to stop loops on
        the SAME artifacts, and those are gone."""
        if not self._ckpt_blacklist or self.ckpt_dir is None:
            return
        newest = _latest_finalized_step(self.ckpt_dir,
                                        exclude=self._ckpt_blacklist)
        if newest is not None and newest > max(self._ckpt_blacklist):
            self._event("ckpt_blacklist_expired",
                        blacklist=sorted(self._ckpt_blacklist),
                        newest_step=newest)
            self._ckpt_blacklist.clear()
            self._ckpt_retries = 0
            self.launcher.extra_env.pop(CKPT_BLACKLIST_ENV, None)

    def _host_lost(self, host_id: int) -> bool:
        """Is this host gone for good?  Chaos ``lose_host`` marks it
        directly; otherwise the control plane is asked through
        ``reacquire_check(address)`` — best-effort, because a flaky
        control-plane answer must degrade to a same-size restart, not
        block recovery."""
        if host_id in self._lost_hosts:
            return True
        if self.reacquire_check is None:
            return False
        hosts = self.launcher.contract.hosts()[
            : self.launcher.contract.workers_count]
        if not 0 <= host_id < len(hosts):
            return False
        try:
            return not self.reacquire_check(hosts[host_id])
        except Exception:  # noqa: BLE001 — see docstring
            return False

    def _drain_restart(self, incident: int, decision: Decision,
                       failures: list[Failure], t_detect: float) -> None:
        """Preemption drain: converge the gang on one step boundary via
        the drain file, let every rank force-save and exit clean, then
        relaunch as a PLANNED restart — zero lost work, zero budget.
        The drain target is fleet max step + margin so laggards can
        still reach it inside the notice's lead time."""
        leads = [f.lead_s for f in failures
                 if f.kind is FailureKind.PREEMPT and f.lead_s]
        grace = min([*leads, self.drain_grace_s]) if leads \
            else self.drain_grace_s
        target = None
        if self._last_fleet_step is not None:
            target = self._last_fleet_step + self.drain_step_margin
        # Input hosts don't watch drain.json (they have no step to
        # converge on) — stop them up front (SIGTERM drains the service
        # cleanly) so the wait below covers only trainer ranks instead
        # of burning the whole grace on a role that can never exit it.
        input_live = [h for h in self._procs if h in self.input_host_ids]
        if input_live:
            self._stop_hosts(input_live)
        drain_file = None
        if self.ft_dir is not None:
            drain_file = request_drain(self.ft_dir, step=target)
            self._j("drain_armed", incident=incident, step=target)
        self._event("drain", incident=incident, hosts=list(decision.hosts),
                    step=target, grace_s=round(grace, 3),
                    file=None if drain_file is None else str(drain_file))
        escalated = 0
        if drain_file is not None:
            deadline = self.clock() + grace
            while (any(p.poll() is None for p in self._procs.values())
                   and self.clock() < deadline):
                self.sleep(self.poll_interval)
        leftovers = [p for p in self._procs.values() if p.poll() is None]
        if leftovers:
            # No drain channel (ft_dir unset), or the lead time ran out:
            # stop the stragglers the hard way.  Still a planned
            # restart — the preemption was coming either way — just a
            # less graceful one, and the event says so.
            escalated = self.launcher.stop_all(
                leftovers, grace_s=self.term_grace_s,
                poll_interval=self.poll_interval)
        dirty = sorted(h for h, p in self._procs.items()
                       if p.poll() not in (0, None))
        self._procs.clear()
        if self.ft_dir is not None:
            # A relaunched gang polling a stale drain file would
            # immediately drain itself again.
            clear_drain(self.ft_dir)
        extra: dict = {}
        # A preempted host the control plane will not give back turns
        # the planned relaunch into a planned shrink.
        lost = {h for h in self.host_ids if self._host_lost(h)}
        if (lost and self.allow_shrink
                and len(self.host_ids) - len(lost) >= 1):
            extra["shrink"] = self._do_shrink(incident, lost)
        self._launch_gang(first=False)
        crash_point("before_commit", self.ft_dir)
        self._j("restart_commit", incident=incident,
                action=decision.action.value)
        self.coord_pending_g.set(0)
        self.ft_preempt_drains_c.add()
        self.ft_planned_restarts_c.add()
        mttr = self.clock() - t_detect
        self.ft_planned_mttr_s.observe(mttr)
        self._event("recovered", incident=incident,
                    action=decision.action.value, planned=True,
                    mttr_s=round(mttr, 4), escalated=escalated,
                    dirty_exits=dirty, **extra)
        self._event("goodput_incident", incident=incident,
                    action=decision.action.value, planned=True,
                    downtime_s=round(mttr, 4),
                    detection_s=round(self.poll_interval, 4),
                    fleet_step=self._last_fleet_step, **extra)
        if self.tracer is not None:
            self.tracer.record("ft_recover", start=t_detect, dur_s=mttr,
                               trace_id=incident,
                               action=decision.action.value,
                               hosts=list(decision.hosts))
        return None

    def _do_shrink(self, incident: int, lost: set[int]) -> dict:
        """Re-converge the contract at N-k (stopped gang assumed):
        survivors renumber to 0..N-k-1, the monitor re-scopes (the old
        highest ids' heartbeat files must stop being judged), and the
        launcher's next launch uses the new generation's hostfile.  The
        caller relaunches."""
        old_n = len(self.host_ids)
        new_contract = shrink_contract(self.launcher.contract, sorted(lost))
        self.launcher.contract = new_contract
        new_n = new_contract.workers_count
        if self.monitor is not None:
            for h in range(new_n, old_n):
                self.monitor.retire_host(h)
            self.monitor.set_expected_hosts(new_n)
        self.host_ids = list(range(new_n))
        # Renumbered ids make the old lost-markers meaningless; a host
        # lost in the NEW numbering will be re-marked when it fails.
        self._lost_hosts.clear()
        self.ft_shrinks_c.add()
        info = {"from_hosts": old_n, "to_hosts": new_n,
                "lost": sorted(lost),
                "generation": new_contract.generation}
        self._j("shrink", incident=incident, **info)
        self._event("shrink", incident=incident, **info)
        return info

    def _ckpt_retry(self, incident: int, bad_step: int,
                    t_detect: float) -> None:
        """Blacklist + quarantine the checkpoint that failed to restore
        and relaunch to resume from the previous finalized step.  The
        quarantine rename is what frees the step number for a fresh
        save after the re-run; the env blacklist is the belt-and-braces
        for ranks whose manager opened before the rename (or if the
        rename failed)."""
        self._ckpt_retries += 1
        self._ckpt_blacklist.add(bad_step)
        self._j("ckpt_retry", incident=incident, bad_step=bad_step,
                blacklist=sorted(self._ckpt_blacklist))
        self._j("restart_intent", incident=incident, action="ckpt_retry",
                hosts=[], budget_used=self.policy.budget.used)
        self.coord_pending_g.set(1)
        crash_point("after_intent", self.ft_dir)
        self.ft_ckpt_retries_c.add()
        quarantine = None
        src = self.ckpt_dir / str(bad_step)
        if src.is_dir():
            dst = self.ckpt_dir / "corrupt" / str(bad_step)
            try:
                dst.parent.mkdir(parents=True, exist_ok=True)
                src.rename(dst)
                quarantine = str(dst)
            except OSError:
                pass  # blacklist env still steers the resume past it
        self.launcher.extra_env[CKPT_BLACKLIST_ENV] = \
            format_ckpt_blacklist(self._ckpt_blacklist)
        retry_from = _latest_finalized_step(self.ckpt_dir,
                                            exclude=self._ckpt_blacklist)
        ckpt_info = {"bad_step": bad_step, "retry_from": retry_from}
        self._event("ckpt_retry", incident=incident,
                    blacklist=sorted(self._ckpt_blacklist),
                    quarantine=quarantine, **ckpt_info)
        self._stop_hosts(list(self._procs))
        self._launch_gang(first=False)
        crash_point("before_commit", self.ft_dir)
        self._j("restart_commit", incident=incident, action="ckpt_retry")
        self.coord_pending_g.set(0)
        self.ft_gang_restarts_c.add()
        self.ft_restarts_c.add()
        self.restarts_c.add()
        mttr = self.clock() - t_detect
        self.ft_mttr_s.observe(mttr)
        self._event("recovered", incident=incident, action="ckpt_retry",
                    mttr_s=round(mttr, 4), ckpt=ckpt_info)
        self._event("goodput_incident", incident=incident,
                    action="ckpt_retry", planned=False,
                    downtime_s=round(mttr, 4),
                    detection_s=round(self.poll_interval, 4),
                    fleet_step=self._last_fleet_step, ckpt=ckpt_info)
        if self.tracer is not None:
            self.tracer.record("ft_recover", start=t_detect, dur_s=mttr,
                               trace_id=incident, action="ckpt_retry",
                               hosts=[])
        return None


def _latest_finalized_step(ckpt_dir: str | Path,
                           exclude: set[int] | frozenset[int] = frozenset()
                           ) -> int | None:
    """Latest finalized checkpoint step by scanning the directory —
    finalized step dirs are bare numbers; in-flight orbax saves carry a
    tmp suffix and quarantined corrupt steps live under ``corrupt/``,
    so neither matches.  (Orbax's own ``latest_step()`` serves a list
    cached at manager init, which the supervisor never opened.)"""
    try:
        entries = list(Path(ckpt_dir).iterdir())
    except OSError:
        return None
    steps = [int(p.name) for p in entries
             if p.is_dir() and p.name.isdigit()
             and int(p.name) not in exclude]
    return max(steps, default=None)
