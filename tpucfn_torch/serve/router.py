"""Replica router — the robustness-first stage of the serve tier
(ISSUE 9 tentpole).

One :class:`~tpucfn.serve.frontend.Server` is continuous-batching well;
the ROADMAP's million-user serve tier needs many, and the failure
handling belongs in the routing layer (PAPERS.md: TF-Replicator's
pattern — replicate the worker, let the router own failures).  The
:class:`ReplicaRouter` fronts N replica ``Server``s (in-process handles
now; the launch fan-out already gives each replica its own obs and
heartbeat ports for the multi-host stage) and owns four behaviors:

* **Health-driven failover.**  Per-replica health is the existing
  ``ft.heartbeat`` classifier (each replica's serve LOOP beats a
  :class:`~tpucfn.ft.heartbeat.HeartbeatWriter`, so a frozen loop reads
  SUSPECT→DEAD) plus a consecutive-error :class:`CircuitBreaker`
  (closed → open on K failures → half-open probe).  A dead replica
  becomes an ft-style incident: a ``detect`` row in
  ``<ft_dir>/events.jsonl``, a flight-ring capture from every surviving
  replica (the coordinator's forensics discipline, ISSUE 6), a relaunch
  through the replica factory, and re-admission after warmup (the
  relaunched replica starts in half-open probation until its first
  success).
* **Deadline-budgeted retry.**  ``submit`` carries a deadline *budget*:
  on replica death or a 5xx-equivalent engine failure the unfinished
  request is resubmitted to a healthy replica with the REMAINING
  budget (never more than the original deadline), bounded by
  ``retry_budget`` resubmissions.  Greedy decode makes the resubmission
  idempotent — a retried request's tokens are bit-identical to the
  uninterrupted run, which is what lets the retry be transparent.
* **Hedging.**  Optionally, a duplicate fires to a second replica after
  a p99-derived delay (floored at ``hedge_ms``); first completion wins,
  delivered exactly once, and the loser is cancelled
  (``Server.cancel`` → the scheduler drops it at the next step
  boundary).
* **Graceful drain.**  ``drain(i)`` closes admission on replica ``i``,
  hands its queued-not-started work back to the router (resubmitted
  elsewhere immediately), and gives in-flight sequences a grace window
  to finish; whatever misses the window is requeued too.

SLO shedding moves per-replica here (the ROADMAP follow-on): a replica
whose own ``serve_slo_*`` burn rate is sustained above 1 stops
receiving fresh traffic while healthy replicas absorb it; only when
EVERY routable replica is burning does the router 429.

The router is a :class:`~tpucfn.ft.chaos.ChaosTarget` for the serve
ops (``kill_replica`` / ``freeze_replica`` / ``slow_replica``), so
every path above is a deterministic drill.
"""

from __future__ import annotations

import json
import threading
import time
from pathlib import Path
from typing import Callable

from tpucfn_torch.ft.chaos import ChaosTarget
from tpucfn_torch.ft.heartbeat import (
    HeartbeatMonitor,
    HeartbeatWriter,
    HostState,
    MonitorConfig,
)
from tpucfn_torch.obs.registry import MetricRegistry
from tpucfn_torch.serve.frontend import (
    AdmissionError,
    DeadlineExceeded,
    ReplicaFailed,
    Server,
)

# Replica state encoding for the aggregate gauges: the routable states
# first, so "worst > 0" alerts read as "some replica not fully trusted"
# and "worst >= 3" as "some replica out of rotation".  Exported as
# AGGREGATES (`router_replica_state_worst`, `router_replicas_routable`)
# — the ISSUE 14 migration off PR 8's per-replica
# `router_replica_state_{i}` family, which scaled /metrics cardinality
# with the fleet (the registry-cardinality rule's one baselined
# finding, now deleted; per-replica detail lives in `snapshot()`).
REPLICA_STATE_CODES = {"closed": 0, "half_open": 1, "open": 2,
                       "draining": 3, "stopped": 4, "dead": 5}

# How long a relaunch waits for the killed incarnation's serve thread
# to exit before refusing to start a second loop on the same engine.
RELAUNCH_JOIN_S = 10.0

# Router-level deadline enforcement slack: the replica's own serve loop
# is the primary expiry enforcer; the router's sweep fires only this
# long AFTER the deadline, catching requests stuck on a loop too wedged
# to expire them itself.
EXPIRY_SWEEP_SLACK_S = 1.0


class ReplicaTracer:
    """Tracer shim for replica Servers sharing one host-level Tracer:
    every replica numbers its requests from 0, so raw ``trace_id``s
    collide across replicas and the request-lifecycle breakdown would
    fuse unrelated requests.  This namespaces ids (replica * 1e9 + id,
    still ints) and stamps a ``replica`` field on every span/event."""

    _NS = 1_000_000_000

    def __init__(self, tracer, replica: int):
        self._t = tracer
        self.replica = replica

    @property
    def enabled(self) -> bool:
        return self._t.enabled

    def _kw(self, kw: dict) -> dict:
        if kw.get("trace_id") is not None:
            kw["trace_id"] = self.replica * self._NS + kw["trace_id"]
        kw.setdefault("replica", self.replica)
        return kw

    def event(self, kind, **kw):
        return self._t.event(kind, **self._kw(kw))

    def record(self, name, **kw):
        return self._t.record(name, **self._kw(kw))


class CircuitBreaker:
    """Consecutive-error breaker: closed → open after ``threshold``
    consecutive failures → half-open probe after ``cooldown_s`` → closed
    on probe success, back to open on probe failure.

    NOT internally locked: the router mutates it only under its own
    lock (state transitions must be atomic with replica selection).
    ``probation()`` force-enters half-open — a relaunched replica must
    earn one success before it is fully trusted again (re-admission
    after warmup).
    """

    def __init__(self, *, threshold: int = 3, cooldown_s: float = 5.0):
        if threshold < 1:
            raise ValueError(f"threshold must be >= 1, got {threshold}")
        self.threshold = threshold
        self.cooldown_s = float(cooldown_s)
        self._state = "closed"
        self._failures = 0
        self._open_until = 0.0
        self._probe_inflight = False

    def state(self, now: float) -> str:
        if self._state == "open" and now >= self._open_until:
            self._state = "half_open"
            self._probe_inflight = False
        return self._state

    def peek(self, now: float) -> str:
        """The state WITHOUT the open→half_open transition side effect —
        for display paths (gauges, snapshots) that run on scrape threads
        outside the router lock; a scrape racing the routing path's
        transitions could otherwise clear a live probe slot."""
        if self._state == "open" and now >= self._open_until:
            return "half_open"
        return self._state

    def can_route(self, now: float) -> bool:
        s = self.state(now)
        if s == "closed":
            return True
        if s == "half_open":
            return not self._probe_inflight
        return False

    def on_dispatch(self, now: float) -> None:
        if self.state(now) == "half_open":
            self._probe_inflight = True

    def record_success(self) -> None:
        self._state = "closed"
        self._failures = 0
        self._probe_inflight = False

    def record_failure(self, now: float) -> None:
        s = self.state(now)
        self._failures += 1
        self._probe_inflight = False
        if s == "half_open" or self._failures >= self.threshold:
            self._state = "open"
            self._open_until = now + self.cooldown_s

    def abort_probe(self) -> None:
        """The dispatch that held the half-open probe never actually
        ran (admission rejection): release the probe slot, or the
        breaker would stay half-open with ``can_route() == False``
        forever — the replica silently out of rotation with no path
        back."""
        self._probe_inflight = False

    def probation(self) -> None:
        self._state = "half_open"
        self._failures = 0
        self._probe_inflight = False

    def reset(self) -> None:
        self.record_success()


class RouterRequest:
    """Caller-facing handle for a routed request: same surface as
    :class:`~tpucfn.serve.frontend.ServeRequest` (``result``/``done``/
    ``status``), plus the routing history — ``retries`` (resubmissions
    after replica failure or drain), ``hedged``, and one entry in
    ``attempts`` per replica-level submission."""

    def __init__(self, rid: int, prompt: list[int], max_new_tokens: int,
                 temperature: float, deadline: float | None, t_submit: float):
        self.rid = rid
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.deadline = deadline  # absolute, on the router's clock
        self.t_submit = t_submit
        self.t_done: float | None = None
        self.tokens: list[int] | None = None
        self.error: BaseException | None = None
        self.status = "pending"
        self.retries = 0   # total resubmissions (failovers + requeues)
        self.failures = 0  # replica failures only — what retry_budget caps
        self.hedged = False
        self.hedge_at: float | None = None
        self.attempts: list[_Attempt] = []
        self.delivered = False
        self.done = threading.Event()

    def result(self, timeout: float | None = None) -> list[int]:
        if not self.done.wait(timeout):
            raise TimeoutError(f"request {self.rid} still in flight")
        if self.error is not None:
            raise self.error
        assert self.tokens is not None
        return self.tokens


class _Attempt:
    """One replica-level submission of a router request."""

    __slots__ = ("replica", "server", "sreq", "budget_s", "hedge", "done")

    def __init__(self, replica: int, server: Server,
                 budget_s: float | None, hedge: bool):
        self.replica = replica
        self.server = server      # the incarnation this attempt ran on
        self.sreq = None          # ServeRequest, set right after submit
        self.budget_s = budget_s  # deadline budget handed to the replica
        self.hedge = hedge
        self.done = False


class _Replica:
    """Router-side state for one replica slot (the ``Server`` inside is
    swapped on relaunch; the slot index is stable)."""

    def __init__(self, idx: int, server: Server, breaker: CircuitBreaker,
                 hb: HeartbeatWriter | None):
        self.idx = idx
        self.server = server
        self.breaker = breaker
        self.hb = hb
        self.inflight = 0      # router-dispatched, not yet completed
        self.draining = False
        self.stopped = False   # drained to a stop (relaunch to re-admit)
        self.dead = False

    def state(self, now: float) -> str:
        """Display state (gauges/snapshot/tests): read-only — any
        thread may call this without the router lock."""
        if self.dead:
            return "dead"
        if self.stopped:
            return "stopped"
        if self.draining:
            return "draining"
        return self.breaker.peek(now)


class ReplicaRouter(ChaosTarget):
    """Thread-safe router over ``num_replicas`` factory-built Servers.

    ``factory(i) -> Server`` builds replica ``i`` — called at
    construction and again on every relaunch after an incident, so the
    factory must be re-callable (engines are reusable; caches are
    overwritten by the next prefill).  When ``ft_dir`` is given the
    router runs the ft discipline in miniature: per-replica heartbeat
    files under ``<ft_dir>/replicas/`` feed a
    :class:`~tpucfn.ft.heartbeat.HeartbeatMonitor`, incidents append to
    ``<ft_dir>/events.jsonl``, and surviving replicas' flight rings are
    captured to ``<ft_dir>/flight/`` at detect time.
    """

    def __init__(self, factory: Callable[[int], Server],
                 num_replicas: int, *,
                 registry: MetricRegistry | None = None,
                 ft_dir: str | Path | None = None,
                 retry_budget: int = 2,
                 hedge_ms: float = 0.0,
                 hedge_min_samples: int = 20,
                 breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 2.0,
                 drain_grace_s: float = 10.0,
                 heartbeat_interval_s: float = 0.25,
                 monitor_dead_s: float | None = None,
                 monitor_grace_s: float = 30.0,
                 health_interval_s: float | None = None,
                 slo_shed: bool = False,
                 auto_relaunch: bool = True,
                 tick_s: float = 0.02,
                 clock: Callable[[], float] = time.monotonic):
        """``retry_budget`` bounds resubmissions per request (the
        deadline budget bounds them in time either way).  ``hedge_ms``
        > 0 enables hedging: the duplicate fires after the p99 of
        completed request latencies once ``hedge_min_samples`` have been
        observed, floored at ``hedge_ms`` — so only true stragglers
        hedge and a cold router does not double its own traffic."""
        if num_replicas < 1:
            raise ValueError(f"num_replicas must be >= 1, got {num_replicas}")
        if retry_budget < 0:
            raise ValueError(f"retry_budget must be >= 0, got {retry_budget}")
        self.factory = factory
        self.ft_dir = Path(ft_dir) if ft_dir is not None else None
        self.retry_budget = retry_budget
        self.hedge_ms = float(hedge_ms)
        self.hedge_min_samples = hedge_min_samples
        self.breaker_threshold = breaker_threshold
        self.breaker_cooldown_s = breaker_cooldown_s
        self.drain_grace_s = drain_grace_s
        self.heartbeat_interval_s = heartbeat_interval_s
        self.health_interval_s = (health_interval_s
                                  if health_interval_s is not None
                                  else max(heartbeat_interval_s / 2.0, tick_s))
        self.slo_shed = slo_shed
        self.auto_relaunch = auto_relaunch
        self.tick_s = tick_s
        self.clock = clock
        self._lock = threading.RLock()
        self._live: dict[int, RouterRequest] = {}
        self._next_id = 0
        self._incident = 0
        self._blind_until: dict[int, float] = {}
        self._started = False
        self._thread: threading.Thread | None = None
        self._stop_evt = threading.Event()

        self.monitor: HeartbeatMonitor | None = None
        if self.ft_dir is not None:
            self.ft_dir.mkdir(parents=True, exist_ok=True)
            self._hb_dir = self.ft_dir / "replicas"
            # Replica beats flow at STEP boundaries (that is what makes
            # a frozen loop detectable), so one long step — an XLA
            # compile of a cold prefill bucket runs for seconds — stalls
            # them legitimately.  The dead threshold must cover a
            # compile or healthy replicas become phantom hangs (the
            # coordinator's --ft-startup-grace lesson, ISSUE 4).
            dead = (monitor_dead_s if monitor_dead_s is not None
                    else max(6.0 * heartbeat_interval_s, 10.0))
            self.monitor = HeartbeatMonitor(
                self._hb_dir, expected_hosts=num_replicas,
                config=MonitorConfig(interval_s=heartbeat_interval_s,
                                     suspect_after_s=dead / 2.0,
                                     dead_after_s=dead,
                                     startup_grace_s=monitor_grace_s))

        r = self.registry = (registry if registry is not None
                             else MetricRegistry())
        self.requests_c = r.counter(
            "router_requests_total", "requests accepted by the router")
        self.completed_c = r.counter(
            "router_completed_requests_total",
            "router requests delivered ok (after any retries/hedges)")
        self.expired_c = r.counter(
            "router_expired_requests_total",
            "router requests whose deadline passed (terminal)")
        self.failed_c = r.counter(
            "router_failed_requests_total",
            "router requests terminally failed (no replica could finish)")
        self.rejected_c = r.counter(
            "router_rejected_requests_total",
            "accepted requests terminally rejected mid-flight (deferred "
            "400 from the scheduler's feasibility re-check)")
        self.retries_c = r.counter(
            "router_retries_total",
            "resubmissions after replica failure or drain")
        self.hedges_c = r.counter(
            "router_hedges_total", "hedge duplicates fired")
        self.hedges_won_c = r.counter(
            "router_hedges_won_total",
            "requests whose hedge finished first (the loser is cancelled)")
        self.failovers_c = r.counter(
            "router_failovers_total",
            "replica incidents handled (detect -> capture -> relaunch)")
        self.sheds_c = r.counter(
            "router_sheds_total",
            "submits rejected 429 because every routable replica's SLO "
            "burn rate was sustained above 1")
        self.drains_c = r.counter(
            "router_drains_total", "replica drains initiated")
        # registered, not standalone: replica Servers keep private
        # registries in router mode, so this series is the /metrics
        # request-latency surface a dashboard keeps when --replicas
        # turns on (it also feeds the p99-derived hedge delay)
        self._latency = r.summary(
            "router_request_latency_seconds",
            "end-to-end routed request latency (submit to delivery, "
            "across retries and hedges)")

        self.replicas: list[_Replica] = [
            self._build_replica(i) for i in range(num_replicas)]
        r.computed_gauge(
            "router_replica_state_worst", self._worst_state,
            "worst replica state across the fleet: 0 closed, 1 "
            "half_open, 2 open, 3 draining, 4 stopped, 5 dead "
            "(per-replica detail in the router snapshot)")
        r.computed_gauge(
            "router_replicas_routable", self._num_routable,
            "replicas currently able to take fresh traffic (closed or "
            "half_open, not draining/stopped/dead)")

    def _worst_state(self) -> float:
        now = self.clock()
        return float(max((REPLICA_STATE_CODES[rep.state(now)]
                          for rep in self.replicas), default=0))

    def _num_routable(self) -> float:
        now = self.clock()
        return float(sum(
            1 for rep in self.replicas
            if rep.state(now) in ("closed", "half_open")))

    # -- replica lifecycle -------------------------------------------------

    def _build_replica(self, idx: int) -> _Replica:
        hb = None
        if self.ft_dir is not None:
            hb = HeartbeatWriter(self._hb_dir, idx, role="replica",
                                 interval_s=self.heartbeat_interval_s)
        server = self.factory(idx)
        if hb is not None and server.heartbeat is None:
            # beaten FROM the serve loop (Server._maybe_beat): a frozen
            # replica stops beating, which is the whole point
            server.heartbeat = hb
        return _Replica(idx, server,
                        CircuitBreaker(threshold=self.breaker_threshold,
                                       cooldown_s=self.breaker_cooldown_s),
                        hb)

    def start(self) -> "ReplicaRouter":
        """Start every replica's serve thread plus the maintenance
        thread (hedge timers + health checks)."""
        with self._lock:
            if self._started:
                return self
            self._started = True
            blind = self.clock() + (self.monitor.config.grace_s
                                    if self.monitor is not None else 0.0)
            for rep in self.replicas:
                self._blind_until[rep.idx] = blind
        for rep in self.replicas:
            rep.server.start()
        self._stop_evt.clear()
        self._thread = threading.Thread(target=self._maintain, daemon=True,
                                        name="tpucfn-router")
        self._thread.start()
        return self

    def stop(self, timeout: float = 30.0) -> None:
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        for rep in self.replicas:
            if not rep.dead:
                rep.server.stop(timeout)
            if rep.hb is not None:
                rep.hb.stop()
        with self._lock:
            self._started = False

    def relaunch(self, idx: int, *, probation: bool = True) -> bool:
        """Replace replica ``idx``'s Server via the factory and put it
        back in rotation — in half-open probation by default, so it must
        complete one request before it is fully trusted (re-admission
        after warmup).  Expects a failed/drained/stopped replica: the
        old incarnation's serve thread is joined first, because two
        serve loops driving ONE engine race its donated cache buffers
        ("buffer deleted") and the fresh incarnation would fail over
        again immediately — observed as a double failover in the
        availability bench before this join existed.  If the old thread
        is WEDGED inside a step and outlives the join bound, the
        relaunch is REFUSED (returns False, slot stays dead): serving
        at N-1 beats corrupting the shared engine under a second
        loop."""
        old = self.replicas[idx]
        if old.hb is not None:
            old.hb.stop()
        if not old.server.wait_stopped(timeout=RELAUNCH_JOIN_S):
            with self._lock:
                old.dead = True
            self._event("relaunch_skipped", host=idx,
                        reason=f"old serve thread still running after "
                               f"{RELAUNCH_JOIN_S:g}s join")
            return False
        rep_new = self._build_replica(idx)
        with self._lock:
            rep = self.replicas[idx]
            rep.server = rep_new.server
            rep.hb = rep_new.hb
            rep.inflight = 0
            rep.dead = rep.draining = rep.stopped = False
            if probation:
                rep.breaker.probation()
            else:
                rep.breaker.reset()
            if self.monitor is not None:
                self._blind_until[idx] = (self.clock()
                                          + self.monitor.config.grace_s)
            started = self._started
        if started:
            rep.server.start()
        return True

    # -- admission / routing ----------------------------------------------

    def _shedding(self, rep: _Replica) -> bool:
        return rep.server.slo.should_shed(rep.server.shed_min_window)

    def _pick(self, exclude: set[int],
              allow_shedding: bool) -> _Replica | None:
        """Least-loaded routable replica (caller holds the lock).  With
        ``slo_shed`` on, replicas whose own burn rate is sustained above
        1 are skipped for FRESH traffic — the per-replica shed the
        ROADMAP calls for — and the router 429s only when every
        routable replica is burning.  Retries and hedges set
        ``allow_shedding``: finishing accepted work beats protecting a
        burning replica's window."""
        now = self.clock()
        cands = [rep for rep in self.replicas
                 if not rep.dead and not rep.draining and not rep.stopped
                 and rep.idx not in exclude
                 and rep.server.failed is None
                 and rep.breaker.can_route(now)]
        if not cands:
            return None
        if self.slo_shed and not allow_shedding:
            healthy = [r for r in cands if not self._shedding(r)]
            if not healthy:
                self.sheds_c.add()
                raise AdmissionError(
                    "shedding load: every routable replica's SLO burn "
                    "rate is sustained above 1 (back off and retry)",
                    status=429)
            cands = healthy
        return min(cands, key=lambda rep: (rep.inflight, rep.idx))

    def submit(self, prompt: list[int], *, max_new_tokens: int,
               temperature: float = 0.0,
               deadline_s: float | None = None) -> RouterRequest:
        """Route one request.  Raises
        :class:`~tpucfn.serve.frontend.AdmissionError` when no replica
        can accept it (429/503 — retry later; 400 — never valid);
        otherwise returns a handle whose terminal ``status`` is ``ok`` /
        ``expired`` / ``replica_failed`` / ``rejected``, with any
        replica failures retried transparently inside the deadline
        budget."""
        now = self.clock()
        rreq = RouterRequest(
            0, list(prompt), max_new_tokens, temperature,
            None if deadline_s is None else now + deadline_s, now)
        with self._lock:
            rreq.rid = self._next_id
            self._next_id += 1
            self._live[rreq.rid] = rreq
        try:
            placed = self._dispatch(rreq, exclude=set(), is_hedge=False)
        except AdmissionError:  # per-replica SLO shed (429)
            with self._lock:
                self._live.pop(rreq.rid, None)
            raise
        if not placed:
            with self._lock:
                self._live.pop(rreq.rid, None)
            err = rreq.error if isinstance(rreq.error, AdmissionError) \
                else None
            raise err if err is not None else AdmissionError(
                "no routable replica (all dead, draining, or circuit-"
                "open); back off and retry", status=503)
        self.requests_c.add()
        if (self.hedge_ms > 0 and len(self.replicas) > 1
                and not rreq.done.is_set()):
            with self._lock:
                rreq.hedge_at = now + self._hedge_delay_s()
        return rreq

    def _dispatch(self, rreq: RouterRequest, exclude: set[int],
                  is_hedge: bool) -> str | bool:
        """Place one attempt on a routable replica with the remaining
        deadline budget.  Returns ``"placed"`` when an attempt was
        submitted, ``"delivered"`` when the request reached a terminal
        state here instead (already delivered, or expired before
        dispatch) — hedge accounting must only count the former —
        and False when no replica would take it (the caller decides
        whether that is a submit-time rejection or a terminal failover
        failure).  A 400 admission error is terminal everywhere and
        short-circuits."""
        exclude = set(exclude)
        allow_shedding = is_hedge or rreq.retries > 0
        while True:
            with self._lock:
                if rreq.delivered:
                    return "delivered"
                cand = self._pick(exclude, allow_shedding)
                if cand is None:
                    return False
                remaining = None
                if rreq.deadline is not None:
                    remaining = rreq.deadline - self.clock()
                    if remaining <= 0:
                        self._deliver(rreq, error=DeadlineExceeded(
                            "deadline exhausted before dispatch"),
                            status="expired")
                        return "delivered"
                cand.breaker.on_dispatch(self.clock())
                cand.inflight += 1
                att = _Attempt(cand.idx, cand.server, remaining, is_hedge)
                rreq.attempts.append(att)
            try:
                sreq = cand.server.submit(
                    rreq.prompt, max_new_tokens=rreq.max_new_tokens,
                    temperature=rreq.temperature, deadline_s=remaining,
                    on_done=lambda sr, a=att: self._on_attempt_done(
                        rreq, a, sr))
            except AdmissionError as e:
                with self._lock:
                    cand.inflight = max(0, cand.inflight - 1)
                    cand.breaker.abort_probe()
                    att.done = True
                    rreq.attempts.remove(att)
                    # stash the last admission error so the submit path
                    # re-raises the TRUE cause: every-replica-429
                    # (backpressure: back off) must not surface as the
                    # generic 503 (unavailable: go elsewhere)
                    rreq.error = e
                    if e.status == 400:
                        # invalid on EVERY replica: submit re-raises it
                        # (parity with Server.submit); async callers
                        # deliver their own terminal status on False
                        return False
                    exclude.add(cand.idx)
                continue
            att.sreq = sreq
            with self._lock:
                # the request may have been DELIVERED while this submit
                # was in flight (hedge twin won): _deliver's loser sweep
                # skipped this attempt (sreq was still None) — cancel it
                # now or it decodes to completion for nobody
                orphaned = rreq.delivered and not att.done
            if orphaned:
                cand.server.cancel(sreq.req_id)
            return "placed"

    # -- completion plumbing (replica serve threads call this) -------------

    def _on_attempt_done(self, rreq: RouterRequest, att: _Attempt,
                         sreq) -> None:
        rep = self.replicas[att.replica]
        with self._lock:
            if att.done:
                # already handled router-side (_fail_orphan_attempts on
                # a wedged incarnation whose loop later revived and ran
                # its callbacks) — acting twice would double-retry
                return
            att.done = True
            att.sreq = sreq
            # breaker/inflight signals count only against the incarnation
            # the attempt actually ran on: a killed server's thread can
            # deliver its failure callbacks AFTER the slot was relaunched,
            # and those stale failures must not trip (or stale successes
            # close) the fresh replica's breaker
            current = rep.server is att.server
            if current:
                rep.inflight = max(0, rep.inflight - 1)
                if sreq.status not in ("ok", "replica_failed"):
                    # expired/cancelled/retried carry no health signal:
                    # release a half-open probe slot or the breaker
                    # would stay unroutable forever (ok/failed clear it
                    # via record_success/record_failure below)
                    rep.breaker.abort_probe()
        status = sreq.status
        if status == "ok":
            if current:
                with self._lock:
                    rep.breaker.record_success()
            self._deliver(rreq, tokens=sreq.tokens, status="ok",
                          winner=att)
        elif status == "expired":
            # The replica-level deadline IS the remaining router budget:
            # expiry there is expiry here, and nobody retries a request
            # whose caller stopped waiting.
            self._deliver(rreq, error=sreq.error, status="expired")
        elif status == "cancelled":
            return  # the loser we cancelled; the winner already delivered
        elif status in ("replica_failed", "retried"):
            if status == "replica_failed" and current:
                with self._lock:
                    rep.breaker.record_failure(self.clock())
            self._maybe_retry(rreq, att, sreq)
        else:  # "rejected" — 400-class raised by the scheduler's add()
            self._deliver(rreq, error=sreq.error, status="rejected")

    def _maybe_retry(self, rreq: RouterRequest, att: _Attempt,
                     sreq) -> None:
        """Failover: resubmit with the remaining deadline budget, unless
        the budget (time or count) is spent or a hedge twin is still
        running (it may yet win)."""
        with self._lock:
            if rreq.delivered:
                return
            if any(not a.done for a in rreq.attempts):
                return
            expired = (rreq.deadline is not None
                       and self.clock() >= rreq.deadline)
            # A drain requeue (status "retried") is a handoff, not a
            # failure: it must not consume the retry budget, or
            # --retry-budget 0 would terminally fail a drained
            # replica's queue instead of handing it elsewhere.
            requeue = sreq.status == "retried"
            over_budget = (not requeue
                           and rreq.failures >= self.retry_budget)
            if not expired and not over_budget:
                rreq.retries += 1
                if not requeue:
                    rreq.failures += 1
        if expired:
            self._deliver(rreq, error=DeadlineExceeded(
                "deadline passed during failover"), status="expired")
            return
        if over_budget:
            self._deliver(rreq, error=sreq.error, status="replica_failed")
            return
        self.retries_c.add()
        if not self._dispatch(rreq, exclude={att.replica}, is_hedge=False):
            self._deliver(rreq, error=sreq.error, status="replica_failed")

    def _deliver(self, rreq: RouterRequest, *, tokens=None, error=None,
                 status: str, winner: _Attempt | None = None) -> None:
        """Terminal, exactly once: set the result, count it, cancel
        every other live attempt (hedge losers / expired twins)."""
        with self._lock:
            if rreq.delivered:
                return
            rreq.delivered = True
            self._live.pop(rreq.rid, None)
            losers = [a for a in rreq.attempts
                      if a is not winner and not a.done
                      and a.sreq is not None]
            if winner is not None and winner.hedge:
                self.hedges_won_c.add()
        rreq.tokens, rreq.error, rreq.status = tokens, error, status
        rreq.t_done = self.clock()
        if status == "ok":
            self.completed_c.add()
            self._latency.observe(rreq.t_done - rreq.t_submit)
        elif status == "expired":
            self.expired_c.add()
        elif status == "replica_failed":
            self.failed_c.add()
        elif status == "rejected":
            # terminal too: requests_c counted this request at submit,
            # so without this the accounting identity (requests ==
            # completed + expired + failed + rejected) silently leaks
            self.rejected_c.add()
        rreq.done.set()
        for a in losers:
            # cancel on the attempt's OWN incarnation: after a relaunch
            # the slot's current server restarts req ids at 0, and
            # cancelling by id there would hit an unrelated request
            a.server.cancel(a.sreq.req_id)

    # -- hedging -----------------------------------------------------------

    def _hedge_delay_s(self) -> float:
        """p99 of completed router latencies, floored at ``hedge_ms`` —
        only true stragglers hedge; with too few samples the floor is
        the delay (a cold router must not double its own traffic)."""
        floor = self.hedge_ms / 1000.0
        if self._latency.count < self.hedge_min_samples:
            return floor
        p99 = self._latency.percentile(99)
        return max(floor, p99 or 0.0)

    def _fire_due_hedges(self, now: float | None = None) -> int:
        """Fire the duplicate for every live request whose hedge delay
        elapsed with exactly one attempt still running.  Called from the
        maintenance thread; exposed (with an explicit ``now``) for
        deterministic tests."""
        now = self.clock() if now is None else now
        with self._lock:
            due = [r for r in self._live.values()
                   if r.hedge_at is not None and now >= r.hedge_at
                   and not r.hedged and not r.delivered]
            for r in due:
                r.hedged = True
        fired = 0
        for r in due:
            with self._lock:
                live = [a for a in r.attempts if not a.done]
                if len(live) != 1:
                    continue
                exclude = {a.replica for a in r.attempts}
            if self._dispatch(r, exclude=exclude, is_hedge=True) \
                    == "placed":
                self.hedges_c.add()
                fired += 1
        return fired

    def _expire_overdue(self, now: float | None = None) -> int:
        """Backstop deadline enforcement: normally the replica's serve
        loop expires its own requests (that completion flows back
        through the callbacks), but a loop wedged inside one engine
        call can't — without this sweep a ``deadline_s`` request on a
        frozen replica (and its caller's ``result()``) would hang
        forever.  Fires ``EXPIRY_SWEEP_SLACK_S`` after the deadline so
        the replica always gets first crack."""
        now = self.clock() if now is None else now
        with self._lock:
            overdue = [r for r in self._live.values()
                       if r.deadline is not None and not r.delivered
                       and now > r.deadline + EXPIRY_SWEEP_SLACK_S]
        for r in overdue:
            self._deliver(r, error=DeadlineExceeded(
                "deadline passed with the replica unresponsive"),
                status="expired")
        return len(overdue)

    # -- health ------------------------------------------------------------

    def _check_health(self, now: float | None = None) -> None:
        """One health sweep: replicas whose serve loop died (engine
        exception) or whose heartbeats the ft classifier calls DEAD
        become incidents — capture, fail-over, relaunch."""
        now = self.clock() if now is None else now
        for rep in list(self.replicas):
            with self._lock:
                if rep.dead or rep.draining or rep.stopped:
                    continue
                failed = rep.server.failed
            if failed is not None:
                self._replica_incident(rep.idx, kind="replica_failed",
                                       detail=str(failed))
        if self.monitor is None:
            return
        view = self.monitor.observe()
        for v in view.hosts:
            if not 0 <= v.host_id < len(self.replicas):
                continue
            rep = self.replicas[v.host_id]
            with self._lock:
                skip = (rep.dead or rep.draining or rep.stopped
                        or now < self._blind_until.get(v.host_id, 0.0))
            if skip:
                continue
            if v.state is HostState.DEAD:
                self._replica_incident(v.host_id, kind="replica_hang",
                                       detail=v.reason)

    def _replica_incident(self, idx: int, *, kind: str,
                          detail: str = "") -> None:
        """The ft incident flow in miniature: detect → flight capture
        from survivors → fail the replica (its in-flight work retries
        through the normal path) → relaunch in probation → recovered."""
        with self._lock:
            rep = self.replicas[idx]
            if rep.dead:
                return
            rep.dead = True
            self._incident += 1
            incident = self._incident
        t0 = self.clock()
        old_server = rep.server
        self._event("detect", incident=incident,
                    failures=[{"host": idx, "kind": kind, "rc": None,
                               "step": None, "detail": detail}])
        self._capture_flight(incident, failed={idx})
        # completes every in-flight request on the replica with
        # ReplicaFailed; their on_done callbacks re-dispatch to the
        # survivors with the remaining deadline budget
        rep.server.fail(ReplicaFailed(f"replica {idx} {kind}: {detail}"))
        if rep.hb is not None:
            rep.hb.stop()
        if self.auto_relaunch and self.relaunch(idx, probation=True):
            self.failovers_c.add()
            mttr = self.clock() - t0
            self._event("recovered", incident=incident,
                        action="replica_relaunch", host=idx,
                        mttr_s=round(mttr, 4))
        # A loop wedged INSIDE an engine call never consumes the
        # injected failure, so its attempts' callbacks never fire —
        # complete them router-side (retry elsewhere / terminal) or
        # their callers wait forever.  No-op when the loop did process
        # the injection: those attempts are already done.
        self._fail_orphan_attempts(idx, old_server, kind)

    def _fail_orphan_attempts(self, idx: int, old_server: Server,
                              kind: str) -> None:
        """Complete router-side every live attempt stranded on a dead
        incarnation whose serve loop never ran its failure callbacks
        (wedged inside one engine call).  Marking ``att.done`` under
        the lock makes a later revival's real callback a no-op."""
        import types

        with self._lock:
            orphans = [(r, a) for r in list(self._live.values())
                       for a in r.attempts
                       if not a.done and a.replica == idx
                       and a.server is old_server]
            for _, a in orphans:
                a.done = True
        if not orphans:
            return
        err = ReplicaFailed(
            f"replica {idx} {kind}: unresponsive serve loop")
        for r, a in orphans:
            self._maybe_retry(r, a, types.SimpleNamespace(
                status="replica_failed", error=err))

    # -- drain -------------------------------------------------------------

    def drain(self, idx: int, grace_s: float | None = None) -> bool:
        """Gracefully take replica ``idx`` out of rotation: admission
        closes, queued-not-started work is handed back (resubmitted to
        healthy replicas immediately), and in-flight sequences get
        ``grace_s`` to finish — whatever misses the window is requeued
        too.  The replica ends ``stopped``; :meth:`relaunch` re-admits
        it."""
        grace = self.drain_grace_s if grace_s is None else grace_s
        with self._lock:
            rep = self.replicas[idx]
            if rep.dead or rep.draining:
                return False
            rep.draining = True
        self.drains_c.add()
        self._event("drain", host=idx, grace_s=grace)
        rep.server.evict_queued()
        clean = rep.server.drain(grace)
        with self._lock:
            rep.stopped = True
        if rep.hb is not None:
            rep.hb.stop()
        self._event("drained", host=idx, clean=clean)
        return clean

    def drain_all(self, grace_s: float | None = None, *,
                  wait: bool = False) -> None:
        """Process-level graceful shutdown (the SIGTERM path): close
        admission on EVERY replica, give accepted work the grace, and
        disable auto-relaunch — a draining process must not resurrect
        replicas and keep decoding past the preemption.  Work that
        misses the grace fails with ``replica_failed`` (no healthy
        replica remains to requeue onto, so callers unblock loudly).
        ``wait=False`` only arms the drains (signal-handler form)."""
        grace = self.drain_grace_s if grace_s is None else grace_s
        with self._lock:
            self.auto_relaunch = False
            reps = [rep for rep in self.replicas
                    if not rep.dead and not rep.stopped]
            for rep in reps:
                rep.draining = True
        self._event("drain_all", grace_s=grace,
                    hosts=[rep.idx for rep in reps])
        for rep in reps:
            rep.server.drain(grace, wait=wait)
        if wait:
            with self._lock:
                for rep in reps:
                    rep.stopped = True

    # -- ChaosTarget (serve ops) -------------------------------------------

    def num_hosts(self) -> int:
        return len(self.replicas)

    def kill_replica(self, replica: int) -> None:
        self._replica_incident(replica, kind="replica_killed",
                               detail="chaos kill_replica")

    def freeze_replica(self, replica: int, duration_s: float) -> None:
        self.replicas[replica].server.freeze(
            duration_s if duration_s > 0 else None)

    def slow_replica(self, replica: int, delay_s: float,
                     duration_s: float) -> None:
        self.replicas[replica].server.slow(
            delay_s, duration_s if duration_s > 0 else None)

    # -- forensics ---------------------------------------------------------

    def _event(self, kind: str, **fields) -> None:
        from tpucfn_torch.ft.events import validate_event_kind

        if self.ft_dir is None:
            return
        rec = {"ts": time.time(), "kind": validate_event_kind(kind),
               "plane": "serve", **fields}
        with self._lock:
            with open(self.ft_dir / "events.jsonl", "a") as f:
                f.write(json.dumps(rec) + "\n")

    def _capture_flight(self, incident: int, failed: set[int]) -> None:
        """Snapshot every surviving replica's flight ring into
        ``<ft_dir>/flight/`` (same file naming as the coordinator's
        HTTP capture, so ``obs postmortem`` reads both) — in-process
        replicas make this a direct ring read, no endpoint needed."""
        if self.ft_dir is None:
            return
        from tpucfn_torch.obs.flight import incident_flight_path, write_flight_dump

        out = self.ft_dir / "flight"
        captured = []
        for rep in self.replicas:
            if rep.idx in failed or rep.dead:
                continue
            fl = getattr(rep.server, "flight", None)
            if fl is None:
                continue
            out.mkdir(parents=True, exist_ok=True)
            write_flight_dump(
                incident_flight_path(out, incident, rep.idx), fl.snapshot())
            captured.append(rep.idx)
        if captured:
            self._event("flight_capture", incident=incident,
                        hosts=captured, errors=0)

    # -- maintenance thread ------------------------------------------------

    def _maintain(self) -> None:
        next_health = 0.0
        while not self._stop_evt.wait(self.tick_s):
            now = self.clock()
            try:
                self._fire_due_hedges(now)
                self._expire_overdue(now)
                if now >= next_health:
                    next_health = now + self.health_interval_s
                    self._check_health(now)
            except Exception:  # noqa: BLE001 — the watchdog must outlive
                pass           # any single bad sweep

    # -- observability -----------------------------------------------------

    def outstanding(self) -> int:
        with self._lock:
            return len(self._live)

    def snapshot(self) -> dict:
        """The router dashboard in one dict (CLI JSON line, bench row)."""
        now = self.clock()
        with self._lock:
            # "spec" marks replicas decoding speculatively (ISSUE 14) —
            # the router mixes them with plain replicas freely, because
            # greedy output is bit-identical either way (retries and
            # hedges cross the boundary transparently).
            reps = [{"replica": rep.idx, "state": rep.state(now),
                     "inflight": rep.inflight,
                     "spec": bool(getattr(rep.server.engine,
                                          "spec_enabled", False))}
                    for rep in self.replicas]
        return {
            "replicas": reps,
            "requests": self.requests_c.value,
            "completed": self.completed_c.value,
            "expired": self.expired_c.value,
            "failed": self.failed_c.value,
            "rejected": self.rejected_c.value,
            "retries": self.retries_c.value,
            "hedges": self.hedges_c.value,
            "hedges_won": self.hedges_won_c.value,
            "failovers": self.failovers_c.value,
            "sheds": self.sheds_c.value,
            "drains": self.drains_c.value,
            "latency_s": self._latency.snapshot(),
        }
