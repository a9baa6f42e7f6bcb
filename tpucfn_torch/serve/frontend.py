"""Serving frontend: thread-safe request queue, admission control, and
the loop that binds queue → scheduler → engine.

Admission control is LAYERED, and each layer rejects for a different
reason with a different status:

* 429 (:class:`AdmissionError`, ``status=429``) — backpressure: the sum
  of OUTSTANDING tokens (prompt + budgeted new tokens of every request
  submitted but not yet completed) would exceed ``max_queued_tokens``.
  Outstanding, not merely queued: a frontend that only counts its own
  queue believes itself empty while the scheduler drowns.
* 400 (``status=400``) — the request can never run on this engine
  (empty prompt, prompt + max_new over the cache capacity, or more KV
  blocks than the whole pool): rejecting at submit beats starving at
  the head of the queue.
* 503-equivalent deadline expiry — a request whose deadline passes
  while queued or running is completed with :class:`DeadlineExceeded`;
  capacity goes back to live traffic instead of computing answers
  nobody is waiting for.

Metrics ride on ``tpucfn.obs`` primitives registered in a
``MetricRegistry`` (Counter/Gauge/Summary/Histogram): TTFT, generated
tokens/sec, queue depth, KV-cache occupancy, preemptions, rejections —
``ServingMetrics.snapshot()`` is the one dict the CLI, the bench, and
tests all read, and the registry is the scrape surface the per-host
``/metrics`` endpoint exposes (tpucfn/obs/server.py).  A ``Tracer``
(tpucfn/obs/trace.py) records the request lifecycle as spans —
request_submitted → queue_wait → prefill → decode_round* →
request_done (plus preemption events) — so TTFT decomposes into
queue-wait vs prefill vs scheduling per request, reconstructable from
the trace JSONL alone (``tpucfn obs`` renders the breakdown table).
"""

from __future__ import annotations

import threading
import time
from collections import deque

from tpucfn_torch.obs.metrics import Summary
from tpucfn_torch.obs.registry import MetricRegistry
from tpucfn_torch.obs.trace import Tracer
from tpucfn_torch.serve.engine import ServeEngine
from tpucfn_torch.serve.kvcache import KVCacheManager
from tpucfn_torch.serve.scheduler import (
    ContinuousBatchingScheduler,
    PrefillWork,
    Sequence,
    SequenceState,
)


# Canonical terminal vocabulary of ServeRequest.status (ISSUE 10): the
# router, the benches, and tests branch on these strings, so they live
# in ONE tuple the `vocab-drift` rule of `tpucfn check` enforces — a
# literal outside this set anywhere in the package is a finding.
# "pending" is the non-terminal initial state; everything else is
# settled exactly when `done` fires (see ServeRequest).
REQUEST_STATUSES = ("pending", "ok", "expired", "replica_failed",
                    "retried", "rejected", "cancelled")


class AdmissionError(RuntimeError):
    """Request refused at submit time.  ``status`` follows HTTP
    semantics: 429 = retry later (backpressure), 400 = never valid on
    this engine, 503 = this replica is unavailable (draining or failed)
    — retry ELSEWHERE, which is exactly what the replica router does."""

    def __init__(self, msg: str, *, status: int = 429):
        super().__init__(msg)
        self.status = status


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed before it finished."""


class ReplicaFailed(RuntimeError):
    """5xx-equivalent: the replica (engine or serve loop) died under the
    request.  Structurally distinct from :class:`DeadlineExceeded` on
    purpose (ISSUE 9): a router retries a replica failure on a healthy
    replica with the remaining deadline budget, while an expired
    deadline is terminal — nobody is waiting anymore."""


class Requeued(ReplicaFailed):
    """The replica handed this request back without finishing it
    (drain / queue eviction); the router resubmits it elsewhere.  The
    replica-level handle's terminal ``status`` is ``"retried"``."""


class Cancelled(RuntimeError):
    """The request was cancelled (a hedge that lost the race)."""


class ServeRequest:
    """Caller-facing handle: block on :meth:`result` (or poll
    :attr:`done`).  Timing fields are filled by the serve loop —
    ``t_first_token - t_submit`` is the TTFT the metrics record.

    ``status`` is the terminal outcome, settled exactly when ``done``
    sets (ISSUE 9 satellite): ``"ok"`` / ``"expired"`` (deadline) /
    ``"replica_failed"`` (engine or replica death) / ``"retried"`` (the
    replica handed it back for resubmission elsewhere) / ``"rejected"``
    (admission) / ``"cancelled"`` (hedge loser) — so routers and tests
    branch on structure instead of string-matching error messages.
    ``on_done`` is an optional single-shot callback invoked after the
    terminal state is visible (the router's completion hook)."""

    def __init__(self, req_id: int, prompt: list[int], max_new_tokens: int,
                 temperature: float, deadline: float | None):
        self.req_id = req_id
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.deadline = deadline
        self.tokens: list[int] | None = None
        self.error: BaseException | None = None
        self.status = "pending"
        self.on_done = None
        self.t_submit = time.monotonic()
        self.t_first_token: float | None = None
        self.t_done: float | None = None
        self.done = threading.Event()

    def result(self, timeout: float | None = None) -> list[int]:
        """Generated tokens (prompt excluded); raises the request's
        error (DeadlineExceeded, ValueError...) if it failed."""
        if not self.done.wait(timeout):
            raise TimeoutError(f"request {self.req_id} still in flight")
        if self.error is not None:
            raise self.error
        assert self.tokens is not None
        return self.tokens


class ServingMetrics:
    """The serving dashboard in one object, owned by a
    :class:`~tpucfn.obs.registry.MetricRegistry` so ``GET /metrics``
    exposes every serving series in Prometheus text format alongside
    whatever else the process registered (training metrics, supervisor
    counters).  Default is a private registry (test/bench isolation);
    the CLI passes its role-labelled registry so the per-host obs
    endpoint covers serving too.

    ``request_latency_s`` is kept as an (unregistered) Summary for the
    exact-percentile ``snapshot()`` dict; the registered cross-host-
    aggregatable form is the ``serve_request_latency_seconds``
    Histogram — both observe every completion.
    """

    def __init__(self, registry: MetricRegistry | None = None):
        r = self.registry = (registry if registry is not None
                             else MetricRegistry())
        self.ttft_s = r.summary(
            "serve_ttft_seconds", "time to first generated token")
        self.request_latency_s = Summary("request_latency_s")
        self.request_latency_hist = r.histogram(
            "serve_request_latency_seconds",
            "end-to-end request latency (submit to done)")
        self.generated_tokens = r.counter(
            "serve_generated_tokens_total", "tokens sampled (rate = tokens/sec)")
        self.prompt_tokens = r.counter(
            "serve_prompt_tokens_total", "prompt tokens accepted at submit")
        self.completed = r.counter(
            "serve_completed_requests_total", "requests finished successfully")
        self.rejected = r.counter(
            "serve_rejected_requests_total", "requests refused (429/400)")
        self.expired = r.counter(
            "serve_expired_requests_total", "requests past their deadline")
        self.replica_failed = r.counter(
            "serve_replica_failed_requests_total",
            "requests completed with a replica/engine failure "
            "(5xx-equivalent; counted separately from deadline expiry)")
        self.preemptions = r.counter(
            "serve_preemptions_total", "KV-pressure evictions")
        self.prefill_calls = r.counter(
            "serve_prefill_calls_total",
            "jitted prefill programs dispatched (batched: one per batch)")
        self.prefilled_tokens = r.counter(
            "serve_prefilled_tokens_total",
            "real (unpadded) tokens run through prefill — suffix only on "
            "prefix-cache hits")
        self.prefix_hit_requests = r.counter(
            "serve_prefix_hit_requests_total",
            "prefills that reused cached prefix blocks")
        self.prefix_hit_tokens = r.counter(
            "serve_prefix_hit_tokens_total",
            "prompt tokens served by copy_prefix instead of prefill")
        self.prefill_batch_size = r.summary(
            "serve_prefill_batch_size", "sequences per prefill call")
        self.slo_shed = r.counter(
            "serve_slo_shed_total",
            "requests shed at submit because the SLO burn rate was "
            "sustained above 1 (--slo-shed)")
        # Decode-round economics (ISSUE 14): tokens / slot_steps is the
        # per-slot tokens-per-target-step — exactly 1.0 for plain
        # decode, acceptance-driven above 1 with --spec-draft.
        self.decode_rounds = r.counter(
            "serve_decode_rounds_total",
            "decode rounds dispatched (one target verify or decode "
            "program each)")
        self.decode_slot_steps = r.counter(
            "serve_decode_slot_steps_total",
            "active slot-steps across decode rounds (one per running "
            "slot per round)")
        self.decode_tokens = r.counter(
            "serve_decode_tokens_total",
            "tokens emitted by decode rounds (excludes prefill's first "
            "tokens)")
        self.spec_rounds = r.counter(
            "serve_spec_rounds_total",
            "decode rounds that ran propose-verify (speculation on and "
            "proposing; off/probe-idle rounds excluded)")
        self.spec_proposed = r.counter(
            "serve_spec_proposed_total",
            "draft tokens proposed to greedy slots")
        self.spec_accepted = r.counter(
            "serve_spec_accepted_total",
            "proposed draft tokens the target verified and emitted")
        self.queue_depth = r.gauge(
            "serve_queue_depth", "requests waiting (frontend + scheduler)")
        self.running = r.gauge(
            "serve_running_sequences", "sequences in decode slots")
        self.cache_occupancy = r.gauge(
            "serve_kv_cache_occupancy", "fraction of KV blocks in use")
        self._t0 = time.monotonic()

    def snapshot(self) -> dict:
        elapsed = max(time.monotonic() - self._t0, 1e-9)
        return {
            "elapsed_s": round(elapsed, 3),
            "completed": self.completed.value,
            "rejected": self.rejected.value,
            "expired": self.expired.value,
            "replica_failed": self.replica_failed.value,
            "preemptions": self.preemptions.value,
            "prompt_tokens": self.prompt_tokens.value,
            "generated_tokens": self.generated_tokens.value,
            "tokens_per_sec": self.generated_tokens.value / elapsed,
            "ttft_s": self.ttft_s.snapshot(),
            "request_latency_s": self.request_latency_s.snapshot(),
            "prefill_calls": self.prefill_calls.value,
            "prefilled_tokens": self.prefilled_tokens.value,
            "prefix_hit_requests": self.prefix_hit_requests.value,
            "prefix_hit_tokens": self.prefix_hit_tokens.value,
            "prefill_batch_size": self.prefill_batch_size.snapshot(),
            "decode_rounds": self.decode_rounds.value,
            "decode_slot_steps": self.decode_slot_steps.value,
            "decode_tokens": self.decode_tokens.value,
            "tokens_per_target_step": (
                self.decode_tokens.value / self.decode_slot_steps.value
                if self.decode_slot_steps.value else None),
            "spec_rounds": self.spec_rounds.value,
            "spec_proposed": self.spec_proposed.value,
            "spec_accepted": self.spec_accepted.value,
            "spec_acceptance_rate": (
                self.spec_accepted.value / self.spec_proposed.value
                if self.spec_proposed.value else None),
            "slo_shed": self.slo_shed.value,
            "queue_depth": self.queue_depth.value,
            "running_sequences": self.running.value,
            "kv_cache_occupancy": self.cache_occupancy.value,
        }


class SLOTracker:
    """TTFT/TPOT service-level objectives with a rolling-window burn
    rate, exported as ``serve_slo_*`` (ISSUE 5).

    Two latency objectives — time-to-first-token and time-per-output-
    token — each with a target and one shared ``objective`` (the
    fraction of requests that must meet it, e.g. 0.99).  Every finished
    request is scored against both; the **burn rate** is the classic
    SRE ratio

        (violation fraction in the rolling window) / (1 − objective)

    — 1.0 means the error budget is being consumed exactly as fast as
    it refills; >1 sustained means the SLO will be missed.  An expired
    (deadline-exceeded) request counts as a violation of both
    objectives: the caller got no usable answer, whatever the partial
    timings say.

    ``clock`` is injectable so burn-rate windows are pinned by
    fake-clock tests.
    """

    def __init__(self, registry: MetricRegistry | None = None, *,
                 ttft_slo_s: float = 0.5, tpot_slo_s: float = 0.05,
                 objective: float = 0.99, window_s: float = 60.0,
                 clock=time.monotonic):
        if not 0.0 < objective < 1.0:
            raise ValueError(f"objective must be in (0, 1), got {objective}")
        r = registry if registry is not None else MetricRegistry()
        self.ttft_slo_s = ttft_slo_s
        self.tpot_slo_s = tpot_slo_s
        self.objective = objective
        self.window_s = window_s
        self.clock = clock
        self._lock = threading.Lock()
        self._window: deque[tuple[float, bool, bool]] = deque()
        # Running violation counts for the CURRENT window, maintained
        # incrementally by record()/_evict(): the burn gauges and the
        # shed check run per scrape / per submit, and re-summing a
        # 60s-of-traffic deque under the lock each time would make
        # admission cost grow linearly with throughput — worst exactly
        # under the overload shedding exists for.
        self._win_ttft_bad = 0
        self._win_tpot_bad = 0
        self.requests = r.counter(
            "serve_slo_requests_total", "requests scored against the SLOs")
        self.ttft_violations = r.counter(
            "serve_slo_ttft_violations_total",
            "requests whose TTFT missed the target")
        self.tpot_violations = r.counter(
            "serve_slo_tpot_violations_total",
            "requests whose per-output-token time missed the target")
        # computed_gauge rebinds the read callback on re-registration,
        # so a process that rebuilds a Server against the shared
        # default_registry() gets the LIVE tracker's window backing the
        # series — the counters stay shared and cumulative either way.
        self.ttft_burn = r.computed_gauge(
            "serve_slo_ttft_burn_rate", self._ttft_burn_now,
            "TTFT violation rate in the rolling window / error budget")
        self.tpot_burn = r.computed_gauge(
            "serve_slo_tpot_burn_rate", self._tpot_burn_now,
            "TPOT violation rate in the rolling window / error budget")
        self.window_requests = r.computed_gauge(
            "serve_slo_window_requests", lambda: self._window_stats()[0],
            "requests in the rolling window")
        # Targets as gauges so a scrape is self-describing: a burn rate
        # without its objective is not actionable.
        r.gauge("serve_slo_ttft_target_s",
                "TTFT objective target").set(ttft_slo_s)
        r.gauge("serve_slo_tpot_target_s",
                "TPOT objective target").set(tpot_slo_s)
        r.gauge("serve_slo_objective",
                "fraction of requests that must meet each target").set(
            objective)

    def record(self, ttft_s: float | None, tpot_s: float | None) -> None:
        """Score one finished request; ``None`` means the quantity was
        never achieved (no first token before expiry) and is a
        violation by definition."""
        ttft_ok = ttft_s is not None and ttft_s <= self.ttft_slo_s
        tpot_ok = tpot_s is not None and tpot_s <= self.tpot_slo_s
        now = self.clock()
        self.requests.add()
        if not ttft_ok:
            self.ttft_violations.add()
        if not tpot_ok:
            self.tpot_violations.add()
        with self._lock:
            self._window.append((now, ttft_ok, tpot_ok))
            if not ttft_ok:
                self._win_ttft_bad += 1
            if not tpot_ok:
                self._win_tpot_bad += 1
            self._evict(now)

    def _evict(self, now: float) -> None:
        cutoff = now - self.window_s
        while self._window and self._window[0][0] < cutoff:
            _, ttft_ok, tpot_ok = self._window.popleft()
            if not ttft_ok:
                self._win_ttft_bad -= 1
            if not tpot_ok:
                self._win_tpot_bad -= 1

    def _window_stats(self) -> tuple[int, int, int]:
        """``(requests, ttft_violations, tpot_violations)`` in the
        rolling window AS OF NOW — evicts first, so idle time decays the
        window between requests (the computed gauges read this).
        O(evictions), not O(window): the counts are maintained
        incrementally by record()/_evict()."""
        with self._lock:
            self._evict(self.clock())
            return len(self._window), self._win_ttft_bad, \
                self._win_tpot_bad

    def _burn(self, bad: int, n: int) -> float:
        """Burn rate = window violation rate / error budget.  The ONE
        definition behind both the computed gauges and snapshot() — the
        /metrics series and serve_bench's BENCH row must never
        disagree."""
        return bad / n / (1.0 - self.objective) if n else 0.0

    def should_shed(self, min_window: int = 8) -> bool:
        """Shed-load verdict for the frontend's admission path (ISSUE 6
        satellite): True when EITHER burn rate is above 1 over the
        rolling window — the error budget is being consumed faster than
        it refills, so rejecting now beats breaching the SLO later.
        ``min_window`` scored requests are required before any verdict:
        one bad request over an empty window is noise, and the window
        itself is what makes the burn "sustained"."""
        n, ttft_bad, tpot_bad = self._window_stats()
        if n < min_window:
            return False
        return (self._burn(ttft_bad, n) > 1.0
                or self._burn(tpot_bad, n) > 1.0)

    def _ttft_burn_now(self) -> float:
        n, ttft_bad, _ = self._window_stats()
        return self._burn(ttft_bad, n)

    def _tpot_burn_now(self) -> float:
        n, _, tpot_bad = self._window_stats()
        return self._burn(tpot_bad, n)

    def snapshot(self) -> dict:
        """The ``serve_slo_*`` block serve_bench's BENCH row carries."""
        n, ttft_bad, tpot_bad = self._window_stats()
        return {
            "ttft_target_s": self.ttft_slo_s,
            "tpot_target_s": self.tpot_slo_s,
            "objective": self.objective,
            "window_s": self.window_s,
            "requests": self.requests.value,
            "window_requests": n,
            "ttft": {"violations_total": self.ttft_violations.value,
                     "window_violations": ttft_bad,
                     "burn_rate": self._burn(ttft_bad, n)},
            "tpot": {"violations_total": self.tpot_violations.value,
                     "window_violations": tpot_bad,
                     "burn_rate": self._burn(tpot_bad, n)},
        }


class Server:
    """One engine + one scheduler + the frontend queue.

    Two driving modes sharing one step function: :meth:`run_until_idle`
    (synchronous — CLI, benches, deterministic tests) and
    :meth:`start`/:meth:`stop` (a background thread that sleeps on a
    condition until work arrives — the long-lived serving posture).
    """

    def __init__(self, engine: ServeEngine, *, num_blocks: int = 256,
                 block_size: int = 16, max_queued_tokens: int = 1 << 16,
                 eos_id: int | None = None,
                 registry: MetricRegistry | None = None,
                 tracer: Tracer | None = None,
                 prefix_cache: bool = True,
                 max_prefill_batch: int | None = None,
                 ttft_slo_s: float = 0.5, tpot_slo_s: float = 0.05,
                 slo_objective: float = 0.99, slo_window_s: float = 60.0,
                 slo_shed: bool = False, shed_min_window: int = 8,
                 shed_probe_every: int = 10,
                 flight=None, heartbeat=None,
                 clock=time.monotonic):
        """``slo_shed`` arms SLO-aware early shedding: submit() rejects
        with 429 while the rolling-window burn rate is sustained above 1
        (``SLOTracker.should_shed``), shedding load BEFORE the SLO is
        breached instead of after; sheds are counted in
        ``serve_slo_shed_total``.  Every ``shed_probe_every``-th request
        is admitted anyway as a PROBE: shed requests are never scored,
        so without fresh scores the window would freeze and a transient
        blip would 429 everything for the full window — probes that
        complete healthily decay the burn and end the shed episode as
        soon as the engine actually recovers.  ``flight`` is a
        :class:`~tpucfn.obs.flight.FlightRecorder` receiving queue
        depth / batch occupancy / scheduler-decision samples (ISSUE 6).
        ``heartbeat`` is a :class:`~tpucfn.ft.heartbeat.HeartbeatWriter`
        beaten FROM the serve loop itself (ISSUE 9): a frozen or wedged
        loop stops beating, which is what lets the ft classifier (and
        the replica router's health check) tell a stuck replica from an
        idle one — a daemon-thread writer would keep beating through a
        freeze.  ``clock`` (monotonic) is injectable for drain/freeze
        timing tests."""
        self.engine = engine
        # Both ISSUE-3 fast paths are duck-typed off the engine so fakes
        # (and any decode-protocol engine without the batched entry
        # points) degrade to the classic one-prefill-per-call behavior.
        # Prefix hits need BOTH entry points: the hit executes as
        # copy_prefix + a start-offset prefill_batch call, so an engine
        # with only one of them must run fully cache-off.
        self._can_copy_prefix = (hasattr(engine, "copy_prefix")
                                 and hasattr(engine, "prefill_batch"))
        k = (max_prefill_batch if max_prefill_batch is not None
             else getattr(engine, "prefill_width", 1))
        if not hasattr(engine, "prefill_batch"):
            k = 1
        k = max(1, min(k, getattr(engine, "prefill_width", k)))
        self.kv = KVCacheManager(
            num_blocks, block_size,
            prefix_cache=prefix_cache and self._can_copy_prefix)
        self.flight = flight
        self.scheduler = ContinuousBatchingScheduler(
            self.kv, max_batch=engine.max_batch,
            cache_len=engine.cache_len, eos_id=eos_id,
            max_prefill_batch=k, flight=flight)
        self.metrics = ServingMetrics(registry)
        if getattr(engine, "spec_enabled", False):
            # Live acceptance-rate observability (ISSUE 14): the same
            # windowed rate the k-controller acts on, scrapeable — a
            # burn-rate dashboard next to a falling acceptance rate is
            # the whole speculative-decode story in two series.
            ctl = engine.controller
            self.metrics.registry.computed_gauge(
                "serve_spec_acceptance_rate", ctl.acceptance_rate,
                "windowed draft-token acceptance rate (the k-controller's "
                "shrink/grow signal)")
            self.metrics.registry.computed_gauge(
                "serve_spec_k", lambda: float(ctl.k),
                "current proposal depth k (0 = speculation off, probing)")
        self.slo = SLOTracker(self.metrics.registry, ttft_slo_s=ttft_slo_s,
                              tpot_slo_s=tpot_slo_s,
                              objective=slo_objective,
                              window_s=slo_window_s)
        self.slo_shed_enabled = slo_shed
        self.shed_min_window = shed_min_window
        self.shed_probe_every = max(2, shed_probe_every)
        self._shed_seen = 0  # requests arriving during a shed episode
        self.tracer = tracer if tracer is not None else Tracer(None)
        self.max_queued_tokens = max_queued_tokens
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._incoming: deque[ServeRequest] = deque()
        self._outstanding_tokens = 0
        self._by_seq: dict[int, ServeRequest] = {}
        self._next_id = 0
        self._thread: threading.Thread | None = None
        self._stopping = False
        # Resilience state (ISSUE 9): drain/failure/chaos, all consumed
        # at step boundaries ON the serve thread so no second thread
        # ever mutates the scheduler.
        self.heartbeat = heartbeat
        self.clock = clock
        self._last_beat = float("-inf")
        self._draining = False
        self._drain_deadline: float | None = None
        self._failed: BaseException | None = None
        self._injected_failure: BaseException | None = None
        self._frozen_until = 0.0
        self._slow_until = 0.0
        self._slow_delay = 0.0
        self._cancel_req: set[int] = set()
        self._evict_waiting = False

    @property
    def failed(self) -> BaseException | None:
        """The exception that killed this replica's serve loop, or None
        while it is healthy — the router's liveness probe."""
        return self._failed

    # -- submit path (any thread) ------------------------------------------
    def submit(self, prompt: list[int], *, max_new_tokens: int,
               temperature: float = 0.0,
               deadline_s: float | None = None,
               on_done=None) -> ServeRequest:
        """``on_done(req)`` — optional single-shot completion callback,
        attached BEFORE the request is queued so a fast serve thread can
        never complete the request in the submit/attach gap (the race
        the router's retry path would otherwise lose)."""
        with self._lock:
            if self._failed is not None:
                self.metrics.rejected.add()
                raise AdmissionError(
                    f"replica failed: {self._failed}", status=503)
            if self._draining:
                self.metrics.rejected.add()
                raise AdmissionError(
                    "replica draining: admission closed", status=503)
        budget = len(prompt) + max_new_tokens
        if not prompt or max_new_tokens < 1:
            self.metrics.rejected.add()
            raise AdmissionError(
                f"empty prompt or max_new_tokens {max_new_tokens} < 1",
                status=400)
        if budget > self.engine.cache_len \
                or not self.kv.fits_at_all(budget - 1):
            self.metrics.rejected.add()
            raise AdmissionError(
                f"prompt {len(prompt)} + max_new {max_new_tokens} exceeds "
                f"engine capacity (cache_len {self.engine.cache_len}, "
                f"{self.kv.allocator.num_blocks} KV blocks)", status=400)
        if self.slo_shed_enabled and self.slo.should_shed(
                self.shed_min_window):
            # SLO-aware early shedding (ISSUE 6 satellite): the burn
            # rate says the error budget is being consumed faster than
            # it refills — reject NOW so in-flight traffic recovers,
            # instead of admitting work that will breach the SLO.
            # Every Nth arrival is admitted as a probe (see __init__):
            # its completion score is the recovery signal that ends the
            # episode.
            with self._lock:  # submit() is any-thread: cadence must not race
                self._shed_seen += 1
                probe = self._shed_seen % self.shed_probe_every == 0
            if not probe:
                self.metrics.rejected.add()
                self.metrics.slo_shed.add()
                raise AdmissionError(
                    "shedding load: SLO burn rate sustained above 1 over "
                    f"the rolling {self.slo.window_s:g}s window (back off "
                    "and retry)", status=429)
        elif self.slo_shed_enabled:  # healthy again: reset the cadence
            with self._lock:
                self._shed_seen = 0
        with self._lock:
            # Re-checked HERE, in the same lock acquisition that
            # enqueues: the gate at the top is a fast path, but fail()/
            # drain() can land between it and this block, and a request
            # appended after _fail_all drained the queue would never be
            # processed — its on_done would never fire and the caller
            # would wait forever.
            if self._failed is not None:
                self.metrics.rejected.add()
                raise AdmissionError(
                    f"replica failed: {self._failed}", status=503)
            if self._draining:
                self.metrics.rejected.add()
                raise AdmissionError(
                    "replica draining: admission closed", status=503)
            if self._outstanding_tokens + budget > self.max_queued_tokens:
                self.metrics.rejected.add()
                raise AdmissionError(
                    f"queue full: {self._outstanding_tokens} outstanding "
                    f"tokens + {budget} > {self.max_queued_tokens} "
                    "(back off and retry)", status=429)
            self._outstanding_tokens += budget
            req = ServeRequest(
                self._next_id, list(prompt), max_new_tokens, temperature,
                None if deadline_s is None
                else time.monotonic() + deadline_s)
            req.on_done = on_done
            self._next_id += 1
            self._incoming.append(req)
            self._work.notify()
        self.metrics.prompt_tokens.add(len(prompt))
        self.metrics.queue_depth.set(len(self._incoming)
                                     + self.scheduler.num_waiting)
        if self.tracer.enabled:
            self.tracer.event("request_submitted", trace_id=req.req_id,
                              prompt_tokens=len(prompt),
                              max_new=max_new_tokens)
        return req

    # -- completion --------------------------------------------------------
    def _complete(self, req: ServeRequest, *, tokens=None, error=None,
                  partial_generated: int = 0):
        """``partial_generated``: tokens produced before a failure
        (deadline expiry mid-decode) — the trace must not report an
        expired request that generated 30 tokens as zero-output work."""
        req.t_done = time.monotonic()
        req.tokens, req.error = tokens, error
        with self._lock:
            self._outstanding_tokens -= len(req.prompt) + req.max_new_tokens
        ttft = (None if req.t_first_token is None
                else req.t_first_token - req.t_submit)
        if error is None:
            req.status = "ok"
            self.metrics.completed.add()
            self.metrics.request_latency_s.observe(req.t_done - req.t_submit)
            self.metrics.request_latency_hist.observe(req.t_done - req.t_submit)
            # TPOT over the decode tail (first token excluded — that one
            # is the TTFT's business); single-token answers have no tail
            # and score a perfect 0.
            tail = len(tokens) - 1 if tokens else 0
            tpot = ((req.t_done - req.t_first_token) / tail if tail > 0
                    else 0.0)
            self.slo.record(ttft, tpot)
        elif isinstance(error, DeadlineExceeded):
            req.status = "expired"
            self.metrics.expired.add()
            # an expired request violates both objectives by definition —
            # the caller got no usable answer (None scores as violation;
            # results aren't streamed, so a mid-flight first token never
            # reached anyone).
            self.slo.record(None, None)
        elif isinstance(error, Requeued):
            # Handed back for resubmission elsewhere (drain): not a
            # failure of this replica and not scored — the retry's
            # eventual completion is what the fleet experienced.
            req.status = "retried"
        elif isinstance(error, ReplicaFailed):
            # Counted separately from expiry on purpose (ISSUE 9): a
            # dead replica is an availability event the router retries;
            # an expired deadline is a latency event nobody can retry.
            req.status = "replica_failed"
            self.metrics.replica_failed.add()
        elif isinstance(error, Cancelled):
            req.status = "cancelled"
        else:
            req.status = "rejected"
            self.metrics.rejected.add()
        if self.tracer.enabled:
            self.tracer.event(
                "request_done", trace_id=req.req_id, outcome=req.status,
                latency_s=req.t_done - req.t_submit,
                ttft_s=(None if req.t_first_token is None
                        else req.t_first_token - req.t_submit),
                generated=len(tokens) if tokens is not None
                else partial_generated)
        req.done.set()
        cb, req.on_done = req.on_done, None
        if cb is not None:
            try:
                cb(req)
            except Exception:  # noqa: BLE001 — a router-callback bug
                pass  # must not take the serve loop down with it

    # -- the step function (one scheduler decision + one engine call) ------
    def _ingest(self) -> None:
        with self._lock:
            batch = list(self._incoming)
            self._incoming.clear()
        for req in batch:
            seq = Sequence(
                seq_id=req.req_id, prompt=req.prompt,
                max_new_tokens=req.max_new_tokens,
                temperature=req.temperature, deadline=req.deadline,
                arrival=req.t_submit)
            self._by_seq[req.req_id] = req
            try:
                self.scheduler.add(seq)
            except ValueError as e:
                # add() re-checks feasibility because Server config and
                # direct-scheduler users can disagree; surface as 400.
                self._by_seq.pop(req.req_id)
                self._complete(req, error=AdmissionError(str(e), status=400))

    def step(self) -> bool:
        """One iteration: ingest, expire deadlines, run one prefill or
        one decode round, record results.  Returns False when idle.

        Raises :class:`ReplicaFailed` when a failure was injected
        (:meth:`fail`) — the driving loops route that through
        :meth:`_fail_all` so every in-flight request completes with a
        structured error instead of hanging forever."""
        self._maybe_beat()
        self._pause_if_frozen()
        with self._lock:
            inj, self._injected_failure = self._injected_failure, None
            slow = (self._slow_delay
                    if self.clock() < self._slow_until else 0.0)
        if inj is not None:
            raise inj
        if slow > 0.0:
            time.sleep(slow)
        if (self._drain_deadline is not None
                and self.clock() > self._drain_deadline):
            # Bounded drain: the grace window closed with work still in
            # flight — fail the leftovers loudly (the router requeues
            # them; a bare `tpucfn serve` reports them) instead of
            # decoding past the preemption that motivated the drain.
            self._fail_all(ReplicaFailed("drain grace expired with work "
                                         "in flight"))
            return False
        self._process_cancels()
        self._ingest()
        preempt0 = self.kv.evictions
        for seq in self.scheduler.expire():
            req = self._by_seq.pop(seq.seq_id)
            self._complete(req, error=DeadlineExceeded(
                f"deadline passed after {len(seq.generated)}"
                f"/{seq.max_new_tokens} tokens"),
                partial_generated=len(seq.generated))
        work = self.scheduler.next_work()
        if work is None:
            self._refresh_gauges()
            return False
        if isinstance(work, PrefillWork):
            # The prefill's sampled token is ALWAYS new output: for a
            # fresh sequence it's token 1; for a preempted one, the
            # recomputed prefix already contains everything previously
            # emitted, so the last position's logits predict the next
            # unseen token.
            items = work.items
            t_pf0 = time.monotonic()
            if hasattr(self.engine, "prefill_batch") and (
                    len(items) > 1 or items[0].cached_len):
                # Prefix hits plant the shared run first; then ONE
                # bucketed program prefills every item's suffix.
                for it in items:
                    # src == slot is the zero-copy hit: the sequence was
                    # landed on the retired slot that already holds its
                    # prefix, so there is nothing to move.
                    if it.cached_len and it.src_slot != it.slot:
                        self.engine.copy_prefix(it.src_slot, it.slot,
                                                it.cached_len)
                toks = self.engine.prefill_batch(
                    [(it.slot, it.seq.prefix[it.cached_len:], it.cached_len,
                      it.seq.temperature) for it in items], work.bucket)
            else:
                it = items[0]
                toks = {it.slot: self.engine.prefill(
                    it.slot, it.seq.prefix, work.bucket,
                    it.seq.temperature)}
            t_pf1 = time.monotonic()
            self.metrics.prefill_calls.add()
            self.metrics.prefill_batch_size.observe(len(items))
            if self.flight is not None:
                self.flight.record(
                    "sched", work="prefill", batch=len(items),
                    bucket=work.bucket, dur_s=round(t_pf1 - t_pf0, 6),
                    cached=sum(1 for it in items if it.cached_len))
            for it in items:
                req = self._by_seq[it.seq.seq_id]
                first = req.t_first_token is None
                self.metrics.prefilled_tokens.add(
                    len(it.seq.prefix) - it.cached_len)
                if it.cached_len:
                    self.metrics.prefix_hit_requests.add()
                    self.metrics.prefix_hit_tokens.add(it.cached_len)
                if self.tracer.enabled:
                    if first:
                        # The span whose start nobody observed from the
                        # serve loop: submit happened on the caller's
                        # thread, so it is recorded retroactively from
                        # t_submit.  queue_wait + prefill sums to the
                        # measured TTFT by construction.
                        self.tracer.record("queue_wait", start=req.t_submit,
                                           end=t_pf0, trace_id=req.req_id)
                    self.tracer.record("prefill", start=t_pf0, end=t_pf1,
                                       trace_id=req.req_id, slot=it.slot,
                                       bucket=work.bucket,
                                       prefix_len=len(it.seq.prefix),
                                       cached_len=it.cached_len,
                                       batch=len(items),
                                       resumed=not first)
                if first:  # preempted reruns keep the first
                    req.t_first_token = t_pf1
                    self.metrics.ttft_s.observe(
                        req.t_first_token - req.t_submit)
                self.metrics.generated_tokens.add()
                self._finish(
                    self.scheduler.record_prefill(it.slot, toks[it.slot]))
        elif getattr(self.engine, "spec_enabled", False):
            # Propose-verify round (ISSUE 14): the draft proposes k
            # tokens per slot, ONE target dispatch verifies k+1
            # positions, and the scheduler records the accepted run —
            # truncating on EOS/max_new or a dry pool, after which
            # commit_round repairs both caches to what actually landed.
            t_dec0 = time.monotonic()
            outs, st = self.engine.run_round(work.slots)
            work.proposed = outs
            recorded: dict[int, int] = {}
            emitted = 0
            for slot, toks in outs.items():
                seq = work.slots[slot]
                fin, n = self.scheduler.record_decode_tokens(slot, toks)
                recorded[slot] = len(seq.prompt) + len(seq.generated) - 1
                emitted += n
                self.metrics.generated_tokens.add(n)
                self.metrics.decode_tokens.add(n)
                self._finish(fin)
            self.engine.commit_round(recorded)
            t_dec1 = time.monotonic()
            self.metrics.decode_rounds.add()
            self.metrics.decode_slot_steps.add(len(work.slots))
            if st.mode == "spec":
                self.metrics.spec_rounds.add()
                self.metrics.spec_proposed.add(st.proposed)
                self.metrics.spec_accepted.add(st.accepted)
            if self.flight is not None:
                self.flight.record(
                    "sched", work="decode", batch=len(work.slots),
                    dur_s=round(t_dec1 - t_dec0, 6), spec=st.mode,
                    emitted=emitted, proposed=st.proposed,
                    accepted=st.accepted)
            if self.tracer.enabled:
                seqs = sorted(s.seq_id for s in work.slots.values())
                self.tracer.record("decode_round", start=t_dec0,
                                   end=t_dec1, batch=len(work.slots),
                                   seqs=seqs)
                if st.mode == "spec":
                    # The round's TTFT/TPOT attribution splits into its
                    # draft and verify halves; the request breakdown
                    # (obs.aggregate) sums both per request, so the SLO
                    # burn math sees where the per-token time went.
                    self.tracer.record(
                        "spec_propose", start=st.t_propose0,
                        end=st.t_propose1, batch=len(work.slots),
                        seqs=seqs, width=st.width, proposed=st.proposed,
                        resyncs=st.resyncs)
                    self.tracer.record(
                        "spec_verify", start=st.t_verify0,
                        end=st.t_verify1, batch=len(work.slots),
                        seqs=seqs, width=st.width, accepted=st.accepted,
                        emitted=emitted)
        else:
            t_dec0 = time.monotonic()
            out = self.engine.decode(
                {slot: seq.last_token for slot, seq in work.slots.items()})
            if self.flight is not None:
                self.flight.record(
                    "sched", work="decode", batch=len(work.slots),
                    dur_s=round(time.monotonic() - t_dec0, 6))
            if self.tracer.enabled:
                self.tracer.record(
                    "decode_round", start=t_dec0, end=time.monotonic(),
                    batch=len(work.slots),
                    seqs=sorted(s.seq_id for s in work.slots.values()))
            self.metrics.decode_rounds.add()
            self.metrics.decode_slot_steps.add(len(work.slots))
            for slot, tok in out.items():
                self.metrics.generated_tokens.add()
                self.metrics.decode_tokens.add()
                self._finish(self.scheduler.record_decode(slot, tok))
        evicted = self.kv.evictions - preempt0
        if evicted and self.tracer.enabled:
            self.tracer.event("preemption", count=evicted)
        self.metrics.preemptions.add(evicted)
        self._refresh_gauges()
        return True

    def _finish(self, seq) -> None:
        if seq is not None and seq.state is SequenceState.FINISHED:
            req = self._by_seq.pop(seq.seq_id)
            self._complete(req, tokens=list(seq.generated))

    def _refresh_gauges(self) -> None:
        queue = len(self._incoming) + self.scheduler.num_waiting
        running = self.scheduler.num_running
        occupancy = self.kv.occupancy()
        self.metrics.queue_depth.set(queue)
        self.metrics.running.set(running)
        self.metrics.cache_occupancy.set(occupancy)
        if self.flight is not None:
            # One ring sample per serve iteration: queue depth + batch
            # occupancy are exactly the "what was the engine doing in
            # its final seconds" series a postmortem reads (ISSUE 6).
            self.flight.record("serve", queue=queue, running=running,
                               occupancy=round(occupancy, 4))

    # -- resilience plumbing (ISSUE 9) -------------------------------------
    def _maybe_beat(self) -> None:
        """One heartbeat per writer interval, FROM the serve loop (see
        ``heartbeat`` in ``__init__``) — a frozen loop stops beating."""
        hb = self.heartbeat
        if hb is None:
            return
        now = self.clock()
        if now - self._last_beat >= hb.interval_s:
            self._last_beat = now
            hb.beat()

    def _pause_if_frozen(self) -> None:
        """Chaos ``freeze_replica``: block the serve loop (no steps, no
        beats) until the freeze lapses — or a kill/stop arrives, which
        must still win against a frozen replica."""
        while True:
            with self._lock:
                if self._injected_failure is not None or self._stopping:
                    return
                remaining = self._frozen_until - self.clock()
            if remaining <= 0:
                return
            time.sleep(min(0.005, remaining))

    def _process_cancels(self) -> None:
        """Apply cancel/evict requests at the step boundary — the serve
        thread is the only scheduler mutator, so cross-thread ``cancel``
        /``evict_queued`` calls just leave a note here."""
        with self._lock:
            ids, self._cancel_req = self._cancel_req, set()
            evict, self._evict_waiting = self._evict_waiting, False
        for rid in sorted(ids):
            self._cancel_one(rid)
        if evict:
            self._evict_waiting_now()

    def _cancel_one(self, rid: int) -> None:
        with self._lock:
            queued = next((r for r in self._incoming if r.req_id == rid),
                          None)
            if queued is not None:
                self._incoming.remove(queued)
        if queued is not None:
            self._complete(queued, error=Cancelled("cancelled before start"))
            return
        if rid in self._by_seq:
            seq = self.scheduler.cancel(rid)
            if seq is not None:
                req = self._by_seq.pop(rid)
                self._complete(req, error=Cancelled(
                    f"cancelled after {len(seq.generated)}"
                    f"/{seq.max_new_tokens} tokens"),
                    partial_generated=len(seq.generated))

    def _evict_waiting_now(self) -> None:
        """Hand every not-yet-started sequence back to the caller with
        ``Requeued`` (terminal status ``retried``): a draining replica's
        queue belongs on a healthy replica, not behind this one's last
        decodes.  Running sequences are untouched — they get the drain
        grace window."""
        with self._lock:
            batch = list(self._incoming)
            self._incoming.clear()
        for seq in list(self.scheduler.waiting):
            self.scheduler.cancel(seq.seq_id)
            req = self._by_seq.pop(seq.seq_id, None)
            if req is not None:
                batch.append(req)
        for req in batch:
            self._complete(req, error=Requeued(
                "replica draining: requeued to another replica"))

    def cancel(self, req_id: int) -> None:
        """Request cancellation (hedge-loser path): takes effect at the
        next step boundary on the serve thread; the handle completes
        with :class:`Cancelled` (status ``"cancelled"``).  Unknown or
        already-finished ids are a no-op."""
        with self._lock:
            self._cancel_req.add(req_id)
            self._work.notify()

    def evict_queued(self) -> None:
        """Hand all queued-not-started work back (each completes with
        :class:`Requeued`, status ``"retried"``) at the next step
        boundary — the router's drain calls this before waiting out the
        in-flight grace."""
        with self._lock:
            self._evict_waiting = True
            self._work.notify()

    def fail(self, exc: BaseException | None = None) -> None:
        """Kill this replica (chaos ``kill_replica``, or the router
        acting on a DEAD health verdict): every in-flight and queued
        request completes with :class:`ReplicaFailed`, admission closes
        (503), and the serve thread exits.  Idempotent."""
        exc = exc if exc is not None else ReplicaFailed("replica killed")
        if not isinstance(exc, ReplicaFailed):
            exc = ReplicaFailed(repr(exc))
        with self._lock:
            if self._failed is not None:
                return
            if self._thread is not None:
                # the serve thread consumes the injection at its next
                # step boundary (and the freeze-pause loop checks it, so
                # a kill still beats a frozen replica)
                self._injected_failure = exc
                self._work.notify()
                return
        self._fail_all(exc)

    def _fail_all(self, exc: ReplicaFailed) -> None:
        """Terminal: mark the replica failed and complete everything in
        flight with the failure.  Scheduler state is abandoned, not
        repaired — a failed replica never runs another step."""
        with self._lock:
            if self._failed is not None:
                return
            self._failed = exc
            batch = list(self._incoming)
            self._incoming.clear()
        abandon = getattr(self.engine, "abandon_round", None)
        if abandon is not None:
            # A spec round killed between propose-verify and commit
            # must not wedge the engine pair's next incarnation
            # (ISSUE 14); the relaunch re-prefills every slot anyway.
            abandon()
        reqs = batch + [self._by_seq.pop(k) for k in list(self._by_seq)]
        self.scheduler.waiting.clear()
        self.scheduler.running.clear()
        for req in reqs:
            self._complete(req, error=exc)

    def freeze(self, duration_s: float | None = None) -> None:
        """Chaos ``freeze_replica``: the serve loop (and its heartbeat)
        stalls for ``duration_s`` (None = until :meth:`unfreeze`)."""
        with self._lock:
            self._frozen_until = (float("inf") if duration_s is None
                                  else self.clock() + duration_s)

    def unfreeze(self) -> None:
        with self._lock:
            self._frozen_until = 0.0

    def slow(self, delay_s: float, duration_s: float | None = None) -> None:
        """Chaos ``slow_replica``: every step pays an extra ``delay_s``
        for ``duration_s`` (None = until ``slow(0)``)."""
        with self._lock:
            self._slow_delay = float(delay_s)
            self._slow_until = (float("inf") if duration_s is None
                                else self.clock() + duration_s)

    def outstanding(self) -> int:
        """Requests submitted but not yet terminal."""
        with self._lock:
            return len(self._incoming) + len(self._by_seq)

    def wait_stopped(self, timeout: float | None = None) -> bool:
        """Wait for the serve thread to exit (it ends on its own after
        :meth:`fail` or :meth:`stop`); True when no thread is running.
        The router joins a killed incarnation here before relaunching —
        two serve loops driving one engine race its donated cache
        buffers."""
        t = self._thread
        if t is None:
            return True
        t.join(timeout)
        return not t.is_alive()

    def drain(self, grace_s: float = 30.0, *, wait: bool = True) -> bool:
        """Graceful shutdown (ISSUE 9 satellite): close admission (503)
        and run the work already accepted to completion, bounded by
        ``grace_s`` — a preempted serve host finishes its decodes
        instead of abandoning them the way ``stop()`` did.  Work still
        unfinished when the grace closes completes with
        :class:`ReplicaFailed` (the router requeues it).

        ``wait=False`` only arms the drain (admission off + deadline)
        and returns — the signal-handler form: the already-running loop
        enforces the bound.  Returns True when everything finished
        inside the grace."""
        if not wait:
            # Signal-handler form: the handler may have interrupted a
            # frame ON THIS THREAD that already holds self._lock (the
            # serve loop's step(), or submit()), and self._lock is not
            # reentrant — acquiring it here would deadlock the process
            # at the exact moment it is trying to die gracefully.
            # Plain attribute stores are GIL-atomic and the running
            # loop reads them at its next step boundary.
            self._draining = True
            if self._drain_deadline is None:
                self._drain_deadline = self.clock() + grace_s
            return len(self._incoming) + len(self._by_seq) == 0
        with self._lock:
            self._draining = True
            if self._drain_deadline is None:
                self._drain_deadline = self.clock() + grace_s
            deadline = self._drain_deadline
            self._work.notify()
        clean = True
        if self._thread is None:
            while True:
                if self.clock() > deadline:
                    if self.outstanding():
                        self._fail_all(ReplicaFailed(
                            "drain grace expired with work in flight"))
                        clean = False
                    break
                try:
                    if not self.step():
                        break
                except ReplicaFailed as e:
                    self._fail_all(e)
                    clean = False
                    break
                except Exception as e:  # noqa: BLE001 — engine died mid-drain
                    self._fail_all(ReplicaFailed(f"serve loop failed: {e!r}"))
                    clean = False
                    break
        else:
            while self.outstanding() and self.clock() <= deadline:
                time.sleep(0.005)
            thread = self._thread
            self.stop(timeout=max(grace_s, 1.0))
            if thread is not None and thread.is_alive():
                # wedged (e.g. frozen) — leave the leftovers to fail()
                # /the router; completing them here would race the loop
                return False
            if self.outstanding():
                self._fail_all(ReplicaFailed(
                    "drain grace expired with work in flight"))
                clean = False
        # _failed catches every force-fail path, including the serve
        # thread running step()'s own drain-deadline branch just before
        # exiting (the threaded join then sees outstanding()==0 and a
        # dead thread — which is NOT a clean drain).
        return clean and self.outstanding() == 0 and self._failed is None

    # -- driving modes -----------------------------------------------------
    def run_until_idle(self) -> None:
        while True:
            try:
                if not self.step():
                    return
            except ReplicaFailed as e:
                self._fail_all(e)
                return
            except Exception as e:  # noqa: BLE001 — engine/scheduler died
                wrapped = ReplicaFailed(f"serve loop failed: {e!r}")
                self._fail_all(wrapped)
                raise wrapped from e

    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("server already started")
        self._stopping = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="tpucfn-serve")
        self._thread.start()

    def stop(self, timeout: float = 30.0) -> None:
        with self._lock:
            self._stopping = True
            self._work.notify()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    def _run(self) -> None:
        while True:
            try:
                progressed = self.step()
            except ReplicaFailed as e:
                self._fail_all(e)
                return
            except Exception as e:  # noqa: BLE001 — engine/scheduler died
                # The old behavior silently killed this thread and left
                # every in-flight request hanging forever; a replica
                # failure must complete them with a structured error the
                # router can retry (ISSUE 9).
                self._fail_all(ReplicaFailed(f"serve loop failed: {e!r}"))
                return
            if not progressed:
                with self._lock:
                    if self._stopping:
                        return
                    if not self._incoming and not self.scheduler.has_work():
                        # Truly idle: no queued or running sequences means
                        # no pending deadlines either (_by_seq drains with
                        # the scheduler), so sleep until submit()/stop()
                        # notifies — with a heartbeat attached, wake once
                        # per interval so liveness keeps flowing while
                        # idle (idle is not dead).
                        self._work.wait(
                            None if self.heartbeat is None
                            else self.heartbeat.interval_s)
