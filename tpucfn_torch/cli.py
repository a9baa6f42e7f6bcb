"""Command line of the port: ``python -m tpucfn_torch.cli <command>``.

The cluster commands are the port of ``tpucfn/cli/main.py``'s::

    python -m tpucfn_torch.cli create-stack --name demo --accelerator h100-1
    python -m tpucfn_torch.cli status --name demo
    python -m tpucfn_torch.cli env --name demo       # eval-able contract
    python -m tpucfn_torch.cli launch --name demo --ft -- \
        python -m tpucfn_torch.examples.llama3_8b_fsdp --model 1b ...
    python -m tpucfn_torch.cli resize --name demo --accelerator h100-2
    python -m tpucfn_torch.cli kill-host --name demo --host 0
    python -m tpucfn_torch.cli heal --name demo
    python -m tpucfn_torch.cli ft status --name demo
    python -m tpucfn_torch.cli delete --name demo

State lives in ``--state-dir`` (default ``$TPUCFN_TORCH_STATE_DIR`` or
``~/.tpucfn_torch``; not the JAX package's ``$TPUCFN_STATE_DIR``, whose
state file holds TPU accelerators that the port's registry does not know) through the fake
control plane; ``--backend gcp`` (TPU queued resources) is refused.
``launch`` fans the command out with the env contract and, with
``--ft``, runs it under the gang coordinator (heartbeats, restarts with
a budget, preemption drain, checkpoint-corruption retry, chaos specs),
with the reference's launch planes: ``--supervise`` (the coordinator
under a re-exec loop that relaunches it to adopt the running fleet),
``--input-hosts``/``--input-cmd`` (input hosts running ``data serve``),
``--compile-cache`` (the kernel libraries' artifact server in the launch
process), ``--chaos-proxy`` (fault-injection proxies for the ``net_*``
chaos events) and ``--provision-policy goodput`` (the coordinator reads
the ranks' goodput ledgers and grows or shrinks the input plane;
``--defer-input-plane`` reserves the input hosts until a grow).
``data serve``,
``compilecache serve|gc|stats`` and ``chaos proxy`` are the reference's
standalone planes; none of them touches the card.  ``convert-dataset``
(``--kind image-tree|cifar10|recordio|token-jsonl``, ``--publish URL``)
packs a dataset into record shards and ``stage-data`` syncs shards from a
store URL into a local directory, as the reference's do (no image is
decoded: an image tree's shards hold the encoded files).

``serve`` is ``tpucfn serve`` (``tpucfn/cli/main.py:cmd_serve``):
continuous-batching inference over a workload of token-id prompts
(``--prompts`` JSONL with {"tokens": [...]} rows, or ``--synthetic N``
random prompts) on a random-init Llama preset, printing the serving
metrics snapshot as one JSON line: speculative decoding
(``--spec-draft``), N replicas behind the router (``--replicas``), the
admission and SLO flags, a graceful drain on SIGTERM, the obs endpoint
(``--obs-port``), request trace spans (``--trace-dir``), the flight
recorder and, under ``TPUCFN_FT_DIR``, heartbeats.  It runs on the card
unless ``--device cpu`` is given; with ``TPUCFN_COMPILE_CACHE_ADDRS`` or
``TPUCFN_COMPILE_CACHE_DIR`` set, its kernel libraries go through the
fleet cache; with ``--trace-dir`` its obs endpoint takes ``POST
/profile``.

``rl train`` is ``tpucfn rl train`` (``tpucfn/cli/main.py:cmd_rl_train``):
one host's RL loop (:mod:`tpucfn_torch.rl`: bandit or gridworld actors,
an A2C learner, the replay queue on the device), checkpointed and
resumable, and fan-out ready under ``launch``; on the card unless
``--device cpu`` is given.

The read side of a run directory, as the reference's: ``obs`` (metrics
and trace JSONL as one fleet view), ``obs goodput`` (wall clock by
bucket, with the ft incidents; ``--ledger`` appends a row that ``obs
diff`` compares), ``obs postmortem`` (one incident's bundle), ``obs
profile`` (the ``POST /profile`` client), ``trace export|critpath|advise``
(the merged fleet timeline), ``forensics diff`` (two bundles) and ``ft
status`` (heartbeat verdicts, recovery metrics and events).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np

from tpucfn_torch.bootstrap import converge
from tpucfn_torch.launch import Launcher, LocalTransport, SSHTransport
from tpucfn_torch.provision import FakeControlPlane, Provisioner
from tpucfn_torch.serve.engine import LLAMA_PRESETS
from tpucfn_torch.spec import ClusterSpec

def _slo_objective(s: str) -> float:
    """argparse type for ``--slo-objective``: the fraction must leave a
    nonzero error budget (burn rate divides by 1 − objective), so 0 and
    1 are usage errors, not tracebacks from SLOTracker's constructor."""
    try:
        v = float(s)
    except ValueError:
        raise argparse.ArgumentTypeError(f"not a number: {s!r}")
    if not 0.0 < v < 1.0:
        raise argparse.ArgumentTypeError(
            f"objective must be in (0, 1) exclusive, got {v} — 1.0 has "
            "no error budget to burn")
    return v


def cmd_serve(args) -> int:
    """``tpucfn serve`` (``tpucfn/cli/main.py:cmd_serve``): continuous
    batching over a workload of token-id prompts, printing the serving
    metrics snapshot (or, with ``--replicas N``, the router's) as one
    JSON line; rc 0 only when every request was served.

    ``--replicas N`` runs N engines over one set of weights behind a
    :class:`~tpucfn_torch.serve.router.ReplicaRouter` (failover,
    deadline-budgeted retry, hedging, drain).  ``--spec-draft PRESET``
    pairs each engine (or the ``--spec-replicas`` subset) with a draft
    engine for speculative decoding.  SIGTERM drains: admission closes
    and accepted work gets ``--drain-grace`` to finish."""
    import signal

    from tpucfn_torch.obs.flight import FlightRecorder
    from tpucfn_torch.obs.metrics import register_device_gauges
    from tpucfn_torch.obs.registry import MetricRegistry
    from tpucfn_torch.obs.server import start_obs_server
    from tpucfn_torch.obs.trace import Tracer
    from tpucfn_torch.serve import AdmissionError, Server
    from tpucfn_torch.serve.engine import ServeEngine, demo_llama_engine

    # Host identity: under `launch` every rank carries TPUCFN_HOST_ID.
    host_id = int(os.environ.get("TPUCFN_HOST_ID", "0") or 0)
    registry = MetricRegistry(labels={"role": "server", "host": str(host_id)})
    # Fleet warm start: installed before the first engine is built, so
    # every replica's kernel libraries (a probation relaunch's too) come
    # from the kernel directory, the artifact store or the fleet before
    # nvcc builds one.  Env unset: None, the kernels build as ever.  The
    # CPU's plain paths load no library.
    cc_cache = None
    from tpucfn_torch.device import resolve_device

    if resolve_device(args.device).type == "cuda":
        from tpucfn_torch.compilecache import configure_from_env

        cc_cache = configure_from_env(registry=registry)
    cfg, engine = demo_llama_engine(args.preset, seed=args.seed,
                                    max_batch=args.max_batch,
                                    cache_len=args.cache_len,
                                    prefill_width=args.max_prefill_batch,
                                    device=args.device)

    # Each selected engine gets its OWN draft engine (its own cache) at
    # the target's slot layout; unset, every engine is the plain object.
    spec_set: set = set()
    if args.spec_draft:
        spec_set = set(range(max(args.replicas, 1)))
        if args.spec_replicas:
            spec_set = {int(t) for t in args.spec_replicas.split(",")
                        if t.strip()}
            bad = [i for i in spec_set if not 0 <= i < args.replicas]
            if bad:
                return _refuse(f"--spec-replicas {bad} outside "
                               f"0..{args.replicas - 1}")

    def _maybe_spec(i, eng):
        if i not in spec_set:
            return eng
        from tpucfn_torch.serve.spec import SpecDecoder

        if args.spec_draft == "self":
            # the target's weights, shared: a cache and no weights more
            draft = ServeEngine.from_llama(
                cfg, engine.params, max_batch=args.max_batch,
                cache_len=eng.cache_len,
                prefill_width=args.max_prefill_batch, device=args.device)
        else:
            _, draft = demo_llama_engine(
                args.spec_draft,
                seed=(args.seed if args.spec_draft_seed is None
                      else args.spec_draft_seed),
                max_batch=args.max_batch, cache_len=eng.cache_len,
                prefill_width=args.max_prefill_batch, device=args.device)
        return SpecDecoder(eng, draft, k=args.spec_k,
                           adaptive=args.spec_adaptive)

    rs = np.random.RandomState(args.seed)
    if args.prompts:
        prompts = []
        with open(args.prompts) as f:
            for line in f:
                if line.strip():
                    prompts.append([int(t) for t in json.loads(line)["tokens"]])
    else:
        lo, _, hi = (args.prompt_len or "4:32").partition(":")
        prompts = [
            rs.randint(0, cfg.vocab_size,
                       rs.randint(int(lo), int(hi or lo) + 1)).tolist()
            for _ in range(args.synthetic)]
    if not prompts:
        print("error: no prompts (use --prompts file or --synthetic N)",
              file=sys.stderr)
        return 2

    # The forensics plane: the ring feeds /flightrecorder; with
    # --trace-dir the exit dump lands in the trace dir's sibling flight/.
    flight = FlightRecorder(host_id=host_id, role="server")
    register_device_gauges(registry)
    artifacts_root = None
    if args.trace_dir:
        artifacts_root = Path(args.trace_dir).resolve().parent
        flight.install_dump_handlers(artifacts_root / "flight")
    tracer = obs_srv = hb = server = router = profiler = None
    reqs = []
    try:
        # Inside the try from the first resource on: a failed port bind
        # must not leak the tracer opened before it.
        tracer = Tracer(args.trace_dir, host_id=host_id, role="server",
                        truncate=True) if args.trace_dir else Tracer(None)
        if args.trace_dir:
            # POST /profile: the serve loop is the copied Server's, so the
            # capture runs on the obs server's thread and holds the
            # card's activity of every serving thread.
            from tpucfn_torch.obs.profiler import ProfileCapture, capture_here

            profiler = ProfileCapture(artifacts_root / "profile",
                                      tracer=tracer, capture_fn=capture_here)
        # --obs-port wins; otherwise the launcher-assigned TPUCFN_OBS_PORT
        # applies; neither -> no endpoint.
        obs_srv = start_obs_server(registry, port=args.obs_port,
                                   role="server", host_id=host_id,
                                   flight=flight, profiler=profiler)
        if obs_srv is not None:
            print(f"obs endpoint: {obs_srv.url()}", file=sys.stderr)
        # Under `launch --ft` a serve host writes heartbeats like any
        # trainer rank.
        ft_dir = os.environ.get("TPUCFN_FT_DIR", "").strip()
        if ft_dir:
            from tpucfn_torch.ft.heartbeat import HeartbeatWriter

            hb = HeartbeatWriter(
                ft_dir, host_id, role="server",
                interval_s=float(
                    os.environ.get("TPUCFN_FT_HEARTBEAT_S", "1.0") or 1.0))
            hb.start()

        if args.replicas > 1:
            from tpucfn_torch.serve import ReplicaRouter
            from tpucfn_torch.serve.router import ReplicaTracer

            engines = [engine] + [
                ServeEngine.from_llama(cfg, engine.params,
                                       max_batch=args.max_batch,
                                       cache_len=args.cache_len,
                                       prefill_width=args.max_prefill_batch,
                                       device=args.device)
                for _ in range(args.replicas - 1)]
            # Wrapped OUTSIDE the factory so a probation relaunch reuses
            # the same engine pair.
            engines = [_maybe_spec(i, e) for i, e in enumerate(engines)]
            # The replicas' serve_* series live on private registries; the
            # spec replicas' controllers outlive their relaunches, so the
            # shared /metrics carries the single server's two spec series
            # over them: the mean acceptance rate and the smallest k.
            ctls = [engines[i].controller for i in sorted(spec_set)]
            if ctls:
                registry.computed_gauge(
                    "serve_spec_acceptance_rate",
                    lambda: sum(c.acceptance_rate() for c in ctls)
                    / len(ctls),
                    "windowed draft-token acceptance rate (the "
                    "k-controller's shrink/grow signal)")
                registry.computed_gauge(
                    "serve_spec_k", lambda: float(min(c.k for c in ctls)),
                    "current proposal depth k (0 = speculation off, "
                    "probing)")

            class _FlightTee:
                """Replica samples land in the replica's own ring (what
                the router captures from survivors at incident time) and,
                tagged with the replica index, in the host ring that
                /flightrecorder serves."""

                def __init__(self, replica: int):
                    self.replica = replica
                    self.ring = FlightRecorder(host_id=replica,
                                               role="replica")

                def record(self, kind, **fields):
                    flight.record(kind, replica=self.replica, **fields)
                    return self.ring.record(kind, **fields)

                def snapshot(self):
                    return self.ring.snapshot()

            def _replica(i: int) -> Server:
                # a private registry each; the shared one carries router_*
                return Server(engines[i], num_blocks=args.num_blocks,
                              block_size=args.block_size,
                              max_queued_tokens=args.max_queued_tokens,
                              prefix_cache=args.prefix_cache,
                              max_prefill_batch=args.max_prefill_batch,
                              ttft_slo_s=args.slo_ttft,
                              tpot_slo_s=args.slo_tpot,
                              slo_objective=args.slo_objective,
                              tracer=ReplicaTracer(tracer, i),
                              flight=_FlightTee(i))

            serve_ft = (Path(ft_dir) / "serve" if ft_dir
                        else (artifacts_root / "serve-ft"
                              if artifacts_root is not None else None))
            router = ReplicaRouter(
                _replica, args.replicas, registry=registry,
                ft_dir=serve_ft, retry_budget=args.retry_budget,
                hedge_ms=args.hedge_ms, slo_shed=args.slo_shed,
                drain_grace_s=args.drain_grace)
        else:
            server = Server(_maybe_spec(0, engine),
                            num_blocks=args.num_blocks,
                            block_size=args.block_size,
                            max_queued_tokens=args.max_queued_tokens,
                            registry=registry, tracer=tracer,
                            prefix_cache=args.prefix_cache,
                            max_prefill_batch=args.max_prefill_batch,
                            ttft_slo_s=args.slo_ttft,
                            tpot_slo_s=args.slo_tpot,
                            slo_objective=args.slo_objective,
                            slo_shed=args.slo_shed,
                            flight=flight)

        def _on_term(signum, frame):
            # Graceful drain: admission closes, accepted work finishes
            # within the grace.  wait=False only arms the deadline (a
            # signal handler must not block); drain_all also stops the
            # router from relaunching drained replicas.
            if router is not None:
                router.drain_all(args.drain_grace, wait=False)
            else:
                server.drain(args.drain_grace, wait=False)
            print(f"SIGTERM: draining (grace {args.drain_grace:g}s)",
                  file=sys.stderr)

        try:
            signal.signal(signal.SIGTERM, _on_term)
        except ValueError:
            pass  # not the main thread (embedded use): no drain hook

        front = router if router is not None else server
        if router is not None:
            router.start()
        for p in prompts:
            try:
                reqs.append(front.submit(
                    p, max_new_tokens=args.max_new,
                    temperature=args.temperature,
                    deadline_s=args.deadline_s))
            except AdmissionError as e:
                print(f"rejected ({e.status}): {e}", file=sys.stderr)
        if router is not None:
            for r in reqs:
                r.done.wait()
            router.stop()
        else:
            server.run_until_idle()
    finally:
        # A failing run still releases the bound port and the trace file.
        if cc_cache is not None:
            from tpucfn_torch.compilecache import kernels as kernel_cache

            if kernel_cache.installed() is cc_cache:
                kernel_cache.install(None)
        if tracer is not None:
            tracer.close()
        if obs_srv is not None:
            obs_srv.close()
        if hb is not None:
            hb.stop()
    ok = sum(1 for r in reqs if r.error is None)
    print(f"served {ok}/{len(prompts)} requests "
          f"({len(prompts) - len(reqs)} rejected at submit)", file=sys.stderr)
    if router is not None:
        print(json.dumps({"router": router.snapshot()}))
    else:
        print(json.dumps({**server.metrics.snapshot(),
                          "slo": server.slo.snapshot()}))
    return 0 if ok == len(prompts) else 1


def cmd_obs(args) -> int:
    """``tpucfn obs`` (``tpucfn/cli/main.py:cmd_obs``): per-host metrics
    JSONL and trace JSONL of a run directory merged into one fleet view:
    the step timeline, the per-host straggler report, the request latency
    breakdown of the serving spans and the control events.  ``--watch``
    re-renders every N seconds, tailing each file from its last offset."""
    import time

    from tpucfn_torch.ft.heartbeat import HB_GLOB
    from tpucfn_torch.obs.aggregate import (
        JsonlTailer,
        apply_clock_skew,
        control_timeline,
        estimate_clock_skew,
        host_straggler_report,
        merge_step_timeline,
        render_table,
        request_breakdown,
        select_skew_reference_beats,
        step_spans_by_host,
    )
    from tpucfn_torch.obs.goodput import host_id_from_path

    if not args.run_dir:
        return _refuse("--run-dir required")
    run_dir = Path(args.run_dir).expanduser()
    logs_dir = Path(args.logs_dir) if args.logs_dir else run_dir / "logs"
    trace_dir = Path(args.trace_dir) if args.trace_dir else run_dir / "trace"
    ft_dir = run_dir / "ft"

    # --watch keeps per-file byte offsets and reads only new complete
    # lines each tick; one-shot mode is the first poll.
    tailer = JsonlTailer()
    by_host: dict[str, list[dict]] = {}
    events_by_file: dict = {}
    hb_by_host: dict[int, list[dict]] = {}
    hb_last: dict[int, tuple] = {}  # host -> (seq, step) of last kept beat
    cache = {"skew": {}, "events": [], "report": None}

    def _extend_sorted(_k, lst: list, recs: list) -> int:
        # per-file start order: retroactive spans (queue_wait) land in
        # timeline order
        lst.extend(recs)
        lst.sort(key=lambda e: e.get("start", 0.0))
        return len(recs)

    def _keep_hb(host: int, lst: list, recs: list) -> int:
        # only the beats the clock-skew estimate can use
        kept, hb_last[host] = select_skew_reference_beats(
            recs, hb_last.get(host, (None, None)))
        lst.extend(kept)
        return len(kept)

    def one_pass() -> dict:
        new_logs = new_trace = new_hb = False
        if logs_dir.is_dir():
            new_logs = tailer.poll_into(
                sorted(logs_dir.glob("*.jsonl")), by_host,
                key_fn=lambda p: p.stem)
        if trace_dir.is_dir():
            new_trace = tailer.poll_into(
                sorted(trace_dir.glob("trace-*.jsonl")), events_by_file,
                extend=_extend_sorted)
        if ft_dir.is_dir():
            new_hb = tailer.poll_into(
                sorted(ft_dir.glob(HB_GLOB)), hb_by_host,
                key_fn=host_id_from_path, extend=_keep_hb,
                on_drop=lambda h: hb_last.pop(h, None))
        if not (new_logs or new_trace or new_hb) and cache["report"]:
            return cache["report"]  # idle tick: nothing to redo
        # Cross-host ordering on the skew-corrected fleet clock.
        if new_trace or new_hb or cache["report"] is None:
            events = []
            for p in sorted(events_by_file):
                events.extend(events_by_file[p])
            skew = estimate_clock_skew(events, hb_by_host or None)
            if any(skew.values()):
                events = apply_clock_skew(events, skew)
            cache["skew"], cache["events"] = skew, events
        skew, events = cache["skew"], cache["events"]
        # Step spans stand in for a missing metrics JSONL; with both, the
        # JSONL is the timeline and the spans a second report.
        span_hosts = step_spans_by_host(events)
        timeline_src = by_host or span_hosts
        report = {
            "logs_dir": str(logs_dir),
            "trace_dir": str(trace_dir),
            "hosts": sorted(timeline_src),
            "clock_skew_s": skew,
            "timeline": merge_step_timeline(timeline_src, key="step_time",
                                            last=args.steps),
            "stragglers": host_straggler_report(
                timeline_src, keys=("step_time", "data_wait_time")),
        }
        if span_hosts and by_host:
            report["trace_stragglers"] = host_straggler_report(
                span_hosts, keys=("step_time", "data_wait_time"))
        rows, agg = request_breakdown(events)
        report["requests"], report["request_aggregate"] = rows, agg
        report["control"] = control_timeline(events)
        cache["report"] = report
        return report

    def show(report: dict) -> None:
        if args.json:
            print(json.dumps(report))
            return
        print(f"# fleet view  logs={report['logs_dir']} "
              f"trace={report['trace_dir']}")
        if len(report.get("clock_skew_s", {})) >= 2:
            print("clock skew (s vs fleet median): " + "  ".join(
                f"{h}={s:+.3f}" for h, s in
                sorted(report["clock_skew_s"].items())))
        if report["timeline"]:
            print(f"\n== merged step timeline (last {args.steps}) ==")
            print(render_table(report["timeline"],
                               ["step", "hosts", "min", "median", "max",
                                "straggler"]))
        straggler_cols = ["host", "records", "mean_step_time",
                          "mean_data_wait_time", "vs_fleet_median", "slow"]
        if report["stragglers"]:
            print("\n== per-host stragglers ==")
            print(render_table(report["stragglers"], straggler_cols))
        if report.get("trace_stragglers"):
            print("\n== per-host stragglers (trace spans) ==")
            print(render_table(report["trace_stragglers"], straggler_cols))
        if report.get("control"):
            print("\n== control events (recoveries / captures / "
                  "artifact fetches) ==")
            print(render_table(report["control"],
                               ["ts", "host", "role", "span", "dur_s",
                                "detail"], float_fmt="{:.3f}"))
        if report["requests"]:
            print("\n== request latency breakdown ==")
            cols = ["host", "request", "queue_wait_s", "prefill_s",
                    "decode_s", "ttft_s", "total_s", "generated", "outcome"]
            if any(r.get("spec_propose_s") or r.get("spec_verify_s")
                   for r in report["requests"]):
                # speculative rounds ran: show the decode split
                cols[5:5] = ["spec_propose_s", "spec_verify_s"]
            print(render_table(report["requests"], cols))
            agg = report["request_aggregate"]
            print(f"\n{agg['completed']}/{agg['requests']} completed; "
                  "p50/p95 (s): " + "  ".join(
                      f"{k.removesuffix('_s')}="
                      f"{(agg[k]['p50'] or 0):.4f}/{(agg[k]['p95'] or 0):.4f}"
                      for k in ("queue_wait_s", "prefill_s", "decode_s",
                                "ttft_s", "total_s")))
        if not (report["timeline"] or report["stragglers"]
                or report["requests"]):
            print("no metrics or trace JSONL found "
                  f"under {report['logs_dir']} / {report['trace_dir']}")

    show(one_pass())
    while args.watch:
        time.sleep(args.watch)
        print()
        show(one_pass())
    return 0


def cmd_obs_goodput(args) -> int:
    """The goodput ledger report (ISSUE 5 tentpole): wall-clock
    decomposed into productive step / compile / data_wait / ckpt / idle
    / lost_work / restart_downtime buckets that SUM to wall time, per
    host and fleet-averaged, with incident attribution from the ft
    plane's events.jsonl — the answer to "what fraction of paid
    TPU-seconds trained the model, and who stole the rest"."""
    import json as _json
    import time as _time

    from tpucfn_torch.obs.aggregate import JsonlTailer
    from tpucfn_torch.obs.goodput import (LEDGER_GLOB, host_id_from_path,
                                          merge_goodput, render_goodput)

    # --run-dir only derives the defaults, so explicit --goodput-dir
    # (relocated/copied ledgers) stands on its own.
    if not args.run_dir and not args.goodput_dir:
        print("error: --run-dir or --goodput-dir required",
              file=sys.stderr)
        return 2
    run_dir = Path(args.run_dir).expanduser() if args.run_dir else None
    goodput_dir = (Path(args.goodput_dir) if args.goodput_dir
                   else run_dir / "goodput")
    ft_events = (Path(args.ft_events) if args.ft_events
                 else run_dir / "ft" / "events.jsonl" if run_dir
                 else None)

    # Same incremental-tail discipline as cmd_obs (ISSUE 5 satellite):
    # --watch appends only NEW complete lines per tick instead of
    # re-parsing O(run-length) ledger history; one-shot mode is simply
    # the first poll.
    tailer = JsonlTailer()
    by_host: dict[int, list[dict]] = {}
    ev_store: dict[str, list[dict]] = {}
    # Idle-tick cache, same discipline as cmd_obs: a tick that tailed
    # nothing new must not re-merge O(run-length) ledger history.
    cache: dict = {"report": None}

    def one_pass() -> dict:
        dirty = cache["report"] is None
        if goodput_dir.is_dir():
            dirty |= tailer.poll_into(
                sorted(goodput_dir.glob(LEDGER_GLOB)), by_host,
                key_fn=host_id_from_path)
        if ft_events is not None and ft_events.is_file():
            dirty |= tailer.poll_into([ft_events], ev_store,
                                      key_fn=lambda p: "ft")
        if dirty:
            cache["report"] = merge_goodput(
                by_host, ev_store.get("ft", ()),
                skipped_lines=tailer.skipped)
        return cache["report"]

    def show(report: dict) -> None:
        if args.json:
            print(_json.dumps(report))
        elif report["num_hosts"] == 0:
            print(f"no goodput ledgers under {goodput_dir} "
                  "(runs write them via examples/common.py; see README "
                  "Observability → Goodput)")
            # ft incidents can exist without any ledger (older worker,
            # misplaced goodput dir) — exactly the broken-run case the
            # operator is diagnosing; don't hide them.
            if report["incidents"]:
                print(f"{len(report['incidents'])} ft incident(s) in "
                      f"{ft_events} (downtime "
                      f"{report['incident_downtime_s']:.2f}s) — "
                      "run --json for detail")
            if report["skipped_lines"]:
                print(f"skipped {report['skipped_lines']} "
                      "undecodable line(s)")
        else:
            print(render_goodput(report))

    show(one_pass())
    if getattr(args, "ledger", None):
        # Cross-run regression ledger (ISSUE 6 satellite): one BENCH-
        # row-style line per invocation; `tpucfn obs diff` compares the
        # last two.  Refused under --watch — a watch starts while the
        # run is LIVE, so the row would freeze the opening seconds'
        # compile-dominated shares and poison every later diff; append
        # from a one-shot invocation after the run.  An EMPTY report is
        # never appended either: a mistyped --run-dir writing
        # {wall_s: 0} would make the next diff compare a real run
        # against nothing and mask a real regression.
        if args.watch:
            print("not appending to the goodput ledger under --watch "
                  "(the run is still in progress — append with a "
                  "one-shot `tpucfn obs goodput --ledger` after it "
                  "ends)", file=sys.stderr)
        elif cache["report"]["num_hosts"] == 0:
            print("not appending to the goodput ledger: no ledgers "
                  "found (wrong --run-dir?)", file=sys.stderr)
        else:
            from tpucfn_torch.obs.goodput import append_goodput_ledger

            path = append_goodput_ledger(
                args.ledger, cache["report"],
                run_dir=str(run_dir if run_dir else goodput_dir))
            print(f"appended goodput row to {path}", file=sys.stderr)
    while args.watch:
        _time.sleep(args.watch)
        print()
        show(one_pass())
    return 0


def cmd_obs_postmortem(args) -> int:
    """Assemble one incident's forensic bundle (ISSUE 6 tentpole): the
    enriched incident row, the skew-corrected timeline windowed around
    detection, the window's goodput buckets, every host's flight-
    recorder tail, and the last heartbeat per host — as a bundle
    directory + rendered report."""
    import json as _json

    from tpucfn_torch.obs.postmortem import (build_postmortem,
                                             render_postmortem, write_bundle)

    if not args.run_dir:
        print("error: --run-dir required", file=sys.stderr)
        return 2
    run_dir = Path(args.run_dir).expanduser()
    try:
        report = build_postmortem(
            run_dir, incident_id=args.incident, window_s=args.window,
            ft_dir=args.ft_dir)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    inc = report["incident"]["incident"]
    out = (Path(args.out) if args.out
           else run_dir / "postmortem" / f"incident-{inc:03d}")
    bundle = write_bundle(report, out)
    if args.json:
        print(_json.dumps({**report, "bundle": str(bundle)}))
    else:
        print(render_postmortem(report))
        print(f"\nbundle: {bundle}")
    return 0


def cmd_obs_profile(args) -> int:
    """Client for the on-demand profiler capture (ISSUE 6): POST
    /profile?seconds=S against a host's obs endpoint; prints the JSON
    body naming the artifact directory (an XProf/TensorBoard trace on
    that host)."""
    import urllib.error
    import urllib.request

    host = args.host
    if ":" not in host:
        if not args.port:
            print("error: --port required when --host has no :port",
                  file=sys.stderr)
            return 2
        host = f"{host}:{args.port}"
    url = f"http://{host}/profile?seconds={args.seconds:g}"
    req = urllib.request.Request(url, data=b"", method="POST")
    timeout = args.timeout or args.seconds + 120.0
    try:
        # The server blocks for the capture duration; pad the client
        # timeout generously — profiler session setup alone can take
        # tens of seconds on a busy host (a timed-out client does NOT
        # cancel the server-side capture; it completes and the artifact
        # still lands in the profile dir).
        with urllib.request.urlopen(req, timeout=timeout) as r:
            body = r.read().decode()
    except urllib.error.HTTPError as e:
        detail = e.read().decode(errors="replace").strip()
        print(f"error: {url} -> {e.code}: {detail}", file=sys.stderr)
        return 1
    except (urllib.error.URLError, OSError) as e:
        print(f"error: {url} unreachable: {e}", file=sys.stderr)
        return 1
    print(body.strip())
    return 0


def cmd_obs_diff(args) -> int:
    """Compare the last two rows of the cross-run goodput ledger
    (ISSUE 6 satellite): goodput_ratio and per-bucket share deltas —
    the regression check MFU alone cannot do."""
    import json as _json

    from tpucfn_torch.obs.aggregate import render_table
    from tpucfn_torch.obs.goodput import diff_goodput_rows, read_goodput_ledger

    rows, skipped = read_goodput_ledger(args.ledger)
    if len(rows) < 2:
        print(f"error: need at least 2 goodput_run rows in {args.ledger} "
              f"(have {len(rows)}; append with `tpucfn obs goodput "
              "--run-dir R --ledger`)", file=sys.stderr)
        return 1
    diff = diff_goodput_rows(rows[-2], rows[-1])
    if args.json:
        print(_json.dumps({**diff, "skipped_lines": skipped}))
        return 0
    print(f"# goodput diff  {args.ledger}  (last two of {len(rows)} rows)")
    print(f"prev: {diff['prev']['run_dir']}  "
          f"ratio={diff['prev']['goodput_ratio']}")
    print(f"last: {diff['last']['run_dir']}  "
          f"ratio={diff['last']['goodput_ratio']}")
    d = diff["goodput_ratio_delta"]
    print("goodput_ratio delta: "
          + (f"{d:+.4f}" if d is not None else "n/a"))
    print()
    print(render_table(diff["buckets"],
                       ["bucket", "prev_share", "last_share", "delta"]))
    return 0


def _trace_merge(args):
    """Shared load for the trace subcommands: merge the run's per-host
    span files onto the fleet clock, preferring the coordinator's
    measured /clock probes when the run has them."""
    from tpucfn_torch.obs.timeline import merge_timeline

    run_dir = Path(args.run_dir).expanduser()
    trace_dir = Path(args.trace_dir) if args.trace_dir \
        else run_dir / "trace"
    if not trace_dir.is_dir():
        print(f"error: no trace dir at {trace_dir} (run with tracing "
              "enabled, or pass --trace-dir)", file=sys.stderr)
        return None, None
    offsets = Path(args.offsets) if args.offsets \
        else run_dir / "ft" / "clock-offsets.jsonl"
    merged = merge_timeline(
        trace_dir, offsets_path=offsets if offsets.is_file() else None)
    if not merged["events"]:
        print(f"error: no span events under {trace_dir}", file=sys.stderr)
        return None, None
    return merged, run_dir


def cmd_trace_export(args) -> int:
    """Merge a run's per-host span files into one clock-aligned
    Chrome/Perfetto trace (ISSUE 20 tentpole): process lanes per
    (host, role), flow arrows on every resolved cross-host link —
    load the output in https://ui.perfetto.dev or chrome://tracing."""
    import json as _json

    from tpucfn_torch.obs.timeline import write_chrome_trace

    merged, run_dir = _trace_merge(args)
    if merged is None:
        return 1
    out = Path(args.out) if args.out else run_dir / "trace" / "timeline.json"
    write_chrome_trace(merged, out)
    stats = merged["link_stats"]
    summary = {
        "out": str(out), "events": len(merged["events"]),
        "links_resolved": stats["resolved"],
        "link_carriers": stats["carriers"],
        "by_name": stats["by_name"],
        "hosts_probed": sorted(merged["offsets"]),
    }
    if args.json:
        print(_json.dumps(summary))
    else:
        print(f"wrote {out}: {summary['events']} events, "
              f"{stats['resolved']}/{stats['carriers']} cross-host links "
              f"resolved ({len(merged['offsets'])} host(s) on measured "
              "clock offsets)")
    return 0


def cmd_trace_critpath(args) -> int:
    """Per-step critical-path attribution (ISSUE 20 tentpole): walk
    each trainer step's merged span tree, attribute wall time to planes
    (compute / remote-serve / input-local / artifact-fetch / ckpt /
    coordinator), print per-step "bounded by" verdicts — and cross-check
    the aggregate shares against the goodput ledger when the run has
    one."""
    import json as _json

    from tpucfn_torch.obs.timeline import (critical_path, crosscheck_goodput,
                                           render_critpath)

    merged, run_dir = _trace_merge(args)
    if merged is None:
        return 1
    cp = critical_path(merged)
    if not cp["steps"]:
        print("error: no trainer step spans in the merged timeline — "
              "nothing to attribute", file=sys.stderr)
        return 1
    crosscheck = None
    gp_dir = Path(args.goodput) if args.goodput else run_dir / "goodput"
    if gp_dir.is_dir():
        from tpucfn_torch.obs.goodput import goodput_report

        ev = run_dir / "ft" / "events.jsonl"
        report = goodput_report(gp_dir, ev if ev.is_file() else None)
        if report.get("num_hosts"):
            crosscheck = crosscheck_goodput(cp, report)
    if args.json:
        print(_json.dumps({**cp, "crosscheck": crosscheck}))
    else:
        print(render_critpath(cp, crosscheck), end="")
    return 0


def cmd_trace_advise(args) -> int:
    """Per-plane deadline autotune ADVISORY (ISSUE 20 satellite):
    observed frame-time percentiles from the merged span timeline →
    suggested deadline values, report-only — the operator changes the
    flag, nothing auto-applies."""
    import json as _json

    from tpucfn_torch.net.autotune import render_advice, suggest_deadlines

    merged, _run_dir = _trace_merge(args)
    if merged is None:
        return 1
    rows = suggest_deadlines(merged["events"], headroom=args.headroom,
                             min_samples=args.min_samples)
    if args.json:
        print(_json.dumps(rows))
    else:
        print(render_advice(rows), end="")
    return 0


def cmd_forensics_diff(args) -> int:
    """Diff two postmortem bundles of the same incident class
    (ISSUE 20 satellite): same-window goodput bucket shares, per-host
    heartbeat-age and span-count deltas — what did the second incident
    do differently?"""
    import json as _json

    from tpucfn_torch.obs.postmortem import diff_bundles, render_bundle_diff

    for d in (args.bundle_a, args.bundle_b):
        if not (Path(d) / "incident.json").is_file():
            print(f"error: {d} is not a postmortem bundle (no "
                  "incident.json — make one with `tpucfn obs "
                  "postmortem`)", file=sys.stderr)
            return 2
    diff = diff_bundles(args.bundle_a, args.bundle_b)
    if args.json:
        print(_json.dumps(diff))
    else:
        print(render_bundle_diff(diff))
    return 0


def cmd_ft_status(args) -> int:
    """Render the fault-tolerance plane's fleet view: per-host heartbeat
    verdicts (LIVE/STRAGGLER/SUSPECT/DEAD), the supervisor's ft_*
    metrics (restarts, failures detected, MTTR), and the recent
    detect→decide→act→recovered event tail — the read side of
    ``tpucfn launch --ft`` (ISSUE 4)."""
    import json as _json

    from tpucfn_torch.ft import HeartbeatMonitor, MonitorConfig
    from tpucfn_torch.obs.aggregate import render_table

    if not args.dir and not args.name:
        print("error: ft status needs --name (cluster) or --dir "
              "(heartbeat dir)", file=sys.stderr)
        return 2
    ft_dir = Path(args.dir) if args.dir else _run_dir(args, args.name) / "ft"
    if not ft_dir.is_dir():
        print(f"error: no ft dir at {ft_dir} (launch with --ft first, "
              "or pass --dir)", file=sys.stderr)
        return 1

    sup: dict = {}
    sup_path = ft_dir / "supervisor.json"
    if sup_path.is_file():
        try:
            sup = _json.loads(sup_path.read_text())
        except (OSError, _json.JSONDecodeError):
            sup = {}
    interval = args.heartbeat_interval
    if interval is None:
        interval = sup.get("heartbeat_interval_s") or 1.0
    monitor = HeartbeatMonitor(
        ft_dir, expected_hosts=sup.get("gang_hosts"),
        config=MonitorConfig(interval_s=float(interval)))
    view = monitor.observe()
    healthy, health_detail = view.healthy()

    events: list[dict] = []
    ev_path = ft_dir / "events.jsonl"
    if ev_path.is_file():
        for line in ev_path.read_text().splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                events.append(_json.loads(line))
            except _json.JSONDecodeError:
                continue  # torn tail while the supervisor appends

    rows = [{"host": v.host_id, "state": v.state.value,
             "age_s": v.age_s, "step": v.step, "pid": v.pid,
             "reason": v.reason} for v in view.hosts]
    report = {
        "ft_dir": str(ft_dir),
        "healthy": healthy,
        "fleet": health_detail["fleet"],
        "max_step": health_detail["max_step"],
        "hosts": rows,
        "policy": sup.get("policy"),
        "budget": sup.get("budget"),
        "metrics": sup.get("metrics", {}),
        "events": events[-args.events:] if args.events else events,
    }
    if args.json:
        print(_json.dumps(report))
        return 0
    print(f"# ft fleet view  {ft_dir}  "
          f"{'HEALTHY' if healthy else 'UNHEALTHY'}")
    if rows:
        print(render_table(rows, ["host", "state", "age_s", "step", "pid",
                                  "reason"], float_fmt="{:.2f}"))
    else:
        print("no heartbeats yet")
    m = report["metrics"]
    if m:
        mttr = m.get("ft_mttr_seconds") or {}
        print(f"\nrestarts={m.get('ft_restarts_total', 0)} "
              f"(gang={m.get('ft_gang_restarts_total', 0)} "
              f"solo={m.get('ft_solo_restarts_total', 0)}) "
              f"failures_detected={m.get('ft_failures_detected_total', 0)} "
              f"mttr_p50={(mttr.get('p50') if isinstance(mttr, dict) else None)}")
        # The graceful-degradation surface (ISSUE 7): only when any of
        # the four paths actually fired — a quiet fleet stays terse.
        degrade = {"planned_drains": m.get("ft_preempt_drains_total", 0),
                   "shrinks": m.get("ft_shrinks_total", 0),
                   "ckpt_retries": m.get("ft_ckpt_retries_total", 0),
                   "evictions": m.get("ft_straggler_evictions_total", 0)}
        if any(degrade.values()):
            pm = m.get("ft_planned_mttr_seconds") or {}
            planned_p50 = (pm.get("p50")
                           if isinstance(pm, dict) else None)
            print("degradation: "
                  + " ".join(f"{k}={v}" for k, v in degrade.items())
                  + (f" planned_mttr_p50={planned_p50}"
                     if degrade["planned_drains"] else ""))
        if report["budget"]:
            b = report["budget"]
            print(f"policy={report['policy']} budget "
                  f"{b.get('used', 0)}/{b.get('max_restarts', 0)} used")
    if report["events"]:
        print("\n== recent events ==")
        for e in report["events"]:
            extra = {k: v for k, v in e.items() if k not in ("ts", "kind")}
            # Lead with the story, not the raw dict, for the new kinds:
            # a drained preemption / shrink / ckpt retry must be
            # recognizable at a glance, not read as a generic restart.
            kind = e.get("kind", "?")
            tag = ""
            if kind == "recovered" and e.get("planned"):
                tag = " [planned]"
            elif kind == "shrink":
                tag = (f" [{e.get('from_hosts')}->{e.get('to_hosts')} "
                       f"gen {e.get('generation')}]")
            elif kind == "ckpt_retry":
                tag = (f" [bad step {e.get('bad_step')} -> retry from "
                       f"{e.get('retry_from')}]")
            print(f"  {e.get('ts', 0):.3f} {kind:12s}{tag} {extra}")
    return 0


def _refuse(what: str) -> int:
    print(f"error: {what}", file=sys.stderr)
    return 2


def _control_plane(args):
    state = Path(args.state_dir).expanduser() / "control_plane.json"
    # steps_to_provision=1: CLI ticks are driven by wait_active polling.
    return FakeControlPlane(steps_to_provision=1, state_file=str(state))


def _run_dir(args, name: str) -> Path:
    return Path(args.state_dir).expanduser() / "clusters" / name


def cmd_create_stack(args) -> int:
    if args.spec:
        spec = ClusterSpec.load(args.spec)
    else:
        if not args.name:
            return _refuse("--name (or --spec file) required")
        spec = ClusterSpec(
            name=args.name,
            accelerator=args.accelerator,
            storage_path=args.storage or "",
        )
    prov = Provisioner(_control_plane(args))
    rec = prov.create(spec)
    contract = converge(rec, _run_dir(args, spec.name))
    print(f"CREATE_COMPLETE {spec.name}")
    print(f"  accelerator:  {spec.accelerator} ({spec.num_hosts} hosts, "
          f"{spec.num_chips} chips)")
    print(f"  coordinator:  {contract.coordinator}")
    print(f"  hostfile:     {contract.workers_path}")
    print(f"  env file:     {_run_dir(args, spec.name) / 'env.sh'}")
    print(f"  next:         python -m tpucfn_torch.cli launch --name "
          f"{spec.name} -- python train.py")
    return 0


def cmd_status(args) -> int:
    rec = _control_plane(args).describe(args.name)
    print(f"{args.name}: {rec.state.value} gen={rec.generation}")
    for h in rec.hosts:
        print(f"  host{h.host_id} {h.address} {'healthy' if h.healthy else 'DEAD'}")
    return 0


def cmd_delete(args) -> int:
    Provisioner(_control_plane(args)).delete(args.name)
    print(f"DELETE_COMPLETE {args.name}")
    return 0


def cmd_resize(args) -> int:
    prov = Provisioner(_control_plane(args))
    rec = prov.resize(args.name, args.accelerator)
    converge(rec, _run_dir(args, args.name))
    print(f"RESIZE_COMPLETE {args.name} -> {args.accelerator} "
          f"({len(rec.hosts)} hosts, gen={rec.generation})")
    print("  running jobs must be re-launched; they resume from their "
          "latest checkpoint")
    return 0


def cmd_env(args) -> int:
    rec = _control_plane(args).describe(args.name)
    contract = converge(rec, _run_dir(args, args.name))
    for k, v in sorted(contract.to_env().items()):
        print(f"export {k}={v!r}")
    return 0


def cmd_kill_host(args) -> int:
    """Fault injection: mark a host dead so monitors and tests can
    exercise the recovery path."""
    _control_plane(args).kill_host(args.name, args.host)
    print(f"host {args.host} of {args.name} marked dead")
    return 0


def cmd_heal(args) -> int:
    prov = Provisioner(_control_plane(args))
    rec = prov.ensure_healthy(args.name)
    converge(rec, _run_dir(args, args.name))
    print(f"{args.name}: {rec.state.value} gen={rec.generation} "
          f"({len(rec.hosts)} healthy hosts)")
    return 0


def cmd_launch(args) -> int:
    """``tpucfn launch`` (``tpucfn/cli/main.py:cmd_launch``): the command
    fanned out over the cluster's hosts, with its planes: the gang
    coordinator (``--ft``), self-supervision (``--supervise``), input
    hosts (``--input-hosts``), the kernel-library cache's artifact
    server (``--compile-cache``), chaos proxies (``--chaos-proxy``) and
    the goodput-driven provisioner policy loop (``--provision-policy``),
    which grows or shrinks the input plane through the coordinator."""
    rec = _control_plane(args).describe(args.name)
    from tpucfn_torch.provision.control_plane import ClusterState

    if rec.state is not ClusterState.ACTIVE:
        print(f"error: cluster {args.name} is {rec.state.value}, not ACTIVE",
              file=sys.stderr)
        return 1
    contract = converge(rec, _run_dir(args, args.name))
    transport = SSHTransport() if args.transport == "ssh" else LocalTransport()
    ft_dir = _run_dir(args, args.name) / "ft" if args.ft else None
    if args.supervise:
        # Self-supervision: re-exec this same invocation (minus the
        # supervise flags) under the supervise loop.  A crashed
        # coordinator is relaunched and adopts the running fleet through
        # the write-ahead journal; a finished run's rc propagates.
        if not args.ft:
            return _refuse("--supervise needs --ft (the write-ahead journal "
                           "and fleet adoption live under the ft dir)")
        from tpucfn_torch.launch.supervise import (run_supervised,
                                                   supervised_cli_argv)

        child = supervised_cli_argv(args.argv)
        print(f"supervising coordinator (up to {args.supervise_restarts} "
              f"restart(s); journal under {ft_dir}/journal)",
              file=sys.stderr)
        rc = run_supervised(child, ft_dir=ft_dir,
                            max_restarts=args.supervise_restarts)
        print(f"launch finished rc={rc}")
        return rc
    if args.input_hosts and args.input_hosts >= contract.workers_count:
        return _refuse(f"--input-hosts {args.input_hosts} leaves no trainer "
                       f"in a {contract.workers_count}-host cluster")
    if args.input_hosts and not args.input_cmd:
        # A job that does not switch on TPUCFN_ROLE would run a second
        # trainer on the input host: refuse rather than no-op.
        return _refuse("--input-hosts needs --input-cmd (e.g. --input-cmd "
                       "'python -m tpucfn_torch.cli data serve --shards D "
                       "--batch-size B'): input hosts must run the input "
                       "service, not a copy of the trainer argv")
    input_argv = None
    if args.input_cmd:
        import shlex

        input_argv = shlex.split(args.input_cmd)
    # The provisioner policy observes the goodput ledgers and actuates
    # through the coordinator, on the input plane: both must exist.
    if args.provision_policy and not args.ft:
        return _refuse("--provision-policy needs --ft (the controller "
                       "actuates through the gang coordinator's "
                       "planned-restart machinery)")
    if args.provision_policy and not args.input_hosts:
        return _refuse("--provision-policy needs --input-hosts N (growing "
                       "the input plane is the one actuator it owns; with "
                       "no input hosts there is nothing to provision)")
    if args.defer_input_plane and not args.input_hosts:
        return _refuse("--defer-input-plane needs --input-hosts N (it "
                       "reserves those hosts for the provisioner instead "
                       "of spawning them at launch)")
    # All usage validation before any server binds: an early return
    # below must not leak a bound artifact-server port.
    argv = list(args.cmd)
    if argv and argv[0] == "--":
        argv = argv[1:]
    if not argv:
        return _refuse("no command given (use: python -m tpucfn_torch.cli "
                       "launch --name X -- cmd...)")
    inject = None
    if args.kill_host_after:
        host_s, _, secs = args.kill_host_after.partition(":")
        try:
            inject = (int(host_s), float(secs))
        except ValueError:
            return _refuse(f"--kill-host-after wants HOST:SECONDS (e.g. "
                           f"1:30), got {args.kill_host_after!r}")
        if not 0 <= inject[0] < len(contract.hosts()):
            return _refuse(f"--kill-host-after host {inject[0]} out of range "
                           f"(cluster has {len(contract.hosts())} hosts)")
    # A launch-level chaos spec replays against the gang coordinator's
    # supervision clock: kills, hangs, heartbeat delays, preemption
    # notices, host loss, checkpoint corruption, a coordinator kill, and
    # the net_* faults, which land on this process's --chaos-proxy
    # instances.  Parsing is validation and precedes every bind.
    chaos_spec = None
    if args.chaos:
        if not args.ft:
            return _refuse("--chaos needs --ft (chaos specs replay against "
                           "the gang coordinator's supervision clock)")
        from tpucfn_torch.ft.chaos import ChaosSpec

        raw = args.chaos
        try:
            if not raw.lstrip().startswith("{"):
                raw = Path(raw).read_text()
            chaos_spec = ChaosSpec.from_json(raw)
        except (OSError, ValueError, TypeError) as e:
            return _refuse(f"bad --chaos spec: {e}")
    proxy_specs: list[tuple[int, str]] = []
    for raw in args.chaos_proxy or []:
        parts = raw.split(":")
        if len(parts) != 3 or not parts[0].isdigit() \
                or not parts[2].isdigit():
            return _refuse("--chaos-proxy wants LISTEN:HOST:PORT (e.g. "
                           f"7651:127.0.0.1:7641), got {raw!r}")
        proxy_specs.append((int(parts[0]), f"{parts[1]}:{parts[2]}"))
    if chaos_spec is not None and not proxy_specs \
            and any(e.action.startswith("net_") for e in chaos_spec.events):
        return _refuse("--chaos spec schedules net_* events: they need at "
                       "least one --chaos-proxy LISTEN:HOST:PORT to land on")
    registry = None
    if args.obs_port or args.compile_cache:
        # one supervisor registry for everything this process hosts: the
        # artifact server's compilecache_* counters land on the /metrics
        # the obs endpoint serves
        from tpucfn_torch.obs.registry import MetricRegistry

        registry = MetricRegistry(labels={"role": "supervisor"})
    # Fleet warm start: this process runs the artifact server and fans
    # its address out (TPUCFN_COMPILE_CACHE_ADDRS): one host builds each
    # kernel library, the rest fetch it, and every relaunch re-derives
    # the same env.  The server never touches the card.
    cc_server = None
    cc_addrs = None
    if args.compile_cache:
        from tpucfn_torch.compilecache.service import (
            DEFAULT_COMPILE_CACHE_PORT, ArtifactServer)

        cc_dir = args.compile_cache_dir or str(
            _run_dir(args, args.name) / "compilecache")
        cc_server = ArtifactServer(
            cc_dir, host="0.0.0.0",
            port=args.compile_cache_port or DEFAULT_COMPILE_CACHE_PORT,
            registry=registry)
        cc_server.start()
        # The server runs in THIS process: advertise an address of this
        # machine as the fleet sees it (the coordinator host by default).
        advertise = (args.compile_cache_advertise
                     or ("127.0.0.1" if args.transport == "local"
                         else contract.coordinator.rsplit(":", 1)[0]))
        cc_addrs = [f"{advertise}:{cc_server.port}"]
        print(f"compile-artifact server: {cc_addrs[0]} (store {cc_dir})",
              file=sys.stderr)
    net_proxies = []
    if proxy_specs:
        from tpucfn_torch.net.proxy import ChaosProxy

        try:
            for listen, upstream in proxy_specs:
                proxy = ChaosProxy(upstream, host="0.0.0.0", port=listen,
                                   registry=registry)
                proxy.start()
                net_proxies.append(proxy)
                print(f"chaos proxy: :{proxy.port} -> {upstream}",
                      file=sys.stderr)
        except BaseException:
            for proxy in net_proxies:
                proxy.close()
            if cc_server is not None:
                cc_server.close()
            raise
    launcher = Launcher(contract, transport,
                        obs_base_port=args.obs_port or None,
                        ft_dir=str(ft_dir) if ft_dir else None,
                        ft_heartbeat_s=(args.ft_heartbeat_interval
                                        if args.ft else None),
                        input_hosts=args.input_hosts,
                        input_port=args.input_port or None,
                        input_argv=input_argv,
                        # a local fleet runs every host on loopback while
                        # the fake control plane's hostfile names 10.0.0.x
                        input_advertise_host=("127.0.0.1"
                                              if args.transport != "ssh"
                                              else None),
                        compile_cache_addrs=cc_addrs,
                        defer_input_plane=args.defer_input_plane)
    from tpucfn_torch.launch import run_with_restarts

    obs_srv = None
    monitor = None
    # The launched gang is hosts()[:workers_count] (Launcher.launch's
    # precedence rule): what the monitor judges and whose ports serve.
    n_launched = len(contract.hosts()[:contract.workers_count])
    # /healthz late-binds to the coordinator once it exists so the probe
    # carries journal/adoption state on top of the monitor's fleet view;
    # before that (and without --ft) it falls back to the monitor or
    # plain liveness.
    coord_ref: dict = {}

    def _health_fn():
        c = coord_ref.get("coord")
        if c is not None:
            return c.health()
        if monitor is not None:
            return monitor.health()
        return True, {}

    try:
        # Anything that can raise between the servers binding and the
        # main try/finally (monitor dirs, the obs port) must not leak
        # them.
        if args.ft:
            # Heartbeat monitor over the dir every rank writes into.
            # Startup grace must cover a rank's boot (torch import,
            # loading the kernel libraries, init or restore, step 1): a
            # booting gang that has not beaten yet is not hung.  Crash
            # detection (process exit) is unaffected by it.
            from tpucfn_torch.ft import HeartbeatMonitor, MonitorConfig

            monitor = HeartbeatMonitor(
                ft_dir, expected_hosts=n_launched,
                config=MonitorConfig(
                    interval_s=args.ft_heartbeat_interval,
                    startup_grace_s=args.ft_startup_grace))
        if args.obs_port:
            # The supervisor owns the base port, the ranks get
            # base + 1 + host_id (Launcher.host_env).
            from tpucfn_torch.obs.server import start_obs_server

            obs_srv = start_obs_server(
                registry, port=args.obs_port, role="supervisor",
                health_fn=_health_fn if args.ft else None)
            print(f"supervisor obs endpoint: {obs_srv.url()} "
                  f"(hosts at ports {args.obs_port + 1}..."
                  f"{args.obs_port + n_launched})", file=sys.stderr)
    except BaseException:
        for proxy in net_proxies:
            proxy.close()
        if cc_server is not None:
            cc_server.close()
        raise
    try:
        if args.ft:
            import random
            import time as _time

            from tpucfn_torch.ft import (GangCoordinator, RestartBudget,
                                         StragglerGuard, policy_from_name)

            budget = RestartBudget(
                args.ft_restart_budget if args.ft_restart_budget is not None
                else args.restarts,
                backoff_s=args.ft_backoff, rng=random.Random(args.ft_seed))
            # Elastic shrink: before relaunching a failed host, ask the
            # control plane whether it still owns a healthy machine at
            # that address (kill-host makes the next recovery re-converge
            # at N-1 instead of relaunching a ghost).
            cp = _control_plane(args)
            _reacquire_cache: dict = {"t": -10.0, "healthy": frozenset()}

            def _reacquire(addr: str, _name=args.name, _cp=cp) -> bool:
                # one describe() snapshot per incident burst (1 s TTL)
                now = _time.monotonic()
                if now - _reacquire_cache["t"] > 1.0:
                    _reacquire_cache["healthy"] = frozenset(
                        h.address for h in _cp.describe(_name).hosts
                        if h.healthy)
                    _reacquire_cache["t"] = now
                return addr in _reacquire_cache["healthy"]

            provision_policy = None
            goodput_dir = None
            if args.provision_policy:
                from tpucfn_torch.provision import (PolicyConfig,
                                                    provision_policy_from_name)

                # The dir the ranks' GoodputLedger writes into when the
                # job's --run-dir is the cluster's run dir
                # (examples/common.py: <run dir>/goodput): the policy
                # reads what the fleet reports.
                goodput_dir = (Path(args.provision_goodput_dir)
                               if args.provision_goodput_dir
                               else _run_dir(args, args.name) / "goodput")
                provision_policy = provision_policy_from_name(
                    args.provision_policy,
                    PolicyConfig(
                        grow_threshold=args.provision_grow_threshold,
                        shrink_threshold=args.provision_shrink_threshold,
                        cooldown_s=args.provision_cooldown,
                        max_input_hosts=args.input_hosts))

            coordinator = GangCoordinator(
                launcher, argv,
                policy=policy_from_name(args.ft_policy, budget),
                monitor=monitor, ft_dir=ft_dir, registry=registry,
                kill_host_after=inject,
                ckpt_dir=_run_dir(args, args.name) / "ckpt",
                drain_grace_s=args.ft_drain_grace,
                drain_step_margin=args.ft_drain_step_margin,
                allow_shrink=not args.ft_no_shrink,
                reacquire_check=_reacquire,
                max_ckpt_retries=args.ft_max_ckpt_retries,
                straggler_guard=StragglerGuard(
                    hysteresis_s=args.ft_straggler_hysteresis,
                    flap_budget=args.ft_straggler_flap_budget),
                restart_input_hosts=args.ft_restart_input_hosts,
                adopt=(True if args.adopt
                       else False if args.no_adopt else "auto"),
                chaos=chaos_spec,
                net_proxies=net_proxies,
                provision_policy=provision_policy,
                goodput_dir=goodput_dir,
                provision_interval_s=args.provision_interval)
            coord_ref["coord"] = coordinator
            rc = coordinator.run()
        else:
            rc = run_with_restarts(launcher, argv, max_restarts=args.restarts,
                                   kill_host_after=inject, registry=registry)
    finally:
        if obs_srv is not None:
            obs_srv.close()
        for proxy in net_proxies:
            proxy.close()
        if cc_server is not None:
            cc_server.close()
    print(f"launch finished rc={rc}")
    return rc


def cmd_rl_train(args) -> int:
    """Run one host's RL loop (``tpucfn_torch.rl``): actors and an
    A2C learner on one card, trajectories through the replay queue on the
    device, param refresh as a copy on the device.  Under ``launch`` every
    rank gets heartbeats (``TPUCFN_FT_DIR``), goodput ledgers with the
    ``act``/``learn``/``refresh`` buckets and resume from the latest
    whole-stack checkpoint.  It runs on the card unless ``--device cpu``
    is given."""
    from tpucfn_torch.device import resolve_device
    from tpucfn_torch.examples.common import exit_process
    from tpucfn_torch.launch import initialize_runtime
    from tpucfn_torch.rl.loop import RLConfig, run_rl_loop

    initialize_runtime(device=resolve_device(args.device))
    cfg = RLConfig(
        run_dir=args.run_dir, env=args.env, num_envs=args.num_envs,
        unroll=args.unroll, iters=args.iters, hidden=args.hidden,
        lr=args.lr, gamma=args.gamma, entropy_coef=args.entropy_coef,
        seed=args.seed, ckpt_every=args.ckpt_every,
        log_every=args.log_every, queue_capacity=args.queue_capacity,
        stop_after=args.stop_after, fresh=args.fresh,
        iter_sleep_s=args.iter_sleep_s, device=args.device)
    run_rl_loop(cfg)
    if os.environ.get("TPUCFN_FT_DIR", "").strip():
        # under the gang coordinator: leave right after the last beat
        exit_process(0)
    return 0


def cmd_chaos_proxy(args) -> int:
    """Run the network fault-injection proxy standalone (ISSUE 15):
    ``tpucfn chaos proxy --listen P --upstream H:P --spec faults.json``
    fronts any fleet plane's port and injects the scheduled gray
    failures (latency/throttle/stall/partition/tear/rst) at their
    seeded, deterministic times.  SIGTERM (or ``--serve-for``) ends it
    with a stats JSON line — the same operational shape as ``tpucfn
    data serve`` and ``compilecache serve``."""
    import json as _json
    import signal as _signal
    import time as _time

    from tpucfn_torch.net.proxy import ChaosProxy, NetFaultSchedule

    host, _, port = args.upstream.rpartition(":")
    if not port.isdigit():
        print(f"error: --upstream wants HOST:PORT, got {args.upstream!r}",
              file=sys.stderr)
        return 2
    schedule = None
    if args.spec:
        raw = args.spec
        try:
            if not raw.lstrip().startswith("{"):
                raw = Path(raw).read_text()
            schedule = NetFaultSchedule.from_json(raw)
            if args.seed is not None:
                schedule = NetFaultSchedule(faults=schedule.faults,
                                            seed=args.seed)
        except (OSError, ValueError, TypeError) as e:
            print(f"error: bad --spec: {e}", file=sys.stderr)
            return 2
    from tpucfn_torch.obs.registry import MetricRegistry

    registry = MetricRegistry(labels={"role": "chaosproxy"})
    proxy = ChaosProxy(args.upstream, host=args.host, port=args.listen,
                       schedule=schedule, registry=registry)
    stop = [False]

    def _on_term(signum, frame):
        # ONE plain GIL-atomic store (the PR 8 signal lesson); the main
        # loop notices and closes.
        stop[0] = True

    try:
        _signal.signal(_signal.SIGTERM, _on_term)
    except ValueError:
        pass  # not the main thread (embedded use)
    t0 = _time.monotonic()
    try:
        proxy.start()
        print(f"chaos proxy listening on {proxy.address} -> "
              f"{args.upstream}"
              + (f" ({len(schedule.faults)} scheduled fault(s), "
                 f"seed {schedule.seed})" if schedule else ""),
              file=sys.stderr)
        deadline = (t0 + args.serve_for) if args.serve_for > 0 else None
        while not stop[0]:
            if deadline is not None and _time.monotonic() >= deadline:
                break
            _time.sleep(0.2)
    finally:
        proxy.close()
    m = registry.varz()["metrics"]
    print(_json.dumps({
        "served_s": round(_time.monotonic() - t0, 3),
        "connections": m.get("net_proxy_connections_total", 0),
        "faults_fired": m.get("net_proxy_faults_fired_total", 0),
        "forwarded_bytes": m.get("net_proxy_forwarded_bytes_total", 0),
        "dropped_bytes": m.get("net_proxy_dropped_bytes_total", 0),
        "fired": proxy.fired,
    }))
    return 0


def cmd_convert_dataset(args) -> int:
    """Pack a real dataset into tpurecord shards (≈ MXNet's im2rec step
    the reference assumed had already happened off-cluster)."""
    from tpucfn_torch.data.convert import (
        convert_cifar_binary,
        convert_image_tree,
        convert_token_jsonl,
    )

    if args.kind == "image-tree":
        paths = convert_image_tree(args.src, args.out, num_shards=args.num_shards)
    elif args.kind == "recordio":
        from tpucfn_torch.data.recordio import convert_recordio

        paths = convert_recordio(args.src, args.out,
                                 num_shards=args.num_shards)
    elif args.kind == "token-jsonl":
        paths = convert_token_jsonl(args.src, args.out,
                                    seq_len=args.seq_len,
                                    num_shards=args.num_shards)
    else:
        paths = convert_cifar_binary(args.src, args.out,
                                     num_shards=args.num_shards,
                                     train=not args.test_split)
    print(f"wrote {len(paths)} shards to {args.out}")
    if args.publish:
        from tpucfn_torch.data.store import store_for_url
        from tpucfn_torch.data.convert import upload_shards

        store, prefix = store_for_url(args.publish)
        sidecars = [p for p in Path(args.out).glob("*.json")]
        upload_shards([*paths, *sidecars], store, prefix)
        print(f"published {len(paths) + len(sidecars)} objects to {args.publish}")
    return 0


def cmd_stage_data(args) -> int:
    """Sync a dataset prefix down to a local cache (≈ `aws s3 sync`)."""
    from tpucfn_torch.data.store import stage_url

    paths = stage_url(args.url, args.dest)
    print(f"staged {len(paths)} shards into {args.dest}")
    return 0


def cmd_data_serve(args) -> int:
    """Run the disaggregated input plane's service on this host
    (ISSUE 11 tentpole): per connected trainer, the exact
    ShardedDataset/MultiProcessLoader stage the trainer would run
    locally, streamed as ready batches.  jax is never imported — input
    hosts are pure CPU/RAM capacity.

    Under the ``tpucfn launch --input-hosts N`` fan-out everything
    defaults from the env contract (bind port from TPUCFN_INPUT_PORT,
    trainer count from TPUCFN_WORKERS_COUNT, heartbeats into
    TPUCFN_FT_DIR, /metrics on TPUCFN_OBS_PORT); standalone use passes
    the flags explicitly."""
    import json as _json
    import signal as _signal
    import time as _time

    from tpucfn_torch.data.service import INPUT_PORT_ENV, InputService

    shards = sorted(Path(args.shards).glob("*.tpurec"))
    if not shards:
        print(f"error: no *.tpurec shards under {args.shards}",
              file=sys.stderr)
        return 2
    num_trainers = args.num_trainers
    if num_trainers is None:
        raw = os.environ.get("TPUCFN_WORKERS_COUNT", "").strip()
        if not raw:
            print("error: --num-trainers required outside a `tpucfn "
                  "launch --input-hosts` fan-out (TPUCFN_WORKERS_COUNT "
                  "unset)", file=sys.stderr)
            return 2
        num_trainers = int(raw)
    port = args.port
    if port is None:
        port = int(os.environ.get(INPUT_PORT_ENV, "0") or 0)

    from tpucfn_torch.obs.registry import MetricRegistry
    from tpucfn_torch.obs.server import start_obs_server
    from tpucfn_torch.obs.trace import Tracer

    host_id = int(os.environ.get("TPUCFN_HOST_ID", "0") or 0)
    registry = MetricRegistry(labels={"role": "input",
                                      "host": str(host_id)})
    hb = obs_srv = None
    # Fleet timeline (ISSUE 20): with a trace dir (flag, or the
    # launcher's TPUCFN_TRACE_DIR fan-out) every served batch lands an
    # input_serve span whose (trace_id, span_id, origin) context rides
    # the batch frame's header — the remote parent of the trainer's
    # data_wait.  Unset ⇒ Tracer(None), zero wire or file cost.
    trace_dir = (args.trace_dir
                 or os.environ.get("TPUCFN_TRACE_DIR", "").strip() or None)
    tracer = Tracer(trace_dir, host_id=host_id, role="input")
    service = InputService(
        shards, num_trainers=num_trainers,
        batch_size_per_process=args.batch_size, seed=args.seed,
        num_epochs=args.num_epochs, host=args.host, port=port,
        queue_batches=args.queue_batches, mp_workers=args.mp_workers,
        sndbuf_bytes=args.sndbuf_kb * 1024 if args.sndbuf_kb else None,
        send_deadline_s=args.send_deadline,
        registry=registry, shuffle=not args.no_shuffle,
        cache_in_memory=not args.stream,
        num_workers=args.workers, tracer=tracer)
    try:
        service.start()
        print(f"input service listening on {service.address} "
              f"({len(shards)} shards, {num_trainers} trainer stream(s))",
              file=sys.stderr)
        obs_srv = start_obs_server(registry, port=args.obs_port,
                                   role="input", host_id=host_id,
                                   tracer=tracer)
        if obs_srv is not None:
            print(f"obs endpoint: {obs_srv.url()}", file=sys.stderr)
        # Under the ft fan-out an input host is a first-class fleet
        # member: it beats like any rank, and its death is routed as
        # input_degraded (trainers fall back to local loading) instead
        # of a gang incident.
        ft_dir = os.environ.get("TPUCFN_FT_DIR", "").strip()
        if ft_dir:
            from tpucfn_torch.ft.heartbeat import HeartbeatWriter

            hb = HeartbeatWriter(
                ft_dir, host_id, role="input",
                interval_s=float(
                    os.environ.get("TPUCFN_FT_HEARTBEAT_S", "1.0") or 1.0))
            hb.start()

        def _on_term(signum, frame):
            # one lock-free store; wait_idle notices and the main
            # thread runs the real close (a handler must never take
            # this object's locks — the PR 8 drain lesson)
            service.request_close()
            print("SIGTERM: input service closing", file=sys.stderr)

        try:
            _signal.signal(_signal.SIGTERM, _on_term)
        except ValueError:
            pass  # not the main thread (embedded use)
        t0 = _time.monotonic()
        service.wait_idle(args.idle_exit if args.idle_exit > 0 else None)
    finally:
        service.close()
        tracer.close()
        if hb is not None:
            hb.stop()
        if obs_srv is not None:
            obs_srv.close()
    m = registry.varz()["metrics"]
    print(_json.dumps({
        "served_s": round(_time.monotonic() - t0, 3),
        "batches_streamed": m.get("input_batches_streamed_total", 0),
        "bytes_streamed": m.get("input_bytes_streamed_total", 0),
        "connections": m.get("input_connections_total", 0),
        "stream_errors": m.get("input_stream_errors_total", 0),
    }))
    return 0


def cmd_compilecache_serve(args) -> int:
    """Run the fleet compiled-artifact server standalone (ISSUE 13):
    the input-role-host / host-0 deployment shape, jax-free — the
    ``tpucfn launch --compile-cache`` coordinator-hosted form is the
    other.  Serves GET/CLAIM/PUT over the PR 11 framing; SIGTERM (or
    ``--serve-for``) ends it, printing a stats JSON line."""
    import json as _json
    import signal as _signal
    import time as _time

    from tpucfn_torch.compilecache.service import (ArtifactServer,
                                             DEFAULT_COMPILE_CACHE_PORT)
    from tpucfn_torch.compilecache.store import default_store_dir

    from tpucfn_torch.obs.registry import MetricRegistry

    host_id = int(os.environ.get("TPUCFN_HOST_ID", "0") or 0)
    registry = MetricRegistry(labels={"role": "compilecache",
                                      "host": str(host_id)})
    # Fleet timeline (ISSUE 20): artifact_serve spans record the
    # requesting trainer's compile_fetch context as their remote
    # parent.  Unset ⇒ Tracer(None), no cost.
    from tpucfn_torch.obs.trace import Tracer

    trace_dir = (getattr(args, "trace_dir", None)
                 or os.environ.get("TPUCFN_TRACE_DIR", "").strip() or None)
    tracer = Tracer(trace_dir, host_id=host_id, role="compilecache")
    server = ArtifactServer(
        args.dir or default_store_dir(), host=args.host,
        port=args.port if args.port is not None
        else DEFAULT_COMPILE_CACHE_PORT,
        device_kind=args.device_kind or None,
        jax_version=args.jax_version or None,
        registry=registry, tracer=tracer)
    stop = [False]

    def _on_term(signum, frame):
        # ONE plain GIL-atomic store (the PR 8 signal lesson — an
        # Event.set() takes a lock); the main loop does the close.
        stop[0] = True

    try:
        _signal.signal(_signal.SIGTERM, _on_term)
    except ValueError:
        pass  # not the main thread (embedded use)
    t0 = _time.monotonic()
    try:
        server.start()
        print(f"compile-artifact server listening on {server.address} "
              f"(store {server.store.dir})", file=sys.stderr)
        deadline = (t0 + args.serve_for) if args.serve_for > 0 else None
        while not stop[0]:
            if deadline is not None and _time.monotonic() >= deadline:
                break
            _time.sleep(0.2)
    finally:
        server.close()
        tracer.close()
    m = registry.varz()["metrics"]
    print(_json.dumps({
        "served_s": round(_time.monotonic() - t0, 3),
        "entries": len(server.store.keys()),
        "gets": m.get("compilecache_gets_total", 0),
        "hits": m.get("compilecache_hits_total", 0),
        "publishes": m.get("compilecache_publishes_total", 0),
        "claims_granted": m.get("compilecache_claims_granted_total", 0),
        "handshake_refusals": m.get(
            "compilecache_handshake_refusals_total", 0),
    }))
    return 0


def _parse_bytes(s: str) -> int:
    """'512M', '2G', '100K', or a plain byte count."""
    s = s.strip()
    mult = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30}.get(s[-1:].lower())
    if mult is not None:
        return int(float(s[:-1]) * mult)
    return int(s)


def cmd_compilecache_gc(args) -> int:
    """Cap a compile-artifact store at ``--max-bytes`` (ISSUE 14
    satellite): live entries evict LRU by meta atime (reads touch it),
    claimed keys are never evicted, racing publishers' orphan payloads
    and stale tmp files older than ``--orphan-age`` sweep out.  Prints
    the stats JSON line; jax-free (safe from cron on any host sharing
    the dir)."""
    import json as _json

    from tpucfn_torch.compilecache.store import ArtifactStore, default_store_dir

    store = ArtifactStore(args.dir or default_store_dir())
    try:
        max_bytes = _parse_bytes(args.max_bytes)
        if max_bytes < 0:
            raise ValueError(max_bytes)
    except ValueError:
        print(f"error: bad --max-bytes {args.max_bytes!r} "
              "(use a non-negative N, NK, NM, or NG)", file=sys.stderr)
        return 2
    stats = store.gc(max_bytes, orphan_age_s=args.orphan_age)
    print(_json.dumps({"dir": str(store.dir), "max_bytes": max_bytes,
                       **stats}))
    return 0


def cmd_compilecache_stats(args) -> int:
    """Query a running artifact server's stats (entries, live claims,
    fleet identity) — the operator's is-the-warm-start-plane-working
    probe."""
    import json as _json

    from tpucfn_torch.compilecache.service import ArtifactClient
    from tpucfn_torch.data.service import ServiceError

    try:
        print(_json.dumps(ArtifactClient(args.addr).stats()))
    except ServiceError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 0


def _add_launch_parser(sub) -> None:
    l = sub.add_parser("launch", help="fan a command out across all hosts")
    l.add_argument("--name", required=True)
    l.add_argument("--transport", choices=["local", "ssh"], default="local")
    l.add_argument("--restarts", type=int, default=0,
                   help="auto-relaunch the gang up to N times on failure "
                        "(jobs resume from their latest checkpoint)")
    l.add_argument("--kill-host-after", metavar="HOST:SECONDS",
                   help="fault injection: SIGKILL host's rank after N "
                        "seconds on the first attempt (recovery drill)")
    l.add_argument("--obs-port", type=int, default=0, metavar="BASE",
                   help="observability plane: supervisor /metrics on BASE, "
                        "each host's process on BASE+1+host_id via "
                        "TPUCFN_OBS_PORT (0 = off)")
    l.add_argument("--ft", action="store_true",
                   help="fault-tolerance plane: per-host heartbeats "
                        "(TPUCFN_FT_DIR fan-out), failure detection, and "
                        "gang-coordinated recovery via tpucfn_torch.ft")
    l.add_argument("--ft-heartbeat-interval", type=float, default=1.0,
                   metavar="SECONDS",
                   help="heartbeat write interval; detection thresholds "
                        "scale off it (suspect 3x, dead 6x)")
    l.add_argument("--ft-restart-budget", type=int, default=None,
                   metavar="N",
                   help="recoveries allowed before giving up "
                        "(default: --restarts)")
    l.add_argument("--ft-startup-grace", type=float, default=120.0,
                   metavar="SECONDS",
                   help="no-heartbeat-yet window after every (re)launch "
                        "before a silent host counts as hung: must cover a "
                        "rank's boot (torch import, kernel libraries, init "
                        "or restore, step 1); crash detection is unaffected")
    l.add_argument("--ft-policy", choices=["gang", "solo"], default="gang",
                   help="recovery shape: gang = kill all + relaunch all + "
                        "resume from latest checkpoint; solo = restart "
                        "only the dead host into the same gang")
    l.add_argument("--ft-backoff", type=float, default=1.0, metavar="SECONDS",
                   help="base restart backoff; doubles per restart with "
                        "seeded jitter (--ft-seed)")
    l.add_argument("--ft-seed", type=int, default=0,
                   help="seed for backoff jitter (determinism: same seed "
                        "replays the same delays)")
    l.add_argument("--ft-drain-grace", type=float, default=30.0,
                   metavar="SECONDS",
                   help="preemption drain: how long to wait for clean "
                        "exits when the notice carries no lead time (a "
                        "shorter notice lead wins)")
    l.add_argument("--ft-drain-step-margin", type=int, default=2,
                   metavar="STEPS",
                   help="preemption drain: the ranks stop at the fleet's "
                        "newest heartbeat step plus this many steps; it "
                        "must cover the steps a rank runs between its "
                        "heartbeat and the drain request, or a rank past "
                        "the target stops at its own next step")
    l.add_argument("--ft-no-shrink", action="store_true",
                   help="disable elastic N-1 shrink: a host the control "
                        "plane lost gives up instead of re-converging "
                        "the contract at fewer hosts")
    l.add_argument("--ft-straggler-hysteresis", type=float, default=30.0,
                   metavar="SECONDS",
                   help="sustained step-lag required before a straggler "
                        "is evicted (solo-restarted)")
    l.add_argument("--ft-straggler-flap-budget", type=int, default=3,
                   metavar="N",
                   help="brief lag episodes tolerated per host before a "
                        "chronic flapper is evicted without waiting out "
                        "the hysteresis window")
    l.add_argument("--ft-max-ckpt-retries", type=int, default=3,
                   metavar="N",
                   help="checkpoint-corruption retries (each blacklists "
                        "one bad step and resumes from the previous) "
                        "before the normal restart policy decides")
    adopt_group = l.add_mutually_exclusive_group()
    adopt_group.add_argument(
        "--adopt", action="store_true",
        help="crash-safety: replay the write-ahead journal and adopt the "
             "running fleet instead of launching a new one (the default "
             "whenever an unfinished journal exists under the ft dir)")
    adopt_group.add_argument(
        "--no-adopt", action="store_true",
        help="always launch fresh, even over an unfinished journal (the "
             "previous run's journal is rotated aside, its fleet is NOT "
             "stopped)")
    l.add_argument("--chaos", metavar="SPEC",
                   help="deterministic fault injection (needs --ft): a "
                        "ChaosSpec JSON file (or inline JSON) replayed "
                        "against the coordinator: kill, hang, "
                        "delay_heartbeats, preempt_notice, lose_host, "
                        "corrupt_ckpt, kill_coordinator, and the net_* "
                        "gray-failure ops, which land on the --chaos-proxy "
                        "instances")
    l.add_argument("--input-hosts", type=int, default=0, metavar="N",
                   help="disaggregated input plane: the LAST N hosts of "
                        "the cluster stream batches (--input-cmd, usually "
                        "`python -m tpucfn_torch.cli data serve ...`) "
                        "instead of training; trainers get "
                        "TPUCFN_INPUT_ADDRS and the rendezvous shrinks to "
                        "the trainer count")
    l.add_argument("--input-port", type=int, default=0, metavar="BASE",
                   help="input service base port (input host h binds "
                        "BASE + h; 0 = the default base, 7641)")
    l.add_argument("--input-cmd", metavar="CMD",
                   help="command input hosts run (shlex-split); required "
                        "with --input-hosts")
    l.add_argument("--ft-restart-input-hosts", action="store_true",
                   help="solo-relaunch a dead input host (bounded, budget "
                        "untouched); default: trainers degrade to local "
                        "loading")
    l.add_argument("--compile-cache", action="store_true",
                   help="fleet warm start: run the artifact server in this "
                        "process and fan its address out "
                        "(TPUCFN_COMPILE_CACHE_ADDRS): one host builds each "
                        "kernel library with nvcc, the rest fetch it")
    l.add_argument("--compile-cache-dir", metavar="DIR",
                   help="artifact store directory of the server (default: "
                        "the cluster's state dir compilecache/)")
    l.add_argument("--compile-cache-port", type=int, default=0,
                   metavar="PORT",
                   help="artifact server bind port (default 7741)")
    l.add_argument("--compile-cache-advertise", metavar="HOST",
                   help="address the fleet dials for the artifact server "
                        "(default: 127.0.0.1 for --transport local, else "
                        "the coordinator host; the server runs in THIS "
                        "process)")
    l.add_argument("--chaos-proxy", metavar="LISTEN:HOST:PORT",
                   action="append",
                   help="run a fault-injection TCP proxy in this process: "
                        "listen on LISTEN, forward to HOST:PORT "
                        "(repeatable; the targets of net_* chaos ops, "
                        "indexed by flag order)")
    l.add_argument("--supervise", action="store_true",
                   help="wrap the coordinator in a re-exec loop: a crashed "
                        "coordinator is relaunched and adopts the running "
                        "fleet via the journal; orphaned rank exit codes "
                        "are reaped into <ft>/rc/ (needs --ft)")
    l.add_argument("--supervise-restarts", type=int, default=3, metavar="N",
                   help="coordinator relaunches allowed before the "
                        "supervise loop gives up and propagates the rc")
    l.add_argument("--provision-policy", choices=["goodput"],
                   help="goodput-driven provisioner loop (needs --ft and "
                        "--input-hosts): the coordinator reads the fleet "
                        "goodput ledgers each interval and actuates: a "
                        "data_wait share over threshold grows the input "
                        "plane (planned drain-relaunch), chronic "
                        "starvation at ceiling is flagged, a starvation-"
                        "free fleet shrinks it back")
    l.add_argument("--provision-interval", type=float, default=5.0,
                   metavar="SECONDS",
                   help="how often the provisioner policy observes the "
                        "goodput ledgers")
    l.add_argument("--provision-grow-threshold", type=float, default=0.25,
                   metavar="SHARE",
                   help="data_wait share of wall above which the policy "
                        "grows the input plane")
    l.add_argument("--provision-shrink-threshold", type=float, default=0.02,
                   metavar="SHARE",
                   help="data_wait share below which a served fleet "
                        "releases its input hosts")
    l.add_argument("--provision-cooldown", type=float, default=30.0,
                   metavar="SECONDS",
                   help="minimum time between provisioner actuations")
    l.add_argument("--provision-goodput-dir", metavar="DIR",
                   help="where the fleet's goodput ledgers land (must "
                        "match the trainers' run dir goodput/; default: "
                        "the cluster state dir goodput/)")
    l.add_argument("--defer-input-plane", action="store_true",
                   help="reserve the --input-hosts slots instead of "
                        "spawning them at launch: trainers start on "
                        "local loading and the provisioner activates the "
                        "input plane when goodput says it pays")
    l.add_argument("cmd", nargs=argparse.REMAINDER)
    l.set_defaults(fn=cmd_launch)


def _add_cluster_parsers(sub) -> None:
    c = sub.add_parser("create-stack", help="provision a cluster")
    c.add_argument("--name")
    c.add_argument("--spec", help="cluster spec JSON file")
    c.add_argument("--accelerator", default="h100-1",
                   help="h100-1 (one host, one card) or cpu-1 (the fake "
                        "test platform)")
    c.add_argument("--storage", help="shared storage root")
    c.set_defaults(fn=cmd_create_stack)

    s = sub.add_parser("status", help="describe a cluster")
    s.add_argument("--name", required=True)
    s.set_defaults(fn=cmd_status)

    d = sub.add_parser("delete", help="delete a cluster")
    d.add_argument("--name", required=True)
    d.set_defaults(fn=cmd_delete)

    r = sub.add_parser("resize", help="re-acquire at a new topology")
    r.add_argument("--name", required=True)
    r.add_argument("--accelerator", required=True)
    r.set_defaults(fn=cmd_resize)

    e = sub.add_parser("env", help="print the cluster env contract (eval-able)")
    e.add_argument("--name", required=True)
    e.set_defaults(fn=cmd_env)

    _add_launch_parser(sub)

    ft = sub.add_parser(
        "ft", help="fault-tolerance plane (heartbeats, recovery, chaos)")
    ftsub = ft.add_subparsers(dest="ft_command", required=True)
    fs = ftsub.add_parser(
        "status",
        help="render the fleet's heartbeat verdicts, recovery metrics "
             "(restarts, MTTR), and recent incident events")
    fs.add_argument("--name", help="cluster name (heartbeats under its "
                                   "state dir ft/)")
    fs.add_argument("--dir", help="explicit heartbeat dir (overrides --name)")
    fs.add_argument("--heartbeat-interval", type=float, default=None,
                    metavar="SECONDS",
                    help="classification interval override (default: the "
                         "supervisor snapshot's value, else 1.0)")
    fs.add_argument("--events", type=int, default=10,
                    help="incident-event tail length (0 = all)")
    fs.add_argument("--json", action="store_true",
                    help="emit the full fleet report as one JSON object")
    fs.set_defaults(fn=cmd_ft_status)

    cv = sub.add_parser(
        "convert-dataset",
        help="pack an image tree / CIFAR binary / MXNet RecordIO / "
             "tokenized jsonl corpus into tpurecord shards")
    cv.add_argument("--kind",
                    choices=["image-tree", "cifar10", "recordio",
                             "token-jsonl"],
                    required=True)
    cv.add_argument("--src", required=True,
                    help="dataset root directory (or .jsonl file for "
                         "token-jsonl; .rec file or directory of them "
                         "for recordio)")
    cv.add_argument("--out", required=True, help="output shard directory")
    cv.add_argument("--num-shards", type=int, default=16)
    cv.add_argument("--test-split", action="store_true",
                    help="cifar10: convert test_batch.bin instead of train")
    cv.add_argument("--seq-len", type=int, default=2048,
                    help="token-jsonl: packed row length")
    cv.add_argument("--publish", metavar="URL",
                    help="also upload shards to gs://, s3://, or file:// URL")
    cv.set_defaults(fn=cmd_convert_dataset)

    st = sub.add_parser("stage-data",
                        help="sync dataset shards from a store URL to local cache")
    st.add_argument("--url", required=True, help="gs://, s3://, file://, or path")
    st.add_argument("--dest", required=True)
    st.set_defaults(fn=cmd_stage_data)

    da = sub.add_parser(
        "data", help="input-plane commands (disaggregated batch service)")
    dasub = da.add_subparsers(dest="data_command", required=True)
    dsv = dasub.add_parser(
        "serve",
        help="stream ready batches to trainer hosts: the input-host "
             "role of `launch --input-hosts N` (never touches the card)")
    dsv.add_argument("--shards", required=True, metavar="DIR",
                     help="directory of *.tpurec shards (must match the "
                          "trainers' local fallback dataset)")
    dsv.add_argument("--batch-size", type=int, required=True,
                     help="per-trainer batch size (handshake-validated)")
    dsv.add_argument("--num-trainers", type=int, default=None, metavar="T",
                     help="trainer fleet size (default: "
                          "TPUCFN_WORKERS_COUNT from the launch fan-out)")
    dsv.add_argument("--seed", type=int, default=0)
    dsv.add_argument("--num-epochs", type=int, default=None,
                     help="epochs per trainer stream (default: unbounded)")
    dsv.add_argument("--host", default="0.0.0.0",
                     help="bind address (default all interfaces)")
    dsv.add_argument("--port", type=int, default=None,
                     help="bind port (default: TPUCFN_INPUT_PORT from the "
                          "launch fan-out, else ephemeral)")
    dsv.add_argument("--queue-batches", type=int, default=4,
                     help="encoded batches buffered per trainer stream "
                          "(the memory bound; TCP backpressure beyond it)")
    dsv.add_argument("--sndbuf-kb", type=int, default=0, metavar="KB",
                     help="cap the kernel send buffer per stream (makes "
                          "the per-trainer memory bound exact; 0 = OS "
                          "auto-tuning, right for high-bandwidth links)")
    dsv.add_argument("--mp-workers", type=int, default=0, metavar="W",
                     help="decode across W worker PROCESSES per stream "
                          "(MultiProcessLoader; 0 = in-process)")
    dsv.add_argument("--workers", type=int, default=0,
                     help="transform thread pool per stream "
                          "(ShardedDataset num_workers; 0 = inline)")
    dsv.add_argument("--no-shuffle", action="store_true")
    dsv.add_argument("--stream", action="store_true",
                     help="constant-memory shard streaming instead of "
                          "caching decoded examples in RAM")
    dsv.add_argument("--idle-exit", type=float, default=0.0,
                     metavar="SECONDS",
                     help="exit rc 0 after this long with no connected "
                          "trainer (0 = serve until SIGTERM); the launch "
                          "fan-out needs this so the coordinator can end "
                          "the run")
    dsv.add_argument("--obs-port", type=int, default=None, metavar="PORT",
                     help="serve /metrics /healthz /varz (default: "
                          "TPUCFN_OBS_PORT from the launch fan-out)")
    dsv.add_argument("--send-deadline", type=float, default=120.0,
                     metavar="SECONDS",
                     help="end-to-end deadline per sent frame: a stalled "
                          "trainer is dropped (and its producer freed) "
                          "after this long; must exceed the trainers' "
                          "worst-case step time (0 = disabled)")
    dsv.add_argument("--trace-dir", default=None, metavar="DIR",
                     help="write input_serve trace spans here (default: "
                          "TPUCFN_TRACE_DIR; unset = tracing off)")
    dsv.set_defaults(fn=cmd_data_serve)

    cc = sub.add_parser(
        "compilecache",
        help="fleet warm-start plane (kernel-library artifact store/server)")
    ccsub = cc.add_subparsers(dest="compilecache_command", required=True)
    ccs = ccsub.add_parser(
        "serve",
        help="run the artifact server standalone; `launch --compile-cache` "
             "is the coordinator-hosted form")
    ccs.add_argument("--dir", metavar="DIR",
                     help="artifact store directory (default "
                          "$TPUCFN_COMPILE_CACHE_DIR, else compilecache/ "
                          "under the port's state dir)")
    ccs.add_argument("--host", default="0.0.0.0")
    ccs.add_argument("--port", type=int, default=None,
                     help="bind port (default 7741)")
    ccs.add_argument("--device-kind", default="",
                     help="pin the fleet's card name (default: the first "
                          "client's handshake pins it)")
    ccs.add_argument("--toolchain", "--jax-version", dest="jax_version",
                     default="",
                     help="pin the fleet's toolchain identity (torch, CUDA "
                          "runtime, nvcc; the JAX CLI's --jax-version slot)")
    ccs.add_argument("--serve-for", type=float, default=0.0,
                     metavar="SECONDS",
                     help="exit cleanly after this long (0 = until "
                          "SIGTERM)")
    ccs.add_argument("--trace-dir", default=None, metavar="DIR",
                     help="write artifact_serve trace spans here "
                          "(default: TPUCFN_TRACE_DIR; unset = off)")
    ccs.set_defaults(fn=cmd_compilecache_serve)
    ccg = ccsub.add_parser(
        "gc",
        help="cap a store dir at --max-bytes: LRU eviction by meta "
             "atime, claimed keys kept, orphan payloads swept")
    ccg.add_argument("--dir", metavar="DIR",
                     help="store dir (default: TPUCFN_COMPILE_CACHE_DIR, "
                          "else compilecache/ under the port's state dir)")
    ccg.add_argument("--max-bytes", required=True, metavar="N[KMG]",
                     help="live-entry byte cap (0 = evict everything "
                          "unclaimed)")
    ccg.add_argument("--orphan-age", type=float, default=3600.0,
                     metavar="SECONDS",
                     help="age before unreferenced payloads / tmp files "
                          "are swept (younger may be an in-flight "
                          "publish)")
    ccg.set_defaults(fn=cmd_compilecache_gc)
    cct = ccsub.add_parser(
        "stats", help="query a running artifact server's stats")
    cct.add_argument("--addr", required=True, metavar="HOST:PORT")
    cct.set_defaults(fn=cmd_compilecache_stats)

    rl = sub.add_parser(
        "rl", help="RL plane (Podracer: actors + learner on one card, "
                   "replay queue on the device, whole-stack resume)")
    rlsub = rl.add_subparsers(dest="rl_command", required=True)
    rt = rlsub.add_parser(
        "train",
        help="run one host's actor/learner/refresh loop (fan out with "
             "`launch -- python -m tpucfn_torch.cli rl train ...`)")
    rt.add_argument("--run-dir", default="/tmp/tpucfn-rl",
                    help="per-run state: ckpt/, rl-host*.jsonl rows")
    rt.add_argument("--env", choices=["bandit", "gridworld"],
                    default="bandit",
                    help="built-in vectorized env (every env copy stepped "
                         "at once on the device)")
    rt.add_argument("--num-envs", type=int, default=8,
                    help="vectorized env copies = learner batch size "
                         "(split across data-parallel ranks when they "
                         "divide it)")
    rt.add_argument("--unroll", type=int, default=16,
                    help="env steps per rollout slab")
    rt.add_argument("--iters", type=int, default=100,
                    help="act→learn→refresh iterations to run")
    rt.add_argument("--hidden", type=int, default=64,
                    help="policy/value MLP hidden width")
    rt.add_argument("--lr", type=float, default=1e-2)
    rt.add_argument("--gamma", type=float, default=0.99)
    rt.add_argument("--entropy-coef", type=float, default=0.01)
    rt.add_argument("--seed", type=int, default=0,
                    help="root seed; every random draw comes from a "
                         "generator seeded from (seed, iteration), so same "
                         "seed = bit-identical run, including across "
                         "restores")
    rt.add_argument("--ckpt-every", type=int, default=25,
                    help="whole-stack snapshot interval (learner state + "
                         "env state + queue ring + iteration)")
    rt.add_argument("--log-every", type=int, default=10)
    rt.add_argument("--queue-capacity", type=int, default=4,
                    help="replay ring slots on the device (host spill is "
                         "the overflow fallback)")
    rt.add_argument("--stop-after", type=int, default=0,
                    help="halt after this iteration (0 = run to --iters); "
                         "the planned-interruption hook drills use")
    rt.add_argument("--fresh", action="store_true",
                    help="ignore existing checkpoints (default: resume "
                         "from latest)")
    rt.add_argument("--iter-sleep-s", type=float, default=0.0,
                    help="host-side pacing between iterations (chaos "
                         "drills use it to land mid-episode kills)")
    rt.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the card (default) or the CPU")
    rt.set_defaults(fn=cmd_rl_train)

    ch = sub.add_parser(
        "chaos",
        help="network fault injection (gray failures: latency, trickle, "
             "stall, partition, tear, RST)")
    chsub = ch.add_subparsers(dest="chaos_command", required=True)
    cp = chsub.add_parser(
        "proxy",
        help="run a deterministic fault-injection TCP proxy in front of "
             "any fleet plane's port")
    cp.add_argument("--listen", type=int, default=0, metavar="PORT",
                    help="port to listen on (0 = ephemeral, printed)")
    cp.add_argument("--upstream", required=True, metavar="HOST:PORT",
                    help="where healthy traffic forwards to")
    cp.add_argument("--host", default="0.0.0.0",
                    help="bind address (default 0.0.0.0)")
    cp.add_argument("--spec", metavar="FILE|JSON",
                    help="NetFaultSchedule JSON: {\"seed\": N, \"faults\": "
                         "[{\"kind\": \"throttle\", \"at_s\": 5, "
                         "\"rate_bps\": 1024, \"duration_s\": 30}, ...]}")
    cp.add_argument("--seed", type=int, default=None,
                    help="override the schedule's seed (determinism: same "
                         "seed, same fault timeline)")
    cp.add_argument("--serve-for", type=float, default=0.0,
                    metavar="SECONDS",
                    help="exit after this long (0 = until SIGTERM)")
    cp.set_defaults(fn=cmd_chaos_proxy)

    k = sub.add_parser("kill-host", help="fault injection: mark a host dead")
    k.add_argument("--name", required=True)
    k.add_argument("--host", type=int, required=True)
    k.set_defaults(fn=cmd_kill_host)

    h = sub.add_parser("heal", help="health check; re-acquire if hosts died")
    h.add_argument("--name", required=True)
    h.set_defaults(fn=cmd_heal)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m tpucfn_torch.cli")
    ap.add_argument("--state-dir", default=os.environ.get(
        "TPUCFN_TORCH_STATE_DIR", "~/.tpucfn_torch"))
    ap.add_argument("--backend", default="fake",
                    help="control plane: only 'fake' (a local state file) "
                         "is ported")
    sub = ap.add_subparsers(dest="command", required=True)
    _add_cluster_parsers(sub)
    sv = sub.add_parser(
        "serve", help="continuous-batching inference over a prompt workload "
                      "(paged KV cache, bucketed prefills, admission control)")
    sv.add_argument("--preset", choices=LLAMA_PRESETS, default="tiny")
    sv.add_argument("--prompts",
                    help='JSONL file of {"tokens": [ids...]} prompts')
    sv.add_argument("--synthetic", type=int, default=8,
                    help="generate N random prompts instead of --prompts")
    sv.add_argument("--prompt-len", metavar="LO:HI",
                    help="synthetic prompt length range (default 4:32)")
    sv.add_argument("--max-new", type=int, default=16)
    sv.add_argument("--temperature", type=float, default=0.0)
    sv.add_argument("--max-batch", type=int, default=8,
                    help="decode slots (the fixed decode batch shape)")
    sv.add_argument("--cache-len", type=int, default=None,
                    help="per-slot KV capacity in tokens (default: model "
                         "max_seq)")
    sv.add_argument("--num-blocks", type=int, default=256)
    sv.add_argument("--block-size", type=int, default=16)
    sv.add_argument("--max-queued-tokens", type=int, default=1 << 16,
                    help="backpressure cap: outstanding prompt+budget "
                         "tokens before 429")
    sv.add_argument("--prefix-cache", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="block-level prompt-prefix caching (--no-prefix-cache "
                         "disables)")
    sv.add_argument("--max-prefill-batch", type=int, default=4,
                    help="same-bucket prefills fused into one call (the "
                         "engine's fixed lane count; 1 disables)")
    sv.add_argument("--deadline-s", type=float, default=None)
    sv.add_argument("--slo-ttft", type=float, default=0.5, metavar="SECONDS",
                    help="TTFT SLO target; burn rate exported as "
                         "serve_slo_ttft_burn_rate")
    sv.add_argument("--slo-tpot", type=float, default=0.05,
                    metavar="SECONDS", help="per-output-token SLO target")
    sv.add_argument("--slo-objective", type=_slo_objective, default=0.99,
                    help="fraction of requests that must meet each target "
                         "(exclusive (0, 1))")
    sv.add_argument("--slo-shed", action="store_true",
                    help="SLO-aware early shedding: 429 new requests while "
                         "the rolling-window burn rate is sustained above 1")
    sv.add_argument("--replicas", type=int, default=1, metavar="N",
                    help="engine replicas behind a resilient router "
                         "(failover, deadline-budgeted retry, hedging, "
                         "graceful drain); 1 = a single server")
    sv.add_argument("--retry-budget", type=int, default=2, metavar="K",
                    help="max resubmissions per request after replica "
                         "failure (bounded by the deadline budget either "
                         "way)")
    sv.add_argument("--hedge-ms", type=float, default=0.0, metavar="MS",
                    help="hedging: duplicate a straggling request to a "
                         "second replica after the p99-derived delay, "
                         "floored at MS (0 disables)")
    sv.add_argument("--drain-grace", type=float, default=30.0,
                    metavar="SECONDS",
                    help="SIGTERM drain window: admission closes and "
                         "accepted work gets this long to finish")
    sv.add_argument("--spec-draft", metavar="PRESET",
                    choices=("self",) + LLAMA_PRESETS,
                    help="speculative decoding: pair each engine with a "
                         "DRAFT engine of this preset at the same slot "
                         "layout ('self' = the target's own weights); "
                         "greedy output equals plain decode's")
    sv.add_argument("--spec-k", type=int, default=4, metavar="K",
                    help="draft tokens proposed per slot per round (the "
                         "adaptive controller's ceiling)")
    sv.add_argument("--spec-adaptive", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="acceptance-driven k controller: shrink toward 1, "
                         "then off with periodic probes (--no-spec-adaptive "
                         "pins k)")
    sv.add_argument("--spec-draft-seed", type=int, default=None,
                    help="draft init seed for random-init draft presets "
                         "(default: --seed)")
    sv.add_argument("--spec-replicas", metavar="I,J,...",
                    help="with --replicas N: the replica indices that "
                         "decode speculatively (default all)")
    sv.add_argument("--seed", type=int, default=0)
    sv.add_argument("--obs-port", type=int, default=None, metavar="PORT",
                    help="serve /metrics, /healthz, /varz, /flightrecorder "
                         "on PORT while the workload runs (0 = ephemeral "
                         "port, printed; default TPUCFN_OBS_PORT)")
    sv.add_argument("--trace-dir", metavar="DIR",
                    help="write request-lifecycle trace spans (queue_wait/"
                         "prefill/decode_round/spec_*/request_done JSONL) "
                         "to DIR; flight dumps go to its sibling flight/ "
                         "and POST /profile captures to profile/")
    sv.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "attention path)")
    sv.set_defaults(fn=cmd_serve)

    ob = sub.add_parser(
        "obs", help="aggregate per-host metrics/trace JSONL into one fleet "
                    "view (merged step timeline, stragglers, request "
                    "latency breakdown)")
    ob.add_argument("--run-dir",
                    help="the training/serving run dir (expects logs/ and "
                         "trace/ beneath unless overridden)")
    ob.add_argument("--logs-dir", help="metrics JSONL dir (default RUN/logs)")
    ob.add_argument("--trace-dir", help="trace JSONL dir (default RUN/trace)")
    ob.add_argument("--steps", type=int, default=20,
                    help="timeline rows to show (most recent N steps)")
    ob.add_argument("--json", action="store_true",
                    help="emit the full report as one JSON object")
    ob.add_argument("--watch", type=float, default=0, metavar="SECONDS",
                    help="re-render every N seconds, tailing files "
                         "incrementally from their last offset")
    ob.set_defaults(fn=cmd_obs)
    obsub = ob.add_subparsers(dest="obs_command")
    og = obsub.add_parser(
        "goodput",
        help="per-run wall-clock ledger: productive/compile/data_wait/"
             "ckpt/idle/lost_work/restart_downtime buckets that sum to "
             "wall time, plus ft incident attribution")
    # SUPPRESS defaults on the flags the parent `obs` parser also owns:
    # argparse applies subparser defaults AFTER the parent's values are
    # parsed, so a plain default here would silently clobber
    # `python -m tpucfn_torch.cli obs --json --run-dir X goodput` back
    # to json=False.
    og.add_argument("--run-dir", default=argparse.SUPPRESS,
                    help="the training --run-dir (expects goodput/ and "
                         "optionally ft/events.jsonl beneath)")
    og.add_argument("--goodput-dir",
                    help="explicit ledger dir (default RUN/goodput)")
    og.add_argument("--ft-events",
                    help="ft incident log (default RUN/ft/events.jsonl)")
    og.add_argument("--json", action="store_true", default=argparse.SUPPRESS,
                    help="emit the full report as one JSON object")
    og.add_argument("--watch", type=float, default=argparse.SUPPRESS,
                    metavar="SECONDS",
                    help="re-read and re-render every N seconds")
    og.add_argument("--ledger", nargs="?", metavar="PATH",
                    const="runs/goodput_ledger.jsonl", default=None,
                    help="also append this run's report as one JSON row "
                         "to the cross-run regression ledger (default "
                         "runs/goodput_ledger.jsonl); diff with "
                         "`python -m tpucfn_torch.cli obs diff`")
    og.set_defaults(fn=cmd_obs_goodput)

    pm = obsub.add_parser(
        "postmortem",
        help="assemble one incident's forensic bundle: incident row, "
             "skew-corrected timeline window, goodput span, per-host "
             "flight-recorder tails, last heartbeats")
    pm.add_argument("--run-dir", default=argparse.SUPPRESS,
                    help="the training --run-dir (expects ft/, trace/, "
                         "goodput/, flight/ beneath)")
    pm.add_argument("--ft-dir", default=None,
                    help="explicit ft dir (default RUN/ft)")
    which = pm.add_mutually_exclusive_group()
    which.add_argument("--incident", type=int, default=None,
                       help="incident number (from events.jsonl / "
                            "`python -m tpucfn_torch.cli ft status`)")
    which.add_argument("--latest", action="store_true",
                       help="the newest incident (the default)")
    pm.add_argument("--window", type=float, default=15.0, metavar="SECONDS",
                    help="timeline/goodput window padding around "
                         "detection..recovery")
    pm.add_argument("--out", metavar="DIR",
                    help="bundle directory (default "
                         "RUN/postmortem/incident-NNN)")
    pm.add_argument("--json", action="store_true", default=argparse.SUPPRESS,
                    help="emit the full report (+ bundle path) as JSON")
    pm.set_defaults(fn=cmd_obs_postmortem)

    pf = obsub.add_parser(
        "profile",
        help="trigger an on-demand torch.profiler capture on a host "
             "via its obs endpoint (POST /profile)")
    pf.add_argument("--host", required=True, metavar="HOST[:PORT]",
                    help="obs endpoint address (the launch banner prints "
                         "each host's port)")
    pf.add_argument("--port", type=int, default=0,
                    help="port when --host has none")
    pf.add_argument("--seconds", type=float, default=2.0,
                    help="capture duration")
    pf.add_argument("--timeout", type=float, default=0.0,
                    help="client timeout (default: seconds + 120 — "
                         "profiler session setup can take tens of "
                         "seconds on a busy host)")
    pf.set_defaults(fn=cmd_obs_profile)

    df = obsub.add_parser(
        "diff",
        help="compare goodput_ratio + bucket shares between the last "
             "two rows of the cross-run goodput ledger")
    df.add_argument("--ledger", default="runs/goodput_ledger.jsonl",
                    help="ledger path (written by `python -m "
                         "tpucfn_torch.cli obs goodput --ledger`)")
    df.add_argument("--json", action="store_true", default=argparse.SUPPRESS,
                    help="emit the diff as one JSON object")
    df.set_defaults(fn=cmd_obs_diff)

    tr = sub.add_parser(
        "trace",
        help="fleet timeline plane: clock-aligned Perfetto export, "
             "per-step critical-path attribution, deadline advice")
    trsub = tr.add_subparsers(dest="trace_command", required=True)

    def _trace_common(tp):
        tp.add_argument("--run-dir", required=True, metavar="DIR",
                        help="the training run directory (traces under "
                             "DIR/trace, clock probes under "
                             "DIR/ft/clock-offsets.jsonl)")
        tp.add_argument("--trace-dir", default=None, metavar="DIR",
                        help="span-file directory (default: "
                             "<run-dir>/trace)")
        tp.add_argument("--offsets", default=None, metavar="FILE",
                        help="coordinator clock-offsets.jsonl (default: "
                             "<run-dir>/ft/clock-offsets.jsonl when "
                             "present; absent = step-anchored estimate "
                             "only)")
        tp.add_argument("--json", action="store_true",
                        help="emit machine-readable JSON")

    te = trsub.add_parser(
        "export",
        help="merge per-host span files into one Chrome/Perfetto "
             "trace-event JSON with cross-host flow arrows")
    _trace_common(te)
    te.add_argument("--out", default=None, metavar="FILE",
                    help="output path (default: "
                         "<run-dir>/trace/timeline.json)")
    te.set_defaults(fn=cmd_trace_export)
    tc = trsub.add_parser(
        "critpath",
        help="per-step critical-path attribution: which plane bounded "
             "each step, with a goodput-ledger cross-check")
    _trace_common(tc)
    tc.add_argument("--goodput", default=None, metavar="DIR",
                    help="goodput ledger dir for the aggregate "
                         "cross-check (default: <run-dir>/goodput when "
                         "present)")
    tc.set_defaults(fn=cmd_trace_critpath)
    ta = trsub.add_parser(
        "advise",
        help="deadline autotune ADVISORY from observed frame-time "
             "percentiles (report-only)")
    _trace_common(ta)
    ta.add_argument("--headroom", type=float, default=8.0,
                    help="suggested = clamp(p99 * headroom, 1s, "
                         "current default)")
    ta.add_argument("--min-samples", type=int, default=8,
                    help="suggest nothing below this many observed "
                         "frames")
    ta.set_defaults(fn=cmd_trace_advise)

    fo = sub.add_parser(
        "forensics",
        help="postmortem bundle tooling (diff two incidents)")
    fosub = fo.add_subparsers(dest="forensics_command", required=True)
    fd = fosub.add_parser(
        "diff",
        help="diff two postmortem bundles of the same incident class: "
             "goodput-share and per-host deltas over each bundle's "
             "window")
    fd.add_argument("bundle_a", metavar="BUNDLE_A",
                    help="earlier bundle dir (from `python -m "
                         "tpucfn_torch.cli obs postmortem`)")
    fd.add_argument("bundle_b", metavar="BUNDLE_B",
                    help="later bundle dir")
    fd.add_argument("--json", action="store_true",
                    help="emit the diff as one JSON object")
    fd.set_defaults(fn=cmd_forensics_diff)
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    # what --supervise re-executes, also when called in-process
    args.argv = sys.argv[1:] if argv is None else list(argv)
    if args.backend != "fake":
        return _refuse(f"--backend {args.backend}: only the fake control "
                       "plane is ported to tpucfn_torch; the JAX package's "
                       "gcp backend provisions TPU queued resources")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
