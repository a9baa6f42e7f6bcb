"""Command line of the port: ``python -m tpucfn_torch.cli <command>``.

The cluster commands are the port of ``tpucfn/cli/main.py``'s::

    python -m tpucfn_torch.cli create-stack --name demo --accelerator h100-1
    python -m tpucfn_torch.cli status --name demo
    python -m tpucfn_torch.cli env --name demo       # eval-able contract
    python -m tpucfn_torch.cli launch --name demo --ft -- \
        python -m tpucfn_torch.examples.llama3_8b_fsdp --model 1b ...
    python -m tpucfn_torch.cli kill-host --name demo --host 0
    python -m tpucfn_torch.cli heal --name demo
    python -m tpucfn_torch.cli delete --name demo

State lives in ``--state-dir`` (default ``$TPUCFN_TORCH_STATE_DIR`` or
``~/.tpucfn_torch``; not the JAX package's ``$TPUCFN_STATE_DIR``, whose
state file holds TPU accelerators that the port's registry does not know) through the fake
control plane; ``--backend gcp`` (TPU queued resources) is refused.
``launch`` fans the command out with the env contract and, with
``--ft``, runs it under the gang coordinator (heartbeats, restarts with
a budget, preemption drain, checkpoint-corruption retry, chaos specs).
The launch planes that are not ported exit 2 naming their ROADMAP item:
the input service (``--input-*``, ``--ft-restart-input-hosts``: Queue 1
B2), the compile cache (``--compile-cache*``: B4), the supervised
coordinator (``--supervise*``: B5), the network chaos proxy
(``--chaos-proxy`` and ``net_*`` chaos events: B6) and the provisioner
policy loop (``--provision-*``, ``--defer-input-plane``: B7).

``serve`` is ``tpucfn serve`` (``tpucfn/cli/main.py:cmd_serve``):
continuous-batching inference over a workload of token-id prompts
(``--prompts`` JSONL with {"tokens": [...]} rows, or ``--synthetic N``
random prompts) on a random-init Llama preset, printing the serving
metrics snapshot as one JSON line: speculative decoding
(``--spec-draft``), N replicas behind the router (``--replicas``), the
admission and SLO flags, a graceful drain on SIGTERM, the obs endpoint
(``--obs-port``), request trace spans (``--trace-dir``), the flight
recorder and, under ``TPUCFN_FT_DIR``, heartbeats.  It runs on the card
unless ``--device cpu`` is given.  With ``TPUCFN_COMPILE_CACHE_ADDRS``
set it exits 2 (the compile cache: Queue 1 B4).  ``obs`` reads a run
directory's metrics and trace JSONL back as one fleet view
(``tpucfn/cli/main.py:cmd_obs``).
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

# (flag, argparse dest, what it asks for, ROADMAP item) for each launch
# option of the JAX package whose plane the port does not have.
REFUSED_LAUNCH_FLAGS = (
    ("--input-hosts", "input_hosts", "the disaggregated input service",
     "Queue 1 B2"),
    ("--input-port", "input_port", "the disaggregated input service",
     "Queue 1 B2"),
    ("--input-cmd", "input_cmd", "the disaggregated input service",
     "Queue 1 B2"),
    ("--ft-restart-input-hosts", "ft_restart_input_hosts",
     "the disaggregated input service", "Queue 1 B2"),
    ("--compile-cache", "compile_cache", "the fleet compile cache",
     "Queue 1 B4"),
    ("--compile-cache-dir", "compile_cache_dir", "the fleet compile cache",
     "Queue 1 B4"),
    ("--compile-cache-port", "compile_cache_port", "the fleet compile cache",
     "Queue 1 B4"),
    ("--compile-cache-advertise", "compile_cache_advertise",
     "the fleet compile cache", "Queue 1 B4"),
    ("--supervise", "supervise", "the supervised coordinator",
     "Queue 1 B5"),
    ("--supervise-restarts", "supervise_restarts",
     "the supervised coordinator", "Queue 1 B5"),
    ("--chaos-proxy", "chaos_proxy", "the network chaos proxy",
     "Queue 1 B6"),
    ("--provision-policy", "provision_policy",
     "the provisioner policy loop", "Queue 1 B7"),
    ("--provision-interval", "provision_interval",
     "the provisioner policy loop", "Queue 1 B7"),
    ("--provision-grow-threshold", "provision_grow_threshold",
     "the provisioner policy loop", "Queue 1 B7"),
    ("--provision-shrink-threshold", "provision_shrink_threshold",
     "the provisioner policy loop", "Queue 1 B7"),
    ("--provision-cooldown", "provision_cooldown",
     "the provisioner policy loop", "Queue 1 B7"),
    ("--provision-goodput-dir", "provision_goodput_dir",
     "the provisioner policy loop", "Queue 1 B7"),
    ("--defer-input-plane", "defer_input_plane",
     "the provisioner policy loop", "Queue 1 B7"),
)
# Flags of the list above that take no value.
_REFUSED_SWITCHES = ("--ft-restart-input-hosts", "--compile-cache",
                     "--supervise", "--defer-input-plane")


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

    from tpucfn_torch.launch.launcher import COMPILE_CACHE_ADDRS_ENV

    if os.environ.get(COMPILE_CACHE_ADDRS_ENV, "").strip():
        return _refuse(f"{COMPILE_CACHE_ADDRS_ENV} is set: the fleet compile "
                       "cache is not ported to tpucfn_torch yet (ROADMAP "
                       "Queue 1 B4)")
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
    tracer = obs_srv = hb = server = router = None
    reqs = []
    try:
        # Inside the try from the first resource on: a failed port bind
        # must not leak the tracer opened before it.
        tracer = Tracer(args.trace_dir, host_id=host_id, role="server",
                        truncate=True) if args.trace_dir else Tracer(None)
        # --obs-port wins; otherwise the launcher-assigned TPUCFN_OBS_PORT
        # applies; neither -> no endpoint.
        obs_srv = start_obs_server(registry, port=args.obs_port,
                                   role="server", host_id=host_id,
                                   flight=flight)
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


def _refused_launch_flag(args) -> str | None:
    for flag, dest, plane, item in REFUSED_LAUNCH_FLAGS:
        if getattr(args, dest, None) not in (None, False):
            return (f"{flag}: {plane} is not ported to tpucfn_torch yet "
                    f"(ROADMAP {item})")
    return None


def cmd_launch(args) -> int:
    """``tpucfn launch`` (``tpucfn/cli/main.py:cmd_launch``) without the
    planes the port does not have, which exit 2 before anything runs."""
    refused = _refused_launch_flag(args)
    if refused:
        return _refuse(refused)
    # A launch-level chaos spec replays against the gang coordinator's
    # supervision clock: kills, hangs, heartbeat delays, preemption
    # notices, host loss and checkpoint corruption.
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
        net = sorted({e.action for e in chaos_spec.events
                      if e.action.startswith("net_")})
        if net:
            return _refuse(f"--chaos schedules {', '.join(net)}: the network "
                           "chaos proxy is not ported to tpucfn_torch yet "
                           "(ROADMAP Queue 1 B6)")
    rec = _control_plane(args).describe(args.name)
    from tpucfn_torch.provision.control_plane import ClusterState

    if rec.state is not ClusterState.ACTIVE:
        print(f"error: cluster {args.name} is {rec.state.value}, not ACTIVE",
              file=sys.stderr)
        return 1
    contract = converge(rec, _run_dir(args, args.name))
    transport = SSHTransport() if args.transport == "ssh" else LocalTransport()
    ft_dir = _run_dir(args, args.name) / "ft" if args.ft else None
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
    registry = None
    if args.obs_port:
        from tpucfn_torch.obs.registry import MetricRegistry

        registry = MetricRegistry(labels={"role": "supervisor"})
    launcher = Launcher(contract, transport,
                        obs_base_port=args.obs_port or None,
                        ft_dir=str(ft_dir) if ft_dir else None,
                        ft_heartbeat_s=(args.ft_heartbeat_interval
                                        if args.ft else None))
    from tpucfn_torch.launch import run_with_restarts

    obs_srv = None
    monitor = None
    # The launched gang is hosts()[:workers_count] (Launcher.launch's
    # precedence rule): what the monitor judges and whose ports serve.
    n_launched = len(contract.hosts()[:contract.workers_count])
    if args.ft:
        # Heartbeat monitor over the dir every rank writes into.  Startup
        # grace must cover a rank's boot (torch import, loading the
        # kernel libraries, init or restore, step 1): a booting gang that
        # has not beaten yet is not hung.  Crash detection (process exit)
        # is unaffected by it.
        from tpucfn_torch.ft import HeartbeatMonitor, MonitorConfig

        monitor = HeartbeatMonitor(
            ft_dir, expected_hosts=n_launched,
            config=MonitorConfig(
                interval_s=args.ft_heartbeat_interval,
                startup_grace_s=args.ft_startup_grace))
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

            coordinator = GangCoordinator(
                launcher, argv,
                policy=policy_from_name(args.ft_policy, budget),
                monitor=monitor, ft_dir=ft_dir, registry=registry,
                kill_host_after=inject,
                ckpt_dir=_run_dir(args, args.name) / "ckpt",
                drain_grace_s=args.ft_drain_grace,
                allow_shrink=not args.ft_no_shrink,
                reacquire_check=_reacquire,
                max_ckpt_retries=args.ft_max_ckpt_retries,
                straggler_guard=StragglerGuard(
                    hysteresis_s=args.ft_straggler_hysteresis,
                    flap_budget=args.ft_straggler_flap_budget),
                adopt=(True if args.adopt
                       else False if args.no_adopt else "auto"),
                chaos=chaos_spec)
            coord_ref["coord"] = coordinator
            rc = coordinator.run()
        else:
            rc = run_with_restarts(launcher, argv, max_restarts=args.restarts,
                                   kill_host_after=inject, registry=registry)
    finally:
        if obs_srv is not None:
            obs_srv.close()
    print(f"launch finished rc={rc}")
    return rc


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
                        "corrupt_ckpt")
    for flag, dest, plane, item in REFUSED_LAUNCH_FLAGS:
        refused = f"refused: {plane} is not ported (ROADMAP {item})"
        if flag in _REFUSED_SWITCHES:
            l.add_argument(flag, dest=dest, action="store_true",
                           default=None, help=refused)
        else:
            l.add_argument(flag, dest=dest, metavar="X",
                           action="append" if flag == "--chaos-proxy"
                           else "store", help=refused)
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

    e = sub.add_parser("env", help="print the cluster env contract (eval-able)")
    e.add_argument("--name", required=True)
    e.set_defaults(fn=cmd_env)

    _add_launch_parser(sub)

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
                         "to DIR; flight dumps go to its sibling flight/")
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
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.backend != "fake":
        return _refuse(f"--backend {args.backend}: only the fake control "
                       "plane is ported to tpucfn_torch; the JAX package's "
                       "gcp backend provisions TPU queued resources")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
