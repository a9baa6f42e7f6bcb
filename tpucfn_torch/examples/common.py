"""The training loop the port's examples share (the port of
``examples/common.py``).

:func:`run_train_loop` keeps the JAX loop's structure: ``--fresh`` clears
the checkpoints (rank 0, then a barrier that carries its outcome),
``init_or_resume`` restores the latest step or starts fresh (a step that
will not restore exits with ``RESTORE_FAILED_RC``), then ``data_wait ->
step -> ckpt`` per step through :class:`TrainerObs` (trace spans,
registry metrics and the goodput ledger under ``run_dir/goodput``) with
interval saves, ``--stop-after``, ``--eval-every``,
``time_to_first_step`` and the MFU gauge after step 1, the final
force-save, and the final ``items/sec`` line.  Batches come from the
dataset through :func:`tpucfn_torch.data.prefetch_to_device`.

One change: a resumed run skips the batches its restored steps consumed,
so it trains on the batches an uninterrupted run would (the JAX loop
starts its stream again at the first batch), and a relaunch's losses
equal an uninterrupted run's.

The planes the launcher fans out, wired as the JAX loop wires them:

* ``TPUCFN_FT_DIR``: a :class:`~tpucfn_torch.ft.HeartbeatWriter` beats
  every ``TPUCFN_FT_HEARTBEAT_S`` with the latest step, and the loop
  checks ``drain_requested`` after each step's save: a drain breaks out
  to the final force-save, the zero-lost-work stop of a preemption.
* ``TPUCFN_OBS_PORT``: the per-rank obs server (``/metrics`` with the
  card's memory and the kernels' launch counts, ``/healthz`` with the
  step, ``/flightrecorder`` from the :class:`FlightRecorder`, also dumped
  under ``run_dir/flight`` on SIGTERM and at exit, and ``POST /profile``,
  a ``torch.profiler`` capture that the loop runs between step
  boundaries, so it holds the training thread's ops).
* ``--profile``: ``torch.profiler`` around the whole loop.
* ``TPUCFN_INPUT_ADDRS``: the disaggregated input service.  The batches
  come from a :class:`~tpucfn_torch.data.service.ResilientBatchStream`
  (failover across input hosts, then local loading from the exact batch
  cursor) behind an :class:`~tpucfn_torch.data.service.AdaptivePrefetcher`;
  each ``data_wait`` span records the serving host's span as its remote
  parent.  A resumed run asks the service for the batches from its
  restored step on, as it skips them locally.
* ``TPUCFN_COMPILE_CACHE_ADDRS`` / ``TPUCFN_COMPILE_CACHE_DIR``: the
  fleet warm start of the kernel libraries
  (:mod:`tpucfn_torch.compilecache.kernels`), configured before the
  first step; a :class:`~tpucfn_torch.obs.profiler.CompileCacheProbe`
  tells ``TrainerObs`` what the first step paid for them, and each log
  row carries the cache's counters.

Refuse, never skip: with ``--profile-server`` (XProf's live attach,
which has no PyTorch counterpart: ``POST /profile`` captures instead)
the loop exits non-zero and names what is missing.
"""

from __future__ import annotations

import argparse
import itertools
import os
import time
from pathlib import Path

# The kernel-library cache's counters each log row carries, when a cache
# is configured.
COMPILE_CACHE_COUNTERS = (
    "compilecache_kernel_dir_hits_total", "compilecache_store_hits_total",
    "compilecache_fetch_hits_total", "compilecache_compiles_total",
    "compilecache_client_publishes_total",
    "compilecache_fetch_failures_total", "compilecache_corrupt_total")


def add_cluster_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--run-dir", default="/tmp/tpucfn-run",
                   help="checkpoints, metrics, staged data land here")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to train: the card (default), or the CPU's "
                        "plain paths (tests)")
    p.add_argument("--batch-size", type=int, default=256, help="GLOBAL batch size")
    p.add_argument("--steps", type=int, default=0,
                   help="hard step cap that IS the run's budget (0 = the "
                        "full epoch budget); LR schedules anneal over it")
    p.add_argument("--stop-after", type=int, default=0,
                   help="halt once the global step reaches N WITHOUT "
                        "changing the budget or LR schedule — a simulated "
                        "interruption/preemption; relaunching resumes the "
                        "same schedule where it stopped (0 = off)")
    p.add_argument("--num-epochs", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--ckpt-every", type=int, default=200)
    p.add_argument("--fresh", action="store_true",
                   help="delete existing checkpoints in --run-dir and train "
                        "from step 0")
    p.add_argument("--eval-every", type=int, default=0,
                   help="run validation over the held-out split every N steps")
    p.add_argument("--profile", action="store_true",
                   help="trace the training loop with torch.profiler into "
                        "RUN_DIR/profile/trace-<pid>.json (a Chrome trace)")
    p.add_argument("--profile-server", type=int, default=0, metavar="PORT",
                   help="refused: XProf's live attach has no PyTorch "
                        "counterpart; capture with POST /profile on the "
                        "obs port instead")
    p.add_argument("--fsdp", type=int, default=1, help="fsdp axis size")
    p.add_argument("--tensor", type=int, default=1, help="tensor-parallel axis size")


def refuse_unported_planes(args) -> None:
    """Exit non-zero, naming what is missing and its ROADMAP item, when
    the flags ask for a plane the port does not have."""
    if getattr(args, "profile_server", 0):
        raise SystemExit(
            "--profile-server: XProf's live profiler server has no PyTorch "
            "counterpart in tpucfn_torch (ROADMAP Queue 1 B3, kept as a "
            "gap); capture a live rank with POST /profile?seconds=S on its "
            "obs port (TPUCFN_OBS_PORT) instead")


def refuse_sharded_parameters(args) -> None:
    """Exit non-zero, naming ROADMAP Queue 1 C2, for ``--fsdp`` or
    ``--tensor`` > 1: the trainer runs data parallel only."""
    for flag, n, what in (("--fsdp", args.fsdp, "sharded parameters"),
                          ("--tensor", args.tensor, "tensor parallelism")):
        if n > 1:
            raise SystemExit(f"{flag} > 1 ({what}) is not ported to "
                             "tpucfn_torch yet (ROADMAP Queue 1 C2)")


def per_process_batch(args, mesh=None) -> int:
    """``--batch-size`` over the data-parallel ranks: the mesh's batch
    axes (the ranks of a context group share their rows), else every
    process."""
    from tpucfn_torch.launch import process_count

    n = process_count()
    if mesh is not None:
        from tpucfn_torch.collectives import axis_size
        from tpucfn_torch.mesh import BATCH_AXES

        n = axis_size(BATCH_AXES, mesh=mesh)
    if args.batch_size % n:
        raise SystemExit(
            f"--batch-size {args.batch_size} not divisible by "
            f"{n} processes"
        )
    return args.batch_size // n


def stage_synthetic(kind: str, data_dir: Path, *, n: int, num_shards: int,
                    seed: int = 0, **gen_kwargs):
    """Stage synthetic data once (real datasets go through the same
    ``write_dataset_shards`` path): ``cifar10``, ``imagenet`` (with
    ``image_size``), ``tokens`` or ``latents``."""
    from tpucfn_torch.data import (synthetic_cifar10, synthetic_imagenet,
                                   synthetic_latents, synthetic_tokens,
                                   write_dataset_shards)

    data_dir.mkdir(parents=True, exist_ok=True)
    existing = sorted(data_dir.glob("*.tpurec"))
    if existing:
        return existing
    gen = {
        "cifar10": synthetic_cifar10,
        "imagenet": synthetic_imagenet,
        "tokens": synthetic_tokens,
        "latents": synthetic_latents,
    }[kind]
    return write_dataset_shards(gen(n, seed=seed, **gen_kwargs), data_dir,
                                num_shards=num_shards)


def _clear_checkpoints(run_dir: Path) -> None:
    """``--fresh``: rank 0 deletes the checkpoints; every rank learns its
    outcome from a broadcast that is also the barrier, so a failed delete
    stops the whole group together."""
    import shutil

    from tpucfn_torch.launch import process_count, process_index

    delete_err = ""
    if process_index() == 0 and (run_dir / "ckpt").exists():
        shutil.rmtree(run_dir / "ckpt", ignore_errors=True)
        if (run_dir / "ckpt").exists():
            # A silent partial delete would recreate exactly the
            # stale-resume corruption --fresh exists to prevent.
            delete_err = (
                f"--fresh could not clear {run_dir / 'ckpt'} (shared-"
                "mount file still held open, or permissions?) — clear "
                "it manually or use a new --run-dir")
    if process_count() > 1:
        import torch.distributed as dist

        flag = [1 if delete_err else 0]
        dist.broadcast_object_list(flag, src=0)
        if flag[0]:
            raise RuntimeError(
                delete_err or "--fresh checkpoint clear failed on "
                "process 0 — see its log for the path")
    elif delete_err:
        raise RuntimeError(delete_err)


def served_or_local_batches(ds, start: int = 0, *, on_degrade=None,
                            env=None):
    """The loop's batches from batch ``start`` on (the step a resumed run
    restored), for ``ds.batches(None)``: without ``TPUCFN_INPUT_ADDRS``
    the local loader, else the input service's stream as the JAX
    package's ``service_or_local_batches`` builds it (a
    ``ResilientBatchStream`` that degrades to ``ds`` at the exact cursor,
    behind an ``AdaptivePrefetcher``).  The stream's cursor starts at
    ``start``, so the service streams and the local fallback resumes from
    the same batch.  ``on_degrade(reason, cursor)`` is told when, and at
    which batch, the stream fell back to local loading."""
    from tpucfn_torch.data.service import (INPUT_OP_DEADLINE_ENV,
                                           AdaptivePrefetcher,
                                           ResilientBatchStream,
                                           input_addrs_from_env)

    e = os.environ if env is None else env
    addrs = input_addrs_from_env(e)
    if not addrs:
        return itertools.islice(ds.batches(None), start, None)

    def local_factory(cursor):
        return itertools.islice(ds.batches(None), cursor, None)

    def degraded(reason):
        if on_degrade is not None:
            on_degrade(reason, stream.cursor)

    stream = ResilientBatchStream(
        addrs, ds.pi, local_factory=local_factory, process_count=ds.pc,
        batch_size=ds.batch, seed=ds.seed, num_epochs=None,
        on_degrade=degraded,
        rcvbuf_bytes=int(e.get("TPUCFN_INPUT_RCVBUF", "0") or 0) or None,
        op_deadline_s=float(e.get(INPUT_OP_DEADLINE_ENV, "0") or 0) or None,
        mp_workers=0)  # the fallback IS ds.batches(): plain loader order
    # Before the first batch: the first connection asks for the stream
    # from here, and a degrade before it resumes the local loader here.
    # (A resumed incarnation has no boot-skew retry window: a refused
    # first connect degrades at once, to the same batches.)
    stream.cursor = int(start)
    return AdaptivePrefetcher(stream)


def _synchronize(device) -> None:
    """Wait for the device: the step time is the step's, not its launch's."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_train_loop(trainer, ds, mesh, args, *, items_per_step, extra_axes=(),
                   eval_ds=None):
    """The shared epoch/step/checkpoint/metrics loop.  ``eval_ds`` +
    ``--eval-every N`` runs validation through the trainer's
    ``eval_step`` and logs ``eval_*`` metrics.  Returns the final state."""
    from tpucfn_torch.launch import process_index
    from tpucfn_torch.obs.flight import FlightRecorder
    from tpucfn_torch.obs.goodput import GoodputLedger
    from tpucfn_torch.obs.metrics import (MetricLogger, StepTimer,
                                          register_device_gauges,
                                          register_kernel_gauges)
    from tpucfn_torch.compilecache import kernels as kernel_cache
    from tpucfn_torch.obs.profiler import CompileCacheProbe, ProfileCapture
    from tpucfn_torch.obs.registry import set_default_labels
    from tpucfn_torch.obs.server import start_obs_server
    from tpucfn_torch.obs.trace import Tracer
    from tpucfn_torch.parallel import shard_batch
    from tpucfn_torch.train.trainer import TrainerObs

    refuse_unported_planes(args)
    if args.eval_every and eval_ds is None:
        raise SystemExit("--eval-every: this example has no held-out split "
                         "to evaluate")
    run_dir = Path(args.run_dir)
    if args.fresh:
        _clear_checkpoints(run_dir)
    timer = StepTimer()
    host = process_index()

    def run_eval(state, step):
        if eval_ds is None or not args.eval_every:
            return
        sums, n = {}, 0
        for host_batch in eval_ds.epoch(0):
            m = trainer.eval_step(state, shard_batch(mesh, host_batch, extra_axes))
            for k, v in m.items():
                sums[k] = sums.get(k, 0.0) + float(v)
            n += 1
        if n:
            logger.log(step, {f"eval_{k}": v / n for k, v in sums.items()})

    logger = tracer = obs_srv = hb = kcache = ledger = None
    try:
        logger = MetricLogger(run_dir / "logs", stdout_every=args.log_every)
        registry = set_default_labels(host=str(host), role="trainer")
        tracer = Tracer(run_dir / "trace", host_id=host, role="trainer")
        # The goodput ledger: every loop phase is attributed to a
        # wall-clock bucket in a per-host JSONL; a relaunch appends a new
        # window to the same file, which is how `obs goodput` sees
        # restart downtime and re-run steps, and what the provisioner
        # policy reads.
        ledger = GoodputLedger(run_dir / "goodput", host_id=host,
                               role="trainer")
        # The forensics plane: a bounded in-memory flight ring of
        # per-phase and card-memory samples, dumped to run_dir/flight on
        # SIGTERM/atexit and served live on /flightrecorder (where the
        # gang coordinator fetches it at detect time); device_hbm_* and
        # kernel_launches_* gauges on /metrics; an on-demand
        # torch.profiler capture behind POST /profile.
        flight = FlightRecorder(host_id=host, role="trainer")
        flight.install_dump_handlers(run_dir / "flight")
        register_device_gauges(registry, trainer.device)
        register_kernel_gauges(registry)
        profiler = ProfileCapture(run_dir / "profile", tracer=tracer)
        # Fleet warm start: with TPUCFN_COMPILE_CACHE_ADDRS (or a store
        # dir pinned) each kernel library the steps load comes from the
        # kernel directory, the artifact store, the fleet, or one nvcc
        # build that is then published; the probe tells TrainerObs what
        # the first step paid.  Unset: None, the kernels build as ever.
        # The CPU's plain paths load no library.
        compile_probe = CompileCacheProbe()
        if trainer.device.type == "cuda":
            from tpucfn_torch.compilecache import configure_from_env

            kcache = configure_from_env(tracer=tracer, registry=registry,
                                        probe=compile_probe)
        obs = TrainerObs(registry, tracer, ledger=ledger, flight=flight,
                         compile_probe=compile_probe)
        obs_srv = start_obs_server(
            registry, role="trainer", host_id=host,
            health_fn=lambda: (True, {"step": obs.last_step.value}),
            flight=flight, profiler=profiler, tracer=tracer)
        # The fault-tolerance plane: when the gang coordinator assigned
        # a heartbeat dir, a daemon thread beats liveness every interval
        # and the loop keeps the step fresh (update_step) so the monitor
        # can tell DEAD from STRAGGLER.
        ft_dir = os.environ.get("TPUCFN_FT_DIR", "").strip()
        if ft_dir:
            from tpucfn_torch.ft import HeartbeatWriter

            try:
                hb_s = float(os.environ.get("TPUCFN_FT_HEARTBEAT_S", "") or 1.0)
            except ValueError:
                hb_s = 1.0
            hb = HeartbeatWriter(ft_dir, host_id=host, interval_s=hb_s,
                                 role="trainer").start()
        t_start = time.perf_counter()
        return _train_loop_body(
            trainer, ds, mesh, args, items_per_step, extra_axes, run_eval,
            logger, timer, obs, t_start, run_dir, tracer, hb, profiler,
            kcache)
    finally:
        if kcache is not None and kernel_cache.installed() is kcache:
            kernel_cache.install(None)
        if logger is not None:
            logger.close()
        if tracer is not None:
            tracer.close()
        if ledger is not None:
            ledger.close()
        if obs_srv is not None:
            obs_srv.close()
        if hb is not None:
            # Last, after one more beat: the coordinator judges the rank
            # by its beats' age until the process has exited.
            hb.beat()
            hb.stop()


def exit_process(rc) -> None:
    """End an example's process with ``rc``.  Under the gang coordinator
    (``TPUCFN_FT_DIR`` set) the loop's heartbeat has stopped, and the
    coordinator calls a rank dead once its beats have been silent for six
    intervals while the process lives: the interpreter's own teardown of
    a process on the card (the process group, the CUDA context, torch's
    modules) can outlast that.  So there the process joins its threads,
    runs its exit handlers (the flight ring's dump, the reaping of
    spawned loader workers), flushes and leaves with ``os._exit``;
    elsewhere it exits as usual."""
    import sys

    if not os.environ.get("TPUCFN_FT_DIR", "").strip():
        raise SystemExit(rc)
    import atexit
    import threading

    for t in threading.enumerate():
        if t is not threading.main_thread() and not t.daemon:
            t.join()
    atexit._run_exitfuncs()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(int(rc or 0))


def _compile_cache_counters(kcache, build) -> dict:
    """The kernel-library cache's counters so far and the nvcc processes
    this process started, for a log row (empty without a cache)."""
    if kcache is None:
        return {}
    values = kcache.client.registry.varz()["metrics"]
    return {**{k: values.get(k, 0.0) for k in COMPILE_CACHE_COUNTERS},
            "kernel_nvcc_runs": build.nvcc_runs}


def _train_loop_body(trainer, ds, mesh, args, items_per_step, extra_axes,
                     run_eval, logger, timer, obs, t_start, run_dir, tracer,
                     hb=None, profiler=None, kcache=None):
    import contextlib

    import torch

    from tpucfn_torch.ckpt import CheckpointManager
    from tpucfn_torch.data import prefetch_to_device
    from tpucfn_torch.ft import RESTORE_FAILED_RC, drain_requested
    from tpucfn_torch.kernels import _build
    from tpucfn_torch.launch import process_count, process_index
    from tpucfn_torch.obs.goodput import device_peak_flops
    from tpucfn_torch.obs.metrics import kernel_launch_counts
    from tpucfn_torch.obs.profiler import profile_steps
    from tpucfn_torch.parallel import shard_batch
    from tpucfn_torch.train.trainer import RestoreFailure

    device = trainer.device
    ft_dir = os.environ.get("TPUCFN_FT_DIR", "").strip()
    with CheckpointManager(run_dir / "ckpt",
                           save_interval_steps=args.ckpt_every,
                           tracer=tracer) as ckpt:
        # Restart implies resume: a relaunched job picks up at its latest
        # checkpoint; --fresh opts out.
        try:
            state, resumed = trainer.init_or_resume(args.seed, ckpt,
                                                    fresh=args.fresh)
        except RestoreFailure as e:
            # The coordinator catches this rc, blacklists the bad step,
            # and retries from the previous finalized one.
            print(f"checkpoint restore failed: {e}", flush=True)
            raise SystemExit(RESTORE_FAILED_RC)
        if resumed is not None:
            print(f"resumed from step {state.step}", flush=True)

        total = args.steps or len(ds) * args.num_epochs
        halt = min(total, args.stop_after) if args.stop_after else total
        metrics = {}
        step = state.step
        # A resumed run skips the batches its restored steps consumed,
        # served or loaded here.  With input hosts fanned out
        # (TPUCFN_INPUT_ADDRS) the batches are the service's until no
        # host answers, then this host's own from the exact cursor.
        degraded = {}

        def on_degrade(reason, cursor):
            degraded.update(reason=reason, cursor=cursor, wall=time.time())
            print(f"input plane degraded to local loading at batch "
                  f"{cursor}: {reason}", flush=True)

        stream = served_or_local_batches(ds, step, on_degrade=on_degrade)
        batches = iter(prefetch_to_device(stream, device))
        # The stream queues one wire context per batch it yields;
        # popping one per batch consumed keeps the pairing exact through
        # the prefetch (a local loader has none: every wait is local).
        pop_link = getattr(stream, "pop_link", None)
        degrade_logged = False
        _end = object()
        with contextlib.ExitStack() as planes:
            planes.enter_context(profile_steps(run_dir / "profile",
                                               enabled=args.profile))
            if profiler is not None:
                # POST /profile captures run on this thread, between steps
                planes.enter_context(profiler.attach_loop())
            while True:
                # data_wait vs step vs ckpt: the three spans that say WHY a
                # slow step was slow.  The wait is recorded only once the
                # loop commits to a step, so the end-of-data drain never
                # shows up as a phantom step's data wait.
                t0_wait = time.monotonic()
                batch = next(batches, _end)
                t_wait = time.monotonic() - t0_wait
                if batch is _end or step >= halt:
                    break
                obs.record_data_wait(
                    step + 1, t0_wait, t_wait,
                    link=pop_link() if pop_link is not None else None)
                if extra_axes:  # this rank's block of each split dim
                    batch = shard_batch(mesh, batch, extra_axes)
                with obs.step(step + 1):
                    state, metrics = trainer.step(state, batch)
                    step = state.step
                    _synchronize(device)  # honest step timing
                if hb is not None:
                    hb.update_step(step)  # step-lag signal for the monitor
                if profiler is not None:
                    profiler.step_boundary()
                timer.tick()
                if t_start is not None:
                    # data staging + init/restore + kernel builds + first step
                    logger.log(step, {"time_to_first_step": round(
                        time.perf_counter() - t_start, 2)})
                    t_start = None
                    # Live MFU: the step's analytic FLOPs over the card's
                    # peak (no peak entry, e.g. the CPU: the gauge stays
                    # unset).
                    kind = (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else device.type)
                    peak = device_peak_flops(kind)
                    if peak is not None:
                        obs.set_model_flops(trainer.step_cost_flops(batch),
                                            peak)
                if step % args.log_every == 0 or step == halt:
                    # with the flash kernels' launches so far (those
                    # launched at all): which kernels the steps ran, read
                    # exactly from the log, also of a rank later killed
                    logger.log(step, {
                        **{k: float(v) for k, v in metrics.items()},
                        "step_time": timer._last or 0.0,
                        "data_wait_time": t_wait,
                        **{k: n for k, n in kernel_launch_counts().items()
                           if n},
                        **_compile_cache_counters(kcache, _build)})
                if degraded and not degrade_logged:
                    # logged by this thread (the callback runs on the
                    # prefetch thread): when, and from which batch on,
                    # the batches are this host's own
                    logger.log(step, {"input_degraded_cursor":
                                      degraded["cursor"],
                                      "input_degraded_wall":
                                      degraded["wall"]})
                    degrade_logged = True
                if args.eval_every and step % args.eval_every == 0:
                    run_eval(state, step)
                # CheckpointManager gates on save_interval_steps; record
                # the span only when a save actually ran.
                t0_ckpt = time.monotonic()
                if ckpt.save(step, state):
                    obs.record_ckpt(step, t0_ckpt, time.monotonic() - t0_ckpt)
                # Preemption drain: the coordinator asked the gang to stop
                # cleanly at a step boundary; the final force-save below
                # is the drain's zero-lost-work save.
                if ft_dir and drain_requested(ft_dir, step):
                    print(f"preemption drain: stopping cleanly at step "
                          f"{step}", flush=True)
                    break
        batches.close()  # stops the prefetch thread
        # A step-target or drain exit leaves a service stream live (its
        # socket, the input host's producer, buffered batches): close it.
        close_stream = getattr(stream, "close", None)
        if close_stream is not None:
            try:
                close_stream()
            except ValueError:
                pass  # a local generator still running in the prefetch thread
        run_eval(state, state.step)
        t0_ckpt = time.monotonic()
        if ckpt.save(state.step, state, force=True):
            obs.record_ckpt(state.step, t0_ckpt, time.monotonic() - t0_ckpt)

    if process_index() == 0:
        ips = timer.throughput(items_per_step)
        loss = float(metrics.get("loss", float("nan")))
        line = f"final: step={state.step} loss={loss:.4f}"
        if ips:  # needs steady-state steps beyond the warmup
            line += (f" items/sec={ips:.1f}"
                     f" items/sec/chip={ips / process_count():.1f}")
        print(line, flush=True)
    return state
