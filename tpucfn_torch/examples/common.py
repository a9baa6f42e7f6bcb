"""The training loop the port's examples share (the port of
``examples/common.py``).

:func:`run_train_loop` keeps the JAX loop's structure: ``--fresh`` clears
the checkpoints (rank 0, then a barrier that carries its outcome),
``init_or_resume`` restores the latest step or starts fresh (a step that
will not restore exits with ``RESTORE_FAILED_RC``), then ``data_wait ->
step -> ckpt`` per step through :class:`TrainerObs` (trace spans and
registry metrics) with interval saves, ``--stop-after``, ``--eval-every``,
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

Refuse, never skip: with ``TPUCFN_INPUT_ADDRS`` (the input service) or
``TPUCFN_COMPILE_CACHE_ADDRS`` (the compile cache) set, or with
``--profile-server`` (XProf's live attach, which has no PyTorch
counterpart: ``POST /profile`` captures instead), the loop exits
non-zero and names what is missing.
"""

from __future__ import annotations

import argparse
import itertools
import os
import time
from pathlib import Path

# (env var, plane, ROADMAP item) for each plane the loop refuses.
UNPORTED_PLANES = (
    ("TPUCFN_INPUT_ADDRS", "the disaggregated input service", "Queue 1 B2"),
    ("TPUCFN_COMPILE_CACHE_ADDRS", "the fleet compile cache", "Queue 1 B4"),
)


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
    """Exit non-zero, naming the plane and its ROADMAP item, when the env
    or the flags ask for a plane the port does not have."""
    for var, plane, item in UNPORTED_PLANES:
        if os.environ.get(var, "").strip():
            raise SystemExit(
                f"{var} is set: {plane} is not ported to tpucfn_torch yet "
                f"(ROADMAP {item}); refusing to train without it")
    if getattr(args, "profile_server", 0):
        raise SystemExit(
            "--profile-server: XProf's live profiler server has no PyTorch "
            "counterpart in tpucfn_torch (ROADMAP Queue 1 B3, kept as a "
            "gap); capture a live rank with POST /profile?seconds=S on its "
            "obs port (TPUCFN_OBS_PORT) instead")


def per_process_batch(args) -> int:
    from tpucfn_torch.launch import process_count

    if args.batch_size % process_count():
        raise SystemExit(
            f"--batch-size {args.batch_size} not divisible by "
            f"{process_count()} processes"
        )
    return args.batch_size // process_count()


def stage_synthetic(kind: str, data_dir: Path, *, n: int, num_shards: int,
                    seed: int = 0, **gen_kwargs):
    """Stage synthetic data once (real datasets go through the same
    ``write_dataset_shards`` path).  ``tokens`` only: the image and latent
    generators wait with their models."""
    from tpucfn_torch.data import synthetic_tokens, write_dataset_shards

    data_dir.mkdir(parents=True, exist_ok=True)
    existing = sorted(data_dir.glob("*.tpurec"))
    if existing:
        return existing
    if kind != "tokens":
        raise NotImplementedError(f"synthetic {kind!r} data is not ported")
    return write_dataset_shards(synthetic_tokens(n, seed=seed, **gen_kwargs),
                                data_dir, num_shards=num_shards)


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
    from tpucfn_torch.obs.metrics import (MetricLogger, StepTimer,
                                          register_device_gauges,
                                          register_kernel_gauges)
    from tpucfn_torch.obs.profiler import ProfileCapture
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

    logger = tracer = obs_srv = hb = None
    try:
        logger = MetricLogger(run_dir / "logs", stdout_every=args.log_every)
        registry = set_default_labels(host=str(host), role="trainer")
        tracer = Tracer(run_dir / "trace", host_id=host, role="trainer")
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
        obs = TrainerObs(registry, tracer, flight=flight)
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
            logger, timer, obs, t_start, run_dir, tracer, hb, profiler)
    finally:
        if hb is not None:
            hb.stop()
        if logger is not None:
            logger.close()
        if tracer is not None:
            tracer.close()
        if obs_srv is not None:
            obs_srv.close()


def _train_loop_body(trainer, ds, mesh, args, items_per_step, extra_axes,
                     run_eval, logger, timer, obs, t_start, run_dir, tracer,
                     hb=None, profiler=None):
    import contextlib

    import torch

    from tpucfn_torch.ckpt import CheckpointManager
    from tpucfn_torch.data import prefetch_to_device
    from tpucfn_torch.ft import RESTORE_FAILED_RC, drain_requested
    from tpucfn_torch.launch import process_count, process_index
    from tpucfn_torch.obs.goodput import device_peak_flops
    from tpucfn_torch.obs.metrics import kernel_launch_counts
    from tpucfn_torch.obs.profiler import profile_steps
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
        # A resumed run skips the batches its restored steps consumed.
        stream = itertools.islice(ds.batches(None), step, None)
        batches = iter(prefetch_to_device(stream, device))
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
                obs.record_data_wait(step + 1, t0_wait, t_wait)
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
                           if n}})
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
