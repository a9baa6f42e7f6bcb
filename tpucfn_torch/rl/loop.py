"""The fleet-integrated RL loop: act → push → pop → learn → refresh (the
port of ``tpucfn/rl/loop.py``).

One host's whole life, wired into every plane the port has:

* **obs**: registry metrics (``rl_*`` on the per-host ``/metrics``
  endpoint), trace spans per phase, a flight-recorder ring, and the
  goodput ledger with the RL phases first-class: ``act`` / ``learn`` /
  ``refresh`` buckets next to ``compile`` and ``ckpt``, so ``obs
  goodput`` decomposes an RL run's wall clock as it does a supervised
  one.
* **ft**: heartbeats (``TPUCFN_FT_DIR``), resume from the latest
  checkpoint at start, ``RESTORE_FAILED_RC`` on a corrupt one (the
  coordinator's blacklist-and-retry path), drain requests, and the
  ``rl_run_start`` / ``rl_resumed`` event rows.
* **chaos coherence**: everything the next iteration depends on
  (learner state, env state and obs, queue ring and counters, the
  iteration) is one checkpoint, saved synchronously, and every random
  draw comes from a generator seeded afresh from ``(seed, i)`` at its
  use (:func:`fold_in`: 0 for the init, 1 for the env reset, 2 + it for
  iteration ``it``'s rollout).  No generator state runs across
  iterations, so a host restored at iteration k replays k+1..N bit for
  bit.  The draws are not JAX's threefry draws.

Per-iteration results append to ``rl-host{NNN}.jsonl`` (loss, reward,
entropy, queue counters, pid), with the reference's keys: the
trajectory the recovery drill compares with an uninterrupted run.

Placement (the counterpart of ``actor_plane_shardings``): under a group
of W ranks each rank acts ``num_envs / W`` envs when W divides
``num_envs`` (its draws seeded with its rank too), and all of them
otherwise (replicated, the reference's fallback); the learner is the
``Trainer``'s data-parallel mean.  A checkpoint holds the global env,
obs and ring (gathered from the ranks), so it restores onto any W that
divides ``num_envs``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from pathlib import Path


@dataclasses.dataclass(frozen=True)
class RLConfig:
    """One RL run, as the CLI / examples configure it."""

    run_dir: str = "/tmp/tpucfn-rl"
    env: str = "bandit"          # tpucfn_torch.rl.env.ENVS name
    num_envs: int = 8            # the learner batch, over every rank
    unroll: int = 16             # env steps per rollout slab
    iters: int = 100             # learner updates (the run budget)
    hidden: int = 64
    lr: float = 1e-2
    gamma: float = 0.99
    entropy_coef: float = 0.01
    seed: int = 0
    ckpt_every: int = 25
    log_every: int = 10
    queue_capacity: int = 4
    stop_after: int = 0          # halt at iter N without changing budget
    fresh: bool = False
    iter_sleep_s: float = 0.0    # drill pacing: sleep per iter (idle time)
    device: str = "cuda"         # "cpu" runs the same loop on the CPU


class RLObs:
    """TrainerObs's phase discipline for the RL loop's phases.

    ``act`` / ``learn`` / ``refresh`` each land a registry metric, a
    trace span, a goodput-ledger row, and a flight sample.  The first
    iteration's act+learn wall time is compile-dominated and charged to
    the ``compile`` bucket (the StepTimer warmup-exclusion rule), so
    steady-state ``act``/``learn`` shares stay honest.
    """

    def __init__(self, registry=None, tracer=None, *, ledger=None,
                 flight=None, clock=time.monotonic):
        from tpucfn_torch.obs.goodput import GoodputLedger
        from tpucfn_torch.obs.registry import default_registry
        from tpucfn_torch.obs.trace import Tracer

        r = self.registry = (registry if registry is not None
                             else default_registry())
        self.tracer = tracer if tracer is not None else Tracer(None)
        self.ledger = ledger if ledger is not None else GoodputLedger(None)
        self.flight = flight
        self.clock = clock
        self.act_time = r.histogram(
            "rl_act_seconds", "actor rollout wall time (one slab)")
        self.learn_time = r.histogram(
            "rl_learn_seconds", "learner update wall time (one slab)")
        self.refresh_time = r.summary(
            "rl_refresh_seconds",
            "actor param refresh wall time (device-to-device copy)")
        self.iters_total = r.counter(
            "rl_iterations_total", "completed act+learn+refresh iterations")
        self.env_steps_total = r.counter(
            "rl_env_steps_total", "env steps advanced across all envs")
        self.spilled_total = r.counter(
            "rl_spilled_total",
            "trajectory slabs spilled to host memory (queue overflow)")
        self.return_g = r.gauge(
            "rl_episode_return", "mean per-step reward of the last slab")
        self.last_iter_g = r.gauge("rl_last_iter", "most recent iteration")
        self.queue_depth_g = r.gauge(
            "rl_queue_depth", "slabs queued (device ring + host spill)")
        self._iters_seen = 0
        self._compile_s = 0.0

    @contextlib.contextmanager
    def phase(self, name: str, metric, it: int | None):
        t0 = self.clock()
        try:
            yield
        finally:
            dt = self.clock() - t0
            metric.observe(dt)
            self.tracer.record(name, start=t0, dur_s=dt, trace_id=it)
            if self._iters_seen == 0 and name in ("act", "learn", "refresh"):
                # first iteration: compile-dominated, charged as compile
                self.ledger.account("compile", dt, step=it)
            else:
                self.ledger.account(name, dt, step=it)
            if self.flight is not None:
                self.flight.record(name, step=it, dur_s=dt)

    def act(self, it):
        return self.phase("act", self.act_time, it)

    def learn(self, it):
        return self.phase("learn", self.learn_time, it)

    def refresh(self, it):
        return self.phase("refresh", self.refresh_time, it)

    def ckpt(self, it):
        return self.phase("ckpt", self.ckpt_time, it)

    @property
    def ckpt_time(self):
        return self.registry.summary(
            "rl_ckpt_seconds", "checkpoint save-call time")

    def iteration_done(self, it: int, env_steps: int) -> None:
        self._iters_seen += 1
        self.iters_total.add()
        self.env_steps_total.add(env_steps)
        self.last_iter_g.set(it)


def _host_id() -> int:
    """Rank inside a launch fan-out: the launcher's env contract wins,
    else the process group's rank."""
    env = os.environ.get("TPUCFN_HOST_ID", "").strip()
    if env:
        try:
            return int(env)
        except ValueError:
            pass
    from tpucfn_torch.launch import process_index

    return process_index()


# -- random streams --------------------------------------------------------

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def fold_in(seed: int, i: int) -> int:
    """The seed of stream ``i`` under ``seed``: a fixed integer mix
    (splitmix64), the counterpart of ``jax.random.fold_in``; 63 bits."""
    return _splitmix64(_splitmix64(seed & _MASK64) ^ (i & _MASK64)) >> 1


def _generator(device, seed: int):
    import torch

    return torch.Generator(device=device).manual_seed(seed)


# -- placement -------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ActorPlacement:
    """Where the actor plane's envs live across ``world`` ranks:
    ``sharded`` (each rank acts ``num_envs / world`` envs) when world > 1
    divides ``num_envs``, else every rank acts all of them."""

    world: int
    rank: int
    num_envs: int

    @property
    def sharded(self) -> bool:
        return self.world > 1 and self.num_envs % self.world == 0

    @property
    def local_envs(self) -> int:
        return self.num_envs // self.world if self.sharded else self.num_envs

    def stream(self, seed: int, i: int) -> int:
        """Stream ``i``'s seed on this rank: a sharded rank's envs draw
        their own numbers; replicated ranks draw the same ones."""
        s = fold_in(seed, i)
        return fold_in(s, self.rank) if self.sharded else s

    def gather(self, t, dim: int = 0):
        """The global tensor from every rank's slice along ``dim`` (a
        collective: every rank calls it); ``t`` itself unless sharded."""
        if not self.sharded:
            return t
        import torch
        import torch.distributed as dist

        src = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.world)]
        dist.all_gather(parts, src)
        out = torch.cat(parts, dim=dim)
        return out.bool() if t.dtype == torch.bool else out

    def local(self, t, dim: int = 0):
        """This rank's slice of a global tensor along ``dim``."""
        if not self.sharded:
            return t
        n = t.shape[dim] // self.world
        return t.narrow(dim, self.rank * n, n).clone()


class _Stack:
    """The checkpointed whole: learner ``TrainState``, env state and obs,
    the queue (ring slots and counters) and the iteration, in the global
    layout, as one flat dict of tensors (``CheckpointManager``'s
    ``state_dict`` / ``load_state_dict`` protocol)."""

    def __init__(self, train, env, obs, queue, it: int):
        self.train, self.env, self.obs, self.queue = train, env, obs, queue
        self.it = it

    def state_dict(self):
        import torch

        sd = {f"train/{k}": v for k, v in self.train.state_dict().items()}
        sd.update({f"env/{k}": v for k, v in self.env.items()})
        sd["obs"] = self.obs
        for k, v in self.queue.items():
            if k == "slots":
                sd.update({f"queue/slots/{s}": t for s, t in v.items()})
            else:
                sd[f"queue/{k}"] = v
        sd["iter"] = torch.tensor(self.it, dtype=torch.int64)
        return sd

    def load_state_dict(self, sd) -> None:
        import torch

        self.train.load_state_dict({k[len("train/"):]: v
                                    for k, v in sd.items()
                                    if k.startswith("train/")})
        with torch.no_grad():
            for k, v in self.env.items():
                v.copy_(sd[f"env/{k}"])
            self.obs.copy_(sd["obs"])
            for k, v in self.queue["slots"].items():
                v.copy_(sd[f"queue/slots/{k}"])
        for k in self.queue:
            if k != "slots":
                self.queue[k] = sd[f"queue/{k}"].clone()
        self.it = int(sd["iter"])


def _stack(place, state, env_state, env_obs, qstate, it):
    """The global stack from this rank's local tensors (a collective
    under a sharded placement)."""
    queue = {k: ({s: place.gather(t, 1) for s, t in v.items()}
                 if k == "slots" else v) for k, v in qstate.items()}
    return _Stack(state, {k: place.gather(v) for k, v in env_state.items()},
                  place.gather(env_obs), queue, it)


def _synchronize(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_rl_loop(cfg: RLConfig):
    """Run one host's RL loop to completion; returns final stats."""
    from tpucfn_torch.device import resolve_device
    from tpucfn_torch.launch import process_count, process_index
    from tpucfn_torch.obs.flight import FlightRecorder
    from tpucfn_torch.obs.goodput import GoodputLedger
    from tpucfn_torch.obs.registry import set_default_labels
    from tpucfn_torch.obs.server import start_obs_server
    from tpucfn_torch.obs.trace import Tracer
    from tpucfn_torch.rl.actor import Actor
    from tpucfn_torch.rl.env import make_env
    from tpucfn_torch.rl.learner import RLLearner
    from tpucfn_torch.rl.replay import ReplayQueue

    host = _host_id()
    run_dir = Path(cfg.run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    ft_dir = os.environ.get("TPUCFN_FT_DIR", "").strip()

    device = resolve_device(cfg.device)
    place = ActorPlacement(process_count(), process_index(), cfg.num_envs)
    mesh = None
    if place.world > 1:
        from tpucfn_torch.mesh import MeshSpec, build_mesh, mesh_device

        mesh = build_mesh(MeshSpec.for_devices(place.world),
                          device_type=device.type)
        device = mesh_device(mesh)
    if device.type == "cuda":
        # the CUDA context now, before the heartbeats start: its creation
        # is a long call that the heartbeat thread would wait behind
        import torch

        torch.empty(1, device=device)
    env = make_env(cfg.env, place.local_envs, device=device)
    learner = RLLearner(mesh, env, hidden=cfg.hidden, lr=cfg.lr,
                        gamma=cfg.gamma, entropy_coef=cfg.entropy_coef)
    actor = Actor(env, learner.apply_fn, unroll=cfg.unroll)
    queue = ReplayQueue(cfg.queue_capacity)

    tracer = obs_srv = hb = ledger = None
    registry = set_default_labels(host=str(host), role="rl")
    try:
        tracer = Tracer(run_dir / "trace", host_id=host, role="rl")
        ledger = GoodputLedger(run_dir / "goodput", host_id=host, role="rl")
        flight = FlightRecorder(host_id=host, role="rl")
        flight.install_dump_handlers(run_dir / "flight")
        # No kernel library runs on this path, so the fleet compile
        # cache (configure_from_env in the JAX loop) has nothing to serve.
        obs = RLObs(registry, tracer, ledger=ledger, flight=flight)
        obs_srv = start_obs_server(
            registry, role="rl", host_id=host,
            health_fn=lambda: (True, {"iter": obs.last_iter_g.value}),
            flight=flight)
        if ft_dir:
            from tpucfn_torch.ft import HeartbeatWriter

            try:
                hb_s = float(os.environ.get("TPUCFN_FT_HEARTBEAT_S", "")
                             or 1.0)
            except ValueError:
                hb_s = 1.0
            hb = HeartbeatWriter(ft_dir, host_id=host, interval_s=hb_s,
                                 role="rl").start()
        return _rl_loop_body(cfg, host, run_dir, ft_dir, place, learner,
                             actor, queue, obs, hb)
    finally:
        if tracer is not None:
            tracer.close()
        if ledger is not None:
            ledger.close()
        if obs_srv is not None:
            obs_srv.close()
        if hb is not None:
            # last, after one more beat: the coordinator judges the rank
            # by its beats' age until the process has exited
            hb.beat()
            hb.stop()


def _rl_loop_body(cfg, host, run_dir, ft_dir, place, learner, actor, queue,
                  obs, hb):
    import torch

    from tpucfn_torch.ckpt import CheckpointManager
    from tpucfn_torch.ft import RESTORE_FAILED_RC, drain_requested

    device = actor.env.device
    # One checkpoint per host: learner TrainState + env state/obs + queue
    # ring + the iteration counter.  Saves are synchronous (tiny states)
    # so a finalized step on disk is always a coherent whole-stack
    # snapshot: the chaos drill's resume anchor.
    with CheckpointManager(run_dir / "ckpt", async_save=False,
                           save_interval_steps=cfg.ckpt_every) as ckpt:
        state = learner.init(fold_in(cfg.seed, 0))
        env_state, env_obs = actor.reset(
            _generator(device, place.stream(cfg.seed, 1)))
        qstate = queue.init_state(_example_slab(actor, learner, state,
                                                env_state, env_obs))
        latest = None if cfg.fresh else ckpt.latest_step()
        resumed = None
        it = 0
        if latest is not None:
            full = _stack(place, state, env_state, env_obs, qstate, 0)
            try:
                ckpt.restore(full)
            except Exception as e:  # noqa: BLE001 — corrupt artifact
                # Distinguishable rc: the coordinator blacklists the bad
                # step and relaunches to retry from the previous one.
                print(f"rl checkpoint restore of step {latest} failed: {e}",
                      flush=True)
                raise SystemExit(RESTORE_FAILED_RC)
            resumed, it = latest, full.it
            env_state = {k: place.local(v) for k, v in full.env.items()}
            env_obs = place.local(full.obs)
            qstate = {k: ({s: place.local(t, 1) for s, t in v.items()}
                          if k == "slots" else v)
                      for k, v in full.queue.items()}
            print(f"rl resumed from iteration {it}", flush=True)
        if ft_dir and host == 0:
            from tpucfn_torch.ft.events import append_event

            if resumed is None:
                append_event(ft_dir, "rl_run_start", env=cfg.env,
                             iters=cfg.iters, num_envs=cfg.num_envs,
                             unroll=cfg.unroll)
            else:
                append_event(ft_dir, "rl_resumed", iteration=it,
                             ckpt_step=resumed)

        halt = min(cfg.iters, cfg.stop_after) if cfg.stop_after else cfg.iters
        rows = run_dir / f"rl-host{host:03d}.jsonl"
        metrics = {}
        env_steps = actor.unroll * cfg.num_envs
        # actors start from the current learner params — on a resumed run
        # that is the RESTORED policy, not a fresh one (refresh is the
        # only path params ever take to the actor plane)
        actor_params = learner.refresh(state)
        with open(rows, "a") as rows_f:
            while it < halt:
                it += 1
                # -- act: one rollout slab, queued without a host sync ---
                with obs.act(it):
                    env_state, env_obs, traj = actor.rollout(
                        actor_params, env_state, env_obs,
                        _generator(device, place.stream(cfg.seed, 2 + it)))
                    _synchronize(device)
                qstate = queue.push(qstate, traj)
                obs.queue_depth_g.set(queue.size(qstate))
                if queue.spilled_total > obs.spilled_total.value:
                    obs.spilled_total.add(queue.spilled_total
                                          - obs.spilled_total.value)
                # -- learn: pop oldest slab, one A2C update ----------------
                qstate, slab = queue.pop(qstate)
                with obs.learn(it):
                    state, metrics = learner.step(state, slab)
                    _synchronize(device)
                # -- refresh: the actors' own copy, on the device ----------
                with obs.refresh(it):
                    actor_params = learner.refresh(state)
                    _synchronize(device)
                metrics = dict(zip(metrics, torch.stack(
                    [v.detach().float() for v in metrics.values()]).tolist()))
                obs.return_g.set(metrics["reward_mean"])
                obs.iteration_done(it, env_steps)
                if hb is not None:
                    hb.update_step(it)
                rows_f.write(json.dumps({
                    "iter": it, "pid": os.getpid(),
                    "loss": metrics["loss"],
                    "reward_mean": metrics["reward_mean"],
                    "entropy": metrics["entropy"],
                    "pushed": int(qstate["pushed"]),
                    "popped": int(qstate["popped"])}) + "\n")
                rows_f.flush()
                if it % cfg.log_every == 0 or it == halt:
                    print(f"iter={it} loss={metrics['loss']:.4f} "
                          f"reward={metrics['reward_mean']:.4f}",
                          flush=True)
                # -- checkpoint: whole-stack snapshot at queue quiescence --
                full = (_stack(place, state, env_state, env_obs, qstate, it)
                        if place.sharded or host == 0 else None)
                if host == 0:
                    queue.assert_quiescent()
                    t0 = time.monotonic()
                    if ckpt.save(it, full):
                        obs.ckpt_time.observe(time.monotonic() - t0)
                        obs.tracer.record("ckpt", start=t0,
                                          dur_s=time.monotonic() - t0,
                                          trace_id=it)
                        obs.ledger.account("ckpt", time.monotonic() - t0,
                                           step=it)
                if cfg.iter_sleep_s:
                    time.sleep(cfg.iter_sleep_s)
                if ft_dir and drain_requested(ft_dir, it):
                    print(f"preemption drain: stopping cleanly at "
                          f"iteration {it}", flush=True)
                    break
            full = (_stack(place, state, env_state, env_obs, qstate, it)
                    if place.sharded or host == 0 else None)
            if host == 0:
                queue.assert_quiescent()
                ckpt.save(it, full, force=True)

    loss = metrics.get("loss", float("nan"))
    reward = metrics.get("reward_mean", float("nan"))
    print(f"final: step={it} loss={loss:.4f} reward={reward:.4f}",
          flush=True)
    return {"iter": it, "loss": loss, "reward_mean": reward,
            "spilled": queue.spilled_total}


def _example_slab(actor, learner, state, env_state, env_obs):
    """Shape template for the queue ring: one rollout on a throwaway
    generator (the env state it is given is left as it was), as zeros."""
    import torch

    _, _, traj = actor.rollout(learner.refresh(state), env_state, env_obs,
                               _generator(actor.env.device, 0))
    return {k: torch.zeros_like(v) for k, v in traj.items()}
