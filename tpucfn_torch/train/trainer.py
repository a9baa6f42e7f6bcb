"""The trainer (the port of ``Trainer``, ``RestoreFailure`` and
``TrainerObs`` in ``tpucfn/train/trainer.py``).

The JAX trainer compiles (loss, gradient, optimizer update) into one
SPMD program over a mesh.  This one runs the same step eagerly on this
process's device: the loss and its gradient through autograd, then the
optimizer chain in place.

    trainer = Trainer(mesh, rules, loss_fn, tx, init_fn)
    state, resumed = trainer.init_or_resume(seed, ckpt)
    state, metrics = trainer.step(state, batch)   # batch: this rank's rows

``mesh`` (:func:`tpucfn_torch.mesh.build_mesh`) and ``rules``
(:class:`tpucfn_torch.parallel.ShardingRules`) may both be None: one
device, no group.  With a mesh the trainer runs data parallel over its
ranks: rank 0's parameters are broadcast at ``init``; after the
microbatches of ``grad_accum`` the gradients are averaged across the
ranks with one coalesced ``all_reduce``, before the optimizer chain (and
so before its global-norm clip), as JAX's mean loss over the sharded
global batch gives; the returned loss and metrics are averaged the same
way.  A loss that averages over a count that differs between ranks
(the packed loss: each rank's valid positions) passes ``loss_weight``,
that count for a batch: each rank's loss, metrics and gradients are then
weighted by its share of the group's count (per microbatch under
``grad_accum``), so the result is the global mean that JAX's loss over
the whole batch gives.  A rule that
places a parameter on a mesh axis of size > 1 (FSDP, tensor
parallelism) is refused (ROADMAP C2), and so is any axis of size > 1
outside the batch axes (pipeline C5, context C3, tensor C2).  Not ported:
the sgd chain and ``donate_state`` (A4), and the compile warm start (D2).

``loss_fn(params, model_state, batch, generator) -> (loss, (aux,
new_model_state))`` and ``init_fn(generator) -> (params, model_state)``
keep the JAX signatures; ``params`` is a dict of tensors.
:class:`TrainerObs` is a copy of the JAX package's class (held equal by
``tests/test_torch_isolation.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable

import torch
from torch import nn

from tpucfn_torch.device import resolve_device
from tpucfn_torch.train.state import TrainState

LossFn = Callable[[dict, dict, dict, torch.Generator],
                  tuple[torch.Tensor, tuple[dict, dict]]]
InitFn = Callable[[torch.Generator], tuple[dict, dict]]


class RestoreFailure(RuntimeError):
    """A checkpoint EXISTS but restoring it failed (corruption,
    truncation, a half-written save that slipped past finalization).

    Distinct from "no checkpoint" (which quietly falls back to a fresh
    init) because the two demand opposite recoveries: a missing
    checkpoint means start over, a corrupt one means *retry from the
    previous step* — the trainer's caller should exit with
    ``tpucfn.ft.RESTORE_FAILED_RC`` so the gang coordinator can
    blacklist the bad step instead of crash-looping into give_up
    (ISSUE 7).

    Deliberately broad: any failure restoring an existing checkpoint
    maps here, including non-corruption causes (a sharding/config
    mismatch, a transient allocator failure).  The coordinator's
    response is bounded (``max_ckpt_retries``) and reversible — a
    "quarantined" step is a plain rename into ``<ckpt>/corrupt/`` the
    operator can move back — and with no earlier step to resume from
    it declines to retry and fails loudly rather than re-init fresh."""

    def __init__(self, step: int, cause: BaseException):
        super().__init__(
            f"restoring checkpoint step {step} failed: {cause!r}")
        self.step = step


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    # Accepted for the JAX signature and ignored: the port always updates
    # the state's tensors in place, which is what donation buys in JAX.
    donate_state: bool = True
    # Split each batch into this many microbatches along dim 0, run them
    # one after another, and average their grads, losses and aux.
    grad_accum: int = 1
    # Exponential moving average of the params, tracked post-update under
    # model_state["ema"]; 0.0 disables.
    ema_decay: float = 0.0


class Trainer:
    """Binds (mesh, rules, loss, optimizer chain, init) into ``init``/
    ``init_or_resume``/``step``/``eval_step`` on this process's device: the
    mesh's, else the card unless ``device`` says otherwise."""

    def __init__(self, mesh, rules, loss_fn: LossFn, tx, init_fn: InitFn,
                 config: TrainerConfig = TrainerConfig(),
                 eval_loss_fn: LossFn | None = None, *,
                 device: str | torch.device | None = None,
                 step_flops: Callable[[dict], float] | None = None,
                 loss_weight: Callable[[dict], torch.Tensor] | None = None):
        """``step_flops(batch)`` counts one step's FLOPs on this device
        analytically (:meth:`step_cost_flops`); None leaves the MFU gauge
        unset.  ``loss_weight(batch)`` is the count that ``loss_fn``
        averages over in ``batch``, for data parallelism when it differs
        between ranks; None: every rank's loss averages over the same
        count."""
        from tpucfn_torch.mesh import BATCH_AXES, mesh_device, mesh_sizes

        if (mesh is None) != (rules is None):
            raise NotImplementedError(
                "a mesh without sharding rules, or rules without a mesh: "
                "pass both (data parallelism) or neither (one device)")
        if config.grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {config.grad_accum}")
        self.world = 1
        if mesh is not None:
            split = {a: n for a, n in mesh_sizes(mesh).items()
                     if n > 1 and a not in BATCH_AXES}
            if split:
                raise NotImplementedError(
                    f"mesh axes {split}: the port's Trainer runs data "
                    "parallel only; tensor parallelism (ROADMAP C2), "
                    "context parallelism (C3) and pipelines (C5) are not "
                    "ported yet")
            self.world = mesh.size()
            if device is None:
                device = mesh_device(mesh)
        self.mesh = mesh
        self.rules = rules
        self.device = resolve_device("cuda" if device is None else device)
        self.loss_fn = loss_fn
        self.eval_loss_fn = eval_loss_fn if eval_loss_fn is not None else loss_fn
        self.tx = tx
        self.init_fn = init_fn
        self.config = config
        self.step_flops = step_flops
        self.loss_weight = loss_weight

    def _check_rules(self, params: dict) -> None:
        from tpucfn_torch.parallel.sharding import (make_partition_spec,
                                                    placed_on_split_axes)

        placed = placed_on_split_axes(make_partition_spec(self.rules, params),
                                      self.mesh)
        if placed:
            shown = ", ".join(f"{n} on {a}" for n, a in list(placed.items())[:3])
            raise NotImplementedError(
                f"the sharding rules place {len(placed)} parameters on mesh "
                f"axes of size > 1 ({shown}, ...): sharded parameters (FSDP, "
                "tensor parallelism) are not ported yet (ROADMAP C2); run "
                "with those axes at 1")

    def init(self, seed: int) -> TrainState:
        """Params from ``init_fn`` with a generator seeded ``seed`` on the
        trainer's device (moved there, as ``nn.Parameter``s; under data
        parallelism rank 0's, broadcast), the optimizer state, and the step
        generator, seeded ``seed + 1``."""
        params, model_state = self.init_fn(
            torch.Generator(device=self.device).manual_seed(seed))
        # .to() returns a Parameter already on the device as it is.
        moved = {name: t.to(self.device) for name, t in params.items()}
        params = {name: t if isinstance(t, nn.Parameter)
                  else nn.Parameter(t.detach()) for name, t in moved.items()}
        if self.rules is not None:
            self._check_rules(params)
        if self.world > 1:
            import torch.distributed as dist

            for p in params.values():
                dist.broadcast(p.data, src=0)
        model_state = dict(model_state or {})
        if self.config.ema_decay:
            if "ema" in model_state:
                raise ValueError("model_state already has an 'ema' entry; "
                                 "ema_decay owns that key")
            model_state["ema"] = {name: p.detach().clone()
                                  for name, p in params.items()}
        return TrainState.create(
            params, self.tx,
            torch.Generator(device=self.device).manual_seed(seed + 1),
            model_state)

    def init_or_resume(self, seed: int, ckpt=None, *, fresh: bool = False
                       ) -> tuple[TrainState, int | None]:
        """Resume from the latest checkpoint of ``ckpt`` (a
        :class:`tpucfn_torch.ckpt.CheckpointManager`), or init fresh when
        it has none (or ``fresh`` forces it).  Returns ``(state,
        resumed_step)``, ``resumed_step`` None for a fresh init.

        The restore copies into a state from :meth:`init`.  A checkpoint
        that exists but will not restore raises :class:`RestoreFailure`
        (never a silent fresh init: giving up the run's progress is the
        coordinator's call, not this method's)."""
        state = self.init(seed)
        if ckpt is not None and not fresh:
            latest = ckpt.latest_step()
            if latest is not None:
                try:
                    return ckpt.restore(state, latest), latest
                except Exception as e:  # noqa: BLE001 — see docstring
                    raise RestoreFailure(latest, e) from e
        return state, None

    def step_cost_flops(self, batch: dict) -> float | None:
        """FLOPs of one step on this device, from ``step_flops`` (the JAX
        trainer asks XLA's cost analysis of the compiled step); None
        without it."""
        return None if self.step_flops is None else float(
            self.step_flops(batch))

    def _mean_over_ranks(self, tensors: list[torch.Tensor]) -> None:
        """Average ``tensors`` in place across the ranks: one all_reduce
        of one flat buffer."""
        import torch.distributed as dist
        from torch._utils import (_flatten_dense_tensors,
                                  _unflatten_dense_tensors)

        flat = _flatten_dense_tensors(tensors)
        dist.all_reduce(flat)
        flat.div_(self.world)
        for t, avg in zip(tensors, _unflatten_dense_tensors(flat, tensors)):
            t.copy_(avg)

    def _rank_scales(self, microbatches: list[dict]) -> list[float] | None:
        """Per microbatch, ``world * w / W``: this rank's ``loss_weight``
        ``w`` over the group's total ``W``, times the world size that
        :meth:`_mean_over_ranks` divides by.  None when no weighting is
        needed."""
        if self.world == 1 or self.loss_weight is None:
            return None
        import torch.distributed as dist

        w = torch.stack([torch.as_tensor(self.loss_weight(mb),
                                         device=self.device).double()
                         for mb in microbatches])
        total = w.clone()
        dist.all_reduce(total)
        return (w * self.world / total.clamp_min(1)).tolist()

    def _batch(self, batch: dict) -> dict:
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in batch.items()}

    def _grads(self, state: TrainState, batch: dict):
        accum = self.config.grad_accum
        names = list(state.params)
        params = [state.params[n] for n in names]
        rows = {v.shape[0] for v in batch.values()}
        if any(r % accum for r in rows):
            raise ValueError(f"batch rows {sorted(rows)} do not split into "
                             f"grad_accum={accum} microbatches")
        microbatches = ([{k: v.reshape(accum, -1, *v.shape[1:])[i]
                          for k, v in batch.items()} for i in range(accum)]
                        if accum > 1 else [batch])
        scales = self._rank_scales(microbatches)
        mstate = state.model_state
        grads = loss = aux = None
        for i, mb in enumerate(microbatches):
            l_i, (aux_i, mstate) = self.loss_fn(state.params, mstate, mb,
                                                state.generator)
            g_i = torch.autograd.grad(l_i, params, allow_unused=True)
            g_i = [torch.zeros_like(p) if g is None else g
                   for g, p in zip(g_i, params)]
            aux_i = {k: v.detach() for k, v in aux_i.items()}
            if scales is not None:
                torch._foreach_mul_(g_i, scales[i])
                l_i = l_i * scales[i]
                aux_i = {k: v * scales[i] for k, v in aux_i.items()}
            if grads is None:
                grads, loss, aux = g_i, l_i.detach(), aux_i
            else:
                torch._foreach_add_(grads, g_i)
                loss = loss + l_i.detach()
                aux = {k: aux[k] + v for k, v in aux_i.items()}
        if accum > 1:
            inv = 1.0 / accum
            torch._foreach_mul_(grads, inv)
            loss = loss * inv
            aux = {k: v * inv for k, v in aux.items()}
        return loss, aux, mstate, dict(zip(names, grads))

    def step(self, state: TrainState, batch: dict
             ) -> tuple[TrainState, dict[str, torch.Tensor]]:
        """One optimizer step.  Returns the next state (the same parameter
        and optimizer tensors, updated in place) and ``{"loss": ..., **aux}``
        of the batch before the update, as device tensors."""
        loss, aux, model_state, grads = self._grads(state, self._batch(batch))
        if self.world > 1:
            self._mean_over_ranks(list(grads.values()))
            scalars = [loss, *aux.values()]
            self._mean_over_ranks(scalars)
            loss, aux = scalars[0], dict(zip(aux, scalars[1:]))
        if self.tx.update(grads, state.opt_state, state.params) is not None:
            raise ValueError("the optimizer chain must end in an optimizer "
                             "that applies the update (e.g. adamw)")
        if self.config.ema_decay:
            # Post-update EMA; owns model_state["ema"] (re-attached even
            # when a loss_fn rebuilds its model_state from scratch).
            d = self.config.ema_decay
            ema = state.model_state["ema"]
            with torch.no_grad():
                for name, p in state.params.items():
                    ema[name].mul_(d).add_(p.to(ema[name].dtype), alpha=1 - d)
            model_state = {**model_state, "ema": ema}
        new_state = dataclasses.replace(state, step=state.step + 1,
                                        model_state=model_state)
        return new_state, {"loss": loss, **aux}

    def eval_step(self, state: TrainState, batch: dict
                  ) -> dict[str, torch.Tensor]:
        with torch.no_grad():
            loss, (aux, _) = self.eval_loss_fn(
                state.params, state.model_state, self._batch(batch),
                state.generator)
        return {"loss": loss, **aux}


class TrainerObs:
    """Observability for the canonical train loop phases.

    The loop a host actually lives in is ``data_wait → step → ckpt``
    repeated; this binds each phase to both planes at once — registry
    metrics (scrapeable via the per-host ``/metrics`` endpoint) and
    trace spans (one JSONL line per phase occurrence, host id attached,
    ``trace_id`` = the global step so ``tpucfn obs`` can line hosts up
    per step and name the straggler).  Phase timings are host-observed
    wall times: ``step`` includes the device dispatch AND the block on
    the result, which is the honest per-step number on an async runtime
    (same rule as StepTimer).

    Usage (what examples/common.py's run_train_loop does)::

        obs = TrainerObs(registry, tracer)
        with obs.data_wait():   batch = next(it)
        with obs.step(step_no): state, m = trainer.step(state, batch); ...
        with obs.ckpt(step_no): ckpt.save(step_no, state)
    """

    def __init__(self, registry=None, tracer=None, *, prefix: str = "train",
                 ledger=None, peak_flops: float | None = None,
                 clock=time.monotonic, flight=None, compile_probe=None):
        """``ledger`` is a :class:`tpucfn.obs.goodput.GoodputLedger` (or
        None): every phase the loop reports is also attributed to the
        per-host goodput JSONL so ``tpucfn obs goodput`` can decompose
        the run's wall clock (ISSUE 5).  ``peak_flops``/:meth:`
        set_model_flops` arm the live ``{prefix}_mfu`` gauge; ``clock``
        is injectable so the gauges are pinned with a fake clock and no
        TPU.

        ``flight`` is a :class:`tpucfn.obs.flight.FlightRecorder` (or
        None): every phase also lands one sample in the in-memory ring,
        plus an ``hbm`` device-memory sample per step — the last-N-
        seconds record a postmortem reads (ISSUE 6).  ``compile_probe``
        is a :class:`tpucfn.obs.profiler.CompileCacheProbe` (or None):
        when it reports the first step was served from the persistent
        compile cache, the ledger charges ``compile_cached`` instead of
        ``compile``, so warm restarts stop inflating the compile
        bucket."""
        from tpucfn_torch.obs.goodput import GoodputLedger
        from tpucfn_torch.obs.registry import default_registry
        from tpucfn_torch.obs.trace import Tracer

        r = self.registry = (registry if registry is not None
                             else default_registry())
        self.tracer = tracer if tracer is not None else Tracer(None)
        self.ledger = ledger if ledger is not None else GoodputLedger(None)
        self.clock = clock
        self.flight = flight
        self.compile_probe = compile_probe
        self.step_time = r.histogram(
            f"{prefix}_step_seconds", "host-observed step wall time")
        self.data_wait_time = r.histogram(
            f"{prefix}_data_wait_seconds",
            "time the step loop blocked on the input pipeline")
        self.ckpt_time = r.summary(
            f"{prefix}_ckpt_seconds", "checkpoint save-call time")
        self.steps_total = r.counter(
            f"{prefix}_steps_total", "completed optimizer steps")
        self.last_step = r.gauge(
            f"{prefix}_last_step", "most recent global step")
        # The live efficiency plane (ISSUE 5): what bench.py computed
        # offline, exported per step on the existing /metrics endpoint.
        self.step_time_g = r.gauge(
            f"{prefix}_step_time_s", "last host-observed step wall time")
        self.mfu_g = r.gauge(
            f"{prefix}_mfu",
            "model FLOPs utilization of the last step (cost-analysis "
            "FLOPs / step time / device peak)")
        self.goodput_ratio_g = r.gauge(
            f"{prefix}_goodput_ratio",
            "productive step seconds / wall seconds since loop start")
        self._flops_per_dev_step: float | None = None
        self._peak_flops = peak_flops
        self._t0 = clock()
        self._productive_s = 0.0
        self._steps_seen = 0

    def set_model_flops(self, flops_per_dev_step: float | None,
                        peak_flops: float | None = None) -> None:
        """Arm the MFU gauge: per-device FLOPs of one step (from
        :meth:`Trainer.step_cost_flops`, captured once at compile) and
        the device's peak FLOP/s (``goodput.device_peak_flops``).
        Either None leaves the gauge unset — no number beats a wrong
        number."""
        self._flops_per_dev_step = flops_per_dev_step
        if peak_flops is not None:
            self._peak_flops = peak_flops

    @contextlib.contextmanager
    def _phase(self, name: str, metric, step: int | None):
        t0 = self.clock()
        try:
            yield
        finally:
            dt = self.clock() - t0
            metric.observe(dt)
            self.tracer.record(name, start=t0, dur_s=dt, trace_id=step)
            if name != "step":  # step attribution happens in step()
                self.ledger.account(name, dt, step=step)
                if self.flight is not None:
                    self.flight.record(name, step=step, dur_s=dt)

    def _compile_bucket(self) -> str:
        """``compile`` vs ``compile_cached`` vs ``compile_fetched`` for
        the first step (ISSUE 6/13): the probe's verdict decides — a
        fleet-fetched AOT executable gets its own bucket so the warm-
        start plane's effect is visible in the ledger; no probe, or an
        unknown/throwing probe, keeps the plain ``compile`` charge."""
        if self.compile_probe is None:
            return "compile"
        try:
            outcome = self.compile_probe.outcome() \
                if hasattr(self.compile_probe, "outcome") \
                else {True: "hit", False: "miss"}.get(
                    self.compile_probe.hit())
        except Exception:  # noqa: BLE001 — the probe is best-effort
            outcome = None
        if outcome is not None:
            self.tracer.event("compile_cache", outcome=outcome,
                              hit=outcome in ("hit", "fetch"))
        if outcome == "fetch":
            return "compile_fetched"
        if outcome == "hit":
            return "compile_cached"
        return "compile"

    def _record_step(self, step: int | None, dur_s: float) -> None:
        """Shared post-step bookkeeping: the first step of a process is
        compile-dominated and lands in the ``compile`` bucket — or
        ``compile_cached`` when the probe says the persistent cache
        served it (the StepTimer warmup-exclusion rule applied to
        accounting); steady steps are ``step`` and feed the live
        efficiency gauges."""
        self._steps_seen += 1
        if self.flight is not None:
            self.flight.record("step", step=step, dur_s=dur_s)
            self.flight.sample_device()
        if self._steps_seen == 1:
            self.ledger.account(self._compile_bucket(), dur_s, step=step)
            return
        self.ledger.account("step", dur_s, step=step)
        self._productive_s += dur_s
        self.step_time_g.set(dur_s)
        elapsed = self.clock() - self._t0
        if elapsed > 0:
            self.goodput_ratio_g.set(self._productive_s / elapsed)
        if (self._flops_per_dev_step and self._peak_flops
                and dur_s > 0):
            self.mfu_g.set(self._flops_per_dev_step
                           / dur_s / self._peak_flops)

    def data_wait(self, step: int | None = None):
        return self._phase("data_wait", self.data_wait_time, step)

    def record_data_wait(self, step: int | None, start: float,
                         dur_s: float, link=None) -> None:
        """Post-hoc form of :meth:`data_wait` (``start`` in
        ``time.monotonic()`` seconds) for loops that must first decide
        whether the fetched batch starts a real step — the end-of-data
        drain wait must not be recorded as a phantom step's data wait.
        ``link`` is the batch's wire context from the input plane
        (``ResilientBatchStream.pop_link()``), recorded as the span's
        remote parent (ISSUE 20): on the merged timeline this wait
        points at the input-host ``input_serve`` span that produced the
        batch; None (local batch, tracing off upstream) records a plain
        local wait."""
        self.data_wait_time.observe(dur_s)
        self.tracer.record("data_wait", start=start, dur_s=dur_s,
                           trace_id=step, remote_parent=link)
        self.ledger.account("data_wait", dur_s, step=step)
        if self.flight is not None:
            self.flight.record("data_wait", step=step, dur_s=dur_s)

    def step(self, step: int | None = None):
        @contextlib.contextmanager
        def _span():
            if self._steps_seen == 0 and self.compile_probe is not None:
                # Arm the hit/miss baseline at the first step's ENTRY:
                # anything the pre-loop path compiled (restore, probes)
                # has already written its cache entries by now, so only
                # this step's own compile moves the count.
                try:
                    self.compile_probe.rearm()
                except Exception:  # noqa: BLE001 — probe is best-effort
                    pass
            t0 = self.clock()
            try:
                with self._phase("step", self.step_time, step):
                    yield
            finally:
                self._record_step(step, self.clock() - t0)
            self.steps_total.add()
            if step is not None:
                self.last_step.set(step)
        return _span()

    def ckpt(self, step: int | None = None):
        return self._phase("ckpt", self.ckpt_time, step)

    def record_ckpt(self, step: int | None, start: float,
                    dur_s: float) -> None:
        """Post-hoc form of :meth:`ckpt` for interval-gated save calls:
        record only saves that actually happened, or the percentiles
        measure no-op call overhead and read ~0 while real saves take
        seconds."""
        self.ckpt_time.observe(dur_s)
        self.tracer.record("ckpt", start=start, dur_s=dur_s, trace_id=step)
        self.ledger.account("ckpt", dur_s, step=step)
        if self.flight is not None:
            self.flight.record("ckpt", step=step, dur_s=dur_s)


def llama_train_fns(cfg, *, attention_fn=None, chunk_size: int | None = 512,
                    z_loss: float = 0.0) -> tuple[InitFn, LossFn]:
    """(init_fn, loss_fn) for a Llama, as the JAX package's Llama example
    wires them.  ``cfg.param_dtype`` should be fp32 (master weights).
    ``attention_fn`` defaults to the flash kernels' Function (K1 forward,
    K2/K3 backward; the plain versions for CPU tensors).  A batch with
    ``"segments"`` takes the packed path (``packed_causal_lm_loss`` over
    full logits); otherwise ``chunk_size`` picks ``chunked_causal_lm_loss``
    and None the plain ``causal_lm_loss``.  aux is ``{"accuracy": ...}``."""
    from tpucfn_torch.data.packing import packed_causal_lm_loss
    from tpucfn_torch.kernels.flash_attention import flash_attention
    from tpucfn_torch.models.llama import (Llama, causal_lm_loss,
                                           chunked_causal_lm_loss,
                                           init_llama_params)

    attention_fn = attention_fn or flash_attention

    def init_fn(generator):
        return init_llama_params(cfg, generator=generator,
                                 device=generator.device), {}

    def loss_fn(params, model_state, batch, generator):
        del generator
        model = Llama.from_state_dict(cfg, params, attention_fn=attention_fn,
                                      trainable=True)
        tokens, segments = batch["tokens"], batch.get("segments")
        if segments is not None:
            logits = model(tokens, segment_ids=segments)
            loss, acc = packed_causal_lm_loss(logits, tokens, segments,
                                              z_loss=z_loss)
        elif chunk_size:
            hidden = model(tokens, return_hidden=True)
            loss, acc = chunked_causal_lm_loss(
                hidden, params["lm_head.weight"], tokens,
                chunk_size=chunk_size, z_loss=z_loss)
        else:
            loss, acc = causal_lm_loss(model(tokens), tokens, z_loss=z_loss)
        return loss, ({"accuracy": acc}, model_state)

    return init_fn, loss_fn
