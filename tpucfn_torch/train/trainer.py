"""The trainer on one device (the port of ``Trainer`` in
``tpucfn/train/trainer.py``).

The JAX trainer compiles (loss, gradient, optimizer update) into one
SPMD program over a mesh.  This one runs the same step eagerly on one
device: the loss and its gradient through autograd, then the optimizer
chain in place.  The mesh and sharding rules wait for the mesh and
sharding slices: ``mesh`` and ``rules`` are accepted only as ``None``.

    trainer = Trainer(None, None, loss_fn, tx, init_fn, device="cuda")
    state = trainer.init(0)
    state, metrics = trainer.step(state, batch)   # batch: dict of arrays

``loss_fn(params, model_state, batch, generator) -> (loss, (aux,
new_model_state))`` and ``init_fn(generator) -> (params, model_state)``
keep the JAX signatures; ``params`` is a dict of tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch import nn

from tpucfn_torch.device import resolve_device
from tpucfn_torch.train.state import TrainState

LossFn = Callable[[dict, dict, dict, torch.Generator],
                  tuple[torch.Tensor, tuple[dict, dict]]]
InitFn = Callable[[torch.Generator], tuple[dict, dict]]


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
    """Binds (loss, optimizer chain, init) into ``init``/``step``/
    ``eval_step`` on one device: the card unless ``device`` says
    otherwise."""

    def __init__(self, mesh, rules, loss_fn: LossFn, tx, init_fn: InitFn,
                 config: TrainerConfig = TrainerConfig(),
                 eval_loss_fn: LossFn | None = None, *,
                 device: str | torch.device = "cuda"):
        if mesh is not None or rules is not None:
            raise NotImplementedError(
                "the port's Trainer runs on one device; meshes and sharding "
                "rules wait for the mesh slice (pass None, None)")
        if config.grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {config.grad_accum}")
        self.device = resolve_device(device)
        self.loss_fn = loss_fn
        self.eval_loss_fn = eval_loss_fn if eval_loss_fn is not None else loss_fn
        self.tx = tx
        self.init_fn = init_fn
        self.config = config

    def init(self, seed: int) -> TrainState:
        """Params from ``init_fn`` with a generator seeded ``seed`` on the
        trainer's device (moved there, as ``nn.Parameter``s), the
        optimizer state, and the step generator, seeded ``seed + 1``."""
        params, model_state = self.init_fn(
            torch.Generator(device=self.device).manual_seed(seed))
        # .to() returns a Parameter already on the device as it is.
        moved = {name: t.to(self.device) for name, t in params.items()}
        params = {name: t if isinstance(t, nn.Parameter)
                  else nn.Parameter(t.detach()) for name, t in moved.items()}
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
        mstate = state.model_state
        grads = loss = aux = None
        for i in range(accum):
            mb = ({k: v.reshape(accum, -1, *v.shape[1:])[i]
                   for k, v in batch.items()} if accum > 1 else batch)
            l_i, (aux_i, mstate) = self.loss_fn(state.params, mstate, mb,
                                                state.generator)
            g_i = torch.autograd.grad(l_i, params, allow_unused=True)
            g_i = [torch.zeros_like(p) if g is None else g
                   for g, p in zip(g_i, params)]
            aux_i = {k: v.detach() for k, v in aux_i.items()}
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
