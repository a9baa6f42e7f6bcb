"""The optimizer chain of the JAX package's examples, with optax's
definitions (the port of what ``optax`` gives ``tpucfn/train``).

A transform has ``init(params) -> state`` and ``update(grads, state,
params) -> grads``; the last transform of a :func:`chain` applies the
update to the parameters in place and returns ``None``.  ``params`` and
``grads`` are dicts of tensors with the same keys; gradients are
transformed in place.  ``state_dict(state, params)`` gives the state as a
flat dict of tensors named after the parameters (what a checkpoint
holds), and ``load_state_dict(state, params, sd)`` writes such a dict
back into ``state`` in place.

* :func:`clip_by_global_norm` — optax's formula, g * max_norm /
  max(||g||, max_norm), with the norm over every gradient together
  (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm, so it is not
  used).  Over :class:`ShardedGrads`, each rank's blocks of the global
  gradients, the norm is the global one: the squares summed over every
  block, each element once.
* :func:`adamw` — ``torch.optim.AdamW`` with optax's defaults stated
  (b1 0.9, b2 0.999, eps 1e-8 added outside the square root,
  weight_decay 1e-4; PyTorch's own default decay is 0.01).  The learning
  rate is a float or a schedule of the update count, read before each
  update, so the first update runs at ``schedule(0)``.
* :func:`adam` — optax's ``adam``: AdamW's update with no weight decay
  (b1 0.9, b2 0.999, eps 1e-8 outside the square root, ``eps_root`` 0,
  both moments bias-corrected), which is what ``torch.optim.AdamW`` at
  ``weight_decay=0`` computes; its state is named as AdamW's.
* :func:`sgd` — optax's ``sgd(learning_rate, momentum, nesterov)``: the
  trace t = g + momentum * t from zeros, the update t (or g + momentum * t
  with ``nesterov``) times the learning rate.  ``torch.optim.SGD`` with
  ``dampening=0`` follows the same recurrence (its first buffer is the
  gradient itself, the same t from zeros); the learning rate is set from
  the schedule at the update count before each step, so the first update
  runs at ``schedule(0)``.
* :func:`add_decayed_weights` — optax's: g + weight_decay * p for every
  parameter (no mask), before the optimizer of the chain.
* :func:`warmup_cosine_decay_schedule` — optax's: a linear warmup from
  ``init_value`` to ``peak_value`` over ``warmup_steps``, then a cosine
  decay to ``end_value``; ``decay_steps`` counts the warmup too.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import torch

Schedule = Callable[[int], float]


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0,
                                 exponent: float = 1.0) -> Schedule:
    if decay_steps - warmup_steps <= 0:
        raise ValueError("the cosine decay needs decay_steps > warmup_steps, "
                         f"got {decay_steps} and {warmup_steps}")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1 - count / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        t = min(count - warmup_steps, cosine_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * t / cosine_steps))
        return peak_value * ((1 - alpha) * cosine ** exponent + alpha)

    return schedule


class ShardedGrads(dict):
    """Gradients that are this rank's blocks of the global ones (the
    trainer's, under sharded rules): ``weights[name]`` is one over the
    number of ranks that hold the same block, so the global sum of
    squares is one all-reduce of the weighted local sums."""

    def __init__(self, grads: dict[str, torch.Tensor],
                 weights: dict[str, float]):
        super().__init__(grads)
        self.weights = weights

    def global_norm(self) -> torch.Tensor:
        import torch.distributed as dist

        sq = torch.stack([torch.linalg.vector_norm(g.float()) ** 2
                          * self.weights[name] for name, g in self.items()])
        total = sq.sum().double()
        dist.all_reduce(total)
        return total.sqrt().float()


class _ClipByGlobalNorm:
    def __init__(self, max_norm: float):
        self.max_norm = float(max_norm)

    def init(self, params: dict[str, torch.Tensor]) -> tuple:
        return ()

    def state_dict(self, state, params) -> dict:
        return {}

    def load_state_dict(self, state, params, sd) -> None:
        pass

    def update(self, grads, state, params):
        del state, params
        gs = list(grads.values())
        if isinstance(grads, ShardedGrads):
            norm = grads.global_norm()
        else:
            norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g.float()) for g in gs]))
        factor = self.max_norm / torch.clamp(norm, min=self.max_norm)
        torch._foreach_mul_(gs, factor)
        return grads


def clip_by_global_norm(max_norm: float) -> _ClipByGlobalNorm:
    return _ClipByGlobalNorm(max_norm)


class _AdamW:
    def __init__(self, learning_rate: float | Schedule, b1: float, b2: float,
                 eps: float, weight_decay: float):
        self.learning_rate = learning_rate
        self.kwargs = dict(betas=(b1, b2), eps=eps, weight_decay=weight_decay)

    def _lr(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count) if callable(lr) else lr)

    def init(self, params: dict[str, torch.Tensor]) -> dict[str, Any]:
        opt = torch.optim.AdamW(list(params.values()), lr=self._lr(0),
                                **self.kwargs)
        return {"optimizer": opt, "count": 0}

    def state_dict(self, state, params) -> dict:
        """The update count and each parameter's AdamW ``step``,
        ``exp_avg`` and ``exp_avg_sq``.  A parameter with no state yet
        gets it here as ``torch.optim.AdamW`` would make it at its first
        update (zeros), so a state before any update saves too."""
        opt = state["optimizer"]
        group = opt.param_groups[0]
        sd = {"count": torch.tensor(state["count"], dtype=torch.int64)}
        for name, p in params.items():
            st = opt.state[p]
            if not st:
                on_device = group["capturable"] or group["fused"]
                st["step"] = (torch.zeros((), dtype=torch.float32,
                                          device=p.device)
                              if on_device else torch.tensor(0.0))
                st["exp_avg"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
                st["exp_avg_sq"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
            for key in ("step", "exp_avg", "exp_avg_sq"):
                sd[f"{key}/{name}"] = st[key]
        return sd

    def load_state_dict(self, state, params, sd) -> None:
        """Copy ``sd`` (as :meth:`state_dict` names it) into the state."""
        own = self.state_dict(state, params)
        with torch.no_grad():
            for key, t in own.items():
                t.copy_(sd[key])
        state["count"] = int(own["count"])

    def update(self, grads, state, params) -> None:
        opt = state["optimizer"]
        for group in opt.param_groups:
            group["lr"] = self._lr(state["count"])
        for name, p in params.items():
            p.grad = grads[name]
        opt.step()
        for p in params.values():
            p.grad = None
        state["count"] += 1
        return None


def adamw(learning_rate: float | Schedule, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4) -> _AdamW:
    return _AdamW(learning_rate, b1, b2, eps, weight_decay)


def adam(learning_rate: float | Schedule, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> _AdamW:
    return _AdamW(learning_rate, b1, b2, eps, 0.0)


class _SGD:
    def __init__(self, learning_rate: float | Schedule, momentum: float | None,
                 nesterov: bool):
        self.learning_rate = learning_rate
        self.kwargs = dict(momentum=momentum or 0.0, nesterov=nesterov,
                           dampening=0.0, weight_decay=0.0)

    def _lr(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count) if callable(lr) else lr)

    def init(self, params: dict[str, torch.Tensor]) -> dict[str, Any]:
        opt = torch.optim.SGD(list(params.values()), lr=self._lr(0),
                              **self.kwargs)
        return {"optimizer": opt, "count": 0}

    def state_dict(self, state, params) -> dict:
        """The update count and, with momentum, each parameter's trace
        (``momentum_buffer``), zeros before the first update: the first
        update of a zero trace gives the gradient, as
        ``torch.optim.SGD``'s own first buffer does."""
        opt = state["optimizer"]
        sd = {"count": torch.tensor(state["count"], dtype=torch.int64)}
        if not self.kwargs["momentum"]:
            return sd
        for name, p in params.items():
            st = opt.state[p]
            if st.get("momentum_buffer") is None:
                st["momentum_buffer"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
            sd[f"momentum_buffer/{name}"] = st["momentum_buffer"]
        return sd

    load_state_dict = _AdamW.load_state_dict
    update = _AdamW.update


def sgd(learning_rate: float | Schedule, momentum: float | None = None,
        nesterov: bool = False) -> _SGD:
    return _SGD(learning_rate, momentum, nesterov)


class _AddDecayedWeights:
    def __init__(self, weight_decay: float):
        self.weight_decay = float(weight_decay)

    init = _ClipByGlobalNorm.init
    state_dict = _ClipByGlobalNorm.state_dict
    load_state_dict = _ClipByGlobalNorm.load_state_dict

    def update(self, grads, state, params):
        del state
        with torch.no_grad():
            torch._foreach_add_([grads[n] for n in params],
                                list(params.values()),
                                alpha=self.weight_decay)
        return grads


def add_decayed_weights(weight_decay: float) -> _AddDecayedWeights:
    return _AddDecayedWeights(weight_decay)


class _Chain:
    def __init__(self, transforms):
        self.transforms = tuple(transforms)

    def init(self, params):
        return tuple(t.init(params) for t in self.transforms)

    def state_dict(self, state, params) -> dict:
        return {f"{i}/{k}": v
                for i, (t, st) in enumerate(zip(self.transforms, state))
                for k, v in t.state_dict(st, params).items()}

    def load_state_dict(self, state, params, sd) -> None:
        for i, (t, st) in enumerate(zip(self.transforms, state)):
            prefix = f"{i}/"
            t.load_state_dict(st, params, {
                k[len(prefix):]: v for k, v in sd.items()
                if k.startswith(prefix)})

    def update(self, grads, state, params):
        for t, s in zip(self.transforms, state):
            grads = t.update(grads, s, params)
        return grads


def chain(*transforms) -> _Chain:
    return _Chain(transforms)
