"""Training state (the port of ``tpucfn/train/state.py``): one object
holding everything a step reads and writes.

``params`` is a dict of ``nn.Parameter`` (fp32 master weights) that the
step updates in place; ``opt_state`` is the optimizer chain's state (for
AdamW, the ``torch.optim.AdamW`` holding the moments); ``model_state``
carries non-differentiated collections (the parameter EMA under
``"ema"``); ``generator`` is the step's random stream, consumed in order.

Under sharded rules (:class:`tpucfn_torch.train.Trainer`) the params are
this rank's blocks, ``opt_params`` are the tensors the optimizer updates
(views of the params' blocks, smaller where the rules split the moments
further: ZeRO-1), and ``shardings`` name the
:class:`~tpucfn_torch.parallel.NamedSharding` of every entry of
:meth:`TrainState.state_dict`, which a checkpoint saves and restores by.

:meth:`TrainState.state_dict` names every tensor of the state in one flat
dict (the live tensors, not copies): ``step``, ``params/<name>``,
``model_state/<path>`` (nested dicts joined with ``/``), ``opt/<path>``
(the chain's ``state_dict``) and ``generator`` (its state bytes).
:meth:`TrainState.load_state_dict` copies such a dict back in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass
class TrainState:
    step: int
    params: dict[str, torch.Tensor]
    model_state: dict[str, Any]
    opt_state: Any
    generator: torch.Generator
    tx: Any = None  # the chain that owns opt_state (for state_dict)
    # What the optimizer updates, when not the params themselves.
    opt_params: dict[str, torch.Tensor] | None = None
    # state_dict name -> NamedSharding, when the state is placed by rules.
    shardings: dict[str, Any] | None = None

    @classmethod
    def create(cls, params: dict[str, torch.Tensor], tx,
               generator: torch.Generator,
               model_state: dict[str, Any] | None = None,
               opt_params: dict[str, torch.Tensor] | None = None
               ) -> "TrainState":
        return cls(step=0, params=params,
                   model_state={} if model_state is None else model_state,
                   opt_state=tx.init(opt_params or params),
                   generator=generator, tx=tx, opt_params=opt_params)

    @property
    def update_params(self) -> dict[str, torch.Tensor]:
        """The tensors the optimizer state belongs to."""
        return self.opt_params or self.params

    def state_dict(self) -> dict[str, torch.Tensor]:
        sd = {"step": torch.tensor(self.step, dtype=torch.int64),
              "generator": self.generator.get_state()}
        sd.update({f"params/{k}": v for k, v in self.params.items()})
        sd.update(_flatten("model_state", self.model_state))
        sd.update({f"opt/{k}": v for k, v in self.tx.state_dict(
            self.opt_state, self.update_params).items()})
        return sd

    def load_state_dict(self, sd: dict[str, torch.Tensor]) -> None:
        with torch.no_grad():
            for k, v in self.params.items():
                v.copy_(sd[f"params/{k}"])
            for k, v in _flatten("model_state", self.model_state).items():
                v.copy_(sd[k])
        self.tx.load_state_dict(self.opt_state, self.update_params, {
            k[len("opt/"):]: v for k, v in sd.items() if k.startswith("opt/")})
        self.generator.set_state(sd["generator"])
        self.step = int(sd["step"])


def _flatten(prefix: str, tree) -> dict[str, torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    if not isinstance(tree, dict):
        raise TypeError(f"{prefix}: a checkpoint holds tensors and dicts of "
                        f"them, not {type(tree).__name__}")
    out = {}
    for k, v in tree.items():
        out.update(_flatten(f"{prefix}/{k}", v))
    return out
