"""Training state (the port of ``tpucfn/train/state.py``): one object
holding everything a step reads and writes.

``params`` is a dict of ``nn.Parameter`` (fp32 master weights) that the
step updates in place; ``opt_state`` is the optimizer chain's state (for
AdamW, the ``torch.optim.AdamW`` holding the moments); ``model_state``
carries non-differentiated collections (the parameter EMA under
``"ema"``); ``generator`` is the step's random stream, consumed in order.
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

    @classmethod
    def create(cls, params: dict[str, torch.Tensor], tx,
               generator: torch.Generator,
               model_state: dict[str, Any] | None = None) -> "TrainState":
        return cls(step=0, params=params,
                   model_state={} if model_state is None else model_state,
                   opt_state=tx.init(params), generator=generator)
