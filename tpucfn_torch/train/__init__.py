"""The training path on one device: ``Trainer``, its state, and the
optimizer chain of the JAX package's examples."""

from tpucfn_torch.train.optim import (adamw, chain, clip_by_global_norm,
                                      warmup_cosine_decay_schedule)
from tpucfn_torch.train.state import TrainState
from tpucfn_torch.train.trainer import (Trainer, TrainerConfig,
                                        llama_train_fns)

__all__ = ["TrainState", "Trainer", "TrainerConfig", "adamw", "chain",
           "clip_by_global_norm", "llama_train_fns",
           "warmup_cosine_decay_schedule"]
