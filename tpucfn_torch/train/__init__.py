"""The training path: ``Trainer`` (data parallel over a mesh, or one
device), its state, its observability, and the optimizer chain of the JAX
package's examples."""

from tpucfn_torch.train.optim import (adamw, chain, clip_by_global_norm,
                                      warmup_cosine_decay_schedule)
from tpucfn_torch.train.state import TrainState
from tpucfn_torch.train.trainer import (RestoreFailure, Trainer,
                                        TrainerConfig, TrainerObs,
                                        llama_train_fns)

__all__ = ["RestoreFailure", "TrainState", "Trainer", "TrainerConfig",
           "TrainerObs", "adamw", "chain", "clip_by_global_norm",
           "llama_train_fns", "warmup_cosine_decay_schedule"]
