"""The training path: ``Trainer`` (data parallel over a mesh, or one
device), its state, its observability, and the optimizer chain of the JAX
package's examples."""

from tpucfn_torch.train.optim import (adam, add_decayed_weights, adamw, chain,
                                      clip_by_global_norm, sgd,
                                      warmup_cosine_decay_schedule)
from tpucfn_torch.train.state import TrainState
from tpucfn_torch.train.trainer import (RestoreFailure, Trainer,
                                        TrainerConfig, TrainerObs,
                                        llama_loss, llama_train_fns)
from tpucfn_torch.train.lora import (lora_init, lora_materialize,
                                     lora_sharding_rules, lora_train_fns)

__all__ = ["RestoreFailure", "TrainState", "Trainer", "TrainerConfig",
           "TrainerObs", "adam", "add_decayed_weights", "adamw", "chain",
           "clip_by_global_norm",
           "llama_loss", "llama_train_fns", "lora_init", "lora_materialize",
           "lora_sharding_rules", "lora_train_fns", "sgd",
           "warmup_cosine_decay_schedule"]
