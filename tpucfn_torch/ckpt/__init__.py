"""Step-directory checkpoints of the training state."""

from tpucfn_torch.ckpt.manager import CheckpointManager

__all__ = ["CheckpointManager"]
