"""The cluster contract the launcher writes and every process reads."""

from tpucfn_torch.bootstrap.contract import EnvContract

__all__ = ["EnvContract"]
