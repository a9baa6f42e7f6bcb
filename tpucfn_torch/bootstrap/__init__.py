"""The cluster contract the launcher writes and every process reads."""

from tpucfn_torch.bootstrap.contract import (COORDINATOR_PORT, EnvContract,
                                             converge, shrink_contract)

__all__ = ["COORDINATOR_PORT", "EnvContract", "converge", "shrink_contract"]
