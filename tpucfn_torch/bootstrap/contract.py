"""The cluster contract (the port of ``EnvContract`` in
``tpucfn/bootstrap/contract.py``, held equal to it by
``tests/test_torch_isolation.py``): the hostfile and environment that the
``tpucfn launch`` fan-out writes for every process.

    TPUCFN_WORKERS_PATH      hostfile, one address per line
    TPUCFN_WORKERS_COUNT     processes in the job (one per host)
    TPUCFN_WORKER_CHIP_COUNT cards per host
    TPUCFN_COORDINATOR       host0:port, the rendezvous address
    TPUCFN_HOST_ID           this process's rank

The port reads it in :func:`tpucfn_torch.launch.initialize_runtime`.
``converge`` (writing the contract from a provisioned cluster record)
and ``ClusterRecord`` stay with the JAX package's provisioner.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path


@dataclasses.dataclass(frozen=True)
class EnvContract:
    workers_path: str  # hostfile location
    workers_count: int
    worker_chip_count: int
    coordinator: str  # "host0_addr:port"
    host_id: int
    storage: str
    generation: int

    def to_env(self) -> dict[str, str]:
        env = {
            "TPUCFN_WORKERS_PATH": self.workers_path,
            "TPUCFN_WORKERS_COUNT": str(self.workers_count),
            "TPUCFN_WORKER_CHIP_COUNT": str(self.worker_chip_count),
            "TPUCFN_COORDINATOR": self.coordinator,
            "TPUCFN_HOST_ID": str(self.host_id),
            "TPUCFN_STORAGE": self.storage,
            "TPUCFN_GENERATION": str(self.generation),
            # Legacy aliases for reference-era commands.
            "DEEPLEARNING_WORKERS_PATH": self.workers_path,
            "DEEPLEARNING_WORKERS_COUNT": str(self.workers_count),
            "DEEPLEARNING_WORKER_GPU_COUNT": str(self.worker_chip_count),
        }
        return env

    @classmethod
    def from_env(cls, env: dict[str, str] | None = None) -> "EnvContract":
        e = os.environ if env is None else env
        try:
            return cls(
                workers_path=e["TPUCFN_WORKERS_PATH"],
                workers_count=int(e["TPUCFN_WORKERS_COUNT"]),
                worker_chip_count=int(e["TPUCFN_WORKER_CHIP_COUNT"]),
                coordinator=e["TPUCFN_COORDINATOR"],
                host_id=int(e["TPUCFN_HOST_ID"]),
                storage=e.get("TPUCFN_STORAGE", ""),
                generation=int(e.get("TPUCFN_GENERATION", "0")),
            )
        except KeyError as k:
            raise EnvironmentError(
                f"missing {k.args[0]} — this process is not inside a converged "
                "tpucfn cluster (run via `tpucfn launch` or source the env file)"
            ) from None

    def hosts(self) -> list[str]:
        return Path(self.workers_path).read_text().split()
