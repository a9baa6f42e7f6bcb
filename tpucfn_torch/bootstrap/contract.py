"""The cluster contract (the port of ``EnvContract`` in
``tpucfn/bootstrap/contract.py``, held equal to it by
``tests/test_torch_isolation.py``): the hostfile and environment that the
``tpucfn launch`` fan-out writes for every process.

    TPUCFN_WORKERS_PATH      hostfile, one address per line
    TPUCFN_WORKERS_COUNT     processes in the job (one per host)
    TPUCFN_WORKER_CHIP_COUNT cards per host
    TPUCFN_COORDINATOR       host0:port, the rendezvous address
    TPUCFN_HOST_ID           this process's rank

The port reads it in :func:`tpucfn_torch.launch.initialize_runtime`;
:func:`converge` writes it from a provisioned cluster record
(``tpucfn_torch.cli create-stack``, ``env`` and ``launch``), and
:func:`shrink_contract` re-converges it at fewer hosts (the gang
coordinator's elastic shrink).  Both are copies held equal to the JAX
package's, as is ``EnvContract``.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path

from tpucfn_torch.provision.control_plane import ClusterRecord

COORDINATOR_PORT = 8476


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


def converge(record: ClusterRecord, run_dir: str | Path, host_id: int = 0) -> EnvContract:
    """Per-host bootstrap: write the hostfile + env file under ``run_dir``
    (≈ what cfn-init did with EC2 metadata), return the contract.

    Idempotent — re-running after a re-acquire overwrites with the new
    generation, exactly like the reference's bootstrap regenerating the
    hostfile after an ASG resize (SURVEY.md §3.5).
    """
    d = Path(run_dir)
    d.mkdir(parents=True, exist_ok=True)
    hostfile = d / "hostfile"
    hostfile.write_text("".join(f"{h.address}\n" for h in record.hosts))
    coord_host = record.hosts[0].address.rsplit(":", 1)[0]
    contract = EnvContract(
        workers_path=str(hostfile),
        workers_count=len(record.hosts),
        worker_chip_count=record.spec.sku.chips_per_host,
        coordinator=f"{coord_host}:{COORDINATOR_PORT}",
        host_id=host_id,
        storage=record.spec.storage_path or str(d / "storage"),
        generation=record.generation,
    )
    envfile = d / "env.sh"
    envfile.write_text(
        "".join(f"export {k}={v!r}\n" for k, v in sorted(contract.to_env().items()))
    )
    return contract


def shrink_contract(contract: EnvContract,
                    lost_host_ids: list[int] | set[int],
                    hostfile_path: str | Path | None = None) -> EnvContract:
    """Re-converge at N-k hosts (elastic shrink, ISSUE 7): drop the lost
    hosts from the launched slice, renumber the survivors 0..N-k-1, bump
    the contract generation, and write the new hostfile next to the old
    one (``<hostfile>.gen<G>`` — the previous generation's file is left
    untouched for forensics).  The coordinator address follows the new
    host 0 (on the original coordinator port) in case host 0 itself was
    the one lost.

    Raises ``ValueError`` when nothing would remain — a gang of zero is
    not a shrink, it is a give-up, and the caller must decide that."""
    hosts = contract.hosts()[: contract.workers_count]
    lost = {int(h) for h in lost_host_ids}
    bad = lost - set(range(len(hosts)))
    if bad:
        raise ValueError(
            f"lost host id(s) {sorted(bad)} out of range for "
            f"{len(hosts)} launched hosts")
    keep = [h for i, h in enumerate(hosts) if i not in lost]
    if not keep:
        raise ValueError(
            f"shrink would remove all {len(hosts)} hosts — nothing left "
            "to re-converge")
    generation = contract.generation + 1
    old = Path(contract.workers_path)
    path = (Path(hostfile_path) if hostfile_path is not None
            else old.with_name(f"{old.name}.gen{generation}"))
    path.write_text("".join(f"{h}\n" for h in keep))
    coord_port = contract.coordinator.rsplit(":", 1)[1]
    # This host's own new id: old id minus the lost ids below it — the
    # same renumbering every survivor applies, so a per-host
    # re-converge lands each machine in a distinct slot.  A caller
    # whose own host was lost (shouldn't happen — the lost host has no
    # business re-converging) clamps to 0.
    if contract.host_id in lost:
        new_host_id = 0
    else:
        new_host_id = contract.host_id - sum(
            1 for i in lost if i < contract.host_id)
    return EnvContract(
        workers_path=str(path),
        workers_count=len(keep),
        worker_chip_count=contract.worker_chip_count,
        coordinator=f"{keep[0].rsplit(':', 1)[0]}:{coord_port}",
        host_id=new_host_id,
        storage=contract.storage,
        generation=generation,
    )
