"""Joining the cluster (the port of ``initialize_runtime`` in
``tpucfn/launch/launcher.py``).

``tpucfn launch`` fans the env contract
(:class:`tpucfn_torch.bootstrap.EnvContract`) out to one process per
host; :func:`initialize_runtime` reads it and joins a ``torch.distributed``
process group at ``tcp://{TPUCFN_COORDINATOR}`` with rank
``TPUCFN_HOST_ID`` and world size ``TPUCFN_WORKERS_COUNT``: NCCL on the
card, gloo only when the caller asks for the CPU.  Without the contract
it does nothing, so the same script runs single-host.

Not ported yet (ROADMAP A1 and D2): one rank per card under a per-host
parent, so a host with ``TPUCFN_WORKER_CHIP_COUNT`` > 1 is refused; and
the persistent compile cache the JAX package arms here.
"""

from __future__ import annotations

import torch

from tpucfn_torch.bootstrap.contract import EnvContract
from tpucfn_torch.device import resolve_device


def initialize_runtime(contract: EnvContract | None = None, *,
                       device: str | torch.device = "cuda"
                       ) -> EnvContract | None:
    """Per-process entry: join the cluster rendezvous.

    Returns the contract, or None for a plain single-host run (no
    cluster env), which joins nothing.  ``device`` picks the backend:
    ``nccl`` for the card (raising when there is none, never falling back
    to gloo), ``gloo`` for ``"cpu"``."""
    if contract is None:
        try:
            contract = EnvContract.from_env()
        except EnvironmentError:
            return None  # plain single-host run, no cluster env
    if contract.worker_chip_count > 1:
        raise NotImplementedError(
            f"TPUCFN_WORKER_CHIP_COUNT={contract.worker_chip_count}: the port "
            "runs one rank per card, and a per-host parent that starts one "
            "rank per card is not ported yet (ROADMAP A1); launch one "
            "process per card with a chip count of 1")
    dev = resolve_device(device)
    if contract.workers_count > 1:
        import torch.distributed as dist

        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"tcp://{contract.coordinator}",
            world_size=contract.workers_count, rank=contract.host_id)
    return contract


def process_index() -> int:
    """This process's rank in the default process group (0 without one):
    the counterpart of ``jax.process_index()``."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """Ranks in the default process group (1 without one): the
    counterpart of ``jax.process_count()``, and of ``jax.device_count()``
    with one card per rank."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1
