"""Cluster specification (the port of ``tpucfn/spec/cluster.py``).

A validated, JSON-serializable description of the machines a job runs
on; ``tpucfn_torch.cli create-stack`` provisions one on the fake control
plane and ``launch`` fans the job out over its hosts.
:class:`AcceleratorType` and :class:`ClusterSpec`'s methods are copies
held equal to the JAX package's by ``tests/test_torch_isolation.py``.

The port's own: the registry names NVIDIA machines (``h100-1``: one host
with one H100) and the fake ``cpu-1`` (one CPU rank, for tests), not TPU
slices; and :class:`ClusterSpec` defaults to ``h100-1`` with no TPU
runtime image or zone.  A host with more than one card waits for one
rank per card under a per-host parent (ROADMAP A1): the launcher's
ranks refuse ``TPUCFN_WORKER_CHIP_COUNT`` > 1 today.
"""

from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path
from typing import Any

from tpucfn_torch.mesh import MeshSpec


@dataclasses.dataclass(frozen=True)
class AcceleratorType:
    """Static description of one slice SKU: chip generation + topology."""

    name: str  # e.g. "v5e-8"
    chips: int
    hosts: int
    chips_per_host: int
    ici_topology: tuple[int, ...]  # physical torus shape

    def default_mesh(self) -> MeshSpec:
        return MeshSpec.for_devices(self.chips)


def _sku(name: str, chips: int, hosts: int, topo: tuple[int, ...]) -> AcceleratorType:
    return AcceleratorType(name, chips, hosts, chips // hosts, topo)


# The registry of machine shapes the port can provision.  ``ici_topology``
# keeps the reference's field: one card has no interconnect to shape.
ACCELERATOR_TYPES: dict[str, AcceleratorType] = {
    t.name: t
    for t in [
        _sku("h100-1", 1, 1, (1,)),
        # Fake/test platform: one CPU rank on one host.
        _sku("cpu-1", 1, 1, (1,)),
    ]
}

_NAME_RE = re.compile(r"^[a-z][a-z0-9-]{0,61}[a-z0-9]$")


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    name: str
    accelerator: str = "h100-1"
    runtime_version: str = ""  # no TPU runtime image on a GPU host
    storage_path: str = ""  # shared storage root (≈ the EFS mount)
    zone: str = ""
    preemptible: bool = False
    env: tuple[tuple[str, str], ...] = ()  # extra env for every host

    def __post_init__(self):
        if not _NAME_RE.match(self.name):
            raise ValueError(
                f"cluster name {self.name!r} must be lowercase RFC-1035-ish "
                "(letters, digits, hyphens)"
            )
        if self.accelerator not in ACCELERATOR_TYPES:
            known = ", ".join(sorted(ACCELERATOR_TYPES))
            raise ValueError(f"unknown accelerator {self.accelerator!r}; known: {known}")

    @property
    def sku(self) -> AcceleratorType:
        return ACCELERATOR_TYPES[self.accelerator]

    @property
    def num_hosts(self) -> int:
        return self.sku.hosts

    @property
    def num_chips(self) -> int:
        return self.sku.chips

    # ---- serialization (the "template file" form) ----------------------

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["env"] = dict(self.env)
        return json.dumps(d, indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "ClusterSpec":
        d: dict[str, Any] = json.loads(text)
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(f"unknown ClusterSpec fields: {sorted(unknown)}")
        if "env" in d:
            d["env"] = tuple(sorted(d["env"].items()))
        return cls(**d)

    @classmethod
    def load(cls, path: str | Path) -> "ClusterSpec":
        return cls.from_json(Path(path).read_text())

    def save(self, path: str | Path) -> None:
        Path(path).write_text(self.to_json() + "\n")
