"""Regex-path -> partition-spec sharding rules (the port of
``tpucfn/parallel/sharding.py``).

The same rule text and the same first-match-wins resolution: a rule list
maps parameter names (the port's dotted state-dict names,
``"layers.3.attn.q_proj.weight"``) to a spec over the mesh's named axes.
A spec here is a tuple with one entry per tensor dim: an axis name, a
tuple of axis names, or None (not split).  :func:`make_partition_spec`
resolves a dict of tensors to such specs, padded with None to each
tensor's rank, as a ``NamedSharding`` reads a short ``PartitionSpec``.

Placement itself waits: the trainer accepts rules that place no
parameter on a mesh axis of size > 1 (data parallelism), and refuses the
rest (FSDP and tensor parallelism, ROADMAP C2); so does
``shard_batch_device_layout``.  :func:`shard_batch` puts this process's
batch rows, which are its shard of the global batch, on its device.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Iterable, Mapping

import torch

from tpucfn_torch.mesh import BATCH_AXES, mesh_device, mesh_sizes

Spec = tuple
Rule = tuple[str, Spec]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """An ordered rule list, applied first-match-wins to parameter names."""

    rules: tuple[Rule, ...]

    def __post_init__(self):
        for pat, spec in self.rules:
            re.compile(pat)
            if not isinstance(spec, tuple):
                raise TypeError(f"rule {pat!r} maps to {spec!r}, want a "
                                "tuple of axis names / None")

    def spec_for(self, path: str, ndim: int) -> Spec:
        """First matching rule's spec, padded with None to ``ndim``;
        an over-long spec raises."""
        for pat, spec in self.rules:
            if re.search(pat, path):
                if len(spec) > ndim:
                    raise ValueError(
                        f"rule spec {spec} has {len(spec)} entries but "
                        f"{path!r} has rank {ndim}")
                return tuple(spec) + (None,) * (ndim - len(spec))
        return (None,) * ndim

    def extended(self, head: Iterable[Rule]) -> "ShardingRules":
        """New rules with ``head`` prepended (higher precedence)."""
        return ShardingRules(tuple(head) + self.rules)


def make_partition_spec(rules: ShardingRules,
                        tensors: Mapping[str, Any]) -> dict[str, Spec]:
    """Name -> spec for a dict of tensors (anything with ``.shape``)."""
    return {name: rules.spec_for(name, len(t.shape))
            for name, t in tensors.items()}


def spec_axes(spec: Spec) -> set[str]:
    """The mesh axes a spec splits a tensor over."""
    out = set()
    for entry in spec:
        if entry is None:
            continue
        out.update((entry,) if isinstance(entry, str) else entry)
    return out


def placed_on_split_axes(specs: Mapping[str, Spec],
                         mesh) -> dict[str, list[str]]:
    """Name -> the axes of size > 1 its spec splits it over (only names
    that have any)."""
    sizes = mesh_sizes(mesh)
    out = {}
    for name, spec in specs.items():
        split = sorted(a for a in spec_axes(spec) if sizes.get(a, 1) > 1)
        if split:
            out[name] = split
    return out


def batch_spec(extra_axes: tuple[str | None, ...] = ()) -> Spec:
    """Spec of a batch: the leading dim over (data, fsdp, expert), then
    ``extra_axes``."""
    return (BATCH_AXES, *extra_axes)


def shard_batch(mesh, batch: Mapping[str, Any],
                extra_axes: tuple[str | None, ...] = ()) -> dict:
    """Put this process's batch (its rows of the global batch, as
    :class:`tpucfn_torch.data.ShardedDataset` yields them) on its device
    of ``mesh``.  Sequence axes (``extra_axes`` of size > 1) are not
    ported (ROADMAP C3)."""
    sizes = mesh_sizes(mesh)
    split = [a for a in extra_axes if a is not None and sizes.get(a, 1) > 1]
    if split:
        raise NotImplementedError(
            f"batch axes {split} of size > 1 (sequence parallelism) are "
            "not ported yet (ROADMAP C3)")
    device = mesh_device(mesh)
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
