"""Regex-path -> partition-spec sharding rules and their placement (the
port of ``tpucfn/parallel/sharding.py``).

The same rule text and the same first-match-wins resolution: a rule list
maps parameter names (the port's dotted state-dict names,
``"layers.3.attn.q_proj.weight"``) to a spec over the mesh's named axes.
A spec here is a tuple with one entry per tensor dim: an axis name, a
tuple of axis names, or None (not split).  :func:`make_partition_spec`
resolves a dict of tensors to such specs, padded with None to each
tensor's rank, as a ``NamedSharding`` reads a short ``PartitionSpec``.

Placement: :class:`NamedSharding` binds a spec to the six-axis
``DeviceMesh``, and :func:`named_sharding_tree` does it for a dict of
tensors, as the JAX function of that name.  Each process is one device,
so a rank holds one block of every tensor: a dim split over an axis of
size ``W`` keeps the rank's ``[i·L/W, (i+1)·L/W)`` (over a tuple of axes,
the flattened row-major coordinate), the layout ``jax.device_put`` gives
the same spec.  :meth:`NamedSharding.shard` takes a whole tensor to this
rank's block and :meth:`NamedSharding.unshard` gathers it back.
:class:`ShardedParams` is the dict a loss sees under sharded rules: each
parameter gathered at its use over the axes that only store it (FSDP),
kept as this rank's block over the axes a model computes on (``tensor``,
``expert``: :data:`COMPUTE_AXES`).

:func:`shard_batch` puts this process's batch rows, which are its shard
of the global batch, on its device, and keeps of each dim split over an
extra axis (the sequence over ``context``) this rank's block;
:func:`next_block_tokens` hands a block's last position the token it
predicts.  ``shard_batch_device_layout`` is not ported (ROADMAP A6).
"""

from __future__ import annotations

import dataclasses
import re
import math
from typing import Any, Callable, Iterable, Iterator, Mapping

import torch

from tpucfn_torch.mesh import (ALL_AXES, AXIS_CONTEXT, AXIS_EXPERT,
                               AXIS_TENSOR, BATCH_AXES, mesh_device,
                               mesh_sizes)

Spec = tuple
Rule = tuple[str, Spec]
# Axes a model computes on its block of: a tensor-parallel layer takes its
# heads' (or its vocabulary's, its FFN's) rows, an expert-parallel MoE its
# experts.  A split over any other axis only stores the tensor: it is
# gathered where the model uses it.
COMPUTE_AXES = (AXIS_TENSOR, AXIS_EXPERT)


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

    def spec_for(self, path: str, ndim: int,
                 on_rank_mismatch: Callable | None = None) -> Spec:
        """First matching rule's spec, padded with None to ``ndim``; an
        over-long spec goes to ``on_rank_mismatch(path, spec, ndim)``
        when given (the trainer replicates optimizer scalars that mirror
        a parameter's name), else raises."""
        for pat, spec in self.rules:
            if re.search(pat, path):
                if len(spec) > ndim and on_rank_mismatch is not None:
                    return on_rank_mismatch(path, spec, ndim)
                if len(spec) > ndim:
                    raise ValueError(
                        f"rule spec {spec} has {len(spec)} entries but "
                        f"{path!r} has rank {ndim}")
                return tuple(spec) + (None,) * (ndim - len(spec))
        return (None,) * ndim

    def extended(self, head: Iterable[Rule]) -> "ShardingRules":
        """New rules with ``head`` prepended (higher precedence)."""
        return ShardingRules(tuple(head) + self.rules)


def make_partition_spec(rules: ShardingRules, tensors: Mapping[str, Any],
                        on_rank_mismatch: Callable | None = None
                        ) -> dict[str, Spec]:
    """Name -> spec for a dict of tensors (anything with ``.shape``)."""
    return {name: rules.spec_for(name, len(t.shape), on_rank_mismatch)
            for name, t in tensors.items()}



def spec_axes(spec: Spec) -> set[str]:
    """The mesh axes a spec splits a tensor over."""
    out = set()
    for entry in spec:
        if entry is None:
            continue
        out.update((entry,) if isinstance(entry, str) else entry)
    return out


def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec bound to a mesh: where each block of a tensor lives.  With
    ``mesh`` None (one device) every spec places nothing."""

    mesh: Any
    spec: Spec

    def _sizes(self) -> dict[str, int]:
        return {} if self.mesh is None else mesh_sizes(self.mesh)

    def splits(self) -> list[tuple[int, tuple[str, ...]]]:
        """(dim, axes) for every dim split over axes of size > 1, the
        axes of size 1 dropped."""
        sizes = self._sizes()
        out = []
        for dim, entry in enumerate(self.spec):
            axes = tuple(a for a in _entry_axes(entry) if sizes.get(a, 1) > 1)
            if axes:
                out.append((dim, axes))
        return out

    def is_split(self) -> bool:
        return bool(self.splits())

    def _ways(self, axes) -> int:
        sizes = self._sizes()
        return math.prod(sizes[a] for a in axes)

    def local_shape(self, shape) -> tuple[int, ...]:
        """The block's shape of a tensor of global ``shape``; a dim that
        does not split evenly raises, naming the sizes."""
        shape = list(shape)
        for dim, axes in self.splits():
            n = self._ways(axes)
            if shape[dim] % n:
                raise ValueError(
                    f"dim {dim} of {tuple(shape)} does not split over the "
                    f"{n} ranks of mesh axes {axes} (spec {self.spec})")
            shape[dim] //= n
        return tuple(shape)

    def global_shape(self, local_shape) -> tuple[int, ...]:
        shape = list(local_shape)
        for dim, axes in self.splits():
            shape[dim] *= self._ways(axes)
        return tuple(shape)

    def replicas(self) -> int:
        """Ranks that hold the same block (the mesh's size over the
        ways the tensor is split)."""
        if self.mesh is None:
            return 1
        return self.mesh.size() // math.prod(
            self._ways(axes) for _, axes in self.splits())

    def shard(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``full`` (a new tensor)."""
        from tpucfn_torch.collectives import axis_index

        self.local_shape(full.shape)  # evenness, named
        t = full
        for dim, axes in self.splits():
            n = self._ways(axes)
            block = t.shape[dim] // n
            t = t.narrow(dim, axis_index(axes, mesh=self.mesh) * block, block)
        return t.clone()

    def unshard(self, local: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's block (tiled all-gathers
        over each split dim's axes; no gradient)."""
        from tpucfn_torch.collectives import all_gather

        t = local.detach()
        for dim, axes in reversed(self.splits()):
            t = all_gather(t, axes, mesh=self.mesh, gather_axis=dim)
        return t

    def placements(self) -> list:
        """``torch.distributed.tensor`` placements over the mesh's axes,
        for a ``DTensor`` of this layout: ``Shard(dim)`` on each axis that
        splits ``dim``, in the mesh's axis order, which must be the
        spec's order within a tuple entry."""
        from torch.distributed.tensor import Replicate, Shard

        on = {}
        for dim, axes in self.splits():
            order = [a for a in ALL_AXES if a in axes]
            if list(axes) != order:
                raise NotImplementedError(
                    f"spec {self.spec}: axes {axes} of dim {dim} out of the "
                    f"mesh's order {tuple(order)}")
            on.update({a: dim for a in axes})
        return [Shard(on[a]) if a in on else Replicate()
                for a in self.mesh.mesh_dim_names]


def named_sharding_tree(mesh, rules: ShardingRules,
                        tensors: Mapping[str, Any],
                        on_rank_mismatch: Callable | None = None
                        ) -> dict[str, NamedSharding]:
    """Name -> :class:`NamedSharding` of ``rules``' spec on ``mesh``."""
    return {name: NamedSharding(mesh, spec) for name, spec in
            make_partition_spec(rules, tensors, on_rank_mismatch).items()}


def storage_splits(sharding: NamedSharding
                   ) -> list[tuple[int, tuple[str, ...]]]:
    """(dim, axes) of the splits that only store a parameter: those over
    axes outside :data:`COMPUTE_AXES`.  A dim split over both kinds at
    once is refused."""
    out = []
    for dim, axes in sharding.splits():
        compute = [a for a in axes if a in COMPUTE_AXES]
        if compute and len(compute) < len(axes):
            raise NotImplementedError(
                f"spec {sharding.spec}: dim {dim} split over {axes}, which "
                f"mixes compute axes {COMPUTE_AXES} with storage axes")
        if not compute:
            out.append((dim, axes))
    return out


def gather_at_use(t: torch.Tensor, mesh,
                  splits: list[tuple[int, tuple[str, ...]]]) -> torch.Tensor:
    """``t`` all-gathered over each of ``splits``' axes on its dim:
    differentiable, the backward a reduce-scatter (the FSDP pair)."""
    from tpucfn_torch.collectives import all_gather

    for dim, axes in reversed(splits):
        t = all_gather(t, axes, mesh=mesh, gather_axis=dim)
    return t


class ShardedParams(Mapping):
    """The parameters as a loss sees them under sharded rules.  Reading
    ``params[name]`` gathers that parameter's storage splits (its FSDP
    blocks), differentiably, and keeps its compute splits (its tensor or
    expert block); :func:`tpucfn_torch.models.layers.bind_state_dict`
    binds the block itself and gathers it each time its module runs, so
    a model gathers one layer's weights at a time, where it uses them,
    and its backward reduce-scatters their gradients."""

    def __init__(self, local: Mapping[str, torch.Tensor], mesh,
                 splits: Mapping[str, list]):
        self.local, self.mesh = local, mesh
        self.splits = {n: s for n, s in splits.items() if s}

    def __getitem__(self, name: str) -> torch.Tensor:
        t = self.local[name]
        if name not in self.splits:
            return t
        return gather_at_use(t, self.mesh, self.splits[name])

    def gather(self, name: str
               ) -> Callable[[torch.Tensor], torch.Tensor] | None:
        """The gather of ``name``'s block at its use, or None when the
        block is what the model uses."""
        splits = self.splits.get(name)
        if splits is None:
            return None
        return lambda t: gather_at_use(t, self.mesh, splits)

    def __iter__(self) -> Iterator[str]:
        return iter(self.local)

    def __len__(self) -> int:
        return len(self.local)


def batch_spec(extra_axes: tuple[str | None, ...] = ()) -> Spec:
    """Spec of a batch: the leading dim over (data, fsdp, expert), then
    ``extra_axes``."""
    return (BATCH_AXES, *extra_axes)


def context_block(mesh, axis: str = AXIS_CONTEXT) -> tuple[int, int]:
    """(this rank's block, the number of blocks) of a sequence split over
    ``axis``; (0, 1) without a mesh."""
    if mesh is None:
        return 0, 1
    n = mesh_sizes(mesh).get(axis, 1)
    return (mesh.get_local_rank(axis) if n > 1 else 0), n


def shard_batch(mesh, batch: Mapping[str, Any],
                extra_axes: tuple[str | None, ...] = ()) -> dict:
    """Put this process's batch (its rows of the global batch, as
    :class:`tpucfn_torch.data.ShardedDataset` yields them) on its device
    of ``mesh``.  Dim ``1 + j`` of every array is split over
    ``extra_axes[j]`` (None: not split): rank ``i`` of an axis of size
    ``W`` keeps the block ``[i·L/W, (i+1)·L/W)``, as
    ``NamedSharding(mesh, batch_spec(extra_axes))`` lays out the global
    array in the JAX package.  ``("context",)`` is sequence parallelism:
    each rank its contiguous block of positions."""
    device = mesh_device(mesh)
    out = {}
    for key, value in batch.items():
        t = torch.as_tensor(value)
        for dim, axis in enumerate(extra_axes, start=1):
            i, n = (0, 1) if axis is None else context_block(mesh, axis)
            if n == 1:
                continue
            if t.shape[dim] % n:
                raise ValueError(
                    f"batch {key!r} dim {dim} of length {t.shape[dim]} does "
                    f"not split over the {n} ranks of mesh axis {axis!r}")
            block = t.shape[dim] // n
            t = t.narrow(dim, i * block, block)
        out[key] = t.contiguous().to(device)
    return out


def next_block_tokens(tokens: torch.Tensor, mesh) -> torch.Tensor | None:
    """(B, 1): the first token of the next block of the context axis,
    which this block's last position predicts; None on the axis's last
    block, and with the axis at 1.  One ``ring_permute`` of (B, 1) over
    the axis, made by every rank of it."""
    i, n = context_block(mesh)
    if n == 1:
        return None
    from tpucfn_torch.collectives import ring_permute

    nxt = ring_permute(tokens[:, :1].contiguous(), AXIS_CONTEXT, mesh=mesh,
                       shift=-1)
    return None if i == n - 1 else nxt
