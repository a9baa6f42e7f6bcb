"""Named-axis collective wrappers (the port of ``tpucfn/collectives/ops.py``).

The JAX wrappers run inside a ``shard_map`` axis context; here each rank is
a process, and an axis name resolves to the process group of that axis of a
six-axis ``DeviceMesh`` (:func:`tpucfn_torch.mesh.build_mesh`), which every
wrapper takes as ``mesh``.  A tuple of axes is one flattened group, its
coordinate row-major over the axes in the order given, as ``lax`` reads a
tuple.  At an axis (or tuple) of size 1 every wrapper returns its input
without a collective: gloo refuses a send to self.

``psum``/``pmean``, ``all_gather``/``reduce_scatter``, ``ring_permute`` and
``all_to_all`` are differentiable: the gradient of a sum over the group is
the sum of the gradients, a tiled all-gather and a reduce-scatter are each
other's transpose, ``ring_permute(x, shift)``'s is ``ring_permute(g,
-shift)`` and ``all_to_all``'s is the inverse exchange.  ``pmax`` is
forward-only.  ``ring_permute`` posts its send and its receive together
(``batch_isend_irecv``), so a ring of ranks cannot wait on itself.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.distributed as dist

AxisName = str | Sequence[str]


def _axes(axis: AxisName) -> tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def axis_size(axis: AxisName, *, mesh) -> int:
    """Size of a mesh axis (the product over a tuple)."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return math.prod(sizes[a] for a in _axes(axis))


def axis_index(axis: AxisName, *, mesh) -> int:
    """This rank's coordinate along ``axis`` (0-based; row-major over a
    tuple)."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    idx = 0
    for a in _axes(axis):
        idx = idx * sizes[a] + mesh.get_local_rank(a)
    return idx


def _group(axis: AxisName, mesh):
    """The process group of ``axis``: the axis's own, or, over a tuple
    with more than one axis of size > 1, the flattened submesh's."""
    axes = _axes(axis)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    split = [a for a in axes if sizes[a] > 1]
    if len(split) == 1:
        return mesh.get_group(split[0])
    return mesh[axes]._flatten().get_group()


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return _Psum.apply(g.contiguous(), ctx.group), None


def psum(x: torch.Tensor, axis: AxisName, *, mesh) -> torch.Tensor:
    """Sum across ``axis``: the gradient all-reduce."""
    if axis_size(axis, mesh=mesh) == 1:
        return x
    return _Psum.apply(x.contiguous(), _group(axis, mesh))


def pmean(x: torch.Tensor, axis: AxisName, *, mesh) -> torch.Tensor:
    """Mean across ``axis``: gradient averaging, metric reduction."""
    return psum(x, axis, mesh=mesh) / axis_size(axis, mesh=mesh)


def pmax(x: torch.Tensor, axis: AxisName, *, mesh) -> torch.Tensor:
    """Maximum across ``axis`` (forward-only)."""
    if axis_size(axis, mesh=mesh) == 1:
        return x
    out = x.detach().clone().contiguous()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=_group(axis, mesh))
    return out


def _gather(x, group, n, dim):
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _scatter(x, group, n, dim):
    chunks = x.chunk(n, dim=dim)
    flat = torch.cat([c.reshape(-1) for c in chunks])
    out = torch.empty(chunks[0].numel(), dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, flat, group=group)
    return out.view(chunks[0].shape)


class _AllGather(torch.autograd.Function):
    """Tiled all-gather along ``dim``; its transpose is a reduce-scatter."""

    @staticmethod
    def forward(ctx, x, group, n, dim):
        ctx.group, ctx.n, ctx.dim = group, n, dim
        return _gather(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        return _ReduceScatter.apply(g, ctx.group, ctx.n, ctx.dim), None, \
            None, None


class _ReduceScatter(torch.autograd.Function):
    """Sum, then keep this rank's block of ``dim``; its transpose is a
    tiled all-gather."""

    @staticmethod
    def forward(ctx, x, group, n, dim):
        ctx.group, ctx.n, ctx.dim = group, n, dim
        return _scatter(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        return _AllGather.apply(g, ctx.group, ctx.n, ctx.dim), None, None, \
            None


def all_gather(x: torch.Tensor, axis: AxisName, *, mesh, tiled: bool = True,
               gather_axis: int = 0) -> torch.Tensor:
    """Gather shards along ``axis``; ``tiled=True`` concatenates on
    ``gather_axis`` (FSDP param gather), ``tiled=False`` stacks a new
    axis there."""
    n = axis_size(axis, mesh=mesh)
    if not tiled:
        x = x.unsqueeze(gather_axis)
    if n == 1:
        return x
    return _AllGather.apply(x, _group(axis, mesh), n,
                            gather_axis % x.ndim)


def reduce_scatter(x: torch.Tensor, axis: AxisName, *, mesh,
                   scatter_axis: int = 0) -> torch.Tensor:
    """Sum across ``axis``, then keep this rank's block of
    ``scatter_axis``: FSDP gradient reduction at 1/N the bytes of a psum."""
    n = axis_size(axis, mesh=mesh)
    if n == 1:
        return x
    if x.shape[scatter_axis] % n:
        raise ValueError(f"dim {scatter_axis} of {tuple(x.shape)} does not "
                         f"split over {n} ranks")
    return _ReduceScatter.apply(x, _group(axis, mesh), n,
                                scatter_axis % x.ndim)


def _permute(x, group, n, shift):
    """Send ``x`` to the rank ``shift`` places on around the group's ring
    and receive from the rank ``shift`` places back."""
    ranks = dist.get_process_group_ranks(group)
    i = ranks.index(dist.get_rank())
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, ranks[(i + shift) % n], group),
           dist.P2POp(dist.irecv, out, ranks[(i - shift) % n], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, shift):
        ctx.group, ctx.n, ctx.shift = group, n, shift
        return _permute(x, group, n, shift)

    @staticmethod
    def backward(ctx, g):
        return _RingPermute.apply(g, ctx.group, ctx.n, -ctx.shift), None, \
            None, None


def ring_permute(x: torch.Tensor, axis: str, *, mesh,
                 shift: int = 1) -> torch.Tensor:
    """Rotate shards around ``axis`` as a ring: shard i's value goes to
    shard (i + shift) % N.  Ring attention's KV rotation and the pipeline
    stage hand-off."""
    n = axis_size(axis, mesh=mesh)
    if shift % n == 0:
        return x
    return _RingPermute.apply(x, _group(axis, mesh), n, shift)


def _exchange(x, group, n, split_axis, concat_axis):
    chunks = torch.stack(x.chunk(n, dim=split_axis)).contiguous()
    out = torch.empty_like(chunks)
    dist.all_to_all_single(out, chunks, group=group)
    return torch.cat(out.unbind(0), dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, split_axis, concat_axis):
        ctx.args = group, n, split_axis, concat_axis
        return _exchange(x, group, n, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        group, n, split_axis, concat_axis = ctx.args
        return _AllToAll.apply(g, group, n, concat_axis, split_axis), None, \
            None, None, None


def all_to_all(x: torch.Tensor, axis: str, *, mesh, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """Scatter ``split_axis`` across ``axis`` while gathering the axis into
    ``concat_axis`` (tiled): block j of ``split_axis`` goes to rank j, and
    the blocks received are concatenated on ``concat_axis`` in rank order.
    Ulysses's head scatter and MoE expert dispatch."""
    n = axis_size(axis, mesh=mesh)
    if n == 1:
        return x
    if x.shape[split_axis] % n:
        raise ValueError(f"dim {split_axis} of {tuple(x.shape)} does not "
                         f"split over {n} ranks")
    return _AllToAll.apply(x, _group(axis, mesh), n, split_axis % x.ndim,
                           concat_axis % x.ndim)
