"""Megatron tensor parallelism for the port's layers: what XLA inserts in
the JAX package when the rules put a layer's heads, FFN rows or
vocabulary on the ``tensor`` axis.

A column-parallel product (q/k/v, gate/up, the LM head) takes a
replicated input and gives this rank's block of the output features; a
row-parallel one (o, down) takes such a block and gives a partial sum of
the output.  Three differentiable ops join them, each the other's
transpose in the pair:

* :meth:`TensorSplit.copy_to`: the identity forward, a sum over the axis
  backward (a replicated input's gradient is every rank's share of it);
* :meth:`TensorSplit.reduce_from`: a sum over the axis forward, the
  identity backward (every rank goes on with the same sum);
* :meth:`TensorSplit.gather_from`: the blocks concatenated forward, this
  rank's block of the gradient backward.

A :class:`TensorSplit` with no mesh is a virtual rank: its ops are the
identity, and the caller sums the partial outputs of every rank itself
(``chip_smoke.py`` runs the ranks of one layer so on one card).
:func:`vocab_parallel_cross_entropy` is the token CE over a vocabulary
split on the axis: the log-sum-exp, the target's logit and the argmax
span every rank's block.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from tpucfn_torch.mesh import AXIS_TENSOR


def _group(mesh):
    return mesh.get_group(AXIS_TENSOR)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, index, dim):
        ctx.size, ctx.index, ctx.dim = size, index, dim
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        block = g.shape[ctx.dim] // ctx.size
        return (g.narrow(ctx.dim, ctx.index * block, block).contiguous(),
                None, None, None, None)


@dataclasses.dataclass(frozen=True)
class TensorSplit:
    """This rank's place on the ``tensor`` axis: ``size`` ranks, this one
    at ``index``; ``mesh`` None for a virtual rank (identity ops)."""

    size: int
    index: int
    mesh: Any = None

    def local(self, n: int, what: str) -> int:
        """``n`` (heads, rows) over the axis; refused, naming the sizes,
        when the axis does not divide it."""
        if n % self.size:
            raise ValueError(f"{what} {n} do not split over the tensor "
                             f"axis of size {self.size}")
        return n // self.size

    def copy_to(self, x: torch.Tensor) -> torch.Tensor:
        if self.mesh is None:
            return x
        return _CopyTo.apply(x, _group(self.mesh))

    def reduce_from(self, x: torch.Tensor) -> torch.Tensor:
        if self.mesh is None:
            return x
        return _ReduceFrom.apply(x, _group(self.mesh))

    def gather_from(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        if self.mesh is None:
            raise ValueError("a virtual rank holds no other rank's block")
        return _GatherFrom.apply(x, _group(self.mesh), self.size,
                                 self.index, dim % x.ndim)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise maximum over the axis (no gradient)."""
        x = x.detach().contiguous().clone()
        if self.mesh is not None:
            dist.all_reduce(x, op=dist.ReduceOp.MAX, group=_group(self.mesh))
        return x


def tensor_split(mesh) -> TensorSplit | None:
    """The split of ``mesh``'s tensor axis for this rank; None without a
    mesh or with the axis at 1."""
    if mesh is None:
        return None
    size = dict(zip(mesh.mesh_dim_names, mesh.shape)).get(AXIS_TENSOR, 1)
    if size == 1:
        return None
    return TensorSplit(size, mesh.get_local_rank(AXIS_TENSOR), mesh)


def vocab_parallel_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                                 z_loss: float, split: TensorSplit
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """``token_cross_entropy`` (per-token CE plus ``z_loss *
    logsumexp**2``, and whether the argmax hits) over ``logits`` (..., V/T),
    this rank's block of the vocabulary, rows ``[index·V/T, (index+1)·V/T)``.
    The result is the same on every rank of the axis; its gradient
    reaches each rank's own logits only."""
    v_loc = logits.shape[-1]
    lo = split.index * v_loc
    local_max = logits.detach().max(-1).values
    m = split.max(local_max)
    sum_exp = split.reduce_from(torch.exp(logits - m[..., None]).sum(-1))
    lse = m + torch.log(sum_exp)
    mine = (targets >= lo) & (targets < lo + v_loc)
    picked = logits.gather(-1, (targets - lo).clamp(0, v_loc - 1)[..., None])
    picked = split.reduce_from(torch.where(mine, picked[..., 0], 0.0))
    per_tok = lse - picked
    if z_loss:
        per_tok = per_tok + z_loss * lse ** 2
    # The argmax over the whole vocabulary: the first index at the global
    # maximum, as torch.argmax picks.
    first = logits.detach().argmax(-1) + lo
    at_max = torch.where(local_max == m, first, torch.iinfo(first.dtype).max)
    argmax = -split.max(-at_max)
    return per_tok, argmax == targets
