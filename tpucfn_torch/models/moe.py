"""Mixture-of-Experts MLP (the port of ``tpucfn/models/moe.py``).

GShard/Switch-style capacity-based top-k routing, as in the JAX package:
the router runs in fp32 on an fp32 cast of the input, top-k over the fp32
softmax, each (token, slot) assignment takes the next free position of
its expert in token-major order (a cumulative count over the flattened
(T, k) assignments), assignments past an expert's capacity
``max(1, round(cf * T * k / E))`` are dropped (their gate is zeroed and
the kept gates renormalized), and the aux losses (Switch load balance
plus router z-loss) and the dropped fraction come from the routing
decisions alone.

Two dispatches, as in the JAX package:

* ``ragged`` (default): each kept assignment owns the row ``expert * C +
  position`` of a flat fp32 (E·C, D) buffer, so dispatch is one
  scatter-add (``index_add_``) of the picked token rows, cast to the
  compute dtype; the return path is one gather weighted by the kept gates.
  A dropped assignment points at one spare row past the buffer, which
  reads back 0.
* ``dense``: the one-hot checker, (T, E, C) dispatch and combine einsums.

The experts are stacked (E, out, in) weights, the port's ``nn.Linear``
layout (``experts.gate_proj.weight`` and ``experts.up_proj.weight`` (E,
F, D), ``experts.down_proj.weight`` (E, D, F)), and their three products
are ``torch.bmm`` over (E, C, ·), as the JAX package's are XLA einsums.
The router weight ``router.weight`` (E, D) is stored in fp32 whatever the
storage dtype of the other weights, as the JAX router's kernel is used in
fp32.

Routing scopes (chosen by whoever builds the layer):

* the call's tokens (default): every (B, S) token of the call, as the JAX
  layer routes the batch it is applied to;
* ``per_row``: each batch row routed alone, with its own capacity from S
  and its own cumulative count, as the JAX serving engine's
  ``jax.vmap`` over slots routes each lane; the rows' buffers are laid
  out (E, B·C, D), so the expert products stay one ``bmm`` each;
* ``route_group`` (data parallelism with an expert axis of 1): routing
  over the GLOBAL batch of the group's ranks, each holding its shard of
  rows in rank order, as XLA routes a batch sharded over the data axis:
  capacity from the global token count, positions offset by the
  per-expert assignment counts of the ranks before (one ``all_gather``
  of an E-vector), and the aux statistics all-reduced before the
  products.  The all-reduce's backward is an all-reduce, so each rank's
  gradient carries every rank's share of the aux loss, and the trainer's
  mean over ranks gives the global gradient;
* ``expert_group`` (the expert-parallel pair, ``_ep_body``): each rank
  holds E/ep experts and routes its own tokens with local capacity; one
  ``all_to_all`` carries each (local expert, capacity) slice to the rank
  that owns the expert and one carries the outputs back.  Their backward
  is the same exchange (``_AllToAll``).  aux and the dropped fraction are
  averaged over every rank of the default group (the JAX layer's
  ``pmean`` over its batch axes).  ``dispatch="dense"`` with an expert
  group of more than one rank raises, as in the JAX package.

Tensor parallelism (``tensor``, a :class:`~tpucfn_torch.parallel.TensorSplit`):
each expert holds ``ffn_dim / T`` of its FFN rows, as the JAX rules put
them on ``tensor``; the routing is the same on every rank of the axis,
and the experts' partial outputs are summed over it before the gates
weight them.

``forward`` returns ``(out, aux, dropped)``; :class:`Llama` sums ``aux``
over its layers and averages ``dropped`` (the JAX layer sows them).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    load_balance_loss: float = 1e-2
    dispatch: str = "ragged"  # "ragged" (scatter/gather) | "dense" (checker)


def capacity(cfg: MoEConfig, n_tokens: int) -> int:
    """Per-expert buffer rows for ``n_tokens`` routed together: Python's
    ``round`` (half to even) on the host, as the JAX layer computes it."""
    return max(1, round(cfg.capacity_factor * n_tokens * cfg.top_k
                        / cfg.n_experts))


def _route(router_logits: torch.Tensor, k: int, capacity: int,
           offset: torch.Tensor | None = None):
    """Routing of G independent groups: ``router_logits`` (G, T, E) fp32.
    Top-k gates on the fp32 softmax, each assignment's position in its
    expert by a cumulative count over the (T, k) assignments flattened
    token-major (plus ``offset`` (E,), the assignments of earlier ranks
    under global routing), drop past ``capacity``, renormalize the kept
    gates.  Returns (probs, gates, expert_idx, onehot, position,
    within_capacity), each with the leading G."""
    g, t, e = router_logits.shape
    probs = torch.softmax(router_logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, k, dim=-1)  # (G, T, k)
    onehot = F.one_hot(expert_idx, e)  # (G, T, k, E) int64
    flatoh = onehot.reshape(g, t * k, e)
    pos = (torch.cumsum(flatoh, dim=1) - flatoh).reshape(g, t, k, e)
    pos = (pos * onehot).sum(-1)  # (G, T, k)
    if offset is not None:
        pos = pos + offset[expert_idx]
    within = pos < capacity
    gate_vals = gate_vals * within
    denom = gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate_vals / denom, expert_idx, onehot, pos, within


def _aux_sums(router_logits, probs, expert_idx, within):
    """Per group: kept assignments per expert (E,), the summed router
    probabilities (E,) and the summed squared logsumexp — the sufficient
    statistics of the aux losses, summable across ranks."""
    e = probs.shape[-1]
    counts = torch.zeros(probs.shape[0], e, dtype=torch.float32,
                         device=probs.device)
    counts.scatter_add_(1, expert_idx.flatten(1),
                        within.flatten(1).to(torch.float32))
    return (counts, probs.sum(1),
            (torch.logsumexp(router_logits, dim=-1) ** 2).sum(1))


def _aux_from_sums(cfg: MoEConfig, counts, prob_sum, lse2_sum, n_tokens):
    """Switch load balance + router z-loss, and the dropped fraction, from
    :func:`_aux_sums` over ``n_tokens`` tokens (the last axis is E)."""
    e, k = counts.shape[-1], cfg.top_k
    kept = counts.sum(-1)
    token_frac = counts / kept.clamp_min(1.0)[..., None]
    prob_frac = prob_sum / n_tokens
    lb = e * (token_frac * prob_frac).sum(-1) * cfg.load_balance_loss
    zl = lse2_sum / n_tokens * cfg.router_z_loss
    dropped = 1.0 - torch.clamp(kept / (n_tokens * k), max=1.0)
    return lb + zl, dropped


class _AllReduceSum(torch.autograd.Function):
    """Sum over ``group``; the backward sums the incoming gradients over
    the group (every rank's loss depends on the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` over ``group`` with equal splits along dim 0;
    the exchange is its own transpose, so the backward is the same
    exchange of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_to_all(grad, ctx.group), None


def _all_to_all(x, group):
    import torch.distributed as dist

    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _group_rank_size(group):
    import torch.distributed as dist

    return dist.get_rank(group), dist.get_world_size(group)


class _Stacked(nn.Module):
    """One stacked expert weight, (E, out, in)."""

    def __init__(self, shape, dtype, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(shape, dtype=dtype,
                                               device=device))


class MoEMLP(nn.Module):
    """Drop-in replacement for the dense SwiGLU MLP (see the module
    docstring for the routing scopes).  ``expert_group``: the layer holds
    ``n_experts / size`` experts, this rank's slice in rank order."""

    def __init__(self, dim: int, ffn_dim: int, moe: MoEConfig,
                 dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype | None = None, device=None, *,
                 per_row: bool = False, route_group=None,
                 expert_group=None, tensor=None):
        super().__init__()
        self.tensor = tensor
        if tensor is not None:
            ffn_dim = tensor.local(ffn_dim, "FFN rows")
        if moe.dispatch not in ("ragged", "dense"):
            raise ValueError(
                f"unknown MoE dispatch {moe.dispatch!r} (ragged|dense)")
        self.moe, self.dtype = moe, dtype
        self.per_row, self.route_group = per_row, route_group
        self.expert_group = expert_group
        ep = 1 if expert_group is None else _group_rank_size(expert_group)[1]
        e = moe.n_experts
        if e % ep:
            raise ValueError(
                f"n_experts {e} not divisible by expert-axis size {ep}")
        if ep > 1 and moe.dispatch != "ragged":
            raise ValueError(
                f"dispatch={moe.dispatch!r} with an active expert axis "
                f"(size {ep}): the expert-parallel path always runs the "
                "ragged all-to-all dispatch; 'dense' is the single-device "
                "reference checker only")
        if ep > 1 and (per_row or route_group is not None):
            raise ValueError("the expert-parallel path routes each rank's "
                             "own tokens: no per_row or route_group")
        if per_row and route_group is not None:
            raise ValueError("per_row routing is local to the call")
        self.ep = ep
        el, wdt = e // ep, param_dtype or dtype
        self.router = nn.Linear(dim, e, bias=False, dtype=torch.float32,
                                device=device)
        self.experts = nn.Module()
        self.experts.gate_proj = _Stacked((el, ffn_dim, dim), wdt, device)
        self.experts.up_proj = _Stacked((el, ffn_dim, dim), wdt, device)
        self.experts.down_proj = _Stacked((el, dim, ffn_dim), wdt, device)

    def _experts(self, expert_in: torch.Tensor) -> torch.Tensor:
        """The SwiGLU of every expert over its (E, C, D) rows."""
        dt = self.dtype
        wg, wu, wd = (m.weight.to(dt) for m in (
            self.experts.gate_proj, self.experts.up_proj,
            self.experts.down_proj))
        if self.tensor is not None:
            expert_in = self.tensor.copy_to(expert_in)
        h = F.silu(torch.bmm(expert_in, wg.transpose(1, 2))) \
            * torch.bmm(expert_in, wu.transpose(1, 2))
        out = torch.bmm(h, wd.transpose(1, 2))
        if self.tensor is not None:
            return self.tensor.reduce_from(out)
        return out

    def forward(self, x: torch.Tensor):
        """(B, S, D) -> ((B, S, D) in the compute dtype, aux, dropped)."""
        cfg = self.moe
        b, s, d = x.shape
        e, k = cfg.n_experts, cfg.top_k
        logits = self.router(x.float())  # fp32 weight: an fp32 product
        if self.ep > 1:
            return self._ep_forward(x, logits.reshape(1, b * s, e))
        if self.per_row:
            groups, n = b, s  # each row alone
        else:
            groups, n = 1, b * s
        logits = logits.reshape(groups, n, e)
        offset, n_route = None, n
        if self.route_group is not None:
            rank, world = _group_rank_size(self.route_group)
            n_route = n * world
        cap = capacity(cfg, n_route)
        if self.route_group is not None:
            offset = self._rank_offset(logits, rank, world)
        probs, gates, idx, onehot, pos, within = _route(logits, k, cap,
                                                        offset)
        counts, prob_sum, lse2_sum = _aux_sums(logits, probs, idx, within)
        if self.route_group is not None:
            import torch.distributed as dist

            dist.all_reduce(counts, group=self.route_group)
            prob_sum = _AllReduceSum.apply(prob_sum, self.route_group)
            lse2_sum = _AllReduceSum.apply(lse2_sum, self.route_group)
        aux, dropped = _aux_from_sums(cfg, counts, prob_sum, lse2_sum,
                                      n_route)
        xt = x.reshape(groups, n, d)
        if cfg.dispatch == "ragged":
            out = self._ragged(xt, gates, idx, pos, within, cap)
        else:
            out = self._dense(xt, gates, onehot, pos, within, cap)
        return (out.reshape(b, s, d).to(self.dtype), aux.mean(),
                dropped.mean())

    def _rank_offset(self, logits, rank, world):
        """(E,) assignments of the ranks before this one, every one of
        them (kept or not), as the global cumulative count sees them."""
        import torch.distributed as dist

        with torch.no_grad():
            idx = torch.topk(logits[0], self.moe.top_k, dim=-1).indices
            mine = torch.bincount(idx.flatten(),
                                  minlength=self.moe.n_experts)
            every = [torch.empty_like(mine) for _ in range(world)]
            dist.all_gather(every, mine, group=self.route_group)
            return sum(every[:rank], torch.zeros_like(mine))

    def _ragged(self, xt, gates, idx, pos, within, cap):
        """Scatter-add of the kept (token, slot) rows into a flat fp32
        buffer laid out (E, G·C, D), the experts' products, and the gated
        gather back; dropped assignments use the spare last row."""
        g, n, d = xt.shape
        e, k = self.moe.n_experts, self.moe.top_k
        rows = g * cap
        group = torch.arange(g, device=xt.device)[:, None, None]
        slot = torch.where(within, idx * rows + group * cap + pos,
                           e * rows).reshape(-1)
        picked_in = xt.reshape(g * n, 1, d).expand(g * n, k, d) \
            .reshape(-1, d).float()
        buf = torch.zeros(e * rows + 1, d, dtype=torch.float32,
                          device=xt.device).index_add(0, slot, picked_in)
        expert_in = buf[:e * rows].reshape(e, rows, d).to(self.dtype)
        flat_out = self._experts(expert_in).float().reshape(e * rows, d)
        flat_out = torch.cat([flat_out, flat_out.new_zeros(1, d)])
        picked = flat_out.index_select(0, slot)
        return (picked * gates.reshape(-1, 1)).reshape(g * n, k, d).sum(1)

    def _dense(self, xt, gates, onehot, pos, within, cap):
        """The one-hot checker: (T, E, C) dispatch and combine einsums,
        per group, concatenated along C."""
        outs = []
        for gi in range(xt.shape[0]):
            oh = onehot[gi].float()
            cap_oh = F.one_hot(pos[gi].clamp(max=cap - 1), cap).float() \
                * within[gi][..., None]
            disp = torch.einsum("tke,tkc->tec", oh, cap_oh)
            expert_in = torch.einsum("tec,td->ecd", disp,
                                     xt[gi].float()).to(self.dtype)
            expert_out = self._experts(expert_in)
            combine = torch.einsum("tke,tkc,tk->tec", oh, cap_oh, gates[gi])
            outs.append(torch.einsum("tec,ecd->td", combine,
                                     expert_out.float()))
        return torch.cat(outs)

    def _ep_forward(self, x, logits):
        """The expert-parallel pair (``_ep_body`` and ``_ep_apply`` of the
        JAX layer): local routing and scatter, one exchange out, the
        local experts, one exchange back."""
        import torch.distributed as dist

        cfg = self.moe
        b, s, d = x.shape
        e, k, ep = cfg.n_experts, cfg.top_k, self.ep
        el, t_loc = e // ep, b * s
        cap = capacity(cfg, t_loc)
        probs, gates, idx, _, pos, within = _route(logits, k, cap)
        slot = torch.where(within, idx * cap + pos, e * cap).reshape(-1)
        xt = x.reshape(t_loc, d)
        picked_in = xt[:, None].expand(t_loc, k, d).reshape(-1, d).float()
        buf = torch.zeros(e * cap + 1, d, dtype=torch.float32,
                          device=x.device).index_add(0, slot, picked_in)
        send = buf[:e * cap].reshape(ep, el, cap, d).to(self.dtype)
        recv = _AllToAll.apply(send, self.expert_group)  # (src, el, cap, d)
        expert_in = recv.transpose(0, 1).reshape(el, ep * cap, d)
        eo = self._experts(expert_in)
        back = eo.reshape(el, ep, cap, d).transpose(0, 1)
        ret = _AllToAll.apply(back, self.expert_group)  # (owner, el, cap, d)
        flat_out = ret.reshape(e * cap, d).float()
        flat_out = torch.cat([flat_out, flat_out.new_zeros(1, d)])
        out = (flat_out.index_select(0, slot) * gates.reshape(-1, 1)) \
            .reshape(t_loc, k, d).sum(1)
        aux, dropped = _aux_from_sums(
            cfg, *_aux_sums(logits, probs, idx, within), t_loc)
        n = dist.get_world_size()
        aux = _AllReduceSum.apply(aux.reshape(()), None) / n
        dropped = dropped.reshape(()).detach().clone()
        dist.all_reduce(dropped)
        return (out.reshape(b, s, d).to(self.dtype), aux, dropped / n)


def collect_moe_aux(losses) -> torch.Tensor:
    """The sum of the MoE aux losses in ``losses`` (a tensor, a list of
    per-layer tensors, or nested dicts of them, as a forward returns
    them); 0.0 when there are none."""
    total = torch.zeros((), dtype=torch.float32)
    stack = [losses]
    while stack:
        leaf = stack.pop()
        if isinstance(leaf, dict):
            stack.extend(leaf.values())
        elif isinstance(leaf, (list, tuple)):
            stack.extend(leaf)
        elif leaf is not None:
            leaf = torch.as_tensor(leaf)
            total = total.to(leaf.device) + leaf.float().sum()
    return total
