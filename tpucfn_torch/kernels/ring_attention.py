"""Ring attention: causal attention over a context-sharded sequence (the
port of ``tpucfn/kernels/ring_attention.py``).

The sequence is split over the ``context`` mesh axis, one block a rank, in
axis order.  Each rank keeps its Q block; the K/V blocks rotate around the
ring (:func:`tpucfn_torch.collectives.ring_permute`), one neighbour hop a
step, and the hops' partial results merge by their log-sum-exp, so the
result is exactly full attention with O(S/N · S/N) logits a hop.

``hop_attention="flash"`` runs each hop through the hand-written kernels
(:func:`tpucfn_torch.kernels.flash_attention.flash_attention_with_lse`:
K1 forward; Delta, K2 and K3 backward, with the dLSE the merge feeds back)
by the causal trichotomy: relative to this rank's queries a KV block is
the same block (causal), strictly in the past (no mask) or strictly in
the future (contributes nothing and launches nothing).  The hop indices
are host integers here, so Python picks the branch.  ``"dense"`` runs
the plain attention with the blocks' global offsets; ``"auto"`` picks
flash by :func:`tpucfn_torch.kernels.auto.should_use_flash` on the local
block length, which on the card is always flash.

K and V travel together as one stacked tensor, one ``ring_permute`` a
hop, so every rank makes the same collectives in the same order in the
forward and in the backward; the last hop sends nothing.  The backward
reaches every exchange on every rank, also on a rank whose later hops
are all in the future (:class:`_KeepRing`).

:func:`ring_hops` is the hop loop alone, with the exchange replaced by a
caller's supplier of each hop's (K, V): ``chip_smoke.py`` runs the ring's
numerics on one card with it, as W virtual ranks.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from tpucfn_torch.collectives import axis_index, axis_size, ring_permute
from tpucfn_torch.kernels.flash_attention import flash_attention_with_lse
from tpucfn_torch.mesh import AXIS_CONTEXT, AXIS_TENSOR, BATCH_AXES
from tpucfn_torch.ops.attention import NEG_INF, dot_product_attention_with_lse


def _merge(o, lse, blk_o, blk_lse):
    """Online-softmax combine of two partial attention results."""
    new_lse = torch.logaddexp(lse, blk_lse)
    # empty ∪ empty stays empty; guard the exp against NEG_INF - NEG_INF
    w_old = torch.where(lse > NEG_INF / 2, torch.exp(lse - new_lse), 0.0)
    w_new = torch.where(blk_lse > NEG_INF / 2, torch.exp(blk_lse - new_lse),
                        0.0)
    o = o * w_old[..., None] + blk_o.float() * w_new[..., None]
    return o, new_lse


def _flash_hop(q, kk, vv, *, step, src, idx, causal):
    """One hop through the kernels, the mask by the causal trichotomy:
    step 0 holds the rank's own block (causal), a past block needs no
    mask, a future one contributes nothing (None: no launch)."""
    if not causal or src < idx:
        return flash_attention_with_lse(q, kk, vv, causal=False)
    if step == 0:  # src == idx exactly when step == 0
        return flash_attention_with_lse(q, kk, vv, causal=True)
    return None


def _resolve_hop_attention(hop_attention: str, q: torch.Tensor) -> str:
    """``"flash"`` or ``"dense"`` for a hop of ``q``'s block."""
    if hop_attention not in ("auto", "dense", "flash"):
        raise ValueError(f"hop_attention {hop_attention!r} not in "
                         "('auto', 'dense', 'flash')")
    if hop_attention != "auto":
        return hop_attention
    from tpucfn_torch.kernels.auto import should_use_flash

    return ("flash" if should_use_flash(q.shape[1], d=q.shape[-1],
                                        dtype=q.dtype, device=q.device)
            else "dense")


def ring_hops(q: torch.Tensor,
              kv_at: Callable[[int], tuple[torch.Tensor, torch.Tensor]], *,
              size: int, index: int, causal: bool = True,
              hop_attention: str = "auto") -> torch.Tensor:
    """The ring's hop loop for the rank at ``index`` of ``size``:
    ``kv_at(step)`` gives the (K, V) block that rank holds at ``step``,
    the block of rank ``(index - step) % size``; the steps are asked for
    in order, each once.  q (B, S_loc, H, D) -> (B, S_loc, H, D)."""
    hop_attention = _resolve_hop_attention(hop_attention, q)
    q = q.contiguous()
    sq = q.shape[1]
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.full(q.shape[:3], NEG_INF, dtype=torch.float32,
                     device=q.device)  # (B, S_loc, H)
    for step in range(size):
        src = (index - step) % size
        kk, vv = (t.contiguous() for t in kv_at(step))
        if causal and src > index:
            continue  # a future block: every row masked, the merge a no-op
        if hop_attention == "flash":
            blk = _flash_hop(q, kk, vv, step=step, src=src, idx=index,
                             causal=causal)
        else:
            blk = dot_product_attention_with_lse(
                q, kk, vv, causal=causal, q_offset=index * sq,
                k_offset=src * kk.shape[1])
        o, lse = _merge(o, lse, *blk)
    return o.to(q.dtype)


class _KeepRing(torch.autograd.Function):
    """Returns ``out`` and ties the ring's last K/V block to it with a zero
    gradient, so the backward runs every exchange on every rank: a rank
    whose later hops all lie in the future uses none of the blocks it
    received, and would otherwise skip the exchanges its neighbours wait
    on."""

    @staticmethod
    def forward(ctx, out, kv):
        ctx.kv = (kv.shape, kv.dtype, kv.device)
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.kv
        return g, torch.zeros(shape, dtype=dtype, device=device)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   mesh, axis: str = AXIS_CONTEXT, causal: bool = True,
                   hop_attention: str = "auto") -> torch.Tensor:
    """This rank's ring attention: q (B, S_loc, H, D), k/v (B, S_loc,
    Hkv, D), the rank's blocks of a sequence split over ``axis`` of
    ``mesh`` in axis order."""
    n = axis_size(axis, mesh=mesh)
    held = [torch.stack([k, v])]

    def kv_at(step):
        if step:
            held[0] = ring_permute(held[0], axis, mesh=mesh)
        return held[0][0], held[0][1]

    out = ring_hops(q, kv_at, size=n, index=axis_index(axis, mesh=mesh),
                    causal=causal, hop_attention=hop_attention)
    if n > 1 and torch.is_grad_enabled() and held[0].requires_grad:
        out = _KeepRing.apply(out, held[0])
    return out


def make_ring_attention(mesh, *, seq_axis: str = AXIS_CONTEXT,
                        heads_axis: str | None = AXIS_TENSOR,
                        batch_axes: Sequence[str] = BATCH_AXES,
                        hop_attention: str = "auto"):
    """AttentionFn for the model layer: this rank's (B, S_loc, H, D)
    blocks in, ring attention over ``seq_axis`` inside.  Plugs into
    ``CausalSelfAttention(attention_fn=...)``; the ring derives its blocks'
    offsets from the axis index and ignores ``q_offset``/``k_offset``.
    ``batch_axes`` and ``heads_axis`` are kept for the JAX signature: each
    rank holds its own rows, and, with heads split over ``heads_axis``
    (tensor parallelism), its own heads, which the ring runs on as they
    are."""
    del batch_axes, heads_axis

    def attention_fn(q, k, v, *, causal=True, mask=None, q_offset=0,
                     k_offset=0):
        if mask is not None:
            raise NotImplementedError("ring attention is causal-only")
        return ring_attention(q, k, v, mesh=mesh, axis=seq_axis,
                              causal=causal, hop_attention=hop_attention)

    return attention_fn
