"""Ulysses sequence parallelism: an all-to-all head scatter (the port of
``tpucfn/kernels/ulysses.py``).

The other SP mode: instead of rotating K/V around a ring, one all-to-all
turns this rank's sequence block of every head into the whole sequence
of its share of the heads, any attention runs on that unchanged, and a
second all-to-all turns it back.  Heads are the unit scattered, so the
context axis must divide the query and the KV heads the rank holds: all
of them, or under tensor parallelism its block of them.
"""

from __future__ import annotations

from typing import Callable, Sequence

from tpucfn_torch.collectives import all_to_all, axis_size
from tpucfn_torch.mesh import (AXIS_CONTEXT, AXIS_TENSOR, BATCH_AXES,
                               mesh_sizes)


def make_ulysses_attention(mesh, *, seq_axis: str = AXIS_CONTEXT,
                           heads_axis: str | None = AXIS_TENSOR,
                           batch_axes: Sequence[str] = BATCH_AXES,
                           inner: Callable | None = None):
    """AttentionFn over this rank's (B, S_loc, H, D) blocks.  ``inner=None``
    is the model's dense/flash policy
    (:func:`tpucfn_torch.kernels.auto.auto_attention_static_zero`) on the
    GATHERED sequence length.  ``batch_axes`` is kept for the JAX
    signature.  With heads split over ``heads_axis`` (tensor parallelism)
    the rank's own heads are scattered, and must divide over the context
    axis."""
    del batch_axes
    t = 1 if heads_axis is None else mesh_sizes(mesh).get(heads_axis, 1)
    if inner is None:
        from tpucfn_torch.kernels.auto import auto_attention_static_zero

        inner = auto_attention_static_zero

    def attention_fn(q, k, v, *, causal=True, mask=None, q_offset=0,
                     k_offset=0):
        if mask is not None:
            raise NotImplementedError("ulysses attention is causal-only here")
        n = axis_size(seq_axis, mesh=mesh)
        if q.shape[2] % n or k.shape[2] % n:
            held = "" if t == 1 else (
                f" (this rank's block over {heads_axis} of size {t})")
            raise ValueError(
                f"heads {q.shape[2]}/{k.shape[2]}{held} not divisible by "
                f"context axis {n} — use ring attention instead")

        # (B, S/n, H, D) -> (B, S, H/n, D): scatter heads, gather sequence
        def a2a(x):
            return all_to_all(x, seq_axis, mesh=mesh, split_axis=2,
                              concat_axis=1)

        out = inner(a2a(q), a2a(k), a2a(v), causal=causal)
        # (B, S, H/n, D) -> (B, S/n, H, D)
        return all_to_all(out, seq_axis, mesh=mesh, split_axis=1,
                          concat_axis=2)

    return attention_fn
