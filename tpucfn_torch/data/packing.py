"""Packed-sequence training: many short documents per (B, S) row (the
port of ``tpucfn/data/packing.py``).

* :func:`pack_sequences` — a copy of the JAX package's greedy first-fit
  packer (numpy; held equal to it by ``tests/test_torch_isolation.py``):
  (N, S) ``tokens`` + 1-based ``segments`` (0 = pad).
* :func:`packed_attention_fn` — an attention op that masks attention
  across segment boundaries: the flash kernels' segment path (K1 forward,
  K2/K3 backward; no (S, S) mask is built) where the dispatch policy of
  :mod:`tpucfn_torch.kernels.auto` picks flash — CUDA tensors at zero
  offsets, unless the tune table measured dense faster for the family —
  and an explicit
  dense mask everywhere else, as the JAX package does.
  The dense path also keeps padding queries (segment 0) from attending;
  the kernel path lets them attend to padding keys, which the loss never
  reads — compare only valid positions across the two.
* :func:`packed_causal_lm_loss` — next-token CE only where target and
  input share a segment (no cross-document prediction, no loss on pad);
  :func:`packed_loss_weight` counts those positions, the weight of a
  rank's loss under data parallelism.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch


def pack_sequences(
    sequences: Iterable[np.ndarray],
    seq_len: int,
    *,
    pad_id: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Greedy first-fit packing. Returns (tokens (N, S) int32,
    segments (N, S) int32 — 1-based per-row document ids, 0 on padding).

    Documents longer than ``seq_len`` raise (chunk upstream — silently
    truncating data is how eval numbers lie)."""
    rows: list[list[int]] = []
    segs: list[list[int]] = []
    counts: list[int] = []
    # Shortest document in the corpus: any row whose remaining capacity
    # drops below it can never accept another document, so it leaves the
    # open list for good. First-fit results are bit-identical (a dropped
    # row would never have been chosen), but the per-document scan is
    # over OPEN rows only — on real corpora that is what keeps packing
    # from going quadratic in document count (ADVICE r3).
    # Materialize first: the pre-scan below iterates the input a second
    # time, and a one-pass iterator/generator (part of the accepted
    # Iterable contract) would arrive at the main loop already consumed
    # (ADVICE r4).
    sequences = [np.asarray(s) for s in sequences]
    lens = [len(s) for s in sequences]
    min_len = min((n for n in lens if n > 0), default=0)
    open_rows: list[int] = []  # indices into rows, in creation order
    for seq in sequences:
        if seq.ndim != 1:
            raise ValueError(f"sequences must be rank-1, got shape {seq.shape}")
        if len(seq) > seq_len:
            raise ValueError(
                f"document of length {len(seq)} exceeds seq_len {seq_len}; "
                "chunk it upstream")
        if len(seq) == 0:
            continue
        placed_at = None
        for pos, i in enumerate(open_rows):
            if len(rows[i]) + len(seq) <= seq_len:
                counts[i] += 1
                rows[i].extend(int(t) for t in seq)
                segs[i].extend([counts[i]] * len(seq))
                placed_at = pos
                break
        if placed_at is not None:
            i = open_rows[placed_at]
            if seq_len - len(rows[i]) < min_len:
                open_rows.pop(placed_at)
        else:
            rows.append([int(t) for t in seq])
            segs.append([1] * len(seq))
            counts.append(1)
            if seq_len - len(rows[-1]) >= min_len:
                open_rows.append(len(rows) - 1)
    if not rows:
        raise ValueError("no non-empty sequences to pack")
    n = len(rows)
    tokens = np.full((n, seq_len), pad_id, np.int32)
    segments = np.zeros((n, seq_len), np.int32)
    for i, (row, seg) in enumerate(zip(rows, segs)):
        tokens[i, :len(row)] = row
        segments[i, :len(seg)] = seg
    return tokens, segments


def packed_attention_fn(segments: torch.Tensor):
    """Attention op masking attention across segment boundaries (and, on
    the dense path, off padding, segment 0)."""
    from tpucfn_torch.kernels.auto import should_use_flash

    def att(q, k, v, *, causal=True, mask=None, q_offset=0, k_offset=0):
        if mask is not None:
            raise NotImplementedError(
                "packed attention owns the mask; combine masks upstream")
        static_offsets = isinstance(q_offset, int) and isinstance(k_offset, int)
        if (static_offsets and q_offset == 0 and k_offset == 0
                and should_use_flash(q.shape[1], causal=causal,
                                     d=q.shape[-1], dtype=q.dtype,
                                     device=q.device)):
            from tpucfn_torch.kernels.flash_attention import flash_attention

            return flash_attention(q, k, v, causal=causal,
                                   segment_ids=segments)
        from tpucfn_torch.ops.attention import dot_product_attention

        same = (segments[:, None, :, None] == segments[:, None, None, :])
        valid = (segments > 0)[:, None, :, None]  # pad queries attend nothing
        return dot_product_attention(q, k, v, causal=causal,
                                     mask=same & valid,
                                     q_offset=q_offset, k_offset=k_offset)

    return att


def _valid_targets(segments: torch.Tensor) -> torch.Tensor:
    """(B, S-1): the positions whose target shares their segment and is
    not padding."""
    return (segments[:, 1:] == segments[:, :-1]) & (segments[:, 1:] > 0)


def packed_loss_weight(batch: dict) -> torch.Tensor:
    """The count that :func:`packed_causal_lm_loss` averages over in
    ``batch`` (its ``"segments"``): the trainer's ``loss_weight`` for
    data parallelism."""
    return _valid_targets(batch["segments"]).sum()


def packed_causal_lm_loss(
    logits: torch.Tensor,    # (B, S, V)
    tokens: torch.Tensor,    # (B, S)
    segments: torch.Tensor,  # (B, S)
    *,
    z_loss: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Next-token CE averaged over positions whose TARGET shares the
    input's segment (and is not padding). Returns (loss, accuracy)."""
    from tpucfn_torch.models.llama import token_cross_entropy

    valid = _valid_targets(segments)
    per_tok, hit = token_cross_entropy(logits[:, :-1].float(),
                                       tokens[:, 1:].long(), z_loss)
    denom = valid.sum().clamp_min(1)
    loss = torch.where(valid, per_tok, 0.0).sum() / denom
    return loss, (valid & hit).sum() / denom
