"""Automatic dense/flash attention dispatch (the port of
``tpucfn/kernels/auto.py``).

The JAX package's policy and environment variables, with the port's own
defaults:

* ``should_use_flash(s, d=..., dtype=..., device=...)`` — False unless
  ``device`` is a CUDA device (the JAX package: off a TPU) or below
  ``flash_threshold()``; above it, the tune table's measured dense/flash
  ratio for the (S, D, dtype) family decides
  (:func:`tpucfn_torch.kernels.flash_autotune.lookup_speedup`):
  tuned-and-winning (>= 1.05) -> flash, tuned-and-losing -> dense,
  never measured -> flash only at ``untuned_flash_min_s()`` and beyond.
  A head dim or dtype the kernels are not built for (``HEAD_DIMS``,
  ``DTYPES`` of :mod:`tpucfn_torch.kernels.flash_attention`; D = 40 and
  fp16, say) takes the dense path, which the JAX package runs those
  shapes on as well.
* ``flash_threshold()`` — ``TPUCFN_FLASH_MIN_S`` (default 0).
* ``untuned_flash_min_s()`` — ``TPUCFN_FLASH_UNTUNED_MIN_S`` (default 0).

The JAX package's defaults (2048 and 8192) come from its TPU readings,
against XLA's dense attention.  Here the dense side is the plain PyTorch
op, so both defaults are 0: on the card the kernels take every shape
they support, and only a measured table entry for the card
(``flash_tune_builtin.json`` or the user's own ``tune``) sends a family
to dense.  With both variables set to the JAX package's values, the
decisions equal its.  CPU tensors always take the dense path, the branch
JAX takes on the CPU.  Dispatch sites:
:class:`tpucfn_torch.models.llama.Llama` with ``attention_fn=None``
outside decode (:func:`auto_attention_static_zero`) and
:func:`tpucfn_torch.data.packing.packed_attention_fn`.

:func:`serve_decode_attention_fn` differs from the JAX package's on
purpose: there each slot's cache index is a traced value and the Pallas
grid takes static offsets, so serving runs dense XLA attention; the CUDA
forward kernel reads its offsets from memory, so here every prefill and
decode call of the engine runs it, with one query offset per batch row.
"""

from __future__ import annotations

import os

import torch


# Differs from the JAX package's: default 0 (see the module docstring).
def flash_threshold() -> int:
    return int(os.environ.get("TPUCFN_FLASH_MIN_S", "0"))


# Differs from the JAX package's: default 0, and its TPU readings dropped.
def untuned_flash_min_s() -> int:
    """Above this length flash is the default even for a shape family
    with NO measured dense comparison; below it, such a family runs
    dense.  Default 0: on the card the kernels take every family that no
    measured table entry sends to dense."""
    return int(os.environ.get("TPUCFN_FLASH_UNTUNED_MIN_S", "0"))


def _on_card(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


def _kernels_take(d, dtype) -> bool:
    """Whether the kernels are built for this head dim and dtype
    (``HEAD_DIMS`` and ``DTYPES`` of the kernels' module); a call site
    that passes neither keeps the length rule alone."""
    from tpucfn_torch.kernels.flash_attention import DTYPES, HEAD_DIMS

    return ((d is None or int(d) in HEAD_DIMS)
            and (dtype is None or dtype in DTYPES))


_warned_untuned_kinds: set[str] = set()


def _warn_once_if_kind_untuned() -> None:
    """One warning per card name and process when the current card has no
    tune-table entries: every shape family then runs dense between
    ``flash_threshold`` and ``untuned_flash_min_s`` (an empty range at
    the defaults, where this never warns)."""
    from tpucfn_torch.kernels import flash_autotune

    kind = flash_autotune._device_kind()
    if kind is None or kind in _warned_untuned_kinds:
        return
    _warned_untuned_kinds.add(kind)  # scan the table once per kind
    if not flash_autotune.kind_has_entries(kind):
        import warnings

        warnings.warn(
            f"CUDA device {kind!r} has no flash-tune table entries: "
            f"sequence lengths in [{flash_threshold()}, "
            f"{untuned_flash_min_s()}) will silently use DENSE attention. "
            "Run tpucfn_torch.kernels.flash_autotune.tune(s, d) on this "
            "card (or lower TPUCFN_FLASH_UNTUNED_MIN_S) to enable flash "
            "where it wins.", stacklevel=3)


def _evidence_says_flash(s: int, d, dtype, causal: bool) -> bool:
    """Measurement-backed dispatch core (VERDICT r4 #5): consult the
    tune table's measured dense/flash ratio for this (S, D, dtype)
    family. Tuned and winning (>=5%) → flash; tuned and losing → dense;
    never measured → flash only past ``untuned_flash_min_s``."""
    if d is None:
        # Legacy call sites without a head-dim: length threshold only
        # (preserves their observed behavior; all in-repo sites pass d).
        return True
    from tpucfn_torch.kernels.flash_autotune import lookup_speedup

    speedup = lookup_speedup(int(s), int(d), dtype, causal)
    if speedup is not None:
        return speedup >= 1.05
    if int(s) < untuned_flash_min_s():
        _warn_once_if_kind_untuned()
        return False
    return True


def should_use_flash(s: int, *, causal: bool = True, mask=None,
                     d: int | None = None, dtype=None, device=None) -> bool:
    """One policy for every dispatch site.  ``device`` is where the
    tensors live: anything but a CUDA device gets dense, as does a head
    dim or dtype the kernels are not built for.  Pass ``d`` and
    ``dtype`` so the decision can consult the measured evidence."""
    if mask is not None or not causal:
        return False  # the kernels mask causally or by segment only
    if not _on_card(device) or int(s) < flash_threshold():
        return False
    if not _kernels_take(d, dtype):
        return False
    return _evidence_says_flash(s, d, dtype, causal=True)


def should_use_flash_full(s_q: int, s_kv: int, *, mask=None,
                          d: int | None = None, dtype=None,
                          device=None) -> bool:
    """Non-causal (full) attention policy: flash only when both sides are
    long, by the same evidence rule."""
    if mask is not None:
        return False
    t = flash_threshold()
    if not _on_card(device) or int(s_q) < t or int(s_kv) < t:
        return False
    if not _kernels_take(d, dtype):
        return False
    return _evidence_says_flash(s_q, d, dtype, causal=False)


def full_attention_auto(q, k, v, *, mask=None):
    """Dense/flash dispatch for non-causal attention, layout (B, S, H, D)."""
    if should_use_flash_full(q.shape[1], k.shape[1], mask=mask,
                             d=q.shape[-1], dtype=q.dtype, device=q.device):
        from tpucfn_torch.kernels.flash_attention import flash_attention

        return flash_attention(q, k, v, causal=False)
    from tpucfn_torch.ops.attention import dot_product_attention

    return dot_product_attention(q, k, v, causal=False, mask=mask)


def auto_attention_static_zero(q, k, v, *, causal=True, mask=None,
                               q_offset=0, k_offset=0):
    """The attention of a model whose offsets are zero (``Llama`` outside
    decode): dispatches on the sequence length, head dim, dtype and
    device, and drops the zero offsets on the flash path."""
    if mask is None and should_use_flash(q.shape[1], causal=causal,
                                         d=q.shape[-1], dtype=q.dtype,
                                         device=q.device):
        from tpucfn_torch.kernels.flash_attention import flash_attention

        return flash_attention(q, k, v, causal=causal)
    from tpucfn_torch.ops.attention import dot_product_attention

    return dot_product_attention(q, k, v, causal=causal, mask=mask,
                                 q_offset=q_offset, k_offset=k_offset)


def auto_attention(q, k, v, *, causal=True, mask=None, q_offset=0,
                   k_offset=0, segment_ids=None):
    """Dense/flash dispatch for call sites with int offsets."""
    from tpucfn_torch.kernels.flash_attention import flash_attention
    from tpucfn_torch.ops.attention import dot_product_attention

    static_offsets = isinstance(q_offset, int) and isinstance(k_offset, int)
    if static_offsets and should_use_flash(q.shape[1], causal=causal,
                                           mask=mask, d=q.shape[-1],
                                           dtype=q.dtype, device=q.device):
        return flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                               k_offset=k_offset, segment_ids=segment_ids)
    if segment_ids is not None:
        raise NotImplementedError(
            "segment_ids on the dense fallback path is not wired; pass an "
            "explicit mask or use flash_attention directly")
    return dot_product_attention(q, k, v, causal=causal, mask=mask,
                                 q_offset=q_offset, k_offset=k_offset)


def serve_decode_attention_fn(cache_len: int):
    """Attention path for the engine's decode-mode model: the flash
    forward kernel's wrapper.  ``cache_len`` is accepted for the JAX
    signature; the kernel stops each row at its live prefix itself."""
    from tpucfn_torch.kernels.flash_attention import flash_attention

    del cache_len
    return flash_attention
