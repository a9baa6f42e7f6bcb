"""FlashAttention-2 forward on Hopper: the port of the Pallas kernel
``_fwd_kernel`` in ``tpucfn/kernels/flash_attention.py``.

The kernel is CUDA C++ (``csrc/flash_fwd.cu``), built with ``nvcc`` for
``sm_90a`` at first use and bound with ``ctypes``
(:mod:`tpucfn_torch.kernels._build`).  :func:`flash_fwd` is its wrapper:
it checks device, dtype, shape and contiguity, allocates O and LSE,
launches on the current stream, raises if the launch failed, and counts
the launch in ``flash_fwd.launches``.  Given CPU tensors it computes the
same function with the plain version,
:func:`tpucfn_torch.ops.attention.dot_product_attention_with_lse`; a CUDA
tensor gets the kernel or an exception, never the plain version.

The public entry points keep the JAX package's signatures and its
(B, S, H, D) layout.  ``q_offset`` may also be an int32 tensor of shape
(B,), one global query position per batch row: the kernel reads it from
memory, so per-slot offsets (the serving engine's cache indices) cost it
nothing — the Pallas grid needed static offsets.

Block sizes: ``block_q`` rows per CTA — a row is one (query position,
query head) pair of a KV head's GQA group — and ``block_k`` keys per KV
tile.  Explicit arguments, then ``TPUCFN_FLASH_BLOCK_Q``/``_K``, then
64/64.  The JAX package's tuned table holds TPU measurements and is not
carried over.  Padding to the block is never materialized: the kernel
masks the ragged edge itself.
"""

from __future__ import annotations

import ctypes
import os

import torch

from tpucfn_torch.ops.attention import NEG_INF, dot_product_attention_with_lse

SUBLANES = 8  # blocks are multiples of this (the JAX package's rule)
DEFAULT_BLOCK = 64
HEAD_DIMS = (16, 64, 128)  # the kernel's instantiations: tiny, 1B, 8B
DTYPES = (torch.float32, torch.bfloat16)
SMEM_LIMIT = 232448  # bytes of shared memory one CTA may use on sm_90
MAX_SPLITS = 16  # split-KV CTAs per (q-block, head, row); the combine takes <= 32

__all__ = ["NEG_INF", "flash_attention", "flash_attention_with_lse",
           "flash_fwd"]


def _block_and_pad(s: int, target: int) -> tuple[int, int]:
    """(block, padded_s): block ≤ target, multiple of SUBLANES, tiling the
    padded length. Sequences shorter than the target become one block."""
    if s >= target:
        block = target
    else:
        block = -(-s // SUBLANES) * SUBLANES  # round up to sublane tile
    padded = -(-s // block) * block
    return block, padded


def _check_block(value: int, origin: str) -> int:
    """Block targets must be positive multiples of the sublane tile."""
    try:
        as_int = int(value)
        if as_int != float(value):  # reject silent truncation (136.5 -> 136)
            raise ValueError
        value = as_int
    except (TypeError, ValueError) as e:
        raise ValueError(f"{origin} must be an integer, got {value!r}") from e
    if value <= 0 or value % SUBLANES:
        raise ValueError(
            f"{origin} must be a positive multiple of {SUBLANES}, got {value}")
    return value


def _choose_blocks(block_q: int | None, block_k: int | None) -> tuple[int, int]:
    """Explicit argument > TPUCFN_FLASH_BLOCK_Q/_K > DEFAULT_BLOCK."""
    envq = os.environ.get("TPUCFN_FLASH_BLOCK_Q")
    envk = os.environ.get("TPUCFN_FLASH_BLOCK_K")
    bq = (_check_block(block_q, "block_q") if block_q is not None
          else _check_block(envq or DEFAULT_BLOCK, "TPUCFN_FLASH_BLOCK_Q"))
    bk = (_check_block(block_k, "block_k") if block_k is not None
          else _check_block(envk or DEFAULT_BLOCK, "TPUCFN_FLASH_BLOCK_K"))
    return bq, bk


def _kv_splits(ctas: int, n_tiles: int, n_sm: int) -> tuple[int, int]:
    """(n_split, split_tiles) for ``ctas`` (row block, KV head, batch row)
    CTAs over ``n_tiles`` KV tiles on ``n_sm`` SMs.  The KV walk is split
    when the CTAs alone would leave the card short of 4 CTAs per SM (the
    decode shape: a few rows per CTA and a long cache), keeping at least
    two tiles per split; otherwise one CTA walks all its tiles."""
    want = min(MAX_SPLITS, -(-4 * n_sm // max(ctas, 1)), n_tiles // 2)
    if want < 2:
        return 1, n_tiles
    split_tiles = -(-n_tiles // want)
    return -(-n_tiles // split_tiles), split_tiles


def _segment_mask(q_seg, kv_seg):
    if q_seg is None:
        return None
    return (q_seg[:, None, :, None] == kv_seg[:, None, None, :])


def _plain_fwd(q, k, v, *, causal, q_offset, k_offset, q_seg, kv_seg):
    o, lse = dot_product_attention_with_lse(
        q, k, v, causal=causal, mask=_segment_mask(q_seg, kv_seg),
        q_offset=q_offset, k_offset=k_offset)
    return o, lse.transpose(1, 2)


def _lib():
    from tpucfn_torch.kernels import _build

    lib = _build.load("flash_fwd")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        # q k v o lse q_offset q_seg kv_seg o_part ml_part;
        # B H Hkv Sq Sk D kv_len k_offset causal; scale;
        # block_q block_k n_split split_tiles is_bf16 device; stream
        lib.flash_fwd.argtypes = [p] * 10 + [i] * 9 + [ctypes.c_float] + [
            i] * 6 + [p]
        lib.flash_fwd.restype = i
        lib.flash_fwd_smem_bytes.argtypes = [i, i, i]
        lib.flash_fwd_smem_bytes.restype = ctypes.c_size_t
        lib.flash_fwd_error_string.argtypes = [i]
        lib.flash_fwd_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check_inputs(q, k, v, q_seg, kv_seg):
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)} must be (B,Sq,H,D) and k/v "
                         f"{tuple(k.shape)}/{tuple(v.shape)} (B,Sk,Hkv,D)")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree "
                         "on batch or head dim")
    if h % k.shape[2]:
        raise ValueError(f"query heads {h} not a multiple of kv heads "
                         f"{k.shape[2]}")
    if q_seg is not None:
        if kv_seg is None or q_seg.shape != q.shape[:2] \
                or kv_seg.shape != k.shape[:2]:
            raise ValueError("segment ids must be (B, Sq) and (B, Sk)")


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, q_offset: int | torch.Tensor = 0,
              k_offset: int = 0, q_seg: torch.Tensor | None = None,
              kv_seg: torch.Tensor | None = None,
              block_q: int | None = None, block_k: int | None = None,
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The K1 wrapper. q (B,Sq,H,D), k/v (B,Sk,Hkv,D) -> (o (B,Sq,H,D),
    lse (B,H,Sq) fp32).  CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise.  ``flash_fwd.launches`` counts one per
    forward on the card, whether it ran whole or split with its combine
    pass."""
    _check_inputs(q, k, v, q_seg, kv_seg)
    bq, bk = _choose_blocks(block_q, block_k)
    if q.device.type == "cpu":
        return _plain_fwd(q, k, v, causal=causal, q_offset=q_offset,
                          k_offset=k_offset, q_seg=q_seg, kv_seg=kv_seg)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd runs on cuda or cpu, not {q.device}")
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: the kernel "
                         "takes float32 or bfloat16, all alike")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in the kernel's {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    # The kernel reads 16-byte vectors; a contiguous view that starts off
    # that alignment (rare: fresh allocations are 256-byte aligned) is
    # copied once.
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    if isinstance(q_offset, torch.Tensor):
        if q_offset.shape != (b,):
            raise ValueError(f"per-row q_offset must be ({b},), got "
                             f"{tuple(q_offset.shape)}")
        q_off = q_offset.to(device=q.device, dtype=torch.int32).contiguous()
    else:
        q_off = torch.full((b,), int(q_offset), dtype=torch.int32,
                           device=q.device)
    segs = (None, None)
    if q_seg is not None:
        segs = tuple(s.to(device=q.device, dtype=torch.int32).contiguous()
                     for s in (q_seg, kv_seg))
    # A kernel row is one (query position, query head) of a KV head's group.
    rows = sq * (h // hkv)
    bq, _ = _block_and_pad(rows, bq)
    bk, _ = _block_and_pad(sk, bk)
    lib = _lib()
    smem = lib.flash_fwd_smem_bytes(d, bq, bk)
    if smem > SMEM_LIMIT:
        raise ValueError(f"blocks {bq}x{bk} need {smem} B of shared memory "
                         f"at head dim {d} (limit {SMEM_LIMIT})")
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    n_split, split_tiles = _kv_splits(
        -(-rows // bq) * hkv * b, -(-sk // bk),
        torch.cuda.get_device_properties(q.device).multi_processor_count)
    o_part = ml_part = None
    if n_split > 1:
        o_part = torch.empty((n_split, b, h, sq, d), dtype=torch.float32,
                             device=q.device)
        ml_part = torch.empty((2, n_split, b, h, sq), dtype=torch.float32,
                              device=q.device)
    err = lib.flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), q_off.data_ptr(),
        segs[0].data_ptr() if segs[0] is not None else None,
        segs[1].data_ptr() if segs[1] is not None else None,
        o_part.data_ptr() if o_part is not None else None,
        ml_part.data_ptr() if ml_part is not None else None,
        b, h, hkv, sq, sk, d, sk, int(k_offset), int(bool(causal)),
        d ** -0.5, bq, bk, n_split, split_tiles, int(q.dtype == torch.bfloat16),
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError("flash_fwd launch failed: "
                           + lib.flash_fwd_error_string(err).decode())
    flash_fwd.launches += 1
    return o, lse


flash_fwd.launches = 0


def flash_attention_with_lse(
    q: torch.Tensor,  # (B, SQ, H, D)
    k: torch.Tensor,  # (B, SK, HKV, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: int | torch.Tensor = 0,
    k_offset: int = 0,
    block_q: int | None = None,
    block_k: int | None = None,
    interpret: bool | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(out (B,SQ,H,D), lse (B,SQ,H)) — the flash counterpart of
    :func:`tpucfn_torch.ops.attention.dot_product_attention_with_lse`
    (rows attending to nothing give lse = NEG_INF).  ``interpret`` is
    kept for the JAX signature; the tensors' device picks the path."""
    del interpret
    o, lse = flash_fwd(q, k, v, causal=causal, q_offset=q_offset,
                       k_offset=k_offset, block_q=block_q, block_k=block_k)
    return o, lse.transpose(1, 2)


def flash_attention(
    q: torch.Tensor,  # (B, SQ, H, D) — framework-standard layout
    k: torch.Tensor,  # (B, SK, HKV, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    mask: torch.Tensor | None = None,
    segment_ids: torch.Tensor | tuple[torch.Tensor, torch.Tensor] | None = None,
    q_offset: int | torch.Tensor = 0,
    k_offset: int = 0,
    block_q: int | None = None,
    block_k: int | None = None,
    interpret: bool | None = None,
) -> torch.Tensor:
    """Drop-in replacement for
    :func:`tpucfn_torch.ops.attention.dot_product_attention`.

    ``segment_ids``: (B, S) int tensor (self-attention) or a
    ``(q_ids, kv_ids)`` pair — attention is masked across segment
    boundaries.  Dense boolean masks are unsupported, as in the JAX
    kernel.  ``interpret`` is kept for the JAX signature."""
    del interpret
    if mask is not None:
        raise NotImplementedError(
            "flash_attention supports causal/segment masking only")
    q_seg = kv_seg = None
    if segment_ids is not None:
        q_seg, kv_seg = (segment_ids if isinstance(segment_ids, tuple)
                         else (segment_ids, segment_ids))
    o, _ = flash_fwd(q, k, v, causal=causal, q_offset=q_offset,
                     k_offset=k_offset, q_seg=q_seg, kv_seg=kv_seg,
                     block_q=block_q, block_k=block_k)
    return o
