"""FlashAttention-2 on Hopper: the port of the three Pallas kernels in
``tpucfn/kernels/flash_attention.py`` and of their ``jax.custom_vjp``.

The kernels are CUDA C++, built with ``nvcc`` for ``sm_90a`` at first use
and bound with ``ctypes`` (:mod:`tpucfn_torch.kernels._build`):

* K1, the forward ``_fwd_kernel`` (wrapper :func:`flash_fwd`), in three
  variants that :func:`fwd_variant` picks between:
  ``csrc/flash_fwd_sm90.cu`` ("sm90": wgmma tensor cores fed by TMA) for
  bf16 with at least 64 packed rows per (batch row, KV head) and a GQA
  group that divides 64; ``csrc/flash_fwd_decode_sm90.cu`` ("decode":
  mma.sync at M = 16 over a grid of key chunks fixed by the cache's
  capacity, the chunks of a (batch row, KV head) merged on chip by a CTA
  cluster) for bf16 with at most 16, which is every serving decode step;
  and ``csrc/flash_fwd_mma_sm90.cu`` ("mma": mma.sync, 1-4 warps of 16
  rows a CTA, keys split into cluster-merged chunks from the shapes;
  fp32 as 3xTF32) for everything else: fp32, bf16 at 17-63 rows (a
  speculative-decoding verify pass) and groups that do not divide 64;
* the backward: Delta = rowsum(dO*O) (:func:`flash_bwd_delta`,
  ``csrc/flash_bwd.cu``), K2 ``_bwd_dq_kernel`` (:func:`flash_bwd_dq`) and
  K3 ``_bwd_dkv_kernel`` (:func:`flash_bwd_dkv`), both in the variant
  :func:`dkv_variant` picks (:func:`dq_variant` is the same rule).  For
  bf16 with a GQA group that divides 64 they run
  ``csrc/flash_bwd_dq_sm90.cu`` and ``csrc/flash_bwd_dkv_sm90.cu``
  ("sm90": wgmma fed by TMA); otherwise ``csrc/flash_bwd_dq_mma_sm90.cu``
  and ``csrc/flash_bwd_dkv_mma_sm90.cu`` ("mma": mma.sync, 3xTF32 in
  fp32).
  :func:`flash_bwd` runs the three.

Head dims (``VARIANT_HEAD_DIMS``): ``sm90``, ``mma`` and Delta are built
for 16, 32, 40, 64, 80, 128 and 160 (every head dim of a model of the JAX
package); ``decode`` and the old FMA kernels for 16, 64 and 128, so a
bf16 call of at most 16 rows at D = 32, 40, 80 or 160 runs ``mma``.
D = 32 tiles take the 64-byte swizzle; D = 40, 80 and 160 run ``sm90`` on
zero-padded tiles of whole 64-column boxes (64, 128 and 192 columns), and
D = 40 bf16 ``mma`` on 48 columns; each stores only its D columns.  At
D = 160 K3 ``sm90`` splits dV and dK over two consumer warpgroups.  A
head dim no variant takes raises, naming the variant.

The older FMA kernels of K1, K2 and K3 (``csrc/flash_fwd.cu``, and
``flash_bwd_dq`` and ``flash_bwd_dkv`` in ``csrc/flash_bwd.cu``) are
reached by no variant rule; ``chip_smoke.py`` times them beside ``mma``
by overriding the rule for a call.

The decode variant reads nothing back to the host and keeps no state
between launches, and its grid depends on the shapes alone, so one call
can be captured in a CUDA graph and replayed as the offsets and the
cache move (make one call before the capture: the first builds the
library).

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs, launches on the current stream, raises if the launch failed, and
counts the launch in its ``launches`` attribute and by head dim in
``launches_by_head_dim`` (K1, K2 and K3 also in ``launches_by_variant``).  Given CPU tensors it
computes the same function with its plain PyTorch version
(:func:`tpucfn_torch.ops.attention.dot_product_attention_with_lse` for
K1, :func:`flash_bwd_plain` for the backward); a CUDA tensor gets the
kernel or an exception, never the plain version.

:func:`flash_attention` and :func:`flash_attention_with_lse` keep the JAX
package's signatures and its (B, S, H, D) layout, and are differentiable:
each runs through a ``torch.autograd.Function`` (the counterparts of
``_make_flash`` and ``_make_flash_with_lse``) whose backward is
:func:`flash_bwd`; the second treats LSE as a differentiable output whose
cotangent feeds dS.  ``q_offset`` may also be an int32 tensor of shape
(B,), one global query position per batch row: K1 reads it from memory,
so per-slot offsets (the serving engine's cache indices) cost it nothing.
Such offsets are forward-only, as in the JAX package, whose backward
takes static offsets.

Block sizes of K1's old fma kernel: ``block_q`` rows per CTA — a row is one
(query position, query head) pair of a KV head's GQA group — and
``block_k`` keys per KV tile.  Explicit arguments, then
``TPUCFN_FLASH_BLOCK_Q``/``_K``, then 64/64.  The JAX package's tuned
table holds TPU measurements and is not carried over.  The sm90 forward
tiles 64 rows by 128 keys (64 at D = 80, 128 and 160) and the backward
kernels 64 x 64, fixed in their sources; the decode variant's key chunks
come from :func:`_decode_chunks`, K1 mma's tiles and chunks from
:func:`_mma_fwd_plan`; K2 mma takes 64 keys a tile (32 at D = 128 and
160) and K3 mma 16 keys a CTA, fixed in their sources.
Padding to a block is never materialized: the kernels mask the ragged
edge themselves.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from tpucfn_torch.ops.attention import (NEG_INF, _repeat_kv,
                                        dot_product_attention_with_lse)

SUBLANES = 8  # blocks are multiples of this (the JAX package's rule)
DEFAULT_BLOCK = 64
# Head dims each kernel variant is built for: 16 (tiny), 32 (the tiny
# UNet's middle block), 40, 80 and 160 (the SD-1.5 UNet's 64x64, 32x32 and
# 16x16 stages and middle block), 64 (1B) and 128 (8B) on the tensor-core
# variants and Delta; the decode variant and the old fma kernels keep 16,
# 64 and 128.
VARIANT_HEAD_DIMS = {"sm90": (16, 32, 40, 64, 80, 128, 160),
                     "mma": (16, 32, 40, 64, 80, 128, 160),
                     "decode": (16, 64, 128), "fma": (16, 64, 128)}
# The head dims every call can run at: each variant that a call of such a
# head dim can reach takes it, and Delta is built for each (the
# dispatcher reads this).
HEAD_DIMS = (16, 32, 40, 64, 80, 128, 160)
DTYPES = (torch.float32, torch.bfloat16)
SMEM_LIMIT = 232448  # bytes of shared memory one CTA may use on sm_90
MAX_SPLITS = 16  # split-KV CTAs per (q-block, head, row); the combine takes <= 32
TC_ROWS = 64  # packed rows of one tensor-core (sm90) tile: one wgmma M
DECODE_ROWS = 16  # packed rows of the decode variant: one mma.sync M
# Key chunks per (batch row, KV head), one CTA cluster: the portable
# cluster limit.  chip_smoke.py's ``decode_chunking`` holds 8 against 4 at
# the serving phase's decode offsets and at spread offsets.
DECODE_CLUSTER = 8
# The mma variants (csrc/flash_fwd_mma_sm90.cu, csrc/flash_bwd_dq_mma_sm90.cu,
# csrc/flash_bwd_dkv_mma_sm90.cu).
MMA_ROWS = 16  # packed rows of one warp: one mma.sync M tile
MMA_MAX_WARPS = 4  # K1 and K2: M tiles (warps) per CTA
MMA_CLUSTER = 8  # K1: key chunks per row block, one CTA cluster (portable limit)
# K1 splits its keys until the grid has about 4 CTAs per SM of an H100 SXM
# (132 SMs; a pure function of the shapes, so the plan does not ask the
# device), keeping at least this many key tiles per chunk: a bf16 tile is
# one cheap mma.sync pass that does not pay for the cluster merge on its
# own, an fp32 tile (3xTF32: three products) does (chip_smoke.py
# ``mma_plans`` times the plan against another in turns).
H100_SMS = 132
MMA_FILL_CTAS = 4 * H100_SMS
MMA_MIN_CHUNK_TILES = {torch.bfloat16: 2, torch.float32: 1}

__all__ = ["NEG_INF", "flash_attention", "flash_attention_with_lse",
           "flash_bwd", "flash_bwd_delta", "flash_bwd_dkv", "flash_bwd_dq",
           "flash_bwd_delta_plain", "flash_bwd_plain",
           "flash_bwd_plain_from_delta", "flash_fwd", "fwd_variant",
           "dq_variant", "dkv_variant"]


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


def _decode_chunks(sk: int) -> tuple[int, int]:
    """(chunk_keys, n_chunks) of the decode variant for a cache of capacity
    ``sk``: at most :data:`DECODE_CLUSTER` chunks of a multiple of 64 keys
    that cover it, one CTA each, so the grid (and each cluster) is fixed by
    the shapes, not by the live lengths."""
    chunk = 64 * -(-sk // (64 * DECODE_CLUSTER))
    return chunk, -(-sk // chunk)


def _mma_keys(dtype: torch.dtype, d: int) -> int:
    """Keys of one K/V tile of K1's mma variant (the kernel's
    ``tile_keys``): 64, or 32 for fp32 at D = 128 and 160."""
    return 32 if dtype == torch.float32 and d >= 128 else 64


def _mma_fwd_plan(dtype: torch.dtype, b: int, sq: int, h: int, hkv: int,
                  d: int, sk: int) -> tuple[int, int, int]:
    """(warps, chunk_keys, n_chunks) of K1's mma variant, from the shapes
    alone: CTAs of up to :data:`MMA_MAX_WARPS` warps of 16 packed rows,
    and the keys cut into at most :data:`MMA_CLUSTER` chunks of at least
    :data:`MMA_MIN_CHUNK_TILES` whole tiles (one CTA cluster per row
    block) until the grid has about :data:`MMA_FILL_CTAS` CTAs — a
    verify pass over a long cache gets 8, a bf16 prefill of a few hundred
    rows over as many keys 1."""
    m_tiles = -(-sq * (h // hkv) // MMA_ROWS)
    warps = min(MMA_MAX_WARPS, m_tiles)
    ctas = -(-m_tiles // warps) * hkv * b
    tile = _mma_keys(dtype, d)
    n_tiles = max(1, -(-sk // tile))
    want = max(1, min(MMA_CLUSTER, -(-MMA_FILL_CTAS // ctas),
                      n_tiles // MMA_MIN_CHUNK_TILES[dtype]))
    per = -(-n_tiles // want)
    return warps, per * tile, -(-n_tiles // per)


def _segment_mask(q_seg, kv_seg):
    if q_seg is None:
        return None
    return (q_seg[:, None, :, None] == kv_seg[:, None, None, :])


def _plain_fwd(q, k, v, *, causal, q_offset, k_offset, q_seg, kv_seg):
    o, lse = dot_product_attention_with_lse(
        q, k, v, causal=causal, mask=_segment_mask(q_seg, kv_seg),
        q_offset=q_offset, k_offset=k_offset)
    return o, lse.transpose(1, 2)


def fwd_variant(dtype: torch.dtype, sq: int, h: int, hkv: int,
                d: int | None = None) -> str:
    """Which K1 kernel a forward of q (B, sq, h, d) over hkv KV heads
    launches.  In bf16: "decode" (mma.sync at M = 16) for at most 16
    packed rows per (batch row, KV head), sq * (h / hkv) <= 16 — every
    serving decode step — at a head dim it is built for (``d`` None: any);
    "sm90" (wgmma tensor cores) for at least one
    64-row tile of them and a GQA group that divides the tile (TMA loads
    a tile as a box of 64 / group positions x group heads).  "mma"
    (mma.sync, any row count and group; 3xTF32 in fp32) otherwise: fp32,
    bf16 at 17-63 rows (a verify pass), groups that do not divide 64, and
    at most 16 rows at a head dim the decode variant lacks (32, 40, 80,
    160)."""
    rep = h // hkv
    if dtype != torch.bfloat16:
        return "mma"
    if sq * rep <= DECODE_ROWS:
        return ("decode" if d is None or d in VARIANT_HEAD_DIMS["decode"]
                else "mma")
    return "sm90" if sq * rep >= TC_ROWS and TC_ROWS % rep == 0 else "mma"


def dkv_variant(dtype: torch.dtype, h: int, hkv: int) -> str:
    """Which K3 (dK/dV) kernel a backward launches, and K2 (dQ) with it:
    "sm90" for bf16 with a GQA group that divides the 64-row query tile,
    "mma" (mma.sync; 3xTF32 in fp32) otherwise."""
    return ("sm90" if dtype == torch.bfloat16 and TC_ROWS % (h // hkv) == 0
            else "mma")


# K2 takes K3's variant: the two backward kernels cannot drift apart.
dq_variant = dkv_variant


# The C entry points of each library (csrc/<name>.cu) as ctypes sees
# them: name -> (argtypes, restype).  Every pointer and the stream are
# c_void_p (a c_int would cut them to 32 bits).
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ERR = ([_I], ctypes.c_char_p)
ARGTYPES = {
    "flash_fwd": {
        # q k v o lse q_offset q_seg kv_seg o_part ml_part;
        # B H Hkv Sq Sk D kv_len k_offset causal; scale;
        # block_q block_k n_split split_tiles is_bf16 device; stream
        "flash_fwd": ([_P] * 10 + [_I] * 9 + [_F] + [_I] * 6 + [_P], _I),
        "flash_fwd_smem_bytes": ([_I] * 3, ctypes.c_size_t),
        "flash_fwd_error_string": _ERR,
    },
    "flash_fwd_sm90": {
        # q k v o lse q_offset q_seg kv_seg; B H Hkv Sq Sk D k_offset
        # causal; scale; device; stream
        "flash_fwd_sm90": ([_P] * 8 + [_I] * 8 + [_F, _I, _P], _I),
        "flash_fwd_sm90_error_string": _ERR,
    },
    "flash_fwd_decode_sm90": {
        # q k v o lse q_offset q_seg kv_seg; B H Hkv Sq Sk D k_offset
        # causal; scale; chunk_keys n_chunks device; stream
        "flash_fwd_decode_sm90": ([_P] * 8 + [_I] * 8 + [_F] + [_I] * 3
                                  + [_P], _I),
        "flash_fwd_decode_sm90_error_string": _ERR,
    },
    "flash_fwd_mma_sm90": {
        # q k v o lse q_offset q_seg kv_seg; B H Hkv Sq Sk D k_offset
        # causal; scale; warps chunk_keys n_chunks is_bf16 device; stream
        "flash_fwd_mma_sm90": ([_P] * 8 + [_I] * 8 + [_F] + [_I] * 5
                               + [_P], _I),
        "flash_fwd_mma_sm90_error_string": _ERR,
    },
    "flash_bwd": {
        # o dout delta; B Sq H D; is_bf16 device; stream
        "flash_bwd_delta": ([_P] * 3 + [_I] * 6 + [_P], _I),
        # q k v dout lse delta dlse q_seg kv_seg dq; B H Hkv Sq Sk D
        # q_offset k_offset causal; scale; is_bf16 device; stream
        # (flash_bwd_dkv: dk dv in place of dq)
        "flash_bwd_dq": ([_P] * 10 + [_I] * 9 + [_F, _I, _I, _P], _I),
        "flash_bwd_dkv": ([_P] * 11 + [_I] * 9 + [_F, _I, _I, _P], _I),
        "flash_bwd_smem_bytes": ([_I] * 2, ctypes.c_size_t),
        "flash_bwd_error_string": _ERR,
    },
    "flash_bwd_dq_sm90": {
        # q k v dout lse delta dlse q_seg kv_seg dq; B H Hkv Sq Sk D
        # q_offset k_offset causal; scale; device; stream
        "flash_bwd_dq_sm90": ([_P] * 10 + [_I] * 9 + [_F, _I, _P], _I),
        "flash_bwd_dq_sm90_error_string": _ERR,
    },
    "flash_bwd_dkv_sm90": {
        # q k v dout lse delta dlse q_seg kv_seg dk dv; B H Hkv Sq Sk D
        # q_offset k_offset causal; scale; device; stream
        "flash_bwd_dkv_sm90": ([_P] * 11 + [_I] * 9 + [_F, _I, _P], _I),
        "flash_bwd_dkv_sm90_error_string": _ERR,
    },
    "flash_bwd_dq_mma_sm90": {
        # q k v dout lse delta dlse q_seg kv_seg dq; B H Hkv Sq Sk D
        # q_offset k_offset causal; scale; is_bf16 device; stream
        "flash_bwd_dq_mma_sm90": ([_P] * 10 + [_I] * 9 + [_F, _I, _I, _P],
                                  _I),
        "flash_bwd_dq_mma_sm90_error_string": _ERR,
    },
    "flash_bwd_dkv_mma_sm90": {
        # q k v dout lse delta dlse q_seg kv_seg dk dv; B H Hkv Sq Sk D
        # q_offset k_offset causal; scale; is_bf16 device; stream
        "flash_bwd_dkv_mma_sm90": ([_P] * 11 + [_I] * 9 + [_F, _I, _I, _P],
                                   _I),
        "flash_bwd_dkv_mma_sm90_error_string": _ERR,
    },
}


def _lib(name: str = "flash_fwd"):
    """The library built from ``csrc/<name>.cu``, its functions typed."""
    from tpucfn_torch.kernels import _build

    lib = _build.load(name)
    if not getattr(lib, "_typed", False):
        for fn, (argtypes, restype) in ARGTYPES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        lib._typed = True
    return lib


def _raise_on(lib, err, what, library="flash_bwd"):
    if err != 0:
        message = getattr(lib, f"{library}_error_string")(err).decode()
        raise RuntimeError(f"{what} launch failed: {message}")


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


def _check_cuda(name, alike, others=None, *, variant=None):
    """What every kernel takes: the ``alike`` tensors (name -> tensor) of
    one dtype, fp32 or bf16, at a head dim in ``HEAD_DIMS`` (in those of
    ``variant``, the kernel about to launch, when it is given), and
    the ``others``, all contiguous on the first tensor's CUDA device.
    Returns the tensors in order, each copied once if its start is not
    16-byte aligned (the kernels read 16-byte vectors; fresh allocations
    are 256-byte aligned, so this is rare)."""
    tensors = {**alike, **(others or {})}
    first = next(iter(alike.values()))
    if first.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {first.device}")
    dtypes = [t.dtype for t in alike.values()]
    if first.dtype not in DTYPES or len(set(dtypes)) != 1:
        raise ValueError(f"dtypes {'/'.join(map(str, dtypes))} of "
                         f"{'/'.join(alike)}: the kernel takes float32 or "
                         "bfloat16, all alike")
    head_dims = HEAD_DIMS if variant is None else VARIANT_HEAD_DIMS[variant]
    if first.shape[-1] not in head_dims:
        which = f"the {variant} variant's" if variant else "the kernel's"
        raise ValueError(f"head dim {first.shape[-1]} not in {which} "
                         f"{head_dims}")
    for tname, t in tensors.items():
        if t.device != first.device:
            raise ValueError(f"{tname} on {t.device}, not {first.device}")
        if not t.is_contiguous():
            raise ValueError(f"{tname} must be contiguous")
    return [t if t.data_ptr() % 16 == 0 else t.clone()
            for t in tensors.values()]


def _segments_on(device, q_seg, kv_seg):
    if q_seg is None:
        return None, None
    return tuple(s.to(device=device, dtype=torch.int32).contiguous()
                 for s in (q_seg, kv_seg))


# The serving router launches from one thread per replica: a counter's
# read-modify-write would lose counts between them.
_count_lock = threading.Lock()


def _count(wrapper, head_dim: int, variant: str | None = None) -> None:
    """Count one launch of ``wrapper``'s kernel (and of ``variant``, and
    at ``head_dim``)."""
    with _count_lock:
        wrapper.launches += 1
        by_d = wrapper.launches_by_head_dim
        by_d[head_dim] = by_d.get(head_dim, 0) + 1
        if variant is not None:
            wrapper.launches_by_variant[variant] += 1


def _ptr(t):
    return t.data_ptr() if t is not None else None


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, q_offset: int | torch.Tensor = 0,
              k_offset: int = 0, q_seg: torch.Tensor | None = None,
              kv_seg: torch.Tensor | None = None,
              block_q: int | None = None, block_k: int | None = None,
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The K1 wrapper. q (B,Sq,H,D), k/v (B,Sk,Hkv,D) -> (o (B,Sq,H,D),
    lse (B,H,Sq) fp32).  CPU tensors take the plain version; CUDA tensors
    launch the kernel that :func:`fwd_variant` picks, or raise.
    ``flash_fwd.launches`` counts one per forward on the card (the old
    fma kernel's combine pass included), ``launches_by_variant`` the same
    by variant.  ``block_q``/``block_k`` tile the old fma kernel only."""
    _check_inputs(q, k, v, q_seg, kv_seg)
    bq, bk = _choose_blocks(block_q, block_k)
    if q.device.type == "cpu":
        return _plain_fwd(q, k, v, causal=causal, q_offset=q_offset,
                          k_offset=k_offset, q_seg=q_seg, kv_seg=kv_seg)
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    variant = fwd_variant(q.dtype, sq, h, hkv, d)
    q, k, v = _check_cuda("flash_fwd", dict(q=q, k=k, v=v), variant=variant)
    if isinstance(q_offset, torch.Tensor):
        if q_offset.shape != (b,):
            raise ValueError(f"per-row q_offset must be ({b},), got "
                             f"{tuple(q_offset.shape)}")
        q_off = q_offset.to(device=q.device, dtype=torch.int32).contiguous()
    else:
        q_off = torch.full((b,), int(q_offset), dtype=torch.int32,
                           device=q.device)
    segs = _segments_on(q.device, q_seg, kv_seg)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if o.numel() == 0 or sk == 0:  # nothing to launch; rows see no key
        return o.zero_(), lse.fill_(NEG_INF)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if variant == "sm90":
        lib = _lib("flash_fwd_sm90")
        _raise_on(lib, lib.flash_fwd_sm90(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), q_off.data_ptr(), _ptr(segs[0]), _ptr(segs[1]),
            b, h, hkv, sq, sk, d, int(k_offset), int(bool(causal)), d ** -0.5,
            q.device.index, stream), "flash_fwd", "flash_fwd_sm90")
    elif variant == "decode":
        _fwd_decode(q, k, v, o, lse, q_off, segs, causal, k_offset, stream)
    elif variant == "mma":
        _fwd_mma(q, k, v, o, lse, q_off, segs, causal, k_offset, stream)
    else:
        _fwd_fma(q, k, v, o, lse, q_off, segs, causal, k_offset, bq, bk,
                 stream)
    _count(flash_fwd, d, variant)
    return o, lse


def _fwd_fma(q, k, v, o, lse, q_off, segs, causal, k_offset, bq, bk, stream):
    """Launches K1's old fma kernel (``csrc/flash_fwd.cu``; no variant
    rule picks it since the mma variant), split over the KV walk when its
    CTAs alone would leave the card idle."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    # A kernel row is one (query position, query head) of a KV head's group.
    rows = sq * (h // hkv)
    bq, _ = _block_and_pad(rows, bq)
    bk, _ = _block_and_pad(sk, bk)
    lib = _lib()
    smem = lib.flash_fwd_smem_bytes(d, bq, bk)
    if smem > SMEM_LIMIT:
        raise ValueError(f"blocks {bq}x{bk} need {smem} B of shared memory "
                         f"at head dim {d} (limit {SMEM_LIMIT})")
    n_split, split_tiles = _kv_splits(
        -(-rows // bq) * hkv * b, -(-sk // bk),
        torch.cuda.get_device_properties(q.device).multi_processor_count)
    o_part = ml_part = None
    if n_split > 1:
        o_part = torch.empty((n_split, b, h, sq, d), dtype=torch.float32,
                             device=q.device)
        ml_part = torch.empty((2, n_split, b, h, sq), dtype=torch.float32,
                              device=q.device)
    _raise_on(lib, lib.flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), q_off.data_ptr(), _ptr(segs[0]), _ptr(segs[1]),
        _ptr(o_part), _ptr(ml_part),
        b, h, hkv, sq, sk, d, sk, int(k_offset), int(bool(causal)),
        d ** -0.5, bq, bk, n_split, split_tiles, int(q.dtype == torch.bfloat16),
        q.device.index, stream), "flash_fwd", "flash_fwd")


def _fwd_decode(q, k, v, o, lse, q_off, segs, causal, k_offset, stream):
    """Launches K1's decode variant (``csrc/flash_fwd_decode_sm90.cu``):
    one CTA per (key chunk, KV head, batch row) over the cache's whole
    capacity, the chunks of each (KV head, batch row) one cluster that
    merges them on chip."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    chunk_keys, n_chunks = _decode_chunks(sk)
    lib = _lib("flash_fwd_decode_sm90")
    _raise_on(lib, lib.flash_fwd_decode_sm90(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), q_off.data_ptr(), _ptr(segs[0]), _ptr(segs[1]),
        b, h, hkv, sq, sk, d, int(k_offset), int(bool(causal)), d ** -0.5,
        chunk_keys, n_chunks, q.device.index, stream),
        "flash_fwd", "flash_fwd_decode_sm90")


def _fwd_mma(q, k, v, o, lse, q_off, segs, causal, k_offset, stream):
    """Launches K1's mma variant (``csrc/flash_fwd_mma_sm90.cu``): CTAs of
    1-4 warps of 16 packed rows, the keys cut into the chunks that
    :func:`_mma_fwd_plan` picks, the chunks of a row block one cluster
    that merges them on chip."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    warps, chunk_keys, n_chunks = _mma_fwd_plan(q.dtype, b, sq, h, hkv, d, sk)
    lib = _lib("flash_fwd_mma_sm90")
    _raise_on(lib, lib.flash_fwd_mma_sm90(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), q_off.data_ptr(), _ptr(segs[0]), _ptr(segs[1]),
        b, h, hkv, sq, sk, d, int(k_offset), int(bool(causal)), d ** -0.5,
        warps, chunk_keys, n_chunks, int(q.dtype == torch.bfloat16),
        q.device.index, stream), "flash_fwd", "flash_fwd_mma_sm90")


flash_fwd.launches = 0
flash_fwd.launches_by_variant = {"sm90": 0, "decode": 0, "mma": 0, "fma": 0}
flash_fwd.launches_by_head_dim = {}

# ---- backward --------------------------------------------------------------


def flash_bwd_delta_plain(o, do):
    """The plain version of Delta = rowsum(dO * O), fp32 (B, H, Sq)
    (``_flash_bwd`` line 393)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def flash_bwd_plain_from_delta(q, k, v, lse, delta, do, *, dlse=None,
                               causal=True, q_offset=0, k_offset=0,
                               q_seg=None, kv_seg=None):
    """The plain version of K2 and K3 together, from the same inputs:
    their arithmetic written out in fp32 (``:275-299``, ``:343-370``).
    Recompute P = exp(S - LSE) on live pairs, dS = P * (dP - Delta
    [+ dLSE]) * scale, then dQ = dS K, dK = dS^T Q, dV = P^T dO, summed
    over each KV head's group of query heads -> (dq, dk, dv)."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    scale = d ** -0.5
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    kr, vr = _repeat_kv(kf, rep), _repeat_kv(vf, rep)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kr) * scale
    keep = torch.ones((1, 1, sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        qpos = torch.arange(sq, device=q.device) + int(q_offset)
        kpos = torch.arange(sk, device=q.device) + int(k_offset)
        keep = keep & (qpos[:, None] >= kpos[None, :])
    seg = _segment_mask(q_seg, kv_seg)
    if seg is not None:
        keep = keep & seg
    p = torch.where(keep, torch.exp(s - lse[..., None]), 0.0)
    resid = torch.einsum("bqhd,bkhd->bhqk", dof, vr) - delta[..., None]
    if dlse is not None:
        resid = resid + dlse.float()[..., None]
    ds = p * resid * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf).reshape(b, sk, hkv, rep, d)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof).reshape(b, sk, hkv, rep, d)
    return dq.to(q.dtype), dk.sum(3).to(k.dtype), dv.sum(3).to(v.dtype)


def flash_bwd_plain(q, k, v, o, lse, do, *, dlse=None, causal=True,
                    q_offset=0, k_offset=0, q_seg=None, kv_seg=None):
    """The plain version of the backward: (q, k, v, o, lse (B,H,Sq), dO
    [, dLSE (B,H,Sq)], segment ids, int offsets) -> (dq, dk, dv) in q's,
    k's and v's dtypes.  Used for CPU tensors and as the kernels'
    reference on the card; nothing on the card's main path calls it."""
    return flash_bwd_plain_from_delta(
        q, k, v, lse, flash_bwd_delta_plain(o, do), do, dlse=dlse,
        causal=causal, q_offset=q_offset, k_offset=k_offset, q_seg=q_seg,
        kv_seg=kv_seg)


def flash_bwd_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """Delta = rowsum(dO * O), fp32 (B, H, Sq), from o and dO (B, Sq, H,
    D).  Counts ``flash_bwd_delta.launches``."""
    if o.shape != do.shape or o.ndim != 4:
        raise ValueError(f"o {tuple(o.shape)} and dO {tuple(do.shape)} must "
                         "be one (B, Sq, H, D) shape")
    if o.device.type == "cpu":
        return flash_bwd_delta_plain(o, do)
    o, do = _check_cuda("flash_bwd_delta", dict(o=o, dO=do))
    b, sq, h, d = o.shape
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=o.device)
    if delta.numel() == 0:
        return delta
    lib = _lib("flash_bwd")
    _raise_on(lib, lib.flash_bwd_delta(
        o.data_ptr(), do.data_ptr(), delta.data_ptr(), b, sq, h, d,
        int(o.dtype == torch.bfloat16), o.device.index,
        torch.cuda.current_stream(o.device).cuda_stream), "flash_bwd_delta")
    _count(flash_bwd_delta, d)
    return delta


flash_bwd_delta.launches = 0
flash_bwd_delta.launches_by_head_dim = {}


def _bwd_launch(which, q, k, v, do, lse, delta, dlse, causal, q_offset,
                k_offset, q_seg, kv_seg):
    """Checks what K2 (which 0) and K3 (which 1) take, allocates their
    outputs and launches one in the variant :func:`dq_variant` or
    :func:`dkv_variant` picks,
    counting it in its wrapper's ``launches`` and ``launches_by_variant``;
    returns (dq,) or (dk, dv).  Empty inputs launch nothing."""
    wrapper = (flash_bwd_dq, flash_bwd_dkv)[which]
    name = wrapper.__name__
    _check_inputs(q, k, v, q_seg, kv_seg)
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    rows = {"lse": lse, "delta": delta}
    if dlse is not None:
        rows["dlse"] = dlse
    for tname, t in rows.items():
        if t.shape != (b, h, sq) or t.dtype != torch.float32:
            raise ValueError(f"{tname} must be float32 {(b, h, sq)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if do.shape != q.shape:
        raise ValueError(f"dO {tuple(do.shape)} must have q's shape")
    if isinstance(q_offset, torch.Tensor):
        raise NotImplementedError("the backward takes int offsets only")
    variant = (dq_variant, dkv_variant)[which](q.dtype, h, hkv)
    q, k, v, do, lse, delta, *rest = _check_cuda(
        name, dict(q=q, k=k, v=v, dO=do), rows, variant=variant)
    dlse = rest[0] if rest else None
    segs = _segments_on(q.device, q_seg, kv_seg)
    outs = ((torch.empty_like(q),) if which == 0
            else (torch.empty_like(k), torch.empty_like(v)))
    if q.numel() == 0 or k.numel() == 0:
        for t in outs:
            t.zero_()
        return outs
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), _ptr(dlse), _ptr(segs[0]),
            _ptr(segs[1]), *(t.data_ptr() for t in outs),
            b, h, hkv, sq, sk, d, int(q_offset), int(k_offset),
            int(bool(causal)), d ** -0.5)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if variant in ("sm90", "mma"):
        library = f"{name}_sm90" if variant == "sm90" else f"{name}_mma_sm90"
        lib = _lib(library)
        extra = (() if variant == "sm90" else
                 (int(q.dtype == torch.bfloat16),))
        _raise_on(lib, getattr(lib, library)(*args, *extra, q.device.index,
                                             stream), name, library)
    else:
        lib = _lib("flash_bwd")
        smem = lib.flash_bwd_smem_bytes(which, d)
        if smem > SMEM_LIMIT:
            raise ValueError(f"{name} needs {smem} B of shared memory at "
                             f"head dim {d} (limit {SMEM_LIMIT})")
        fn = lib.flash_bwd_dq if which == 0 else lib.flash_bwd_dkv
        _raise_on(lib, fn(*args, int(q.dtype == torch.bfloat16),
                          q.device.index, stream), name)
    _count(wrapper, d, variant)
    return outs


def flash_bwd_dq(q, k, v, do, lse, delta, *, dlse=None, causal=True,
                 q_offset=0, k_offset=0, q_seg=None, kv_seg=None):
    """The K2 wrapper: dQ (B, Sq, H, D) in q's dtype.  ``lse``, ``delta``
    and ``dlse`` are fp32 (B, H, Sq).  Counts ``flash_bwd_dq.launches``
    and ``launches_by_variant``."""
    if q.device.type == "cpu":
        return flash_bwd_plain_from_delta(
            q, k, v, lse, delta, do, dlse=dlse, causal=causal,
            q_offset=q_offset, k_offset=k_offset, q_seg=q_seg,
            kv_seg=kv_seg)[0]
    (dq,) = _bwd_launch(0, q, k, v, do, lse, delta, dlse, causal, q_offset,
                        k_offset, q_seg, kv_seg)
    return dq


flash_bwd_dq.launches = 0
flash_bwd_dq.launches_by_variant = {"sm90": 0, "mma": 0, "fma": 0}
flash_bwd_dq.launches_by_head_dim = {}


def flash_bwd_dkv(q, k, v, do, lse, delta, *, dlse=None, causal=True,
                  q_offset=0, k_offset=0, q_seg=None, kv_seg=None):
    """The K3 wrapper: (dK, dV) (B, Sk, Hkv, D) in k's and v's dtype, each
    KV head's gradient summed over its group of query heads.  Counts
    ``flash_bwd_dkv.launches`` and ``launches_by_variant``."""
    if q.device.type == "cpu":
        return flash_bwd_plain_from_delta(
            q, k, v, lse, delta, do, dlse=dlse, causal=causal,
            q_offset=q_offset, k_offset=k_offset, q_seg=q_seg,
            kv_seg=kv_seg)[1:]
    return _bwd_launch(1, q, k, v, do, lse, delta, dlse, causal, q_offset,
                       k_offset, q_seg, kv_seg)


flash_bwd_dkv.launches = 0
flash_bwd_dkv.launches_by_variant = {"sm90": 0, "mma": 0, "fma": 0}
flash_bwd_dkv.launches_by_head_dim = {}


def flash_bwd(q, k, v, o, lse, do, *, dlse=None, causal=True, q_offset=0,
              k_offset=0, q_seg=None, kv_seg=None):
    """The backward of :func:`flash_fwd` (``_flash_bwd``): (dq, dk, dv).
    CPU tensors take :func:`flash_bwd_plain`; CUDA tensors run Delta, K2
    and K3."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, o, lse, do, dlse=dlse, causal=causal,
                               q_offset=q_offset, k_offset=k_offset,
                               q_seg=q_seg, kv_seg=kv_seg)
    delta = flash_bwd_delta(o, do)
    kw = dict(dlse=dlse, causal=causal, q_offset=q_offset, k_offset=k_offset,
              q_seg=q_seg, kv_seg=kv_seg)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv


# ---- autograd --------------------------------------------------------------


class _Flash(torch.autograd.Function):
    """``flash_attention``'s VJP (``_make_flash``): saves (q, k, v, o, lse)
    and the segment ids, which get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, q_seg, kv_seg, causal, q_offset, k_offset,
                block_q, block_k):
        o, lse = flash_fwd(q, k, v, causal=causal, q_offset=q_offset,
                           k_offset=k_offset, q_seg=q_seg, kv_seg=kv_seg,
                           block_q=block_q, block_k=block_k)
        ctx.save_for_backward(q, k, v, o, lse, q_seg, kv_seg)
        ctx.static = (causal, q_offset, k_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, q_seg, kv_seg = ctx.saved_tensors
        causal, q_offset, k_offset = ctx.static
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do.contiguous(),
                               causal=causal, q_offset=q_offset,
                               k_offset=k_offset, q_seg=q_seg, kv_seg=kv_seg)
        return dq, dk, dv, None, None, None, None, None, None, None


class _FlashWithLse(torch.autograd.Function):
    """``flash_attention_with_lse``'s VJP (``_make_flash_with_lse``): LSE
    is a second differentiable output; its cotangent dLSE feeds dS."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, k_offset, block_q, block_k):
        ctx.set_materialize_grads(False)
        o, lse = flash_fwd(q, k, v, causal=causal, q_offset=q_offset,
                           k_offset=k_offset, block_q=block_q,
                           block_k=block_k)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.static = (causal, q_offset, k_offset)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        causal, q_offset, k_offset = ctx.static
        do = torch.zeros_like(o) if do is None else do.contiguous()
        if dlse is not None:
            dlse = dlse.float().contiguous()
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do, dlse=dlse, causal=causal,
                               q_offset=q_offset, k_offset=k_offset)
        return dq, dk, dv, None, None, None, None, None


def _refuse_row_offsets_under_grad(q_offset, *tensors):
    if (isinstance(q_offset, torch.Tensor) and torch.is_grad_enabled()
            and any(t.requires_grad for t in tensors)):
        raise NotImplementedError(
            "a per-row q_offset tensor is forward-only (the backward takes "
            "static offsets, as in the JAX package); run under "
            "torch.no_grad() or pass an int")


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
    (rows attending to nothing give lse = NEG_INF).  Differentiable in both
    outputs.  ``interpret`` is kept for the JAX signature; the tensors'
    device picks the path."""
    del interpret
    _refuse_row_offsets_under_grad(q_offset, q, k, v)
    o, lse = _FlashWithLse.apply(q, k, v, causal, q_offset, k_offset,
                                 block_q, block_k)
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
    _refuse_row_offsets_under_grad(q_offset, q, k, v)
    q_seg = kv_seg = None
    if segment_ids is not None:
        q_seg, kv_seg = (segment_ids if isinstance(segment_ids, tuple)
                         else (segment_ids, segment_ids))
    return _Flash.apply(q, k, v, q_seg, kv_seg, causal, q_offset, k_offset,
                        block_q, block_k)
