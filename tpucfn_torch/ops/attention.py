"""Attention numerics in plain PyTorch — the reference every kernel of
the port is tested against, and the plain version of the flash forward
kernel (:mod:`tpucfn_torch.kernels.flash_attention`).

A port of ``tpucfn/ops/attention.py``: one batched matmul pair with an
fp32 softmax.  ``q_offset`` may also be an int32 tensor of shape
``(B,)``, one global position per batch row — the serving engine's
per-slot cache index.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30  # finite mask value: keeps max/exp nan-free for empty rows


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """GQA: expand KV heads to match query heads. (B, S, Hkv, D) -> (B, S, Hkv*n_rep, D)."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(b, s, h * n_rep, d)


def _positions(offset, n: int, batch: int, device) -> torch.Tensor:
    """(B, n) global positions from a scalar or a per-row (B,) offset."""
    base = torch.arange(n, device=device)
    if isinstance(offset, torch.Tensor) and offset.ndim == 1:
        if offset.shape[0] != batch:
            raise ValueError(
                f"per-row offset has {offset.shape[0]} rows for batch {batch}")
        return offset.to(device=device, dtype=torch.int64)[:, None] + base[None]
    return (base + int(offset))[None].expand(batch, n)


def dot_product_attention_with_lse(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Sk, Hkv, D)
    v: torch.Tensor,  # (B, Sk, Hkv, D)
    *,
    causal: bool = True,
    mask: torch.Tensor | None = None,  # broadcastable to (B, Hq, Sq, Sk); True = attend
    q_offset: int | torch.Tensor = 0,  # global position of q[0]; or (B,) per row
    k_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (out (B,Sq,Hq,D), lse (B,Sq,Hq)). Softmax in fp32.

    Rows that attend to nothing yield out = 0 and lse = NEG_INF."""
    orig_dtype = q.dtype
    b, sq, hq = q.shape[0], q.shape[1], q.shape[2]
    hkv, sk = k.shape[2], k.shape[1]
    if hq % hkv:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    k = _repeat_kv(k, hq // hkv)
    v = _repeat_kv(v, hq // hkv)

    scale = q.shape[-1] ** -0.5
    # (B, H, Sq, Sk), fp32 products as jnp.einsum(preferred_element_type=f32)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale

    if causal:
        qpos = _positions(q_offset, sq, b, q.device)           # (B, Sq)
        kpos = torch.arange(sk, device=q.device) + int(k_offset)
        keep = qpos[:, :, None] >= kpos[None, None, :]         # (B, Sq, Sk)
        logits = torch.where(keep[:, None], logits, NEG_INF)
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)

    m = logits.amax(dim=-1)  # (B, H, Sq); NEG_INF for empty rows
    probs = torch.where(logits > NEG_INF / 2, torch.exp(logits - m[..., None]),
                        0.0)
    l = probs.sum(dim=-1)
    lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)), NEG_INF)
    # P is rounded to v's dtype before the PV product, as the JAX
    # reference does; the sum itself runs in fp32.
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())
    out = out / l.clamp_min(1e-30).transpose(1, 2)[..., None]
    out = torch.where((l > 0).transpose(1, 2)[..., None], out, 0.0)
    return out.to(orig_dtype), lse.transpose(1, 2)  # lse -> (B, Sq, Hq)


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    mask: torch.Tensor | None = None,
    q_offset: int | torch.Tensor = 0,
    k_offset: int = 0,
) -> torch.Tensor:
    """Returns (B, Sq, Hq, D); see :func:`dot_product_attention_with_lse`."""
    out, _ = dot_product_attention_with_lse(
        q, k, v, causal=causal, mask=mask, q_offset=q_offset, k_offset=k_offset
    )
    return out
