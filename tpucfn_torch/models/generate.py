"""Autoregressive generation with a KV cache (the port of
``tpucfn/models/generate.py``).

Prefill runs the prompt through the decode-mode model once, filling each
layer's cache; then one token per step attends over the cached prefix.
The model here uses the plain attention op (``attention_fn=None``, as in
the JAX package), so on the card this is the serving engine's plain
yardstick.  Greedy (temperature=0) or temperature sampling with optional
top-k/top-p; sampling draws from a ``torch.Generator`` and cannot match
``jax.random`` number for number.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch

from tpucfn_torch.models.llama import Llama, LlamaConfig


def _scaled_filtered_logits(logits: torch.Tensor, temperature: float,
                            top_k: int | None,
                            top_p: float | None) -> torch.Tensor:
    """Temperature FIRST, then top-k/top-p filtering (the HF/vLLM
    convention).  The returned logits are already scaled."""
    return _filter_logits(logits / temperature, top_k, top_p)


def _filter_logits(logits: torch.Tensor, top_k: int | None,
                   top_p: float | None) -> torch.Tensor:
    """Mask logits outside the top-k set and/or the top-p (nucleus)
    mass to the dtype's minimum. (B, V) -> (B, V)."""
    neg = torch.finfo(logits.dtype).min
    if top_k is not None:
        if top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {top_k}")
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, neg, logits)
    if top_p is not None:
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # Keep the smallest prefix with mass >= top_p (the first token
        # is always kept: cum - probs < top_p holds at position 0).
        keep_sorted = (cum - probs) < top_p
        cutoff = torch.where(keep_sorted, sorted_logits, torch.inf).amin(
            dim=-1, keepdim=True)
        logits = torch.where(logits < cutoff, neg, logits)
    return logits


def categorical(logits: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
    """One draw per row from softmax(logits) by the Gumbel-max trick (the
    form ``jax.random.categorical`` takes).  Rows holding NaN give some
    index instead of raising, as in JAX."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return (logits + gumbel).argmax(dim=-1)


def generate(
    cfg: LlamaConfig,
    params: Mapping[str, torch.Tensor],
    prompt,  # (B, T) int
    *,
    max_new_tokens: int,
    temperature: float = 0.0,
    top_k: int | None = None,
    top_p: float | None = None,
    generator: torch.Generator | None = None,
    cache_len: int | None = None,
) -> torch.Tensor:
    """Returns (B, T + max_new_tokens) int tokens (prompt included), on
    the device the weights ``params`` (the port's state dict) lie on."""
    device = params["lm_head.weight"].device
    prompt = torch.as_tensor(prompt, device=device).long()
    b, t = prompt.shape
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    total = t + max_new_tokens
    if cache_len is None:
        cache_len = total
    if cache_len < total:
        raise ValueError(f"cache_len {cache_len} < prompt+new {total}")
    # The cache (and RoPE tables) size from max_seq; cap to this call's
    # needs so short generations don't pay full-context attention.
    dcfg = dataclasses.replace(cfg, max_seq=cache_len)
    model = Llama.from_state_dict(dcfg, params, decode=True, device=device)
    cache = model.init_cache(b, cache_len)

    def sample(hidden_last):
        logits = model.logits(hidden_last)
        if temperature <= 0.0:
            return logits.argmax(dim=-1)
        filtered = _scaled_filtered_logits(logits, temperature, top_k, top_p)
        return categorical(filtered, generator)

    with torch.no_grad():
        tok = sample(model(prompt, cache=cache, return_hidden=True)[:, -1])
        out = [tok]
        for _ in range(max_new_tokens - 1):
            hidden = model(tok[:, None], cache=cache, return_hidden=True)
            tok = sample(hidden[:, -1])
            out.append(tok)
    return torch.cat([prompt, torch.stack(out, dim=1)], dim=1)
