"""Llama-3-family decoder (the port of ``LlamaConfig``, ``LlamaBlock``
and ``Llama`` in ``tpucfn/models/llama.py``).

RMSNorm pre-norm, GQA attention with RoPE (theta 500k), SwiGLU MLP,
untied LM head; activations in the compute dtype, norms and the LM head
in fp32.  Layers are a plain ``nn.ModuleList``: the JAX package's
``nn.scan`` stacking is undone by the weight converter.  The dense MLP
only (a MoE config raises); sharding rules, losses and remat belong to
the training path and are not ported yet.

Decode mode keeps its KV cache outside the module, in a
:class:`DecodeCache` the caller owns and passes to every call.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from tpucfn_torch.models.layers import (
    AttentionFn,
    CausalSelfAttention,
    RMSNorm,
    SwiGLUMLP,
    rope_frequencies,
)
from tpucfn_torch.ops.attention import dot_product_attention


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_dim: int = 14336
    max_seq: int = 8192
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    moe: Any = None  # a MoE config is not supported by the port yet

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @classmethod
    def llama3_8b(cls) -> "LlamaConfig":
        return cls()  # the defaults above are the 8B shape

    @classmethod
    def llama3_1b(cls) -> "LlamaConfig":
        return cls(dim=2048, n_layers=16, n_heads=32, n_kv_heads=8, ffn_dim=8192)

    @classmethod
    def tiny(cls, vocab: int = 256) -> "LlamaConfig":
        return cls(vocab_size=vocab, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
                   ffn_dim=128, max_seq=512, dtype=torch.float32)


@dataclasses.dataclass
class DecodeCache:
    """The decode-mode KV cache of a batch of rows: per layer, keys and
    values of shape (B, capacity, Hkv, D) in the compute dtype, and one
    (B,) int32 ``index`` — tokens written so far, per row, shared by all
    layers (the JAX package keeps one equal index per layer)."""

    keys: list[torch.Tensor]
    values: list[torch.Tensor]
    index: torch.Tensor

    @classmethod
    def zeros(cls, cfg: LlamaConfig, batch: int, capacity: int,
              device=None) -> "DecodeCache":
        shape = (batch, capacity, cfg.n_kv_heads, cfg.head_dim)

        def z():
            return torch.zeros(shape, dtype=cfg.dtype, device=device)

        return cls([z() for _ in range(cfg.n_layers)],
                   [z() for _ in range(cfg.n_layers)],
                   torch.zeros((batch,), dtype=torch.int32, device=device))

    def rows(self, slots: torch.Tensor) -> "DecodeCache":
        """A copy of the rows ``slots`` (duplicates allowed)."""
        return DecodeCache([k.index_select(0, slots) for k in self.keys],
                           [v.index_select(0, slots) for v in self.values],
                           self.index.index_select(0, slots))

    def put_rows(self, slots: torch.Tensor, rows: "DecodeCache") -> None:
        """Write ``rows`` back at ``slots`` in place.  Duplicate slots are
        safe only because their rows are identical (the engine's pad
        lanes repeat lane 0), so the write order does not matter."""
        for full, r in zip(self.keys + self.values, rows.keys + rows.values):
            full.index_copy_(0, slots, r)
        self.index.index_copy_(0, slots, rows.index)


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, attention_fn: AttentionFn,
                 decode: bool, device=None):
        super().__init__()
        self.input_norm = RMSNorm(cfg.dim, cfg.norm_eps, cfg.dtype, device)
        self.attn = CausalSelfAttention(
            cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            rope_theta=cfg.rope_theta, max_seq=cfg.max_seq, dtype=cfg.dtype,
            attention_fn=attention_fn, decode=decode, device=device)
        self.post_attn_norm = RMSNorm(cfg.dim, cfg.norm_eps, cfg.dtype, device)
        self.mlp = SwiGLUMLP(cfg.dim, cfg.ffn_dim, cfg.dtype, device)

    def forward(self, x, *, q_offset=0, rope=None, kv_cache=None,
                cache_index=None):
        x = x + self.attn(self.input_norm(x), q_offset=q_offset, rope=rope,
                          kv_cache=kv_cache, cache_index=cache_index)
        return x + self.mlp(self.post_attn_norm(x))


class Llama(nn.Module):
    """``attention_fn=None`` is the plain dense op (the JAX package's
    decode-mode default); pass the flash wrapper to run the kernel."""

    def __init__(self, cfg: LlamaConfig, *, attention_fn: AttentionFn | None = None,
                 decode: bool = False, device=None):
        super().__init__()
        if cfg.moe is not None:
            raise NotImplementedError("MoE Llama is not ported yet")
        self.cfg = cfg
        self.decode = decode
        attention_fn = attention_fn or dot_product_attention
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.dim,
                                         dtype=cfg.dtype, device=device)
        self.layers = nn.ModuleList(
            LlamaBlock(cfg, attention_fn, decode, device)
            for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.dim, cfg.norm_eps, cfg.dtype, device)
        self.lm_head = nn.Linear(cfg.dim, cfg.vocab_size, bias=False,
                                 dtype=torch.float32, device=device)

    @classmethod
    def from_state_dict(cls, cfg: LlamaConfig, params: Mapping[str, torch.Tensor],
                        *, attention_fn: AttentionFn | None = None,
                        decode: bool = False, device=None) -> "Llama":
        """A model over ``params`` (the port's state dict).  Tensors already
        on ``device`` in their storage dtype are used as they are, not
        copied — several models (the engine's and ``generate``'s) can share
        one set of weights."""
        with torch.device("meta"):
            model = cls(cfg, attention_fn=attention_fn, decode=decode)
        want = model.state_dict()
        model.load_state_dict(
            {name: params[name].to(device=device, dtype=want[name].dtype)
             for name in want}, strict=True, assign=True)
        return model.requires_grad_(False)

    def init_cache(self, batch: int, capacity: int | None = None,
                   device=None) -> DecodeCache:
        return DecodeCache.zeros(self.cfg, batch, capacity or self.cfg.max_seq,
                                 device or self.lm_head.weight.device)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """The fp32 LM head over final-norm hidden states."""
        return F.linear(hidden.float(), self.lm_head.weight)

    def forward(self, tokens: torch.Tensor, *, q_offset=0,
                cache: DecodeCache | None = None,
                return_hidden: bool = False) -> torch.Tensor:
        """tokens: (B, S) int → logits (B, S, vocab) fp32, or with
        ``return_hidden`` the (B, S, dim) final-norm hidden states.

        Decode mode needs ``cache``: every layer writes its K/V at the
        rows' ``cache.index`` and the index advances by S."""
        cfg = self.cfg
        if self.decode:
            if cache is None:
                raise ValueError("decode mode needs a DecodeCache")
            if not (isinstance(q_offset, int) and q_offset == 0):
                raise ValueError(
                    "decode mode is incompatible with q_offset/SP sharding")
        x = self.embed_tokens(tokens)
        rope = rope_frequencies(cfg.head_dim, cfg.max_seq, cfg.rope_theta,
                                device=x.device)
        for i, layer in enumerate(self.layers):
            if self.decode:
                x = layer(x, rope=rope,
                          kv_cache=(cache.keys[i], cache.values[i]),
                          cache_index=cache.index)
            else:
                x = layer(x, q_offset=q_offset, rope=rope)
        if self.decode:
            cache.index.add_(tokens.shape[1])
        x = self.final_norm(x)
        if return_hidden:
            return x
        return self.logits(x)


def init_llama_params(cfg: LlamaConfig, *, generator: torch.Generator,
                      device=None) -> dict[str, torch.Tensor]:
    """Random weights from a seeded generator, in the initializer families
    and scales of flax's defaults: the embedding ~ N(0, 1/dim); every
    dense kernel lecun-normal (a normal truncated at ±2σ, σ =
    sqrt(1/fan_in)/0.8796); norm scales one.  Returned in the port's
    storage dtypes.  (The numbers differ from JAX's; parity tests carry
    JAX's own weights across with :mod:`tpucfn_torch.models.convert`.)"""
    with torch.device("meta"):
        shapes = Llama(cfg).state_dict()
    params = {}
    for name, meta in shapes.items():
        w = torch.empty(meta.shape, dtype=torch.float32, device=device)
        if name.endswith(".scale"):
            w.fill_(1.0)
        elif name == "embed_tokens.weight":
            w.normal_(0.0, cfg.dim ** -0.5, generator=generator)
        else:  # nn.Linear weight (out, in): fan_in = in
            std = (1.0 / meta.shape[1]) ** 0.5 / 0.87962566103423978
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
        params[name] = w.to(meta.dtype)
    return params
