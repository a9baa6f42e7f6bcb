"""BERT-base encoder and MLM head (the port of ``tpucfn/models/bert.py``).

Post-LayerNorm BERT: learned positions and token types, a tanh-GELU MLP,
LayerNorm epsilon 1e-12, an untied MLM head (transform, norm, vocab
projection) in fp32.  bf16 compute and fp32 parameters, fp32 softmax and
LayerNorm, as in the JAX package.  Parameter names follow its tree with
``.`` for ``/`` (``layers_3.q_proj.weight`` for ``layers_3/q_proj/kernel``;
embeddings ``embed_tokens.weight``); norms keep flax's ``scale`` and
``bias``.

Attention is the plain :func:`tpucfn_torch.ops.attention.dot_product_attention`
with the padding mask, as the JAX package calls it: a masked call is
dense in both packages (the flash kernels mask causally or by segment
only), so no kernel of the port runs on this model's path.

Dropout (``cfg.dropout``, in training only) draws its masks from the
caller's ``torch.Generator``; JAX draws them from its ``dropout`` key, so
the two agree only where the rate is 0 (the tiny config).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from tpucfn_torch.models.layers import (Dense, LayerNorm, bind_state_dict,
                                         lecun_normal_)
from tpucfn_torch.ops.attention import dot_product_attention


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    dim: int = 768
    n_layers: int = 12
    n_heads: int = 12
    ffn_dim: int = 3072
    max_positions: int = 512
    type_vocab: int = 2
    dropout: float = 0.1
    norm_eps: float = 1e-12
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @classmethod
    def base(cls) -> "BertConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "BertConfig":
        return cls(vocab_size=128, dim=32, n_layers=2, n_heads=2, ffn_dim=64,
                   max_positions=64, dropout=0.0, dtype=torch.float32)


def _dropout(x: torch.Tensor, rate: float, train: bool,
             generator: torch.Generator | None) -> torch.Tensor:
    """flax ``Dropout``: keep with probability 1 - rate, scaled by its
    inverse; the identity outside training or at rate 0."""
    if not train or rate == 0.0:
        return x
    keep = torch.empty(x.shape, device=x.device).bernoulli_(
        1.0 - rate, generator=generator)
    return torch.where(keep.bool(), x / (1.0 - rate), 0.0).to(x.dtype)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        dense = lambda i, o: Dense(i, o, cfg.dtype, cfg.param_dtype,  # noqa: E731
                                   bias=True)
        self.q_proj = dense(cfg.dim, cfg.dim)
        self.k_proj = dense(cfg.dim, cfg.dim)
        self.v_proj = dense(cfg.dim, cfg.dim)
        self.o_proj = dense(cfg.dim, cfg.dim)
        self.attn_norm = LayerNorm(cfg.dim, cfg.param_dtype, cfg.norm_eps)
        self.fc1 = dense(cfg.dim, cfg.ffn_dim)
        self.fc2 = dense(cfg.ffn_dim, cfg.dim)
        self.mlp_norm = LayerNorm(cfg.dim, cfg.param_dtype, cfg.norm_eps)

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor, *,
                train: bool, generator: torch.Generator | None = None
                ) -> torch.Tensor:
        cfg = self.cfg
        b, s, _ = x.shape
        heads = lambda t: t.reshape(b, s, cfg.n_heads, cfg.head_dim)  # noqa: E731
        attn = dot_product_attention(
            heads(self.q_proj(x)), heads(self.k_proj(x)),
            heads(self.v_proj(x)), causal=False,
            mask=attn_mask[:, None, None, :]).reshape(b, s, cfg.dim)
        drop = lambda t: _dropout(t, cfg.dropout, train, generator)  # noqa: E731
        x = self.attn_norm(x + drop(self.o_proj(attn))).to(cfg.dtype)
        h = F.gelu(self.fc1(x), approximate="tanh")
        return self.mlp_norm(x + drop(self.fc2(h))).to(cfg.dtype)


class Bert(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        emb = lambda n: nn.Embedding(n, cfg.dim, dtype=cfg.param_dtype)  # noqa: E731
        self.embed_tokens = emb(cfg.vocab_size)
        self.embed_positions = emb(cfg.max_positions)
        self.embed_types = emb(cfg.type_vocab)
        self.embed_norm = LayerNorm(cfg.dim, cfg.param_dtype, cfg.norm_eps)
        for i in range(cfg.n_layers):
            self.add_module(f"layers_{i}", BertLayer(cfg))
        self.mlm_transform = Dense(cfg.dim, cfg.dim, cfg.dtype,
                                   cfg.param_dtype, bias=True)
        self.mlm_norm = LayerNorm(cfg.dim, cfg.param_dtype, cfg.norm_eps)
        self.lm_head = Dense(cfg.dim, cfg.vocab_size, torch.float32,
                             cfg.param_dtype, bias=True)

    @classmethod
    def from_state_dict(cls, cfg: BertConfig,
                        params: Mapping[str, torch.Tensor], *, device=None,
                        trainable: bool = False) -> "Bert":
        """A model over ``params``, as :meth:`UNet.from_state_dict`."""
        with torch.device("meta"):
            model = cls(cfg)
        return bind_state_dict(model, params, device=device,
                               trainable=trainable)

    def forward(self, tokens: torch.Tensor, *,
                token_types: torch.Tensor | None = None,
                attn_mask: torch.Tensor | None = None, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """tokens (B, S) -> MLM logits (B, S, vocab), fp32.  ``attn_mask``
        (B, S) bool, True where a key may be attended."""
        cfg = self.cfg
        b, s = tokens.shape
        if attn_mask is None:
            attn_mask = torch.ones((b, s), dtype=torch.bool,
                                   device=tokens.device)
        if token_types is None:
            token_types = torch.zeros_like(tokens)
        dt = cfg.dtype
        pos = torch.arange(s, device=tokens.device)[None]
        x = (self.embed_tokens(tokens).to(dt)
             + self.embed_positions(pos).to(dt)
             + self.embed_types(token_types).to(dt))
        x = self.embed_norm(x).to(dt)
        x = _dropout(x, cfg.dropout, train, generator)
        for i in range(cfg.n_layers):
            x = getattr(self, f"layers_{i}")(x, attn_mask, train=train,
                                             generator=generator)
        h = F.gelu(self.mlm_transform(x), approximate="tanh")
        return self.lm_head(self.mlm_norm(h))


def init_bert_params(cfg: BertConfig, *, generator: torch.Generator,
                     device=None) -> dict[str, torch.Tensor]:
    """Random weights from a seeded generator in flax's initializer
    families: embeddings ~ N(0, 1/dim), dense kernels lecun-normal
    (truncated at ±2σ, σ = sqrt(1/fan_in)/0.8796), biases zero, norm
    scales one."""
    with torch.device("meta"):
        shapes = Bert(cfg).state_dict()
    params = {}
    for name, meta in shapes.items():
        w = torch.zeros(meta.shape, dtype=torch.float32, device=device)
        if name.endswith(".scale"):
            w.fill_(1.0)
        elif name.startswith("embed_") and name.endswith(".weight"):
            w.normal_(0.0, cfg.dim ** -0.5, generator=generator)
        elif name.endswith(".weight"):
            lecun_normal_(w, meta.shape[1], generator)
        params[name] = w.to(meta.dtype)
    return params


def mlm_loss(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked-LM cross-entropy and accuracy over the positions where
    ``mask`` is True.  labels (B, S): the original ids; mask (B, S) bool."""
    per_tok = (torch.logsumexp(logits, -1)
               - logits.gather(-1, labels[..., None].long())[..., 0])
    denom = mask.sum().clamp_min(1)
    loss = torch.where(mask, per_tok, 0.0).sum() / denom
    acc = (mask & (logits.argmax(-1) == labels)).sum() / denom
    return loss, acc
