"""Llama-3-family decoder (the port of ``LlamaConfig``, ``LlamaBlock``
and ``Llama`` in ``tpucfn/models/llama.py``).

RMSNorm pre-norm, GQA attention with RoPE (theta 500k), SwiGLU MLP,
untied LM head; activations in the compute dtype, norms and the LM head
in fp32, matmul weights and the embedding stored in ``param_dtype`` (fp32
for training; the compute dtype, by default, for serving).  Layers are a
plain ``nn.ModuleList``: the JAX package's ``nn.scan`` stacking is undone
by the weight converter; ``remat`` wraps each block in
``torch.utils.checkpoint``.  The dense MLP only (a MoE config raises).
Also here: the training losses (``causal_lm_loss``,
``chunked_causal_lm_loss``) and the sharding rules
(``sharding_rules``).

Decode mode keeps its KV cache outside the module, in a
:class:`DecodeCache` the caller owns and passes to every call.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tpucfn_torch.models.layers import (
    AttentionFn,
    CausalSelfAttention,
    RMSNorm,
    SwiGLUMLP,
    bind_state_dict,
    lecun_normal_,
    rope_frequencies,
)
from tpucfn_torch.ops.attention import dot_product_attention


def remat_policy(remat: bool | str) -> bool:
    """Whether a ``LlamaConfig.remat`` value checkpoints each block:
    ``True``/``"full"`` recompute the whole block in the backward,
    ``False``/``"none"`` keep every activation.  The JAX package's
    selective policies save matmul outputs; they are not ported yet."""
    if remat in (True, "full"):
        return True
    if remat in (False, "none"):
        return False
    if remat in ("dots", "dots_no_batch"):
        raise NotImplementedError(
            f"remat={remat!r} (a selective checkpoint policy) is not ported "
            "yet; use True/'full' or False/'none'")
    raise ValueError(
        f"remat={remat!r} — expected True/'full', 'dots', "
        "'dots_no_batch', or False/'none'")


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
    # Storage dtype of the matmul weights and the embedding: None stores
    # them in the compute dtype (serving); training passes torch.float32,
    # the JAX package's default.  Norm scales and the LM head stay fp32.
    param_dtype: torch.dtype | None = None
    remat: bool | str = True  # see remat_policy; a no-op outside autograd
    moe: Any = None  # a MoE config is not supported by the port yet

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    def __post_init__(self):
        remat_policy(self.remat)  # validate early, not at first call

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
            param_dtype=cfg.param_dtype, attention_fn=attention_fn,
            decode=decode, device=device)
        self.post_attn_norm = RMSNorm(cfg.dim, cfg.norm_eps, cfg.dtype, device)
        self.mlp = SwiGLUMLP(cfg.dim, cfg.ffn_dim, cfg.dtype, cfg.param_dtype,
                             device)

    def forward(self, x, *, q_offset=0, rope=None, kv_cache=None,
                cache_index=None, attention_fn=None):
        x = x + self.attn(self.input_norm(x), q_offset=q_offset, rope=rope,
                          kv_cache=kv_cache, cache_index=cache_index,
                          attention_fn=attention_fn)
        return x + self.mlp(self.post_attn_norm(x))


class Llama(nn.Module):
    """``attention_fn=None`` resolves as in the JAX package: outside decode,
    with the zero ``q_offset`` of the unsharded path, through the measured
    dense/flash policy
    (:func:`tpucfn_torch.kernels.auto.auto_attention_static_zero`: the
    flash kernels on the card unless the tune table measured dense
    faster for the shape's family);
    otherwise the plain dense op."""

    def __init__(self, cfg: LlamaConfig, *, attention_fn: AttentionFn | None = None,
                 decode: bool = False, device=None):
        super().__init__()
        if cfg.moe is not None:
            raise NotImplementedError("MoE Llama is not ported yet")
        self.cfg = cfg
        self.decode = decode
        self.attention_fn = attention_fn
        attention_fn = attention_fn or dot_product_attention
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.dim,
                                         dtype=cfg.param_dtype or cfg.dtype,
                                         device=device)
        self.layers = nn.ModuleList(
            LlamaBlock(cfg, attention_fn, decode, device)
            for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.dim, cfg.norm_eps, cfg.dtype, device)
        self.lm_head = nn.Linear(cfg.dim, cfg.vocab_size, bias=False,
                                 dtype=torch.float32, device=device)
        self._rope_tables: dict = {}  # device -> (cos, sin), made once

    @classmethod
    def from_state_dict(cls, cfg: LlamaConfig, params: Mapping[str, torch.Tensor],
                        *, attention_fn: AttentionFn | None = None,
                        decode: bool = False, device=None,
                        trainable: bool = False) -> "Llama":
        """A model over ``params`` (the port's state dict).  Tensors already
        on ``device`` in their storage dtype are used as they are, not
        copied — several models (the engine's and ``generate``'s) can share
        one set of weights, and a training loss builds its model over the
        trainer's parameters in each call.  The weights are frozen unless
        ``trainable``; then ``nn.Parameter`` values stay the very objects
        passed, so their gradients land where the caller looks."""
        with torch.device("meta"):
            model = cls(cfg, attention_fn=attention_fn, decode=decode)
        return bind_state_dict(model, params, device=device,
                               trainable=trainable)

    def init_cache(self, batch: int, capacity: int | None = None,
                   device=None) -> DecodeCache:
        return DecodeCache.zeros(self.cfg, batch, capacity or self.cfg.max_seq,
                                 device or self.lm_head.weight.device)

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """The embedding rows of ``tokens`` as ``jnp.take`` gives them to
        the JAX package's ``nn.Embed``: a negative id counts from the end,
        an id outside [-vocab, vocab) gets a row of NaN.  A draft whose
        vocabulary is smaller than its target's sees such ids; its
        proposals are then garbage that verification rejects, where
        ``nn.Embedding`` would stop the card on a device-side assert."""
        v = self.cfg.vocab_size
        x = self.embed_tokens(tokens.remainder(v))
        fits = (tokens >= -v) & (tokens < v)
        return torch.where(fits[..., None], x, torch.nan)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """The fp32 LM head over final-norm hidden states."""
        return F.linear(hidden.float(), self.lm_head.weight)

    def forward(self, tokens: torch.Tensor, *, q_offset=0,
                cache: DecodeCache | None = None,
                return_hidden: bool = False,
                segment_ids: torch.Tensor | None = None) -> torch.Tensor:
        """tokens: (B, S) int → logits (B, S, vocab) fp32, or with
        ``return_hidden`` the (B, S, dim) final-norm hidden states (pair
        with :func:`chunked_causal_lm_loss`).

        Decode mode needs ``cache``: every layer writes its K/V at the
        rows' ``cache.index`` and the index advances by S.

        ``segment_ids`` (B, S) enables packed-sequence training: attention
        is masked across document boundaries (the kernels' segment path
        where the dispatch policy picks flash, an explicit dense mask
        elsewhere) — pair with ``packed_causal_lm_loss``.  Overrides
        ``attention_fn``; incompatible with decode and with a nonzero
        ``q_offset``."""
        cfg = self.cfg
        if self.decode:
            if cache is None:
                raise ValueError("decode mode needs a DecodeCache")
            if not (isinstance(q_offset, int) and q_offset == 0):
                raise ValueError(
                    "decode mode is incompatible with q_offset/SP sharding")
        attention_fn = None
        if segment_ids is not None:
            if self.decode:
                raise ValueError("segment_ids is incompatible with decode mode")
            if not (isinstance(q_offset, int) and q_offset == 0):
                raise ValueError(
                    "segment_ids is incompatible with q_offset/SP sharding")
            from tpucfn_torch.data.packing import packed_attention_fn

            attention_fn = packed_attention_fn(segment_ids)
        elif (self.attention_fn is None and not self.decode
              and isinstance(q_offset, int) and q_offset == 0):
            from tpucfn_torch.kernels.auto import auto_attention_static_zero

            attention_fn = auto_attention_static_zero
        x = self._embed(tokens).to(cfg.dtype)
        rope = self._rope_tables.get(x.device)
        if rope is None:
            rope = self._rope_tables[x.device] = rope_frequencies(
                cfg.head_dim, cfg.max_seq, cfg.rope_theta, device=x.device)
        remat = (not self.decode and remat_policy(cfg.remat)
                 and torch.is_grad_enabled())
        for i, layer in enumerate(self.layers):
            if self.decode:
                x = layer(x, rope=rope,
                          kv_cache=(cache.keys[i], cache.values[i]),
                          cache_index=cache.index)
            elif remat:
                x = checkpoint(layer, x, use_reentrant=False,
                               q_offset=q_offset, rope=rope,
                               attention_fn=attention_fn)
            else:
                x = layer(x, q_offset=q_offset, rope=rope,
                          attention_fn=attention_fn)
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
    storage dtypes (``cfg.param_dtype``).  (The numbers differ from JAX's;
    parity tests carry JAX's own weights across with
    :mod:`tpucfn_torch.models.convert`.)"""
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
            lecun_normal_(w, meta.shape[1], generator)
        params[name] = w.to(meta.dtype)
    return params


def sharding_rules(cfg: LlamaConfig, *, fsdp: bool = True,
                   tensor: bool = True):
    """Megatron TP x FSDP rules for the port's parameter names: the JAX
    package's rules on its layouts.  ``nn.Linear`` weights are (out, in)
    where a JAX ``DenseGeneral`` kernel is (in, out), so each dense spec
    is the JAX one reversed; the embedding is (vocab, dim) on both sides.
    The layers are a list here, not a stacked scan, so no spec has a
    leading layer entry.  ``cfg`` is taken for the JAX signature (the MoE
    rules of the JAX package wait with the MoE model)."""
    from tpucfn_torch.mesh import AXIS_FSDP, AXIS_TENSOR
    from tpucfn_torch.parallel.sharding import ShardingRules

    del cfg
    t = AXIS_TENSOR if tensor else None
    f = AXIS_FSDP if fsdp else None
    return ShardingRules((
        (r"(q_proj|k_proj|v_proj)\.weight$", (t, f)),
        (r"o_proj\.weight$", (f, t)),
        (r"(gate_proj|up_proj)\.weight$", (t, f)),
        (r"down_proj\.weight$", (f, t)),
        (r"(input_norm|post_attn_norm)\.scale$", ()),
        (r"embed_tokens\.weight$", (t, f)),
        (r"lm_head\.weight$", (t, f)),
        (r".*", ()),
    ))


def train_step_flops(cfg: LlamaConfig, batch: int, seq_len: int, *,
                     chunked_head: bool = True) -> float:
    """Matmul and attention FLOPs of one training step over a (batch,
    seq_len) token batch: the forward, the backward (twice the forward),
    the recompute of every block's forward under full remat
    (``cfg.remat``), and, with ``chunked_head`` (the chunked CE, each
    chunk under a checkpoint), the recompute of the LM head.  Attention
    counts the causal half of each (S, S) product, the work the flash
    kernels do.  Norms, activations, the softmax and the optimizer are
    not counted."""
    hd, h, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    tokens = batch * seq_len
    per_layer = (2 * cfg.dim * h * hd + 2 * cfg.dim * hkv * hd
                 + 3 * cfg.dim * cfg.ffn_dim)
    blocks = cfg.n_layers * (
        2 * tokens * per_layer
        + 4 * batch * h * hd * (seq_len * (seq_len + 1) // 2))
    head_rows = batch * (seq_len - 1) if chunked_head else tokens
    head = 2 * head_rows * cfg.dim * cfg.vocab_size
    recompute = (blocks if remat_policy(cfg.remat) else 0) + (
        head if chunked_head else 0)
    return float(3 * (blocks + head) + recompute)


def token_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                        z_loss: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token CE (optax ``softmax_cross_entropy_with_integer_labels``)
    plus ``z_loss * logsumexp**2``, and whether the argmax hits."""
    lse = torch.logsumexp(logits, dim=-1)
    per_tok = lse - logits.gather(-1, targets[..., None])[..., 0]
    if z_loss:
        per_tok = per_tok + z_loss * lse ** 2
    return per_tok, logits.argmax(-1) == targets


def causal_lm_loss(logits: torch.Tensor, tokens: torch.Tensor, *,
                   z_loss: float = 0.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Next-token cross entropy (mean over B, S-1) + optional z-loss.

    Returns (loss, accuracy)."""
    per_tok, hit = token_cross_entropy(logits[:, :-1].float(),
                                       tokens[:, 1:].long(), z_loss)
    return per_tok.mean(), hit.float().mean()


def chunked_causal_lm_loss(
    hidden: torch.Tensor,          # (B, S, D) — Llama(..., return_hidden=True)
    lm_head_weight: torch.Tensor,  # (V, D), the port's nn.Linear layout
    tokens: torch.Tensor,          # (B, S) int
    *,
    chunk_size: int = 512,
    z_loss: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Next-token CE + accuracy without the (B, S, V) fp32 logits.

    Equal to ``causal_lm_loss(logits(hidden), tokens)`` up to fp32 sum
    order: a loop over sequence chunks computes each chunk's logits,
    reduces them to a CE sum and a hit count and drops them; each chunk
    runs under ``torch.utils.checkpoint``, so the backward recomputes its
    logits instead of keeping them.  Peak logits memory is (B, chunk, V)."""
    b, s, _ = hidden.shape
    n = s - 1
    c = max(1, min(chunk_size, n))

    def chunk_sums(w, h_c, t_c):
        per_tok, hit = token_cross_entropy(F.linear(h_c.float(), w.float()),
                                           t_c, z_loss)
        return per_tok.sum(), hit.float().sum()

    ce = correct = hidden.new_zeros((), dtype=torch.float32)
    pred, targets = hidden[:, :-1], tokens[:, 1:].long()
    for i in range(0, n, c):
        ce_c, cor_c = checkpoint(chunk_sums, lm_head_weight,
                                 pred[:, i:i + c], targets[:, i:i + c],
                                 use_reentrant=False)
        ce, correct = ce + ce_c, correct + cor_c
    return ce / (b * n), correct / (b * n)
