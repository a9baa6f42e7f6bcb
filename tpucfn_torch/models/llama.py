"""Llama-3-family decoder (the port of ``LlamaConfig``, ``LlamaBlock``
and ``Llama`` in ``tpucfn/models/llama.py``).

RMSNorm pre-norm, GQA attention with RoPE (theta 500k), SwiGLU MLP,
untied LM head; activations in the compute dtype, norms and the LM head
in fp32, matmul weights and the embedding stored in ``param_dtype`` (fp32
for training; the compute dtype, by default, for serving).  Layers are a
plain ``nn.ModuleList``: the JAX package's ``nn.scan`` stacking is undone
by the weight converter; ``remat`` wraps each block in
``torch.utils.checkpoint`` (the selective policies through
``create_selective_checkpoint_contexts``).  With ``cfg.moe`` every
block's MLP is a :class:`~tpucfn_torch.models.moe.MoEMLP`, and
``forward(..., return_aux=True)`` also returns the summed aux loss and
the mean dropped fraction, which the JAX layers sow (each block returns
them, so they survive the recompute under remat).  Also here: the training losses
(``causal_lm_loss``, ``chunked_causal_lm_loss``) and the sharding rules
(``sharding_rules``).

Decode mode keeps its KV cache outside the module, in a
:class:`DecodeCache` the caller owns and passes to every call.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

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
from tpucfn_torch.models.moe import MoEConfig, MoEMLP
from tpucfn_torch.ops.attention import dot_product_attention


# The matmul ops each selective policy saves (JAX's
# ``checkpoint_dots`` and ``dots_with_no_batch_dims_saveable``): every
# product, or the products with no batch dimension, which is what
# ``F.linear`` over flattened tokens reaches.  ``bmm`` carries a batch
# dimension: the dense attention's products and the MoE experts'.
_DOTS = ("mm", "addmm", "bmm", "baddbmm")
SAVED_PRODUCTS = {"dots": _DOTS, "dots_no_batch": _DOTS[:2]}


def remat_policy(remat: bool | str) -> tuple[bool, str | None]:
    """(checkpoint each block, selective policy) for a ``LlamaConfig.remat``
    value: ``True``/``"full"`` recompute the whole block in the backward;
    ``"dots"`` and ``"dots_no_batch"`` keep the outputs of the products
    :data:`SAVED_PRODUCTS` names and recompute the rest; ``False``/
    ``"none"`` keep every activation.  The flash forward (K1) is a
    kernel launch, no product the policy can see, so both selective
    policies recompute it in the backward, as JAX's do its
    ``pallas_call``."""
    if remat in (True, "full"):
        return True, None
    if remat in (False, "none"):
        return False, None
    if remat in SAVED_PRODUCTS:
        return True, remat
    raise ValueError(
        f"remat={remat!r} — expected True/'full', 'dots', "
        "'dots_no_batch', or False/'none'")


def _selective_context(policy: str):
    """The ``context_fn`` of ``torch.utils.checkpoint`` for a selective
    policy: save the named products' outputs, recompute everything else."""
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)

    saved = {getattr(torch.ops.aten, name).default
             for name in SAVED_PRODUCTS[policy]}

    def policy_fn(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return create_selective_checkpoint_contexts(policy_fn)


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
    moe: MoEConfig | None = None  # None = dense SwiGLU MLP

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
    """One decoder block; ``forward`` returns ``(x, moe_stats)``,
    ``moe_stats`` None for the dense MLP, else the MoE layer's ``(aux,
    dropped)``.  ``moe_kw`` picks the MoE layer's routing scope
    (:class:`~tpucfn_torch.models.moe.MoEMLP`)."""

    def __init__(self, cfg: LlamaConfig, attention_fn: AttentionFn,
                 decode: bool, device=None, tensor=None, **moe_kw):
        super().__init__()
        self.input_norm = RMSNorm(cfg.dim, cfg.norm_eps, cfg.dtype, device)
        self.attn = CausalSelfAttention(
            cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            rope_theta=cfg.rope_theta, max_seq=cfg.max_seq, dtype=cfg.dtype,
            param_dtype=cfg.param_dtype, attention_fn=attention_fn,
            decode=decode, device=device, tensor=tensor)
        self.post_attn_norm = RMSNorm(cfg.dim, cfg.norm_eps, cfg.dtype, device)
        if cfg.moe is not None:
            self.mlp = MoEMLP(cfg.dim, cfg.ffn_dim, cfg.moe, cfg.dtype,
                              cfg.param_dtype, device, tensor=tensor,
                              **moe_kw)
        else:
            self.mlp = SwiGLUMLP(cfg.dim, cfg.ffn_dim, cfg.dtype,
                                 cfg.param_dtype, device, tensor=tensor)

    def forward(self, x, *, q_offset=0, rope=None, kv_cache=None,
                cache_index=None, attention_fn=None):
        x = x + self.attn(self.input_norm(x), q_offset=q_offset, rope=rope,
                          kv_cache=kv_cache, cache_index=cache_index,
                          attention_fn=attention_fn)
        h = self.mlp(self.post_attn_norm(x))
        if isinstance(h, tuple):
            h, aux, dropped = h
            return x + h, (aux, dropped)
        return x + h, None


class Llama(nn.Module):
    """``attention_fn=None`` resolves as in the JAX package: outside decode,
    with the zero ``q_offset`` of the unsharded path, through the measured
    dense/flash policy
    (:func:`tpucfn_torch.kernels.auto.auto_attention_static_zero`: the
    flash kernels on the card unless the tune table measured dense
    faster for the shape's family);
    otherwise the plain dense op.

    ``moe_per_row``, ``moe_route_group`` and ``moe_expert_group`` set the
    MoE layers' routing scope (:class:`~tpucfn_torch.models.moe.MoEMLP`):
    the serving engine routes each row alone, as the JAX engine's
    per-slot ``vmap`` does; data parallelism routes over the group's
    global batch.

    ``tensor_mesh`` with a ``tensor`` axis of size T > 1: Megatron tensor
    parallelism as ``sharding_rules`` lays it out.  Each rank holds its
    block of the heads, the FFN rows and the vocabulary (the embedding's
    rows, looked up masked and summed over the axis; the LM head's rows,
    whose logits are gathered, or with
    :func:`chunked_causal_lm_loss` never gathered)."""

    def __init__(self, cfg: LlamaConfig, *, attention_fn: AttentionFn | None = None,
                 decode: bool = False, device=None, moe_per_row: bool = False,
                 moe_route_group=None, moe_expert_group=None,
                 tensor_mesh=None):
        from tpucfn_torch.parallel.tensor import tensor_split

        super().__init__()
        moe_kw = {} if cfg.moe is None else dict(
            per_row=moe_per_row, route_group=moe_route_group,
            expert_group=moe_expert_group)
        self.cfg = cfg
        self.decode = decode
        self.attention_fn = attention_fn
        self.tensor = tensor = tensor_split(tensor_mesh)
        vocab = cfg.vocab_size if tensor is None else tensor.local(
            cfg.vocab_size, "vocabulary rows")
        attention_fn = attention_fn or dot_product_attention
        self.embed_tokens = nn.Embedding(vocab, cfg.dim,
                                         dtype=cfg.param_dtype or cfg.dtype,
                                         device=device)
        self.layers = nn.ModuleList(
            LlamaBlock(cfg, attention_fn, decode, device, tensor, **moe_kw)
            for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.dim, cfg.norm_eps, cfg.dtype, device)
        self.lm_head = nn.Linear(cfg.dim, vocab, bias=False,
                                 dtype=torch.float32, device=device)
        self._rope_tables: dict = {}  # device -> (cos, sin), made once

    @classmethod
    def from_state_dict(cls, cfg: LlamaConfig, params: Mapping[str, torch.Tensor],
                        *, attention_fn: AttentionFn | None = None,
                        decode: bool = False, device=None,
                        trainable: bool = False, tensor_mesh=None,
                        **moe_kw) -> "Llama":
        """A model over ``params`` (the port's state dict).  Tensors already
        on ``device`` in their storage dtype are used as they are, not
        copied — several models (the engine's and ``generate``'s) can share
        one set of weights, and a training loss builds its model over the
        trainer's parameters in each call.  The weights are frozen unless
        ``trainable``; then ``nn.Parameter`` values stay the very objects
        passed, so their gradients land where the caller looks.
        ``moe_kw``: the MoE routing scope (see the class); ``params``
        hold this rank's blocks under ``tensor_mesh``."""
        with torch.device("meta"):
            model = cls(cfg, attention_fn=attention_fn, decode=decode,
                        tensor_mesh=tensor_mesh, **moe_kw)
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
        fits = (tokens >= -v) & (tokens < v)
        ids = tokens.remainder(v)
        if self.tensor is None:
            x = self.embed_tokens(ids)
        else:  # this rank's rows of the vocabulary, summed over the axis
            rows = self.embed_tokens.num_embeddings
            lo = self.tensor.index * rows
            mine = (ids >= lo) & (ids < lo + rows)
            x = self.embed_tokens((ids - lo).clamp(0, rows - 1))
            x = self.tensor.reduce_from(torch.where(mine[..., None], x, 0.0))
        return torch.where(fits[..., None], x, torch.nan)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """The fp32 LM head over final-norm hidden states (under tensor
        parallelism every rank's block, gathered)."""
        if self.tensor is None:
            return self.lm_head(hidden.float())
        return self.tensor.gather_from(
            self.lm_head(self.tensor.copy_to(hidden.float())), -1)

    def forward(self, tokens: torch.Tensor, *, q_offset=0,
                cache: DecodeCache | None = None,
                return_hidden: bool = False,
                segment_ids: torch.Tensor | None = None,
                return_aux: bool = False):
        """tokens: (B, S) int → logits (B, S, vocab) fp32, or with
        ``return_hidden`` the (B, S, dim) final-norm hidden states (pair
        with :func:`chunked_causal_lm_loss`).  ``return_aux`` returns
        ``(out, aux, dropped)``: the MoE layers' summed aux loss and mean
        dropped fraction (both 0.0 for the dense MLP).

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
        do_remat, policy = remat_policy(cfg.remat)
        remat = not self.decode and do_remat and torch.is_grad_enabled()
        remat_kw = {} if policy is None else {
            "context_fn": lambda: _selective_context(policy)}
        stats = []
        for i, layer in enumerate(self.layers):
            if self.decode:
                x, st = layer(x, rope=rope,
                              kv_cache=(cache.keys[i], cache.values[i]),
                              cache_index=cache.index)
            elif remat:
                x, st = checkpoint(layer, x, use_reentrant=False,
                                   q_offset=q_offset, rope=rope,
                                   attention_fn=attention_fn, **remat_kw)
            else:
                x, st = layer(x, q_offset=q_offset, rope=rope,
                              attention_fn=attention_fn)
            if st is not None:
                stats.append(st)
        if self.decode:
            cache.index.add_(tokens.shape[1])
        x = self.final_norm(x)
        out = x if return_hidden else self.logits(x)
        if not return_aux:
            return out
        if not stats:
            zero = torch.zeros((), dtype=torch.float32, device=x.device)
            return out, zero, zero
        return (out, torch.stack([a for a, _ in stats]).sum(),
                torch.stack([d for _, d in stats]).mean())


def init_llama_params(cfg: LlamaConfig, *, generator: torch.Generator,
                      device=None) -> dict[str, torch.Tensor]:
    """Random weights from a seeded generator, in the initializer families
    and scales of flax's defaults: the embedding ~ N(0, 1/dim); every
    dense kernel lecun-normal (a normal truncated at ±2σ, σ =
    sqrt(1/fan_in)/0.8796); norm scales one.  Returned in the port's
    storage dtypes (``cfg.param_dtype``).  A stacked expert weight (E,
    out, in) takes flax's fan_in of a 3-D kernel, in x E; the MoE router
    is dense.  (The numbers differ from JAX's; parity tests carry JAX's
    own weights across with :mod:`tpucfn_torch.models.convert`.)"""
    with torch.device("meta"):
        shapes = Llama(cfg).state_dict()
    params = {}
    for name, meta in shapes.items():
        w = torch.empty(meta.shape, dtype=torch.float32, device=device)
        if name.endswith(".scale"):
            w.fill_(1.0)
        elif name == "embed_tokens.weight":
            w.normal_(0.0, cfg.dim ** -0.5, generator=generator)
        elif len(meta.shape) == 3:  # stacked experts (E, out, in)
            lecun_normal_(w, meta.shape[0] * meta.shape[2], generator)
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
    leading layer entry.  The MoE rules come first, as in the JAX
    package: a stacked expert weight (E, out, in) puts its experts on the
    expert axis, and the router (E, D) its D on fsdp.  ``cfg`` is taken
    for the JAX signature."""
    from tpucfn_torch.mesh import AXIS_EXPERT, AXIS_FSDP, AXIS_TENSOR
    from tpucfn_torch.parallel.sharding import ShardingRules

    del cfg
    t = AXIS_TENSOR if tensor else None
    f = AXIS_FSDP if fsdp else None
    e = AXIS_EXPERT
    return ShardingRules((
        (r"experts\.(gate_proj|up_proj)\.weight$", (e, t, f)),
        (r"experts\.down_proj\.weight$", (e, f, t)),
        (r"router\.weight$", (None, f)),
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
    what ``cfg.remat`` recomputes in the backward (every block's forward
    under full remat; under ``"dots"`` the attention forward, K1, which no
    policy saves; under ``"dots_no_batch"`` also the MoE experts'
    products, which are batched), and, with ``chunked_head`` (the chunked
    CE, each chunk under a checkpoint), the recompute of the LM head.
    Attention counts the causal half of each (S, S) product, the work the flash
    kernels do.  A MoE layer counts its router product and its experts'
    three products over the ACTIVE rows, top_k per token, not over the
    capacity-padded E x C rows the ragged dispatch multiplies (nor the
    dense checker's one-hot einsums).  Norms, activations, the softmax,
    the dispatch and the optimizer are not counted."""
    hd, h, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    tokens = batch * seq_len
    mlp = experts = 3 * cfg.dim * cfg.ffn_dim
    if cfg.moe is not None:
        experts = cfg.moe.top_k * mlp
        mlp = cfg.dim * cfg.moe.n_experts + experts
    per_layer = 2 * cfg.dim * h * hd + 2 * cfg.dim * hkv * hd + mlp
    attention = cfg.n_layers * 4 * batch * h * hd * (
        seq_len * (seq_len + 1) // 2)
    blocks = cfg.n_layers * 2 * tokens * per_layer + attention
    head_rows = batch * (seq_len - 1) if chunked_head else tokens
    head = 2 * head_rows * cfg.dim * cfg.vocab_size
    do_remat, policy = remat_policy(cfg.remat)
    recompute = blocks if do_remat and policy is None else 0
    if policy is not None:
        recompute = attention
        if policy == "dots_no_batch" and cfg.moe is not None:
            recompute += cfg.n_layers * 2 * tokens * experts
    if chunked_head:
        recompute += head
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


def _targets(tokens: torch.Tensor,
             next_tokens: torch.Tensor | None) -> torch.Tensor:
    """What each position predicts: ``tokens[:, 1:]``, then
    ``next_tokens`` (the next block's first token) when given."""
    targets = tokens[:, 1:]
    if next_tokens is not None:
        targets = torch.cat([targets, next_tokens.to(targets.dtype)], 1)
    return targets.long()


def causal_lm_loss(logits: torch.Tensor, tokens: torch.Tensor, *,
                   z_loss: float = 0.0,
                   next_tokens: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Next-token cross entropy (mean over the predictions) + optional
    z-loss.  Over a whole sequence the predictions are B x (S-1).  On a
    block of a sequence split over the context axis, pass ``next_tokens``
    (B, 1), the next block's first token
    (:func:`tpucfn_torch.parallel.next_block_tokens`), on every block but
    the last: the block's last position predicts it, so a block makes B x
    S_loc predictions and the last block B x (S_loc - 1); the ranks' means
    weighted by those counts (:func:`causal_lm_loss_weight`) are the
    whole sequence's mean.

    Returns (loss, accuracy)."""
    targets = _targets(tokens, next_tokens)
    per_tok, hit = token_cross_entropy(
        logits[:, :targets.shape[1]].float(), targets, z_loss)
    return per_tok.mean(), hit.float().mean()


def causal_lm_loss_weight(mesh=None):
    """The trainer's ``loss_weight`` for :func:`causal_lm_loss` and
    :func:`chunked_causal_lm_loss` on this rank's batch: its prediction
    count, B x S_loc, or B x (S_loc - 1) on the context axis's last block
    (and without a split)."""
    from tpucfn_torch.parallel.sharding import context_block

    i, n = context_block(mesh)
    short = int(i == n - 1)

    def weight(batch: dict) -> torch.Tensor:
        b, s = batch["tokens"].shape[:2]
        return torch.tensor(b * (s - short))

    return weight


def chunked_causal_lm_loss(
    hidden: torch.Tensor,          # (B, S, D) — Llama(..., return_hidden=True)
    lm_head_weight: torch.Tensor,  # (V, D), the port's nn.Linear layout
    tokens: torch.Tensor,          # (B, S) int
    *,
    chunk_size: int = 512,
    z_loss: float = 0.0,
    next_tokens: torch.Tensor | None = None,
    tensor_mesh=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Next-token CE + accuracy without the (B, S, V) fp32 logits.

    Equal to ``causal_lm_loss(logits(hidden), tokens)`` up to fp32 sum
    order, ``next_tokens`` as there: a loop over sequence chunks computes
    each chunk's logits, reduces them to a CE sum and a hit count and
    drops them; each chunk runs under ``torch.utils.checkpoint``, so the
    backward recomputes its logits instead of keeping them.  Peak logits
    memory is (B, chunk, V).  Under ``tensor_mesh``'s tensor axis
    ``lm_head_weight`` is this rank's (V/T, D) rows, and each chunk's
    log-sum-exp, target logit and argmax span the axis
    (:func:`tpucfn_torch.parallel.tensor.vocab_parallel_cross_entropy`):
    (B, chunk, V/T) logits a rank, none gathered."""
    from tpucfn_torch.parallel.tensor import (tensor_split,
                                              vocab_parallel_cross_entropy)

    targets = _targets(tokens, next_tokens)
    b, n = targets.shape
    c = max(1, min(chunk_size, n))
    split = tensor_split(tensor_mesh)

    def chunk_sums(w, h_c, t_c):
        if split is None:
            per_tok, hit = token_cross_entropy(
                F.linear(h_c.float(), w.float()), t_c, z_loss)
        else:
            per_tok, hit = vocab_parallel_cross_entropy(
                F.linear(split.copy_to(h_c.float()), w.float()), t_c,
                z_loss, split)
        return per_tok.sum(), hit.float().sum()

    ce = correct = hidden.new_zeros((), dtype=torch.float32)
    pred = hidden[:, :n]
    for i in range(0, n, c):
        ce_c, cor_c = checkpoint(chunk_sums, lm_head_weight,
                                 pred[:, i:i + c], targets[:, i:i + c],
                                 use_reentrant=False)
        ce, correct = ce + ce_c, correct + cor_c
    return ce / (b * n), correct / (b * n)
