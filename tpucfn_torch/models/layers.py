"""Shared transformer building blocks (the port of
``tpucfn/models/layers.py``).

Module and parameter names follow the JAX package (q_proj/k_proj/v_proj/
o_proj, gate_proj/up_proj/down_proj, ``scale`` of the norms), so the
weight converter (:mod:`tpucfn_torch.models.convert`) maps name to name.

Mixed precision as in the JAX package (flax ``dtype``/``param_dtype``):
activations in the compute dtype (bf16 for the Llama presets), norms and
RoPE in fp32.  Matmul weights are stored in ``param_dtype`` and cast to
the compute dtype in each call.  Training stores them in fp32 (master
weights, fp32 gradients); serving stores them in the compute dtype, where
the cast is a no-op — the same rounding, done once at load.

Tensor parallelism (``tensor``, a :class:`~tpucfn_torch.parallel.TensorSplit`):
the attention holds ``n_heads / T`` query heads and ``n_kv_heads / T`` KV
heads of the rank, its q/k/v products column-parallel and its o product
row-parallel, and the MLP ``ffn_dim / T`` rows the same way, so each
layer ends in one sum over the axis.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from tpucfn_torch.ops.attention import dot_product_attention


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(dim, dtype=torch.float32,
                                             device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        norm = x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + self.eps)
        return (norm * self.scale).to(self.dtype)


class LayerNorm(nn.Module):
    """flax ``LayerNorm(epsilon=eps, dtype=float32)``: over the last axis,
    in fp32, with a ``scale`` and a ``bias`` (BERT, the UNet)."""

    def __init__(self, dim: int, param_dtype: torch.dtype = torch.float32,
                 eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, dtype=param_dtype,
                                             device=device))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=param_dtype,
                                             device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), x.shape[-1:], self.scale.float(),
                            self.bias.float(), self.eps)


def rope_frequencies(dim: int, max_pos: int, theta: float,
                     device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Precompute RoPE cos/sin tables: (max_pos, dim//2), fp32."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=device) / dim))
    t = torch.arange(max_pos, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) or (S,) global token positions.
    The half-split (NeoX) form: the first and second halves of D rotate
    as pairs."""
    c = cos[positions]  # (..., S, D/2)
    s = sin[positions]
    if c.ndim == 2:  # (S, D/2) -> broadcast batch
        c, s = c[None], s[None]
    c, s = c[:, :, None, :], s[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


# attention_fn(q, k, v, causal=..., q_offset=..., k_offset=...) -> out
AttentionFn = Callable[..., torch.Tensor]


class Dense(nn.Linear):
    """A linear layer, bias-free unless ``bias``, whose weight (and bias)
    is stored in ``param_dtype`` and used in the compute ``dtype`` (flax
    ``DenseGeneral(dtype=..., param_dtype=..., use_bias=...)``)."""

    def __init__(self, n_in: int, n_out: int, dtype: torch.dtype,
                 param_dtype: torch.dtype | None = None, device=None, *,
                 bias: bool = False):
        super().__init__(n_in, n_out, bias=bias, dtype=param_dtype or dtype,
                         device=device)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt),
                        None if self.bias is None else self.bias.to(dt))


def _caller(model: nn.Module, owner: str) -> str:
    """The module whose call uses ``owner``'s parameters: ``owner`` itself,
    or, for a holder with no forward of its own (stacked expert weights),
    its nearest ancestor that has one."""
    while owner and type(model.get_submodule(owner)).forward \
            is nn.Module.forward:
        owner = owner.rpartition(".")[0]
    return owner


def _bind_gathered(model: nn.Module, params, names, device) -> None:
    """Binds each of ``names`` as its block (``params.local``), gathered
    each time the module that uses it runs: a pre-hook puts the gathered
    tensor in the parameter's place, a post-hook puts the block back.
    The gather sits inside the module's call, so a checkpointed block
    re-gathers in its recompute."""
    callers: dict = {}
    for name in names:
        owner, _, leaf = name.rpartition(".")
        module = model.get_submodule(owner)
        block = params.local[name].to(device=device)
        want = module._parameters[leaf].shape
        module._parameters[leaf] = block
        callers.setdefault(_caller(model, owner), []).append(
            (module, leaf, block, params.gather(name), want))

    def gather(mod, args, entries):
        for module, leaf, block, fn, want in entries:
            full = fn(block)
            if full.shape != want:
                raise ValueError(
                    f"{type(module).__name__}.{leaf}: the gathered "
                    f"parameter is {tuple(full.shape)}, the model takes "
                    f"{tuple(want)}")
            module._parameters[leaf] = full

    def restore(mod, args, out, entries):
        for module, leaf, block, _, _ in entries:
            module._parameters[leaf] = block

    for caller, entries in callers.items():
        module = model.get_submodule(caller)
        module.register_forward_pre_hook(
            lambda mod, args, e=entries: gather(mod, args, e))
        module.register_forward_hook(
            lambda mod, args, out, e=entries: restore(mod, args, out, e))


def bind_state_dict(model: nn.Module, params, *, device=None,
                    trainable: bool = False) -> nn.Module:
    """``model`` (built on the meta device) over ``params``, its state
    dict: tensors already on ``device`` in their storage dtype are used
    as they are, not copied, so several models can share one set of
    weights and a training loss can build its model over the trainer's
    parameters in each call.  Frozen unless ``trainable``: the model then
    holds detached views of the tensors (their storage, not their
    objects), so freezing it leaves the caller's ``requires_grad`` flags
    as they were.  With ``trainable``, ``nn.Parameter`` values stay the
    very objects passed, so their gradients land where the caller looks,
    and a tensor computed from other tensors (a LoRA-merged weight) is
    bound as it is, so the gradient flows on into what it was computed
    from.  ``params`` a :class:`tpucfn_torch.parallel.ShardedParams`
    (trainable): a parameter with storage splits is bound as its block
    and gathered at each call of its module."""
    from tpucfn_torch.parallel.sharding import ShardedParams

    want = model.state_dict()
    gathered = []
    if isinstance(params, ShardedParams):
        if not trainable:
            raise ValueError("sharded parameters bind for training only")
        gathered = [n for n in want if params.gather(n) is not None]
    given = {name: params[name].to(device=device, dtype=want[name].dtype)
             for name in want if name not in gathered}
    if gathered:
        _bind_gathered(model, params, gathered, device)
    if not trainable:
        given = {name: t.detach() for name, t in given.items()}
    missing = model.load_state_dict(given, strict=not gathered,
                                    assign=True).missing_keys
    if set(missing) != set(gathered):
        raise KeyError(f"parameters not bound: "
                       f"{sorted(set(missing) - set(gathered))}")
    if not trainable:
        return model.requires_grad_(False)
    for name, t in given.items():
        if t.grad_fn is not None:
            owner, _, leaf = name.rpartition(".")
            model.get_submodule(owner)._parameters[leaf] = t
    return model


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> torch.Tensor:
    """flax's default kernel init in place: a normal truncated at ±2σ,
    σ = sqrt(1/fan_in)/0.8796 (the truncation's variance correction)."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                 generator=generator)


class CausalSelfAttention(nn.Module):
    """GQA self-attention with RoPE; the attention inner op is pluggable.

    ``decode=True`` turns on the autoregressive KV cache: each call writes
    this step's K/V into the caller's cache tensors at each row's
    ``cache_index`` (in place) and attends over the whole prefix.  The
    caller advances the index.  The RoPE tables span ``max_seq``.

    ``tensor``: this rank holds ``n_heads / T`` query heads and ``n_kv_heads
    / T`` KV heads (the rank's contiguous block of each, so its query
    heads' KV heads are its own) and returns its partial sum of the
    output projection, summed over the axis."""

    def __init__(self, dim: int, n_heads: int, n_kv_heads: int, head_dim: int,
                 *, rope_theta: float = 500000.0, max_seq: int = 8192,
                 dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype | None = None,
                 attention_fn: AttentionFn = dot_product_attention,
                 decode: bool = False, device=None, tensor=None):
        super().__init__()
        self.tensor = tensor
        if tensor is not None:
            if decode:
                raise ValueError("decode mode runs unsplit heads")
            n_heads = tensor.local(n_heads, "query heads")
            n_kv_heads = tensor.local(n_kv_heads, "KV heads")
        self.n_heads, self.n_kv_heads, self.head_dim = n_heads, n_kv_heads, head_dim
        self.rope_theta, self.max_seq, self.dtype = rope_theta, max_seq, dtype
        self.attention_fn = attention_fn
        self.decode = decode
        self.q_proj = Dense(dim, n_heads * head_dim, dtype, param_dtype, device)
        self.k_proj = Dense(dim, n_kv_heads * head_dim, dtype, param_dtype,
                            device)
        self.v_proj = Dense(dim, n_kv_heads * head_dim, dtype, param_dtype,
                            device)
        self.o_proj = Dense(n_heads * head_dim, dim, dtype, param_dtype, device)

    def forward(self, x: torch.Tensor, *, positions=None, q_offset=0,
                rope=None, kv_cache=None, cache_index=None,
                attention_fn: AttentionFn | None = None) -> torch.Tensor:
        """``rope``: precomputed (cos, sin) tables (computed here when
        None).  Decode mode needs ``kv_cache`` = (keys, values), each
        (B, capacity, Hkv, D), and ``cache_index`` (B,) int32.
        ``attention_fn`` overrides the module's for this call (the packed
        path's segment-masked op)."""
        attention_fn = attention_fn or self.attention_fn
        b, s, _ = x.shape
        if self.tensor is not None:
            x = self.tensor.copy_to(x)
        q = self.q_proj(x).reshape(b, s, self.n_heads, self.head_dim)
        k = self.k_proj(x).reshape(b, s, self.n_kv_heads, self.head_dim)
        v = self.v_proj(x).reshape(b, s, self.n_kv_heads, self.head_dim)
        cos, sin = rope if rope is not None else rope_frequencies(
            self.head_dim, self.max_seq, self.rope_theta, device=x.device)

        if self.decode:
            if positions is not None:
                raise ValueError(
                    "decode mode derives positions from the KV cache index; "
                    "explicit positions are not supported together with decode"
                )
            keys, values = kv_cache
            i = cache_index.long()
            steps = torch.arange(s, device=x.device)
            # Out-of-range positions clamp, as JAX's gather does; those
            # rows are poisoned below.
            pos = (i[:, None] + steps).clamp(0, self.max_seq - 1)
            q = apply_rope(q, cos, sin, pos)
            k = apply_rope(k, cos, sin, pos)
            # The write clamps so it fits, as dynamic_update_slice does.
            start = i.clamp(0, keys.shape[1] - s)
            rows = torch.arange(b, device=x.device)[:, None]
            cols = start[:, None] + steps
            keys[rows, cols] = k.to(keys.dtype)
            values[rows, cols] = v.to(values.dtype)
            # q lives at global positions [i, i+s); cache slots beyond are
            # dead and masked out by causality.
            out = attention_fn(q, keys, values, causal=True,
                               q_offset=cache_index, k_offset=0)
            # Past-capacity decoding would silently clamp the RoPE gather
            # and the cache write; poison the output instead so overflow is
            # loud (NaNs) rather than quietly wrong.
            fits = (i + s <= self.max_seq)[:, None, None, None]
            out = torch.where(fits, out, torch.nan)
        else:
            if positions is None:
                positions = torch.arange(s, device=x.device) + q_offset
            q = apply_rope(q, cos, sin, positions)
            k = apply_rope(k, cos, sin, positions)
            out = attention_fn(q, k, v, causal=True,
                               q_offset=q_offset, k_offset=q_offset)
        out = out.reshape(b, s, self.n_heads * self.head_dim)
        if self.tensor is not None:
            return self.tensor.reduce_from(self.o_proj(out))
        return self.o_proj(out)


class SwiGLUMLP(nn.Module):
    """``tensor``: this rank's ``ffn_dim / T`` rows of gate/up (column
    parallel) and columns of down (row parallel), the partial sums summed
    over the axis."""

    def __init__(self, dim: int, ffn_dim: int,
                 dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype | None = None, device=None,
                 tensor=None):
        super().__init__()
        self.tensor = tensor
        if tensor is not None:
            ffn_dim = tensor.local(ffn_dim, "FFN rows")
        self.gate_proj = Dense(dim, ffn_dim, dtype, param_dtype, device)
        self.up_proj = Dense(dim, ffn_dim, dtype, param_dtype, device)
        self.down_proj = Dense(ffn_dim, dim, dtype, param_dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tensor is None:
            return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))
        x = self.tensor.copy_to(x)
        return self.tensor.reduce_from(
            self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x)))
