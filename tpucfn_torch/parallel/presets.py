"""Sharding-rule presets (the port of ``tpucfn/parallel/presets.py``:
``dense_rules``, ``transformer_rules``, ``zero1_rules`` and ``PRESETS``).

The JAX package's rules over the port's parameter names.  A JAX
``DenseGeneral`` kernel is (in, out) and an ``nn.Linear`` weight (out,
in), so each dense spec is the JAX one reversed, and ``/kernel`` is
``.weight``; an embedding is (vocab, dim) on both sides.  A convolution's
kernel is (kh, kw, in, out) there and (out, in, kh, kw) here.  The UNet's
convolutions match no rule, in either package: they replicate.  The
port's optimizer state is named ``opt/<i>/exp_avg/<name>``,
``opt/<i>/exp_avg_sq/<name>`` and ``opt/<i>/momentum_buffer/<name>``
(:mod:`tpucfn_torch.train.optim`) where optax's is ``mu``/``nu``/
``trace``, so :func:`zero1_rules` scopes the model rules to those names.
"""

from __future__ import annotations

from tpucfn_torch.mesh import AXIS_EXPERT, AXIS_FSDP, AXIS_TENSOR
from tpucfn_torch.parallel.sharding import ShardingRules

_REPLICATED_TAIL = ((r".*", ()),)


def dense_rules(fsdp: bool = False) -> ShardingRules:
    """Rules for conv/dense vision models (the ResNet family).  Pure data
    parallelism replicates everything; with ``fsdp=True`` each conv
    kernel's out-channels and the head's out-features shard over the fsdp
    axis (the JAX rules' dims, in the port's layouts)."""
    if not fsdp:
        return ShardingRules(_REPLICATED_TAIL)
    return ShardingRules(
        (
            (r"conv.*\.weight$", (AXIS_FSDP, None, None, None)),
            (r"(dense|head|fc).*\.weight$", (AXIS_FSDP, None)),
        )
        + _REPLICATED_TAIL
    )


def transformer_rules(fsdp: bool = True, tensor: bool = True,
                      expert: bool = True) -> ShardingRules:
    """Megatron-style TP composed with FSDP for transformer families
    (BERT, Llama, and the UNet's attention blocks): column-parallel
    q/k/v and up projections (out-features over ``tensor``), row-parallel
    o and down projections (in-features over ``tensor``), FSDP on the
    other dim; the embedding's vocab over ``tensor``.  A stacked expert
    weight is (experts, out, in) here."""
    t = AXIS_TENSOR if tensor else None
    f = AXIS_FSDP if fsdp else None
    e = AXIS_EXPERT if expert else None
    return ShardingRules(
        (
            (r"experts\..*(up|gate)_proj\.weight$", (e, t, f)),
            (r"experts\..*down_proj\.weight$", (e, f, t)),
            (r"router\.weight$", (None, f)),
            (r"(qkv|q_proj|k_proj|v_proj)\.weight$", (t, f)),
            (r"o_proj\.weight$", (f, t)),
            (r"(up_proj|gate_proj|fc1|wi(_\d+)?)\.weight$", (t, f)),
            (r"(down_proj|fc2|wo)\.weight$", (f, t)),
            (r"(embedding|embed_tokens)\.weight$", (t, f)),
            (r"(lm_head|unembed)\.weight$", (t, f)),
            (r"(qkv|q_proj|k_proj|v_proj|up_proj|gate_proj|fc1|wi(_\d+)?)"
             r"\.bias$", (t,)),
        )
        + _REPLICATED_TAIL
    )


# The port's names of the optimizer moments (optax's mu / nu / trace).
_MOMENTS = r"(^|/)(exp_avg|exp_avg_sq|momentum_buffer)/.*"


def zero1_rules(model_rules: ShardingRules | None = None) -> ShardingRules:
    """ZeRO-1: replicated parameters, optimizer moments split over
    ``fsdp``.  Each split rule of ``model_rules`` (default: the fsdp dense
    preset) is re-scoped to the moments' names; a parameter's own name
    falls through to the replicated tail.  The forward and backward see
    whole parameters (no per-layer gathers, unlike FSDP), and each rank
    updates its block of every parameter, then gathers the others'."""
    model_rules = model_rules or dense_rules(fsdp=True)
    opt_scoped = tuple(
        ((_MOMENTS + pat.lstrip("^")), spec)
        for pat, spec in model_rules.rules
        if tuple(spec) != ()
    )
    return ShardingRules(opt_scoped + _REPLICATED_TAIL)


PRESETS = {
    "dp": lambda: dense_rules(fsdp=False),
    "fsdp_dense": lambda: dense_rules(fsdp=True),
    "zero1": lambda: zero1_rules(),
    "transformer": lambda: transformer_rules(),
    "transformer_tp_only": lambda: transformer_rules(fsdp=False),
    "transformer_fsdp_only": lambda: transformer_rules(tensor=False),
}
