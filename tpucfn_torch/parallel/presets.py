"""Sharding-rule presets (the port of ``transformer_rules`` in
``tpucfn/parallel/presets.py``).

The JAX package's rules over the port's parameter names.  A JAX
``DenseGeneral`` kernel is (in, out) and an ``nn.Linear`` weight (out,
in), so each dense spec is the JAX one reversed, and ``/kernel`` is
``.weight``; an embedding is (vocab, dim) on both sides.  Convolutions
match no rule here, in either package: the UNet's replicate.  Placement
waits: the trainer refuses any rule that puts a parameter on a mesh axis
of size > 1 (ROADMAP C2), so with those axes at 1 these rules place
nothing.
"""

from __future__ import annotations

from tpucfn_torch.mesh import AXIS_EXPERT, AXIS_FSDP, AXIS_TENSOR
from tpucfn_torch.parallel.sharding import ShardingRules

_REPLICATED_TAIL = ((r".*", ()),)


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
