"""Sharding rules, their presets, their placement and batch placement."""

from tpucfn_torch.parallel.sharding import (COMPUTE_AXES, NamedSharding,
                                            ShardedParams, ShardingRules,
                                            batch_spec, context_block,
                                            make_partition_spec,
                                            named_sharding_tree,
                                            next_block_tokens, shard_batch,
                                            spec_axes)
from tpucfn_torch.parallel.presets import (PRESETS, dense_rules,
                                           transformer_rules, zero1_rules)
from tpucfn_torch.parallel.tensor import TensorSplit, tensor_split

__all__ = ["COMPUTE_AXES", "NamedSharding", "PRESETS", "ShardedParams",
           "ShardingRules", "TensorSplit", "batch_spec", "context_block",
           "dense_rules", "make_partition_spec", "named_sharding_tree",
           "next_block_tokens", "shard_batch",
           "spec_axes", "tensor_split", "transformer_rules", "zero1_rules"]
