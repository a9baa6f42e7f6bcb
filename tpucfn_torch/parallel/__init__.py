"""Sharding rules, their presets and batch placement."""

from tpucfn_torch.parallel.sharding import (ShardingRules, batch_spec,
                                            context_block,
                                            make_partition_spec,
                                            next_block_tokens,
                                            placed_on_split_axes,
                                            shard_batch, spec_axes)
from tpucfn_torch.parallel.presets import dense_rules, transformer_rules

__all__ = ["ShardingRules", "batch_spec", "context_block", "dense_rules",
           "make_partition_spec", "next_block_tokens", "placed_on_split_axes",
           "shard_batch", "spec_axes", "transformer_rules"]
