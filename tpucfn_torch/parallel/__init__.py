"""Sharding rules, their presets and batch placement."""

from tpucfn_torch.parallel.sharding import (ShardingRules, batch_spec,
                                            make_partition_spec,
                                            placed_on_split_axes,
                                            shard_batch, spec_axes)
from tpucfn_torch.parallel.presets import transformer_rules

__all__ = ["ShardingRules", "batch_spec", "make_partition_spec",
           "placed_on_split_axes", "shard_batch", "spec_axes",
           "transformer_rules"]
