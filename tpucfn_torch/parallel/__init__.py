"""Sharding rules and batch placement."""

from tpucfn_torch.parallel.sharding import (ShardingRules, batch_spec,
                                            make_partition_spec,
                                            placed_on_split_axes,
                                            shard_batch, spec_axes)

__all__ = ["ShardingRules", "batch_spec", "make_partition_spec",
           "placed_on_split_axes", "shard_batch", "spec_axes"]
