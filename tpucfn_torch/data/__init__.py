"""Data for the port's training path: record shards, the sharded
dataset with device prefetch, synthetic tokens and latents, and sequence
packing."""

from tpucfn_torch.data.convert import convert_token_jsonl
from tpucfn_torch.data.packing import (pack_sequences, packed_attention_fn,
                                       packed_causal_lm_loss,
                                       packed_loss_weight)
from tpucfn_torch.data.pipeline import ShardedDataset, prefetch_to_device
from tpucfn_torch.data.records import (RecordShardWriter, read_record_shard,
                                       write_dataset_shards)
from tpucfn_torch.data.synthetic import synthetic_latents, synthetic_tokens

__all__ = ["RecordShardWriter", "ShardedDataset", "convert_token_jsonl",
           "pack_sequences", "packed_attention_fn", "packed_causal_lm_loss",
           "packed_loss_weight", "prefetch_to_device", "read_record_shard", "synthetic_latents",
           "synthetic_tokens",
           "write_dataset_shards"]
