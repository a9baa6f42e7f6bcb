"""Data for the port's training path: synthetic tokens and sequence
packing."""

from tpucfn_torch.data.packing import (pack_sequences, packed_attention_fn,
                                       packed_causal_lm_loss)
from tpucfn_torch.data.synthetic import synthetic_tokens

__all__ = ["pack_sequences", "packed_attention_fn", "packed_causal_lm_loss",
           "synthetic_tokens"]
