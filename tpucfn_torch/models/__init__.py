"""The models: the Llama decoder (its weight converter and generation),
the SD-1.5 UNet and BERT, under the JAX package's names."""

from tpucfn_torch.models.bert import Bert, BertConfig, mlm_loss  # noqa: F401
from tpucfn_torch.models.llama import (Llama, LlamaConfig,  # noqa: F401
                                       causal_lm_loss)
from tpucfn_torch.models.unet import UNet, UNetConfig, ddpm_loss  # noqa: F401
