"""Carry a JAX package Llama's weights into the port.

``llama_state_dict_from_jax`` takes the flax ``params`` tree as plain
numpy arrays (nested mappings; no JAX import here) and returns the
port's state dict:

* the scanned layer stack (one leading ``layers`` axis on every
  per-layer leaf) splits into ``layers.{i}.…``; an unscanned tree
  (``layers_{i}``) maps one to one;
* ``DenseGeneral`` kernels are (in, out); ``nn.Linear`` weights are
  (out, in), so each is transposed;
* every tensor is cast to the port's storage dtype: matmul weights and
  the embedding in ``cfg.param_dtype`` (fp32 for training, so nothing is
  rounded) or, when that is None, the compute dtype (serving); norms and
  the LM head fp32.

The mapping is the same for any tree shaped like the params, so it also
carries a JAX gradient tree into the port's names (the tests compare
gradients tensor by tensor that way).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from tpucfn_torch.models.llama import Llama, LlamaConfig

_DENSE = ("attn.q_proj", "attn.k_proj", "attn.v_proj", "attn.o_proj",
          "mlp.gate_proj", "mlp.up_proj", "mlp.down_proj")
_NORMS = ("input_norm", "post_attn_norm")


def _get(tree: Mapping, dotted: str):
    for part in dotted.split("."):
        tree = tree[part]
    return np.asarray(tree)


def llama_state_dict_from_jax(params_np: Mapping,
                              cfg: LlamaConfig) -> dict[str, torch.Tensor]:
    scanned = "layers" in params_np
    out: dict[str, np.ndarray] = {
        "embed_tokens.weight": _get(params_np, "embed_tokens.embedding"),
        "final_norm.scale": _get(params_np, "final_norm.scale"),
        "lm_head.weight": _get(params_np, "lm_head.kernel").T,
    }
    for i in range(cfg.n_layers):
        def leaf(path, i=i):
            if scanned:
                return _get(params_np["layers"], path)[i]
            return _get(params_np[f"layers_{i}"], path)

        for name in _DENSE:
            out[f"layers.{i}.{name}.weight"] = leaf(f"{name}.kernel").T
        for name in _NORMS:
            out[f"layers.{i}.{name}.scale"] = leaf(f"{name}.scale")
    with torch.device("meta"):
        want = Llama(cfg).state_dict()
    if set(want) != set(out):
        raise ValueError(f"converted names differ from the port's: "
                         f"{sorted(set(want) ^ set(out))}")
    sd = {}
    for name, ref in want.items():
        arr = out[name]
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{name}: JAX shape {arr.shape} vs port "
                             f"{tuple(ref.shape)}")
        sd[name] = torch.from_numpy(
            np.array(arr, dtype=np.float32)).to(ref.dtype)
    return sd
