"""Carry the JAX package's weights into the port: Llama, the SD-1.5 UNet
and BERT.

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

``unet_params_from_flax`` and ``bert_params_from_flax`` map the UNet's and
BERT's trees leaf by leaf: the path joined with ``.`` (a flax name's own
``/``, as in ``self_attn/q_proj``, becomes ``.`` too), ``kernel`` ->
``weight`` with a dense kernel (in, out) transposed to (out, in) and a
convolution's (kh, kw, in, out) to (out, in, kh, kw), ``embedding`` ->
``weight``, ``bias`` and ``scale`` as they are; each in the port's
storage dtype.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from tpucfn_torch.models.bert import Bert, BertConfig
from tpucfn_torch.models.llama import Llama, LlamaConfig
from tpucfn_torch.models.unet import UNet, UNetConfig

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


def _leaves(tree: Mapping, prefix: str = ""):
    for key, sub in tree.items():
        name = prefix + key.replace("/", ".")
        if isinstance(sub, Mapping):
            yield from _leaves(sub, name + ".")
        else:
            yield name, np.asarray(sub)


def _port_layout(name: str, arr: np.ndarray) -> tuple[str, np.ndarray]:
    head, leaf = name.rsplit(".", 1)
    if leaf == "kernel":
        arr = arr.T if arr.ndim == 2 else arr.transpose(3, 2, 0, 1)
        return f"{head}.weight", arr
    if leaf == "embedding":
        return f"{head}.weight", arr
    return name, arr


def _from_flax(params_np: Mapping, model) -> dict[str, torch.Tensor]:
    out = dict(_port_layout(n, a) for n, a in _leaves(params_np))
    want = model.state_dict()
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


def unet_params_from_flax(params_np: Mapping,
                          cfg: UNetConfig) -> dict[str, torch.Tensor]:
    """The JAX package UNet's ``params`` (numpy leaves) as the port's
    state dict."""
    with torch.device("meta"):
        return _from_flax(params_np, UNet(cfg))


def bert_params_from_flax(params_np: Mapping,
                          cfg: BertConfig) -> dict[str, torch.Tensor]:
    """The JAX package BERT's ``params`` (numpy leaves) as the port's state
    dict."""
    with torch.device("meta"):
        return _from_flax(params_np, Bert(cfg))
