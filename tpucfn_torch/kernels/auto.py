"""Attention dispatch for the serving engine (the port of
``serve_decode_attention_fn`` in ``tpucfn/kernels/auto.py``).

In the JAX package this returns dense XLA attention, because each
slot's cache index is a traced value and the Pallas grid takes static
offsets.  The CUDA forward kernel reads its offsets from memory, so here
every prefill and decode call of the engine runs it, with one query
offset per batch row.  The dense/flash training policy of the JAX
module (``should_use_flash*``, ``auto_attention_static_zero``) is not
ported: off a TPU and below its tuned thresholds it picks dense, so
with no H100 tune table the backward kernels would never run.  The
port's training model pins ``flash_attention`` instead
(``tpucfn_torch.train.llama_train_fns``).
"""

from __future__ import annotations


def serve_decode_attention_fn(cache_len: int):
    """Attention path for the engine's decode-mode model: the flash
    forward kernel's wrapper.  ``cache_len`` is accepted for the JAX
    signature; the kernel stops each row at its live prefix itself."""
    from tpucfn_torch.kernels.flash_attention import flash_attention

    del cache_len
    return flash_attention
