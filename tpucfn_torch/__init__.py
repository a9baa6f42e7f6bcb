"""tpucfn_torch — the PyTorch/CUDA port of tpucfn for NVIDIA Hopper.

A package of its own beside ``tpucfn`` (the JAX reference, which it never
imports).  Ported so far:

* the serving path — ``serve.Server`` → ``serve.ServeEngine`` →
  ``models.llama.Llama`` in decode mode — with attention in every prefill
  and decode call on a hand-written CUDA flash-attention forward kernel
  (``kernels/csrc/flash_fwd.cu``);
* the training step on one device — ``train.Trainer`` → ``Llama`` (fp32
  master weights, bf16 compute, remat, chunked CE) — with attention on
  that forward kernel and the hand-written CUDA backward kernels
  (``kernels/csrc/flash_bwd.cu``) behind a ``torch.autograd.Function``.
"""
