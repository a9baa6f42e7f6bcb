"""tpucfn_torch — the PyTorch/CUDA port of tpucfn for NVIDIA Hopper.

A package of its own beside ``tpucfn`` (the JAX reference, which it never
imports).  Ported so far: the serving path — ``serve.Server`` →
``serve.ServeEngine`` → ``models.llama.Llama`` in decode mode — with
attention in every prefill and decode call on a hand-written CUDA
flash-attention forward kernel (``kernels/csrc/flash_fwd.cu``).
"""
