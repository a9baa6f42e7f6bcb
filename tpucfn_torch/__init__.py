"""tpucfn_torch — the PyTorch/CUDA port of tpucfn for NVIDIA Hopper.

A package of its own beside ``tpucfn`` (the JAX reference, which it never
imports).  Ported so far:

* the serving path — ``serve.Server`` → ``serve.ServeEngine`` →
  ``models.llama.Llama`` in decode mode — with attention in every prefill
  and decode call on the flash forward kernel (K1): its ``sm90`` variant
  (``kernels/csrc/flash_fwd_sm90.cu``, ``wgmma`` + TMA) for prefill and
  its ``decode`` variant (``flash_fwd_decode_sm90.cu``) for decode steps;
* the training harness — ``examples/llama3_8b_fsdp.py`` through
  ``examples/common.py:run_train_loop``: ``launch.initialize_runtime``
  (a process group from the launcher's env contract), ``mesh.build_mesh``,
  ``models.llama.sharding_rules``, ``train.Trainer`` (data parallel; fp32
  master weights, bf16 compute, remat, chunked CE), ``data.ShardedDataset``
  with ``prefetch_to_device``, ``ckpt.CheckpointManager`` with resume, and
  ``train.TrainerObs``.  Attention outside decode follows the measured
  dense/flash policy of ``kernels/auto.py``; on the card its flash path is
  K1 and the backward kernels Delta (``flash_bwd.cu``), K2
  (``flash_bwd_dq_sm90.cu``) and K3 (``flash_bwd_dkv_sm90.cu``) in bf16,
  and their ``mma`` variants (``flash_fwd_mma_sm90.cu``,
  ``flash_bwd_dq_mma_sm90.cu``, ``flash_bwd_dkv_mma_sm90.cu``) in fp32 and
  at odd GQA groups, behind ``torch.autograd.Function``s.

The old FMA kernels in ``flash_fwd.cu`` and ``flash_bwd.cu`` (K1, K2, K3)
are on no path; ``chip_smoke.py`` times them beside ``mma``.
"""
