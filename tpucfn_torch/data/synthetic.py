"""Synthetic data (copies of ``synthetic_tokens`` and
``synthetic_latents`` from ``tpucfn/data/synthetic.py``, held equal to
them by ``tests/test_torch_isolation.py``): learnable token sequences for
convergence smoke runs and the training benchmark, and SD-shaped
latent/context pairs for the UNet, made from a seed with numpy."""

from __future__ import annotations

from typing import Iterator

import numpy as np


def synthetic_tokens(
    n: int = 512, seq_len: int = 128, vocab: int = 32000, seed: int = 0
) -> Iterator[dict[str, np.ndarray]]:
    """Learnable token sequences: affine next-token recurrence
    t[i+1] = (a·t[i] + b) mod vocab, so a causal LM can actually drive
    next-token loss toward zero (distinguishes learning from plumbing)."""
    rs = np.random.RandomState(seed)
    a, b = 31, 17
    for _ in range(n):
        t0 = int(rs.randint(vocab))
        seq = np.empty(seq_len, np.int32)
        seq[0] = t0
        for i in range(1, seq_len):
            seq[i] = (a * int(seq[i - 1]) + b) % vocab
        yield {"tokens": seq}


def synthetic_latents(
    n: int = 256, hw: int = 32, ctx_len: int = 77, ctx_dim: int = 768, seed: int = 0
) -> Iterator[dict[str, np.ndarray]]:
    """SD-shaped latent/text-context pairs for diffusion finetune smoke."""
    rs = np.random.RandomState(seed)
    for _ in range(n):
        yield {
            "latents": rs.randn(hw, hw, 4).astype(np.float32),
            "context": rs.randn(ctx_len, ctx_dim).astype(np.float32),
        }
