"""Synthetic token data (a copy of ``synthetic_tokens`` from
``tpucfn/data/synthetic.py``, held equal to it by
``tests/test_torch_isolation.py``): learnable sequences for convergence
smoke runs and the training benchmark, made from a seed with numpy."""

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
