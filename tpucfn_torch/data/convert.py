"""Tokenized text into packed record shards (a copy of
``convert_token_jsonl`` from ``tpucfn/data/convert.py``, held equal to it
by ``tests/test_torch_isolation.py``): the converter behind the Llama
example's ``--packed``.  The image and CIFAR converters are not ported.
"""

from __future__ import annotations

from tpucfn_torch.data.records import write_dataset_shards


def convert_token_jsonl(
    src: str | Path, out_dir: str | Path, *, seq_len: int,
    num_shards: int, prefix: str = "train", pad_id: int = 0,
) -> list[Path]:
    """Tokenized text corpus (jsonl, one ``{"tokens": [...]}`` object —
    or a bare list — per line) → packed tpurecord shards of
    ``{"tokens": (S,), "segments": (S,)}`` rows ready for
    :func:`tpucfn.data.packing.packed_attention_fn` /
    ``packed_causal_lm_loss``.  The text-corpus counterpart of the image
    converters (the reference's im2rec step never had a text story at
    all)."""
    import json

    import numpy as np

    from tpucfn_torch.data.packing import pack_sequences

    seqs = []
    with open(src) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            toks = obj["tokens"] if isinstance(obj, dict) else obj
            seqs.append(np.asarray(toks, np.int32))
    tokens, segments = pack_sequences(seqs, seq_len, pad_id=pad_id)

    def gen():
        for row, seg in zip(tokens, segments):
            yield {"tokens": row, "segments": seg}

    return write_dataset_shards(gen(), out_dir, num_shards=num_shards,
                                prefix=prefix)
