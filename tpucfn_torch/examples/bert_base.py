#!/usr/bin/env python
"""BERT-base MLM pretraining on the card (the port of
``examples/bert_base.py``).

    python tpucfn_torch/examples/bert_base.py --seq-len 128 \\
        --batch-size 32 --steps 10
    python tpucfn_torch/examples/bert_base.py --device cpu --tiny \\
        --seq-len 16 --batch-size 8 --steps 30

The JAX example's chain: synthetic token shards, masking applied on the
fly each step (``--mask-prob`` of the positions, 80% of them replaced by
``MASK_ID``, 10% by a random token, 10% kept, all drawn from the
trainer's generator), BERT-base (``--tiny``: the tests' config) with
dropout drawn from the same generator, AdamW over a warmup-cosine
schedule to 1e-4 with weight decay 0.01, ``transformer_rules`` and
``run_train_loop``.  Attention is masked, so it runs dense, as in the JAX
package: no flash kernel runs on this path.

Data parallel over the ranks; ``--fsdp`` > 1 and ``--tensor`` > 1 are
refused (ROADMAP Queue 1 C2b).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

# Runnable from a bare checkout: put the repo root ahead on sys.path.
_REPO_ROOT = str(Path(__file__).resolve().parent.parent.parent)
if _REPO_ROOT not in sys.path:
    sys.path.insert(0, _REPO_ROOT)

from tpucfn_torch.examples.common import (  # noqa: E402
    add_cluster_args,
    exit_process,
    per_process_batch,
    refuse_sharded_parameters,
    refuse_unported_planes,
    run_train_loop,
    stage_synthetic,
)

MASK_ID = 3


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_cluster_args(p)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--num-examples", type=int, default=512)
    p.add_argument("--mask-prob", type=float, default=0.15)
    p.add_argument("--tiny", action="store_true", help="tiny config (CI)")
    return p


def mask_tokens(tokens, generator, mask_prob: float, vocab: int):
    """(masked tokens, mask): ``mask_prob`` of the positions chosen, 80% of
    them set to ``MASK_ID``, 10% to a random token, 10% kept."""
    import torch

    u = lambda: torch.rand(tokens.shape, generator=generator,  # noqa: E731
                           device=tokens.device)
    mask = u() < mask_prob
    swap = u()
    randoms = torch.randint(0, vocab, tokens.shape, generator=generator,
                            device=tokens.device, dtype=tokens.dtype)
    masked = torch.where(mask & (swap < 0.8), MASK_ID, tokens)
    masked = torch.where(mask & (swap >= 0.8) & (swap < 0.9), randoms, masked)
    return masked, mask


def make_fns(cfg, mask_prob: float):
    """(init_fn, loss_fn) of the example: BERT's random weights from the
    trainer's generator, and the MLM loss of a freshly masked batch over a
    model built on the trainer's parameters in each call; aux is
    ``{"accuracy": ...}``."""
    from tpucfn_torch.models.bert import Bert, init_bert_params, mlm_loss

    def init_fn(generator):
        return init_bert_params(cfg, generator=generator,
                                device=generator.device), {}

    def loss_fn(params, mstate, batch, generator):
        tokens = batch["tokens"].long()
        masked, mask = mask_tokens(tokens, generator, mask_prob,
                                   cfg.vocab_size)
        model = Bert.from_state_dict(cfg, params, trainable=True)
        logits = model(masked, train=True, generator=generator)
        loss, acc = mlm_loss(logits, tokens, mask)
        return loss, ({"accuracy": acc}, mstate)

    return init_fn, loss_fn


def example_tx(total: int):
    """AdamW over a warmup-cosine schedule to 1e-4, weight decay 0.01,
    for a budget of ``total`` steps."""
    from tpucfn_torch.train import adamw, warmup_cosine_decay_schedule

    return adamw(warmup_cosine_decay_schedule(
        0.0, 1e-4, max(1, min(100, total // 10)), total), weight_decay=0.01)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    refuse_sharded_parameters(args)
    refuse_unported_planes(args)

    from tpucfn_torch.device import resolve_device
    from tpucfn_torch.launch import initialize_runtime, process_count

    device = resolve_device(args.device)
    initialize_runtime(device=device)

    from tpucfn_torch.data import ShardedDataset
    from tpucfn_torch.mesh import MeshSpec, build_mesh
    from tpucfn_torch.models.bert import BertConfig
    from tpucfn_torch.parallel import transformer_rules
    from tpucfn_torch.train import Trainer

    cfg = BertConfig.tiny() if args.tiny else BertConfig.base()
    shards = stage_synthetic(
        "tokens", Path(args.run_dir) / "data", n=args.num_examples,
        num_shards=max(8, process_count()), seed=args.seed,
        seq_len=args.seq_len, vocab=cfg.vocab_size)
    mesh = build_mesh(MeshSpec.for_devices(
        process_count(), fsdp=args.fsdp, tensor=args.tensor),
        device_type=device.type)
    init_fn, loss_fn = make_fns(cfg, args.mask_prob)
    trainer = Trainer(mesh, transformer_rules(tensor=args.tensor > 1),
                      loss_fn, example_tx(args.steps or 1000), init_fn,
                      device=device)
    ds = ShardedDataset(shards, batch_size_per_process=per_process_batch(args),
                        seed=args.seed)
    run_train_loop(trainer, ds, mesh, args, items_per_step=args.batch_size)
    return 0


if __name__ == "__main__":
    exit_process(main())
