#!/usr/bin/env python
"""Llama-3 pretraining on the card (the port of
``examples/llama3_8b_fsdp.py``).

    python tpucfn_torch/examples/llama3_8b_fsdp.py --model 1b \\
        --seq-len 2048 --batch-size 2 --steps 6
    tpucfn launch -- python tpucfn_torch/examples/llama3_8b_fsdp.py ...
    python tpucfn_torch/examples/llama3_8b_fsdp.py --device cpu \\
        --model tiny --seq-len 64 --batch-size 8 --steps 6

The JAX example's chain: :func:`tpucfn_torch.launch.initialize_runtime`
(a process group when the launcher's env contract is present), synthetic
token shards (or, with ``--packed``, a synthesized corpus through
``convert_token_jsonl``), the six-axis mesh, ``sharding_rules``, the
``Trainer`` with its optimizer chain (global-norm clip 1.0, AdamW b2 0.95
and weight decay 0.1 over a warmup-cosine schedule to 3e-4), the
``ShardedDataset``, and ``run_train_loop``: checkpoints in
``--run-dir``, resumed on relaunch.  Attention is the model's default,
the measured dense/flash policy of :mod:`tpucfn_torch.kernels.auto`.

Data parallel over the ranks.  Not ported yet, and refused with the
ROADMAP item named: ``--fsdp`` > 1 and ``--tensor`` > 1 (C2),
``--context`` > 1 and ``--ring-flash`` (C3), ``--moe-experts`` (C4),
``--pipeline`` > 1 (C5) and ``--lora-rank`` (C7).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

# Runnable from a bare checkout: put the repo root ahead on sys.path.
_REPO_ROOT = str(Path(__file__).resolve().parent.parent.parent)
if _REPO_ROOT not in sys.path:
    sys.path.insert(0, _REPO_ROOT)

from tpucfn_torch.examples.common import (  # noqa: E402
    add_cluster_args,
    per_process_batch,
    refuse_sharded_parameters,
    refuse_unported_planes,
    run_train_loop,
    stage_synthetic,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_cluster_args(p)
    p.add_argument("--model", default="tiny", choices=["8b", "1b", "tiny"])
    p.add_argument("--layers", type=int, default=0,
                   help="override n_layers (0 = the model preset's depth)")
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--context", type=int, default=1,
                   help="context (sequence-parallel) axis size; refused > 1")
    p.add_argument("--ring-flash", action="store_true", help="refused")
    p.add_argument("--pipeline", type=int, default=1,
                   help="pipeline stages; refused > 1")
    p.add_argument("--moe-experts", type=int, default=0, help="refused > 0")
    p.add_argument("--expert", type=int, default=1,
                   help="expert mesh axis size (a batch axis for dense models)")
    p.add_argument("--num-examples", type=int, default=256)
    p.add_argument("--z-loss", type=float, default=1e-4)
    p.add_argument("--packed", action="store_true",
                   help="packed-sequence training: variable-length "
                        "documents packed into full (S,) rows with "
                        "segment-masked attention and boundary-safe loss "
                        "(this example synthesizes a corpus)")
    p.add_argument("--lora-rank", type=int, default=0, help="refused > 0")
    p.add_argument("--ce-chunk", type=int, default=512,
                   help="compute the LM-head CE over sequence chunks of "
                        "this size so the fp32 (B,S,vocab) logits are never "
                        "materialized; 0 materializes logits")
    return p


def refuse_unported_options(args) -> None:
    """Exit non-zero, naming the ROADMAP item, for options the port does
    not have."""
    refuse_sharded_parameters(args)
    refused = (
        (args.context > 1, "--context > 1 (ring attention)", "C3"),
        (args.ring_flash, "--ring-flash (ring attention)", "C3"),
        (args.moe_experts > 0, "--moe-experts (MoE)", "C4"),
        (args.pipeline > 1, "--pipeline > 1 (pipeline parallelism)", "C5"),
        (args.lora_rank > 0, "--lora-rank (LoRA)", "C7"),
    )
    for asked, what, item in refused:
        if asked:
            raise SystemExit(f"{what} is not ported to tpucfn_torch yet "
                             f"(ROADMAP Queue 1 {item})")


def model_config(args):
    import torch

    from tpucfn_torch.models.llama import LlamaConfig

    cfg = {"8b": LlamaConfig.llama3_8b, "1b": LlamaConfig.llama3_1b,
           "tiny": LlamaConfig.tiny}[args.model]()
    # fp32 master weights, as the JAX package's param_dtype default.
    cfg = dataclasses.replace(cfg, param_dtype=torch.float32)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    return cfg


def example_chain(total: int):
    """The optimizer chain of the example, over a budget of ``total``
    steps."""
    from tpucfn_torch.train import (adamw, chain, clip_by_global_norm,
                                    warmup_cosine_decay_schedule)

    return chain(clip_by_global_norm(1.0), adamw(
        warmup_cosine_decay_schedule(0.0, 3e-4, max(1, min(100, total // 10)),
                                     total),
        b1=0.9, b2=0.95, weight_decay=0.1))


def make_loss_fn(cfg, args):
    """The example's loss: the packed loss over segment-masked attention
    with ``--packed``, else the chunked CE (``--ce-chunk``), else the CE
    over full logits; z-loss on each.  aux is ``{"accuracy": ...}``."""
    from tpucfn_torch.data.packing import packed_causal_lm_loss
    from tpucfn_torch.models.llama import (Llama, causal_lm_loss,
                                           chunked_causal_lm_loss)

    def loss_fn(params, mstate, batch, generator):
        del generator
        model = Llama.from_state_dict(cfg, params, trainable=True)
        tokens = batch["tokens"]
        if args.packed:
            logits = model(tokens, segment_ids=batch["segments"])
            loss, acc = packed_causal_lm_loss(logits, tokens,
                                              batch["segments"],
                                              z_loss=args.z_loss)
        elif args.ce_chunk:
            hidden = model(tokens, return_hidden=True)
            loss, acc = chunked_causal_lm_loss(
                hidden, params["lm_head.weight"], tokens,
                chunk_size=args.ce_chunk, z_loss=args.z_loss)
        else:
            loss, acc = causal_lm_loss(model(tokens), tokens,
                                       z_loss=args.z_loss)
        return loss, ({"accuracy": acc}, mstate)

    return loss_fn


def make_init_fn(cfg):
    from tpucfn_torch.models.llama import init_llama_params

    def init_fn(generator):
        return init_llama_params(cfg, generator=generator,
                                 device=generator.device), {}

    return init_fn


def stage_data(args, cfg, run_dir: Path) -> list:
    """The example's shards under ``run_dir / "data"``, made once."""
    import numpy as np

    from tpucfn_torch.launch import process_count

    num_shards = max(8, process_count())
    if not args.packed:
        return stage_synthetic(
            "tokens", run_dir / "data", n=args.num_examples,
            num_shards=num_shards, seed=args.seed, seq_len=args.seq_len,
            vocab=cfg.vocab_size)
    data_dir = run_dir / "data"
    data_dir.mkdir(parents=True, exist_ok=True)
    shards = sorted(data_dir.glob("*.tpurec"))
    if shards:
        return shards
    rs = np.random.RandomState(args.seed)
    src = data_dir / "corpus.jsonl"
    with src.open("w") as f:
        for _ in range(args.num_examples):
            n = int(rs.randint(max(2, args.seq_len // 8),
                               args.seq_len // 2 + 1))
            f.write(json.dumps(rs.randint(1, cfg.vocab_size, n).tolist())
                    + "\n")
    from tpucfn_torch.data.convert import convert_token_jsonl

    return convert_token_jsonl(src, data_dir, seq_len=args.seq_len,
                               num_shards=num_shards)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    refuse_unported_options(args)
    refuse_unported_planes(args)

    from tpucfn_torch.device import resolve_device
    from tpucfn_torch.launch import initialize_runtime, process_count

    device = resolve_device(args.device)
    initialize_runtime(device=device)

    from tpucfn_torch.data import ShardedDataset, packed_loss_weight
    from tpucfn_torch.mesh import MeshSpec, build_mesh
    from tpucfn_torch.models.llama import sharding_rules, train_step_flops
    from tpucfn_torch.train import Trainer

    cfg = model_config(args)
    shards = stage_data(args, cfg, Path(args.run_dir))
    mesh = build_mesh(MeshSpec.for_devices(
        process_count(), fsdp=args.fsdp, tensor=args.tensor,
        context=args.context, pipeline=args.pipeline, expert=args.expert),
        device_type=device.type)
    chunked = bool(args.ce_chunk) and not args.packed
    trainer = Trainer(
        mesh, sharding_rules(cfg, tensor=args.tensor > 1),
        make_loss_fn(cfg, args), example_chain(args.steps or 1000),
        make_init_fn(cfg), device=device,
        step_flops=lambda batch: train_step_flops(
            cfg, *batch["tokens"].shape, chunked_head=chunked),
        loss_weight=packed_loss_weight if args.packed else None)
    ds = ShardedDataset(shards, batch_size_per_process=per_process_batch(args),
                        seed=args.seed)
    run_train_loop(trainer, ds, mesh, args,
                   items_per_step=args.batch_size * args.seq_len)  # tokens/s
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
