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

``--moe-experts N`` replaces every dense MLP with a MoE of N experts
(``MoEConfig(n_experts=N)``: top-2, capacity factor 1.25) and adds its
aux loss to the loss; under data parallelism each MoE layer routes over
the global batch, as XLA does with the batch sharded over the data axis.
``--lora-rank r`` finetunes rank-r LoRA adapters on the attention and MLP
weights instead (:func:`tpucfn_torch.train.lora.lora_train_fns`): the
base is frozen in the state's ``model_state``, and only the adapters get
optimizer state.

The mesh is the JAX example's: ``--fsdp``, ``--tensor``, ``--context``
and ``--expert`` axes, the ``data`` axis filling the ranks left over, and
``sharding_rules(cfg, tensor=args.tensor > 1)`` place the state.  Data
parallel over the batch axes (data, fsdp, expert); ``--fsdp N``: params
and AdamW moments split over the N ranks, each layer's weights gathered
where it runs; ``--tensor N``: Megatron tensor parallelism over the
heads, the FFN rows and the vocabulary, the N ranks reading the same
rows; ``--context N``: the N ranks of a context group read the same
rows, each trains on its block of S/N positions, and the attention is
ring attention over the group (``--ring-flash``: every hop on the
kernels; else the dense/flash policy on the block's length, which on the
card is the kernels); ``--moe-experts`` with ``--expert N``: each rank
holds n_experts/N experts and the MoE layers exchange tokens with one
``all_to_all`` pair, each rank routing its own tokens.  Every rank is one
card under NCCL.  Refused with the ROADMAP item named: ``--pipeline`` > 1
(C5) and ``--lora-rank`` with ``--fsdp`` or ``--tensor`` > 1 (C2b);
``--packed`` with ``--context`` > 1 exits as the JAX example does.
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
    exit_process,
    per_process_batch,
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
                   help="context (sequence-parallel) axis size; >1 enables "
                        "ring attention")
    p.add_argument("--ring-flash", action="store_true",
                   help="run each ring-attention hop through the flash "
                        "kernels (K1 forward; Delta, K2, K3 backward)")
    p.add_argument("--pipeline", type=int, default=1,
                   help="pipeline stages; refused > 1")
    p.add_argument("--moe-experts", type=int, default=0,
                   help="replace the dense MLP with a MoE of N experts "
                        "(0 = dense); its aux load-balancing loss is added "
                        "to the loss")
    p.add_argument("--expert", type=int, default=1,
                   help="expert mesh axis size (a batch axis for dense models)")
    p.add_argument("--num-examples", type=int, default=256)
    p.add_argument("--z-loss", type=float, default=1e-4)
    p.add_argument("--packed", action="store_true",
                   help="packed-sequence training: variable-length "
                        "documents packed into full (S,) rows with "
                        "segment-masked attention and boundary-safe loss "
                        "(this example synthesizes a corpus)")
    p.add_argument("--lora-rank", type=int, default=0,
                   help="finetune rank-r LoRA adapters on the attention/MLP "
                        "weights instead of full weights (the base stays "
                        "frozen; optimizer state shrinks to the adapters). "
                        "0 = full finetune")
    p.add_argument("--ce-chunk", type=int, default=512,
                   help="compute the LM-head CE over sequence chunks of "
                        "this size so the fp32 (B,S,vocab) logits are never "
                        "materialized; 0 materializes logits")
    return p


def refuse_unported_options(args) -> None:
    """Exit non-zero, naming the ROADMAP item, for options the port does
    not have."""
    refused = (
        (args.pipeline > 1, "--pipeline > 1 (pipeline parallelism)", "C5"),
        (args.lora_rank > 0 and max(args.fsdp, args.tensor) > 1,
         "--lora-rank with --fsdp or --tensor > 1 (adapters over sharded "
         "base weights)", "C2b"),
    )
    for asked, what, item in refused:
        if asked:
            raise SystemExit(f"{what} is not ported to tpucfn_torch yet "
                             f"(ROADMAP Queue 1 {item})")
    if args.packed and args.context > 1:
        raise SystemExit("--packed composes with DP/FSDP/TP only "
                         "(segment ids don't thread through PP/SP yet)")


def model_config(args):
    import torch

    from tpucfn_torch.models.llama import LlamaConfig
    from tpucfn_torch.models.moe import MoEConfig

    cfg = {"8b": LlamaConfig.llama3_8b, "1b": LlamaConfig.llama3_1b,
           "tiny": LlamaConfig.tiny}[args.model]()
    # fp32 master weights, as the JAX package's param_dtype default.
    cfg = dataclasses.replace(cfg, param_dtype=torch.float32)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if args.moe_experts:
        cfg = dataclasses.replace(cfg,
                                  moe=MoEConfig(n_experts=args.moe_experts))
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


def make_loss_fn(cfg, args, moe_route_group=None, mesh=None):
    """The example's loss (:func:`tpucfn_torch.train.llama_loss`): the
    packed loss over segment-masked attention with ``--packed``, else the
    chunked CE (``--ce-chunk``), else the CE over full logits; z-loss on
    each, and the MoE aux loss with ``--moe-experts`` (routed over
    ``moe_route_group``'s global batch when given, or with ``--expert``
    > 1 expert parallel over ``mesh``'s expert axis).  With ``--context``
    > 1 it runs this rank's block of positions with ring attention over
    ``mesh``'s context axis, with ``--tensor`` > 1 tensor parallel over
    its tensor axis.  aux is ``{"accuracy": ...}`` (and the MoE dropped
    fraction)."""
    from tpucfn_torch.train import llama_loss

    model_kw = {} if moe_route_group is None else {
        "moe_route_group": moe_route_group}
    if args.tensor > 1:
        model_kw["tensor_mesh"] = mesh
    if cfg.moe is not None and args.expert > 1:
        model_kw["moe_expert_group"] = mesh.get_group("expert")
    if args.context > 1:
        from tpucfn_torch.kernels import make_ring_attention

        model_kw.update(context_mesh=mesh, attention_fn=make_ring_attention(
            mesh, hop_attention="flash" if args.ring_flash else "auto"))

    def loss_fn(params, mstate, batch, generator):
        del generator
        loss, aux = llama_loss(cfg, params, batch,
                               chunk_size=args.ce_chunk, z_loss=args.z_loss,
                               **model_kw)
        return loss, (aux, mstate)

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

    from tpucfn_torch.collectives import axis_index, axis_size, group_of
    from tpucfn_torch.data import ShardedDataset, packed_loss_weight
    from tpucfn_torch.mesh import BATCH_AXES, MeshSpec, build_mesh
    from tpucfn_torch.models.llama import (causal_lm_loss_weight,
                                           sharding_rules, train_step_flops)
    from tpucfn_torch.train import Trainer, TrainerConfig

    cfg = model_config(args)
    shards = stage_data(args, cfg, Path(args.run_dir))
    mesh = build_mesh(MeshSpec.for_devices(
        process_count(), fsdp=args.fsdp, tensor=args.tensor,
        context=args.context, pipeline=args.pipeline, expert=args.expert),
        device_type=device.type)
    chunked = bool(args.ce_chunk) and not args.packed
    # Without an expert axis a MoE routes over the global batch: the
    # group of every rank that holds other tokens (the tensor axis's
    # ranks hold the same ones).
    routed = ("data", "fsdp", "context")
    route_group = None
    if (cfg.moe is not None and args.expert == 1
            and axis_size(routed, mesh=mesh) > 1):
        import torch.distributed as dist

        route_group = dist.group.WORLD if args.tensor == 1 else group_of(
            routed, mesh=mesh)
    init_fn = make_init_fn(cfg)
    loss_fn = make_loss_fn(cfg, args, route_group, mesh)
    rules = sharding_rules(cfg, tensor=args.tensor > 1)
    if args.lora_rank:
        from tpucfn_torch.train import lora_sharding_rules, lora_train_fns

        init_fn, loss_fn = lora_train_fns(init_fn, loss_fn,
                                          rank=args.lora_rank)
        rules = lora_sharding_rules()
    extra_axes = ("context",) if args.context > 1 else ()
    loss_weight = None
    if args.packed:
        loss_weight = packed_loss_weight
    elif extra_axes:
        loss_weight = causal_lm_loss_weight(mesh)
    # train_step_flops counts a full finetune's products; a LoRA step
    # makes no weight gradients of the base, so it leaves MFU unset.  A
    # rank of a context group counts its share of its rows' whole
    # sequences, a rank of the tensor axis its share of the products.
    trainer = Trainer(
        mesh, rules, loss_fn, example_chain(args.steps or 1000),
        init_fn, device=device,
        config=TrainerConfig(batch_extra_axes=extra_axes),
        step_flops=None if args.lora_rank else lambda batch: train_step_flops(
            cfg, batch["tokens"].shape[0],
            batch["tokens"].shape[1] * args.context,
            chunked_head=chunked) / (args.context * args.tensor),
        loss_weight=loss_weight)
    # The ranks of a context group read the same rows: the dataset splits
    # over the data-parallel coordinate.
    ds = ShardedDataset(shards, batch_size_per_process=per_process_batch(
        args, mesh), process_index=axis_index(BATCH_AXES, mesh=mesh),
        process_count=axis_size(BATCH_AXES, mesh=mesh), seed=args.seed)
    run_train_loop(trainer, ds, mesh, args,
                   items_per_step=args.batch_size * args.seq_len,  # tokens/s
                   extra_axes=extra_axes)
    return 0


if __name__ == "__main__":
    exit_process(main())
