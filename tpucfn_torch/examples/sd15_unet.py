#!/usr/bin/env python
"""Stable Diffusion 1.5 UNet finetune on the card (the port of
``examples/sd15_unet.py``).

    python tpucfn_torch/examples/sd15_unet.py --batch-size 2 --steps 6
    python tpucfn_torch/examples/sd15_unet.py --device cpu --tiny \\
        --batch-size 2 --steps 6

Latent-diffusion eps-prediction finetuning of the SD-1.5 UNet at its
published shape (``--tiny``: the tests' config), with the JAX example's
chain: synthetic latent/context shards (64x64x4 latents and a 77 x 768
context; 16x16 and 8 x 32 with ``--tiny``), the ``Trainer`` with AdamW
at 1e-5 unless ``--lr`` says otherwise and an EMA of the parameters
(``--ema-decay``, 0.9999; 0 disables), ``transformer_rules`` and
``run_train_loop`` (checkpoints in ``--run-dir``, resumed on relaunch).
The t and noise of each step come from the trainer's generator.  On the
card every attention runs on the flash kernels: the 64x64 stage's at
head dim 40 (a 4096 x 4096 self-attention and a 4096 x 77
cross-attention in each of its five transformer blocks), the 32x32
stage's at 80 and the 16x16 stage's and the middle block's at 160.

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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_cluster_args(p)
    p.add_argument("--tiny", action="store_true", help="tiny config (CI)")
    p.add_argument("--latent-size", type=int, default=0,
                   help="latent H=W (default 64 full / 16 tiny)")
    p.add_argument("--num-examples", type=int, default=256)
    p.add_argument("--ema-decay", type=float, default=0.9999,
                   help="EMA of the UNet params (the diffusion-finetune "
                        "standard; tracked in model_state, checkpointed); "
                        "0 disables")
    p.add_argument("--lr", type=float, default=1e-5,
                   help="AdamW learning rate (finetune scale)")
    return p


def make_fns(cfg):
    """(init_fn, loss_fn) of the example: the UNet's random weights from
    the trainer's generator, and ``ddpm_loss`` over a model built on the
    trainer's parameters in each call."""
    from tpucfn_torch.models.unet import UNet, ddpm_loss, init_unet_params

    def init_fn(generator):
        return init_unet_params(cfg, generator=generator,
                                device=generator.device), {}

    def loss_fn(params, mstate, batch, generator):
        model = UNet.from_state_dict(cfg, params, trainable=True)
        return ddpm_loss(model, batch, generator), ({}, mstate)

    return init_fn, loss_fn


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
    from tpucfn_torch.models.unet import UNetConfig
    from tpucfn_torch.parallel import transformer_rules
    from tpucfn_torch.train import Trainer, TrainerConfig, adamw

    cfg = UNetConfig.tiny() if args.tiny else UNetConfig.sd15()
    hw = args.latent_size or (16 if args.tiny else 64)
    ctx_len = 8 if args.tiny else 77
    shards = stage_synthetic(
        "latents", Path(args.run_dir) / "data", n=args.num_examples,
        num_shards=max(8, process_count()), seed=args.seed, hw=hw,
        ctx_len=ctx_len, ctx_dim=cfg.context_dim)
    mesh = build_mesh(MeshSpec.for_devices(
        process_count(), fsdp=args.fsdp, tensor=args.tensor),
        device_type=device.type)
    init_fn, loss_fn = make_fns(cfg)
    trainer = Trainer(
        mesh, transformer_rules(tensor=args.tensor > 1), loss_fn,
        adamw(args.lr), init_fn,
        config=TrainerConfig(ema_decay=args.ema_decay), device=device)
    ds = ShardedDataset(shards, batch_size_per_process=per_process_batch(args),
                        seed=args.seed)
    run_train_loop(trainer, ds, mesh, args, items_per_step=args.batch_size)
    return 0


if __name__ == "__main__":
    exit_process(main())
