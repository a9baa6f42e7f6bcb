#!/usr/bin/env python
"""CIFAR-10 ResNet-20 training on the card (the port of
``examples/cifar10_resnet20.py``).

    python tpucfn_torch/examples/cifar10_resnet20.py --batch-size 128 \\
        --steps 30 --augment --eval-every 10
    tpucfn launch -- python tpucfn_torch/examples/cifar10_resnet20.py \\
        --network resnet20 --kv-store dist_sync
    python tpucfn_torch/examples/cifar10_resnet20.py --device cpu \\
        --batch-size 16 --steps 2

The JAX example's chain: synthetic CIFAR-shaped shards (or, with
``--data-url``, staged shards of encoded images, decoded, optionally
pad-cropped and mirrored, then mapped to [-1, 1]), ResNet-20 or -32, SGD
with Nesterov momentum 0.9 at ``--lr`` (``--cosine``: weight decay 1e-4
and a warmup-cosine schedule over the step budget), ``dense_rules`` and
``run_train_loop``; ``--eval-every`` evaluates a held-out split
(``--eval-url``, else a synthetic one) with the running BatchNorm
statistics.  ``--loader-workers`` N > 0 decodes and augments on N
threads, N < 0 in -N spawned processes (``MultiProcessLoader``).
``--kv-store`` is the reference's flag: both values mean synchronous
data parallelism.  No flash kernel runs on this path: the convolutions
are cuDNN's.

Image decoding needs PIL (``--data-url``); the synthetic data does not.
Data parallel over the ranks, each BatchNorm's statistics over the
global batch; ``--fsdp`` > 1 and ``--tensor`` > 1 are refused (ROADMAP
Queue 1 C2b).
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
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--kv-store", default="dist_sync",
                   choices=["dist_sync", "device"],
                   help="compat shim: the reference's MXNet flag; both mean "
                        "synchronous data parallelism")
    p.add_argument("--network", default="resnet20",
                   choices=["resnet20", "resnet32"])
    p.add_argument("--num-examples", type=int, default=2048,
                   help="synthetic dataset size to stage (ignored with "
                        "--data-url)")
    p.add_argument("--augment", action="store_true",
                   help="pad-crop + mirror augmentation (the CIFAR recipe)")
    p.add_argument("--data-url", default="",
                   help="real dataset: record shards of ENCODED images "
                        "(convert-dataset --kind image-tree) at a gs://, "
                        "s3://, file:// URL or local dir; decoded on the "
                        "host input path, 10-class 32x32 expected")
    p.add_argument("--eval-url", default="",
                   help="held-out split shards (encoded images) for "
                        "--eval-every; with neither, eval uses a "
                        "synthetic split")
    p.add_argument("--loader-workers", type=int, default=0,
                   help="decode/augment parallelism: N>0 threads, N<0 "
                        "spawn processes (|N| MultiProcessLoader workers)")
    p.add_argument("--cosine", action="store_true",
                   help="warmup-cosine LR over the step budget (the "
                        "train-to-accuracy recipe; default is constant "
                        "--lr)")
    return p


def example_tx(args, steps_total: int):
    """SGD with Nesterov momentum 0.9 at ``--lr``; with ``--cosine``,
    weight decay 1e-4 and a warmup-cosine schedule over ``steps_total``."""
    from tpucfn_torch.train import (add_decayed_weights, chain, sgd,
                                    warmup_cosine_decay_schedule)

    if not args.cosine:
        return sgd(args.lr, momentum=0.9, nesterov=True)
    return chain(add_decayed_weights(1e-4), sgd(
        warmup_cosine_decay_schedule(0.0, args.lr,
                                     min(200, max(1, steps_total // 10)),
                                     steps_total),
        momentum=0.9, nesterov=True))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    refuse_sharded_parameters(args)
    refuse_unported_planes(args)

    from tpucfn_torch.device import resolve_device
    from tpucfn_torch.launch import (initialize_runtime, process_count,
                                     process_index)

    device = resolve_device(args.device)
    initialize_runtime(device=device)

    from tpucfn_torch.data import ShardedDataset
    from tpucfn_torch.data.transforms import CIFAR_TRAIN, Compose, normalize
    from tpucfn_torch.mesh import MeshSpec, build_mesh
    from tpucfn_torch.models.resnet import (ResNetConfig, resnet_train_flops,
                                            resnet_train_fns)
    from tpucfn_torch.parallel import dense_rules
    from tpucfn_torch.train import Trainer

    run_dir = Path(args.run_dir)
    owner = (process_index(), process_count())
    if args.data_url:
        # The reference's "aws s3 sync" staging step: sync encoded shards
        # down once, decode on the host.
        from tpucfn_torch.data import stage_url

        shards = stage_url(args.data_url, run_dir / "data-cache",
                           owner_slice=owner)
    else:
        shards = stage_synthetic(
            "cifar10", run_dir / "data", n=args.num_examples,
            num_shards=max(8, process_count()), seed=args.seed)

    mesh = build_mesh(MeshSpec.for_devices(
        process_count(), fsdp=args.fsdp, tensor=args.tensor),
        device_type=device.type)
    cfg = {"resnet20": ResNetConfig.resnet20_cifar,
           "resnet32": ResNetConfig.resnet32_cifar}[args.network]()
    stats_group = None
    if process_count() > 1:
        import torch.distributed as dist

        stats_group = dist.group.WORLD
    init_fn, loss_fn, eval_loss_fn = resnet_train_fns(
        cfg, stats_group=stats_group)

    if args.data_url:
        # Encoded shards: decode, optional CIFAR pad-crop/mirror, then
        # map 0-255 pixels to [-1, 1].
        from tpucfn_torch.data import decode_transform

        steps_t = [decode_transform()]
        if args.augment:
            steps_t.append(CIFAR_TRAIN)
        steps_t.append(normalize((127.5,) * 3, (127.5,) * 3))
        transform = Compose(steps_t)
    elif args.augment:
        transform = CIFAR_TRAIN
    else:
        transform = None
    loader_kw = dict(batch_size_per_process=per_process_batch(args),
                     seed=args.seed, transform=transform,
                     cache_in_memory=not args.data_url)
    if args.loader_workers < 0:
        from tpucfn_torch.data import MultiProcessLoader

        ds = MultiProcessLoader(shards, num_workers=-args.loader_workers,
                                **loader_kw)
    else:
        ds = ShardedDataset(shards, num_workers=args.loader_workers,
                            **loader_kw)

    eval_ds = None
    if args.eval_every:
        if args.eval_url:
            from tpucfn_torch.data import decode_transform, stage_url

            eval_shards = stage_url(args.eval_url, run_dir / "eval-cache",
                                    owner_slice=owner)
            eval_ds = ShardedDataset(
                eval_shards, shuffle=False, cache_in_memory=False,
                batch_size_per_process=per_process_batch(args),
                transform=Compose([decode_transform(),
                                   normalize((127.5,) * 3, (127.5,) * 3)]))
        else:
            eval_shards = stage_synthetic(
                "cifar10", run_dir / "eval", n=max(64, args.num_examples // 4),
                num_shards=max(8, process_count()), seed=args.seed + 1)
            eval_ds = ShardedDataset(
                eval_shards, shuffle=False,
                batch_size_per_process=per_process_batch(args))

    steps_total = args.steps or len(ds) * args.num_epochs
    trainer = Trainer(mesh, dense_rules(fsdp=args.fsdp > 1), loss_fn,
                      example_tx(args, steps_total), init_fn,
                      eval_loss_fn=eval_loss_fn, device=device,
                      step_flops=lambda batch: resnet_train_flops(
                          cfg, batch["image"].shape[0],
                          batch["image"].shape[1]))
    run_train_loop(trainer, ds, mesh, args, items_per_step=args.batch_size,
                   eval_ds=eval_ds)
    return 0


if __name__ == "__main__":
    exit_process(main())
