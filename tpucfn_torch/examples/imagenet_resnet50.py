#!/usr/bin/env python
"""ImageNet ResNet-50 data-parallel training on the card (the port of
``examples/imagenet_resnet50.py``).

    python tpucfn_torch/examples/imagenet_resnet50.py --batch-size 128 \\
        --steps 12 --num-examples 256
    tpucfn launch -- python tpucfn_torch/examples/imagenet_resnet50.py \\
        --batch-size 1024
    python tpucfn_torch/examples/imagenet_resnet50.py --device cpu \\
        --network resnet18 --image-size 32 --num-classes 10 \\
        --batch-size 8 --steps 2

The JAX example's chain: synthetic ImageNet-shaped shards at
``--image-size`` (or, with ``--data-url``, staged shards of encoded
images, decoded, geometry fixed (``--augment``: random-resized-crop and
mirror; else center-crop-resize) and normalized with the ImageNet channel
statistics), ResNet-50 or -18 over ``--num-classes``, the cross entropy
over labels smoothed by ``--label-smoothing``, the 76%-top-1 recipe's
chain (weight decay 1e-4, SGD with Nesterov momentum 0.9 over a
warmup-cosine schedule to ``--lr``), ``dense_rules`` and
``run_train_loop``.  ``--loader-workers`` N > 0 decodes on N threads,
N < 0 in -N spawned processes.  No flash kernel runs on this path: the
convolutions are cuDNN's.

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
    p.add_argument("--network", default="resnet50",
                   choices=["resnet50", "resnet18"])
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--num-examples", type=int, default=512,
                   help="synthetic-data size (ignored with --data-url)")
    p.add_argument("--data-url", default="",
                   help="real dataset: record shards of encoded images "
                        "(convert-dataset) at a gs://, s3://, file:// URL "
                        "or local dir; staged to --run-dir then decoded "
                        "on the host input path")
    p.add_argument("--num-classes", type=int, default=1000,
                   help="label cardinality (set to the real dataset's "
                        "class count with --data-url)")
    p.add_argument("--label-smoothing", type=float, default=0.1)
    p.add_argument("--loader-workers", type=int, default=0,
                   help="decode/augment parallelism: N>0 threads "
                        "(in-process; per-example seeds stay "
                        "deterministic) or N<0 spawn processes (|N| "
                        "workers via MultiProcessLoader)")
    p.add_argument("--augment", action="store_true",
                   help="inception-style random-resized-crop + mirror")
    return p


def example_tx(lr: float, steps_total: int):
    """The standard 76%-top-1 recipe: weight decay 1e-4, SGD with Nesterov
    momentum 0.9, a warmup-cosine schedule to ``lr``."""
    from tpucfn_torch.train import (add_decayed_weights, chain, sgd,
                                    warmup_cosine_decay_schedule)

    return chain(add_decayed_weights(1e-4), sgd(
        warmup_cosine_decay_schedule(0.0, lr, min(200, steps_total // 10),
                                     steps_total),
        momentum=0.9, nesterov=True))


def example_transform(args):
    """The host-side transform of the JAX example (None: the batch as
    staged)."""
    from tpucfn_torch.data.transforms import (IMAGENET_MEAN, IMAGENET_STD,
                                              Compose, normalize, random_flip,
                                              random_resized_crop)

    if args.data_url:
        # Encoded shards vary in size: decode, fix geometry (augment for
        # training, center-crop otherwise) so batches stack, then
        # normalize 0-255 pixels with the standard channel stats.
        from tpucfn_torch.data import center_crop_resize, decode_transform

        geom = ([random_resized_crop(args.image_size), random_flip()]
                if args.augment else [center_crop_resize(args.image_size)])
        return Compose([decode_transform(), *geom,
                        normalize(IMAGENET_MEAN, IMAGENET_STD)])
    if args.augment:
        return Compose([random_resized_crop(args.image_size), random_flip()])
    return None


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
    from tpucfn_torch.mesh import MeshSpec, build_mesh
    from tpucfn_torch.models.resnet import (ResNetConfig, resnet_train_flops,
                                            resnet_train_fns)
    from tpucfn_torch.parallel import dense_rules
    from tpucfn_torch.train import Trainer

    run_dir = Path(args.run_dir)
    if args.data_url:
        # Each process fetches only the shards it will read.
        from tpucfn_torch.data import stage_url

        shards = stage_url(args.data_url, run_dir / "data-cache",
                           owner_slice=(process_index(), process_count()))
    else:
        shards = stage_synthetic(
            "imagenet", run_dir / "data", n=args.num_examples,
            num_shards=max(8, process_count()), seed=args.seed,
            image_size=args.image_size)

    mesh = build_mesh(MeshSpec.for_devices(
        process_count(), fsdp=args.fsdp, tensor=args.tensor),
        device_type=device.type)
    cfg = {"resnet50": ResNetConfig.resnet50,
           "resnet18": ResNetConfig.resnet18}[args.network](
        num_classes=args.num_classes)
    stats_group = None
    if process_count() > 1:
        import torch.distributed as dist

        stats_group = dist.group.WORLD
    init_fn, loss_fn, _ = resnet_train_fns(
        cfg, label_smoothing=args.label_smoothing, stats_group=stats_group)
    trainer = Trainer(mesh, dense_rules(fsdp=args.fsdp > 1), loss_fn,
                      example_tx(args.lr, args.steps or 1000), init_fn,
                      device=device,
                      step_flops=lambda batch: resnet_train_flops(
                          cfg, batch["image"].shape[0],
                          batch["image"].shape[1]))
    # Real datasets stream (constant host RAM); synthetic smoke data is
    # small enough to cache decoded.
    loader_kw = dict(batch_size_per_process=per_process_batch(args),
                     seed=args.seed, transform=example_transform(args),
                     cache_in_memory=not args.data_url)
    if args.loader_workers < 0:
        from tpucfn_torch.data import MultiProcessLoader

        ds = MultiProcessLoader(shards, num_workers=-args.loader_workers,
                                **loader_kw)
    else:
        ds = ShardedDataset(shards, num_workers=args.loader_workers,
                            **loader_kw)
    run_train_loop(trainer, ds, mesh, args, items_per_step=args.batch_size)
    return 0


if __name__ == "__main__":
    exit_process(main())
