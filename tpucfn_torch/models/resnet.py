"""The ResNet family (the port of ``tpucfn/models/resnet.py``): CIFAR
ResNet-20/32 and ImageNet ResNet-50/18, post-activation "v1.5" blocks
with stride-2 projection shortcuts.

Images arrive NHWC from the loader; ``permute(0, 3, 1, 2)`` of that
contiguous batch is an NCHW view in ``channels_last`` memory, the layout
cuDNN's convolutions prefer, and every activation stays in it.  The
convolutions are cuDNN's (the JAX package's are XLA's), in the compute
dtype over fp32 parameters.  Two conventions of flax are kept exactly:

* ``"SAME"`` padding is asymmetric at stride 2: flax pads (0, 1) for a
  3x3 stride-2 convolution on an even size and (2, 3) for the 7x7
  stride-2 stem, where ``nn.Conv2d(padding=1)`` or ``padding=3`` would
  shift every window by a pixel.  :func:`same_pads` is flax's formula;
  unequal pads go through ``F.pad`` and a convolution with no padding.
* BatchNorm: statistics in fp32 as E[x^2] - E[x]^2 (flax's fast
  variance, clipped at 0), the BIASED variance kept in the running
  statistics, ``ra = 0.9 ra + 0.1 batch``, eps 1e-5; the batch's
  statistics when training, the running ones otherwise.  The running
  statistics are not module buffers: they are a flat dict
  (``"<bn path>.mean"``, ``"<bn path>.var"``), ``model_state
  ["batch_stats"]`` of the trainer, passed in and returned by
  :meth:`ResNet.forward`.

Under data parallelism the JAX trainer's statistics are the global
batch's (its step is one program over the sharded batch): with
``stats_group`` set, each BatchNorm sums (sum, sum of squares, count)
over the group's ranks, and the backward sums the incoming gradients over
them too.  The last BatchNorm scale of each block starts at zero; the
classifier head runs in fp32 over the spatial mean in the compute dtype.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tpucfn_torch.models.layers import bind_state_dict, lecun_normal_
from tpucfn_torch.models.moe import _AllReduceSum

MOMENTUM = 0.9
EPSILON = 1e-5


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: Sequence[int]
    num_classes: int
    bottleneck: bool = True
    width: int = 64
    cifar_stem: bool = False  # 3x3 stem, no maxpool (CIFAR) vs 7x7/s2 + pool
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32

    @classmethod
    def resnet20_cifar(cls, num_classes: int = 10) -> "ResNetConfig":
        # The reference CIFAR example's default network (SURVEY.md §3.2).
        return cls(stage_sizes=(3, 3, 3), num_classes=num_classes,
                   bottleneck=False, width=16, cifar_stem=True)

    @classmethod
    def resnet32_cifar(cls, num_classes: int = 10) -> "ResNetConfig":
        return cls(stage_sizes=(5, 5, 5), num_classes=num_classes,
                   bottleneck=False, width=16, cifar_stem=True)

    @classmethod
    def resnet50(cls, num_classes: int = 1000) -> "ResNetConfig":
        # The north-star model: 76% top-1 target (BASELINE.md).
        return cls(stage_sizes=(3, 4, 6, 3), num_classes=num_classes,
                   bottleneck=True, width=64)

    @classmethod
    def resnet18(cls, num_classes: int = 1000) -> "ResNetConfig":
        return cls(stage_sizes=(2, 2, 2, 2), num_classes=num_classes,
                   bottleneck=False, width=64)


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """flax's ``"SAME"`` padding of one spatial dim: (low, high), the
    high side taking the odd pixel."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """A bias-free convolution with flax's ``"SAME"`` padding; the weight
    (out, in, kh, kw) in ``param_dtype``, cast to the compute dtype."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, *,
                 dtype, param_dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel,
                                               dtype=param_dtype))
        self.stride, self.dtype = stride, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.weight.shape[-1]
        (top, bottom), (left, right) = (same_pads(s, k, self.stride)
                                        for s in x.shape[2:])
        w = self.weight.to(self.dtype)
        if (top, left) == (bottom, right):
            return F.conv2d(x, w, stride=self.stride, padding=(top, left))
        x = F.pad(x, (left, right, top, bottom)).contiguous(
            memory_format=torch.channels_last)
        return F.conv2d(x, w, stride=self.stride)


class BatchNorm(nn.Module):
    """flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over NCHW
    activations; ``path`` names its running statistics."""

    def __init__(self, features: int, *, dtype, param_dtype):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(features, dtype=param_dtype))
        self.bias = nn.Parameter(torch.empty(features, dtype=param_dtype))
        self.dtype = dtype
        self.path = ""  # set by ResNet

    def forward(self, x: torch.Tensor, stats: Mapping[str, torch.Tensor],
                new_stats: dict, train: bool, group) -> torch.Tensor:
        mean_key, var_key = f"{self.path}.mean", f"{self.path}.var"
        # One fp32 copy for the statistics and the normalization: its
        # gradient sums both paths in fp32 (they nearly cancel) before the
        # one cast back, where two casts would round each to bf16 first.
        xf = x.float()
        if train:
            sums = torch.cat([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)),
                              xf.new_full((1,), xf.numel() / xf.shape[1])])
            if group is not None:
                sums = _AllReduceSum.apply(sums, group)
            c = x.shape[1]
            mean = sums[:c] / sums[-1]
            var = torch.clamp(sums[c:2 * c] / sums[-1] - mean * mean, min=0.0)
            with torch.no_grad():
                new_stats[mean_key] = (MOMENTUM * stats[mean_key]
                                       + (1 - MOMENTUM) * mean)
                new_stats[var_key] = (MOMENTUM * stats[var_key]
                                      + (1 - MOMENTUM) * var)
        else:
            mean, var = stats[mean_key], stats[var_key]
            new_stats[mean_key], new_stats[var_key] = mean, var
        mul = torch.rsqrt(var + EPSILON) * self.scale.float()
        y = (xf - mean[:, None, None]) * mul[:, None, None]
        return (y + self.bias.float()[:, None, None]).to(self.dtype)


class ResNetBlock(nn.Module):
    def __init__(self, cin: int, filters: int, strides: int, bottleneck: bool,
                 dtype, param_dtype):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.bottleneck = bottleneck
        if bottleneck:
            self.conv1 = Conv(cin, filters, 1, **kw)
            self.bn1 = BatchNorm(filters, **kw)
            self.conv2 = Conv(filters, filters, 3, strides, **kw)
            self.bn2 = BatchNorm(filters, **kw)
            self.conv3 = Conv(filters, filters * 4, 1, **kw)
            self.bn3 = BatchNorm(filters * 4, **kw)
            out_filters = filters * 4
        else:
            self.conv1 = Conv(cin, filters, 3, strides, **kw)
            self.bn1 = BatchNorm(filters, **kw)
            self.conv2 = Conv(filters, filters, 3, **kw)
            self.bn2 = BatchNorm(filters, **kw)
            out_filters = filters
        self.out_filters = out_filters
        if cin != out_filters or strides != 1:
            self.conv_proj = Conv(cin, out_filters, 1, strides, **kw)
            self.bn_proj = BatchNorm(out_filters, **kw)

    def forward(self, x, stats, new_stats, train, group):
        def norm(bn, y):
            return bn(y, stats, new_stats, train, group)

        residual = x
        y = F.relu(norm(self.bn1, self.conv1(x)))
        y = norm(self.bn2, self.conv2(y))
        if self.bottleneck:
            y = norm(self.bn3, self.conv3(F.relu(y)))
        if hasattr(self, "conv_proj"):
            residual = norm(self.bn_proj, self.conv_proj(residual))
        return F.relu(y + residual)


class ResNet(nn.Module):
    """``forward(images (B, H, W, 3), batch_stats, train=True) ->
    (logits (B, classes) fp32, new batch_stats)``."""

    def __init__(self, config: ResNetConfig, *, stats_group=None):
        super().__init__()
        cfg = self.config = config
        kw = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype)
        self.stats_group = stats_group
        if cfg.cifar_stem:
            self.conv_stem = Conv(3, cfg.width, 3, **kw)
        else:
            self.conv_stem = Conv(3, cfg.width, 7, 2, **kw)
        self.bn_stem = BatchNorm(cfg.width, **kw)
        cin = cfg.width
        for stage, num_blocks in enumerate(cfg.stage_sizes):
            for block in range(num_blocks):
                strides = 2 if stage > 0 and block == 0 else 1
                b = ResNetBlock(cin, cfg.width * 2 ** stage, strides,
                                cfg.bottleneck, **kw)
                self.add_module(f"stage{stage}_block{block}", b)
                cin = b.out_filters
        self.head = nn.Linear(cin, cfg.num_classes, dtype=cfg.param_dtype)
        for name, m in self.named_modules():
            if isinstance(m, BatchNorm):
                m.path = name

    @classmethod
    def from_state_dict(cls, cfg: ResNetConfig,
                        params: Mapping[str, torch.Tensor], *, device=None,
                        trainable: bool = False,
                        stats_group=None) -> "ResNet":
        """A model over ``params`` (the port's state dict), the tensors
        used as they are where they already sit on ``device`` in their
        storage dtype; with ``trainable`` the caller's ``nn.Parameter``
        objects stay the model's."""
        with torch.device("meta"):
            model = cls(cfg, stats_group=stats_group)
        return bind_state_dict(model, params, device=device,
                               trainable=trainable)

    def blocks(self):
        cfg = self.config
        return [getattr(self, f"stage{s}_block{b}")
                for s, n in enumerate(cfg.stage_sizes) for b in range(n)]

    def forward(self, images: torch.Tensor,
                batch_stats: Mapping[str, torch.Tensor], train: bool = True
                ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        cfg, group = self.config, self.stats_group
        new_stats: dict[str, torch.Tensor] = {}
        x = images.to(cfg.dtype).permute(0, 3, 1, 2)
        x = self.bn_stem(self.conv_stem(x), batch_stats, new_stats, train,
                         group)
        x = F.relu(x)
        if not cfg.cifar_stem:
            x = F.max_pool2d(x, 3, 2, padding=1)
        for block in self.blocks():
            x = block(x, batch_stats, new_stats, train, group)
        pooled = x.mean(dim=(2, 3), dtype=torch.float32).to(cfg.dtype)
        # Classifier head in fp32 for a stable softmax.
        logits = F.linear(pooled.float(), self.head.weight.float(),
                          self.head.bias.float())
        return logits, new_stats


def init_resnet_params(cfg: ResNetConfig, *, generator: torch.Generator,
                       device=None
                       ) -> tuple[dict[str, torch.Tensor],
                                  dict[str, torch.Tensor]]:
    """(params, batch_stats) from a seeded generator in flax's
    initializer families: every convolution and the head's kernel
    lecun-normal (a normal truncated at ±2σ, σ = sqrt(1/fan_in)/0.8796,
    fan_in = in x kh x kw), the head's bias zero, BatchNorm scales one
    (zero for each block's last), biases zero; running means zero and
    variances one.  (The numbers differ from JAX's; parity tests carry
    JAX's own weights across with :mod:`tpucfn_torch.models.convert`.)"""
    with torch.device("meta"):
        model = ResNet(cfg)
    last_bn = {f"{name}.{'bn3' if cfg.bottleneck else 'bn2'}"
               for name, m in model.named_children()
               if isinstance(m, ResNetBlock)}
    params = {}
    for name, meta in model.state_dict().items():
        w = torch.zeros(meta.shape, dtype=torch.float32, device=device)
        owner = name.rpartition(".")[0]
        if name.endswith(".scale") and owner not in last_bn:
            w.fill_(1.0)
        elif name.endswith(".weight"):
            lecun_normal_(w, math.prod(meta.shape[1:]), generator)
        params[name] = w.to(meta.dtype)
    stats = {}
    for name, m in model.named_modules():
        if isinstance(m, BatchNorm):
            n = m.scale.shape[0]
            stats[f"{name}.mean"] = torch.zeros(n, device=device)
            stats[f"{name}.var"] = torch.ones(n, device=device)
    return params, stats


def resnet_train_fns(cfg: ResNetConfig, *, label_smoothing: float = 0.0,
                     stats_group=None):
    """(init_fn, loss_fn, eval_loss_fn) of the JAX package's ResNet
    examples for the port's ``Trainer``: the weights and running
    statistics from the trainer's generator (``model_state =
    {"batch_stats": ...}``); the mean softmax cross entropy (over labels
    smoothed as optax's ``smooth_labels``, ``(1 - a) onehot + a / K``,
    which ``F.cross_entropy(label_smoothing=a)`` computes) with the batch's
    statistics, returning the updated running ones; and its eval twin over
    the running statistics.  aux is ``{"accuracy": ...}``."""

    def init_fn(generator):
        params, stats = init_resnet_params(cfg, generator=generator,
                                           device=generator.device)
        return params, {"batch_stats": stats}

    def run(params, mstate, batch, train):
        model = ResNet.from_state_dict(cfg, params, trainable=train,
                                       stats_group=stats_group)
        logits, stats = model(batch["image"], mstate["batch_stats"],
                              train=train)
        labels = batch["label"].long()
        loss = F.cross_entropy(logits, labels,
                               label_smoothing=label_smoothing)
        acc = (logits.argmax(-1) == labels).float().mean()
        return loss, ({"accuracy": acc}, {**mstate, "batch_stats": stats})

    def loss_fn(params, mstate, batch, generator):
        return run(params, mstate, batch, True)

    def eval_loss_fn(params, mstate, batch, generator):
        return run(params, mstate, batch, False)

    return init_fn, loss_fn, eval_loss_fn


def resnet_train_flops(cfg: ResNetConfig, batch: int, image_size: int
                       ) -> float:
    """FLOPs of one training step over ``batch`` images of
    ``image_size``^2: every convolution's and the head's multiply-adds
    (2 FLOPs each) in the forward, times 3 for the forward and the
    backward (the input and the weight gradient, each as much as the
    forward).  BatchNorm, the activations, the pooling and the optimizer
    are not counted."""
    flops = 0

    def conv(size, cin, cout, k, stride):
        nonlocal flops
        out = -(-size // stride)
        flops += 2 * out * out * cout * cin * k * k
        return out

    if cfg.cifar_stem:
        size = conv(image_size, 3, cfg.width, 3, 1)
    else:
        size = conv(image_size, 3, cfg.width, 7, 2)
        size = (size + 2 - 3) // 2 + 1  # the 3x3 stride-2 max pool
    cin = cfg.width
    for stage, num_blocks in enumerate(cfg.stage_sizes):
        filters = cfg.width * 2 ** stage
        for block in range(num_blocks):
            stride = 2 if stage > 0 and block == 0 else 1
            out_filters = filters * 4 if cfg.bottleneck else filters
            if cfg.bottleneck:
                conv(size, cin, filters, 1, 1)
                out = conv(size, filters, filters, 3, stride)
                conv(out, filters, out_filters, 1, 1)
            else:
                out = conv(size, cin, filters, 3, stride)
                conv(out, filters, filters, 3, 1)
            if cin != out_filters or stride != 1:
                conv(size, cin, out_filters, 1, stride)
            size, cin = out, out_filters
    flops += 2 * cin * cfg.num_classes
    return float(3 * batch * flops)
