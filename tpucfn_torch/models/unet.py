"""The Stable-Diffusion-1.5 UNet (the port of ``tpucfn/models/unet.py``).

4-channel latents in and out, a sinusoidal timestep embedding into a
2-layer MLP, ResBlocks (GroupNorm, SiLU, the time embedding added after
the first convolution), spatial transformer blocks (self-attention,
cross-attention over a 768-wide text context, a GEGLU feed-forward) at the
attention stages, and the skip-connected down and up paths at widths
(320, 640, 1280, 1280).  ``UNetConfig.sd15()`` is the published shape
(~860M parameters), ``UNetConfig.tiny()`` the tests' size.

The public functions keep the JAX package's NHWC layout: latents (B, H,
W, 4) in, eps (B, H, W, 4) out.  Inside, a feature map is a logical NCHW
tensor in ``channels_last`` memory, which is the same bytes as NHWC: the
convolutions run channels-last, and the transformer's (B, H*W, C) view is
a free reshape.  Mixed precision as in the JAX package: fp32 parameters
(``param_dtype``), bf16 compute (``dtype``), GroupNorm and LayerNorm in
fp32, and an fp32 output convolution, zero-initialised so that a
finetune starts as an identity eps predictor.

Where PyTorch's defaults differ from flax's, the port follows flax: GELU
is the tanh approximation, both norms take epsilon 1e-6, and a skip
concatenation puts the running features first.  Parameter names follow
the JAX tree with ``.`` for ``/`` (``down0_attn0.self_attn.q_proj.weight``
for ``down0_attn0/self_attn/q_proj/kernel``); norms keep flax's ``scale``
and ``bias``.  :func:`tpucfn_torch.models.convert.unet_params_from_flax`
carries the JAX package's parameters across.

Every attention goes through
:func:`tpucfn_torch.kernels.auto.full_attention_auto`: on the card the
flash kernels take every one, self- and cross-attention, at each stage's
head dim (40 at 64x64, 80 at 32x32, 160 at 16x16 and in the middle
block).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tpucfn_torch.models.layers import (Dense, LayerNorm, bind_state_dict,
                                         lecun_normal_)


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    base_width: int = 320
    width_mults: Sequence[int] = (1, 2, 4, 4)
    blocks_per_stage: int = 2
    attn_stages: Sequence[bool] = (True, True, True, False)
    n_heads: int = 8
    context_dim: int = 768
    groups: int = 32
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    @classmethod
    def sd15(cls) -> "UNetConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "UNetConfig":
        return cls(base_width=32, width_mults=(1, 2), blocks_per_stage=1,
                   attn_stages=(True, False), n_heads=2, context_dim=32,
                   groups=8, dtype=torch.float32)


NORM_EPS = 1e-6  # flax's GroupNorm and LayerNorm default


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embeddings, fp32, cos then sin. t: (B,) -> (B, dim)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _dense(n_in: int, n_out: int, cfg: UNetConfig, *,
           bias: bool = True) -> Dense:
    """flax ``DenseGeneral`` at the config's dtypes, with a bias unless
    told otherwise."""
    return Dense(n_in, n_out, cfg.dtype, cfg.param_dtype, bias=bias)


class Conv(nn.Conv2d):
    """flax ``Conv`` with ``padding=1`` (or none for a 1x1 kernel) on a
    channels-last feature map, in the compute dtype."""

    def __init__(self, n_in: int, n_out: int, cfg: UNetConfig, *,
                 kernel: int = 3, stride: int = 1,
                 dtype: torch.dtype | None = None):
        super().__init__(n_in, n_out, kernel, stride=stride,
                         padding=kernel // 2, dtype=cfg.param_dtype)
        self.compute_dtype = dtype or cfg.dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return self._conv_forward(x.to(dt), self.weight.to(dt),
                                  self.bias.to(dt))


class GroupNorm(nn.Module):
    """flax ``GroupNorm(num_groups, epsilon=1e-6)`` over the channels of an
    NCHW (channels-last) feature map, in fp32."""

    def __init__(self, groups: int, ch: int, cfg: UNetConfig):
        super().__init__()
        self.groups = groups
        self.scale = nn.Parameter(torch.ones(ch, dtype=cfg.param_dtype))
        self.bias = nn.Parameter(torch.zeros(ch, dtype=cfg.param_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.groups, self.scale.float(),
                            self.bias.float(), NORM_EPS)


class ResBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, temb_dim: int,
                 cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        self.norm1 = GroupNorm(min(cfg.groups, in_ch), in_ch, cfg)
        self.conv1 = Conv(in_ch, out_ch, cfg)
        self.time_proj = _dense(temb_dim, out_ch, cfg)
        self.norm2 = GroupNorm(min(cfg.groups, out_ch), out_ch, cfg)
        self.conv2 = Conv(out_ch, out_ch, cfg)
        self.skip = (Conv(in_ch, out_ch, cfg, kernel=1) if in_ch != out_ch
                     else None)

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        h = F.silu(self.norm1(x).to(dt))
        h = self.conv1(h)
        h = h + self.time_proj(F.silu(temb))[:, :, None, None]
        h = F.silu(self.norm2(h).to(dt))
        h = self.conv2(h)
        if self.skip is not None:
            x = self.skip(x)
        return x + h


class Attention(nn.Module):
    """The q/k/v/o projections (no bias) of one attention of a
    :class:`SpatialTransformer`; the attention itself is
    ``attention_fn(q, k, v)``, by default ``full_attention_auto``."""

    def __init__(self, c: int, kv_dim: int, cfg: UNetConfig,
                 attention_fn=None):
        super().__init__()
        self.n_heads = cfg.n_heads
        self.attention_fn = attention_fn
        self.q_proj = _dense(c, c, cfg, bias=False)
        self.k_proj = _dense(kv_dim, c, cfg, bias=False)
        self.v_proj = _dense(kv_dim, c, cfg, bias=False)
        self.o_proj = _dense(c, c, cfg, bias=False)

    def forward(self, q_in: torch.Tensor, kv_in: torch.Tensor) -> torch.Tensor:
        from tpucfn_torch.kernels.auto import full_attention_auto

        b, _, c = q_in.shape
        hd = c // self.n_heads
        q = self.q_proj(q_in).reshape(b, -1, self.n_heads, hd)
        k = self.k_proj(kv_in).reshape(b, -1, self.n_heads, hd)
        v = self.v_proj(kv_in).reshape(b, -1, self.n_heads, hd)
        o = (self.attention_fn or full_attention_auto)(q, k, v)
        return self.o_proj(o.reshape(b, -1, c))


class SpatialTransformer(nn.Module):
    """GN -> in-projection -> [self-attention, cross-attention over the
    context, GEGLU feed-forward] -> out-projection, plus the residual."""

    def __init__(self, c: int, cfg: UNetConfig, attention_fn=None):
        super().__init__()
        self.cfg = cfg
        self.norm = GroupNorm(min(cfg.groups, c), c, cfg)
        self.proj_in = _dense(c, c, cfg)
        self.norm_self = LayerNorm(c, cfg.param_dtype, NORM_EPS)
        self.self_attn = Attention(c, c, cfg, attention_fn)
        self.norm_cross = LayerNorm(c, cfg.param_dtype, NORM_EPS)
        self.cross_attn = Attention(c, cfg.context_dim, cfg, attention_fn)
        self.norm_ff = LayerNorm(c, cfg.param_dtype, NORM_EPS)
        self.fc1 = _dense(c, c * 8, cfg)
        self.fc2 = _dense(c * 4, c, cfg)
        self.proj_out = _dense(c, c, cfg)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        b, c, hh, ww = x.shape
        h = self.norm(x).to(dt).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        h = self.proj_in(h)
        hs = self.norm_self(h).to(dt)
        h = h + self.self_attn(hs, hs)
        hc = self.norm_cross(h).to(dt)
        h = h + self.cross_attn(hc, context.to(dt))
        hf = self.norm_ff(h).to(dt)
        gate, up = self.fc1(hf).chunk(2, dim=-1)
        h = h + self.fc2(F.gelu(gate, approximate="tanh") * up)
        h = self.proj_out(h)
        return x + h.reshape(b, hh, ww, c).permute(0, 3, 1, 2)


class UNet(nn.Module):
    """``attention_fn(q, k, v)`` (B, S, H, D) non-causal attention for
    every transformer block; None: ``full_attention_auto``."""

    def __init__(self, cfg: UNetConfig, *, attention_fn=None):
        super().__init__()
        self.cfg = cfg
        w, temb_dim = cfg.base_width, cfg.base_width * 4
        self.time_fc1 = _dense(w, temb_dim, cfg)
        self.time_fc2 = _dense(temb_dim, temb_dim, cfg)
        self.conv_in = Conv(cfg.in_channels, w, cfg)
        # The reference's module names, one flat namespace.
        blocks: dict[str, nn.Module] = {}
        skip_ch, ch = [w], w
        for si, mult in enumerate(cfg.width_mults):
            out = w * mult
            for bi in range(cfg.blocks_per_stage):
                blocks[f"down{si}_res{bi}"] = ResBlock(ch, out, temb_dim, cfg)
                ch = out
                if cfg.attn_stages[si]:
                    blocks[f"down{si}_attn{bi}"] = SpatialTransformer(
                        ch, cfg, attention_fn)
                skip_ch.append(ch)
            if si != len(cfg.width_mults) - 1:
                blocks[f"down{si}_downsample"] = Conv(ch, ch, cfg, stride=2)
                skip_ch.append(ch)
        mid = w * cfg.width_mults[-1]
        blocks["mid_res1"] = ResBlock(ch, mid, temb_dim, cfg)
        blocks["mid_attn"] = SpatialTransformer(mid, cfg, attention_fn)
        blocks["mid_res2"] = ResBlock(mid, mid, temb_dim, cfg)
        ch = mid
        for si, mult in reversed(list(enumerate(cfg.width_mults))):
            out = w * mult
            for bi in range(cfg.blocks_per_stage + 1):
                blocks[f"up{si}_res{bi}"] = ResBlock(ch + skip_ch.pop(), out,
                                                     temb_dim, cfg)
                ch = out
                if cfg.attn_stages[si]:
                    blocks[f"up{si}_attn{bi}"] = SpatialTransformer(
                        ch, cfg, attention_fn)
            if si != 0:
                blocks[f"up{si}_upsample"] = Conv(ch, ch, cfg)
        for name, block in blocks.items():
            self.add_module(name, block)
        self.norm_out = GroupNorm(min(cfg.groups, ch), ch, cfg)
        self.conv_out = Conv(ch, cfg.out_channels, cfg, dtype=torch.float32)

    @classmethod
    def from_state_dict(cls, cfg: UNetConfig,
                        params: Mapping[str, torch.Tensor], *, device=None,
                        trainable: bool = False,
                        attention_fn=None) -> "UNet":
        """A model over ``params`` (the port's state dict), the tensors
        used as they are where they already sit on ``device`` in their
        storage dtype; with ``trainable`` the caller's ``nn.Parameter``
        objects stay the model's, so their gradients land where the
        trainer looks."""
        with torch.device("meta"):
            model = cls(cfg, attention_fn=attention_fn)
        return bind_state_dict(model, params, device=device,
                               trainable=trainable)

    def forward(self, latents: torch.Tensor, timesteps: torch.Tensor,
                context: torch.Tensor) -> torch.Tensor:
        """latents (B, H, W, 4) + timesteps (B,) + context (B, L, ctx) ->
        eps (B, H, W, 4), fp32."""
        cfg = self.cfg
        dt = cfg.dtype
        temb = timestep_embedding(timesteps, cfg.base_width)
        temb = self.time_fc1(temb.to(dt))
        temb = self.time_fc2(F.silu(temb))
        x = latents.to(dt).permute(0, 3, 1, 2)  # NCHW view, channels-last
        h = self.conv_in(x.contiguous(memory_format=torch.channels_last))
        skips = [h]
        for si, _ in enumerate(cfg.width_mults):
            for bi in range(cfg.blocks_per_stage):
                h = getattr(self, f"down{si}_res{bi}")(h, temb)
                if cfg.attn_stages[si]:
                    h = getattr(self, f"down{si}_attn{bi}")(h, context)
                skips.append(h)
            if si != len(cfg.width_mults) - 1:
                h = getattr(self, f"down{si}_downsample")(h)
                skips.append(h)
        h = self.mid_res1(h, temb)
        h = self.mid_attn(h, context)
        h = self.mid_res2(h, temb)
        for si, _ in reversed(list(enumerate(cfg.width_mults))):
            for bi in range(cfg.blocks_per_stage + 1):
                h = torch.cat([h, skips.pop()], dim=1)
                h = getattr(self, f"up{si}_res{bi}")(h, temb)
                if cfg.attn_stages[si]:
                    h = getattr(self, f"up{si}_attn{bi}")(h, context)
            if si != 0:
                h = F.interpolate(h, scale_factor=2, mode="nearest")
                h = getattr(self, f"up{si}_upsample")(h)
        h = F.silu(self.norm_out(h)).to(dt)
        return self.conv_out(h).permute(0, 2, 3, 1)


def init_unet_params(cfg: UNetConfig, *, generator: torch.Generator,
                     device=None) -> dict[str, torch.Tensor]:
    """Random weights from a seeded generator in flax's initializer
    families: every convolution and dense kernel lecun-normal (a normal
    truncated at ±2σ, σ = sqrt(1/fan_in)/0.8796), biases zero, norm scales
    one, and the output convolution zero.  (The numbers differ from
    JAX's; parity tests carry JAX's own weights across with
    :mod:`tpucfn_torch.models.convert`.)"""
    with torch.device("meta"):
        shapes = UNet(cfg).state_dict()
    params = {}
    for name, meta in shapes.items():
        w = torch.zeros(meta.shape, dtype=torch.float32, device=device)
        if name.endswith(".scale"):
            w.fill_(1.0)
        elif name.endswith(".weight") and not name.startswith("conv_out."):
            # (out, in[, kh, kw]): fan_in = in * kh * kw
            lecun_normal_(w, math.prod(meta.shape[1:]), generator)
        params[name] = w.to(meta.dtype)
    return params


def ddpm_noise_draws(latents: torch.Tensor, generator: torch.Generator, *,
                     num_train_timesteps: int = 1000
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(t (B,) int64, noise like ``latents``) drawn from ``generator``."""
    t = torch.randint(0, num_train_timesteps, (latents.shape[0],),
                      generator=generator, device=latents.device)
    noise = torch.randn(latents.shape, generator=generator,
                        dtype=latents.dtype, device=latents.device)
    return t, noise


def ddpm_loss_from(model: UNet, batch: Mapping[str, torch.Tensor],
                   t: torch.Tensor, noise: torch.Tensor, *,
                   num_train_timesteps: int = 1000) -> torch.Tensor:
    """eps-prediction MSE at given timesteps ``t`` and ``noise``: the
    latents noised on the linear-beta DDPM schedule, eps predicted."""
    latents, context = batch["latents"], batch["context"]
    betas = torch.linspace(1e-4, 0.02, num_train_timesteps,
                           dtype=torch.float32, device=latents.device)
    alphas_bar = torch.cumprod(1.0 - betas, dim=0)
    a = alphas_bar[t].sqrt()[:, None, None, None]
    s = (1.0 - alphas_bar[t]).sqrt()[:, None, None, None]
    noised = a * latents + s * noise
    eps = model(noised, t, context)
    return torch.mean((eps.float() - noise.float()) ** 2)


def ddpm_loss(model: UNet, batch: Mapping[str, torch.Tensor],
              generator: torch.Generator, *,
              num_train_timesteps: int = 1000) -> torch.Tensor:
    """The reference's ``ddpm_loss``: t and the noise drawn from the
    trainer's ``generator`` (the reference splits a JAX key), then
    :func:`ddpm_loss_from`."""
    t, noise = ddpm_noise_draws(batch["latents"], generator,
                                num_train_timesteps=num_train_timesteps)
    return ddpm_loss_from(model, batch, t, noise,
                          num_train_timesteps=num_train_timesteps)

