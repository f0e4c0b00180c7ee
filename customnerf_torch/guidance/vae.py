"""Stable Diffusion AutoencoderKL, NCHW (counterpart of
``customnerf_tpu/guidance/vae.py``).

Module names are diffusers' (``encoder.down_blocks.0.resnets.1``,
``encoder.mid_block.attentions.0.to_q``, ``quant_conv``).  SDS uses
``encode``: images in [-1, 1] → posterior sample × ``scaling_factor``
(0.18215 for SD 1.x/2.x, reference ``nerf/sd.py:97-105``; 0.13025 for
SDXL, whose VAE has the same layout); ``decode`` inverts it.  FLUX.1-dev's
VAE (``vae_config("flux-dev")`` in ``sds.py``) has 16 latent channels, no
``quant_conv`` / ``post_quant_conv`` and latents (z − 0.1159)·0.3611.
``sample_size`` is the side of the square image the model encodes (512,
SDXL's 1024): the editing step resizes its frame to it.

``VAEConfig.dtype`` is the compute dtype (flax's policy, ``layers.py``):
the encoder and decoder cast their input to it, the mid-block attention
takes f32 logits and softmax (``vae.py:73``), and the convolutions on the
latent side (the encoder's and decoder's ``conv_out``, ``quant_conv``,
``post_quant_conv``) compute in f32, as the JAX package's
``dtype=jnp.float32`` convs do: the moments, the posterior sample and the
decoded image are f32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from customnerf_torch.guidance.layers import (Conv2d, Downsample2D, GroupNorm,
                                              Linear, ResnetBlock2D, Upsample2D,
                                              compute_dtype)


@dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    sample_size: int = 512
    scaling_factor: float = 0.18215
    # FLUX's VAE: no 1×1 convs around the latents, and latents shifted
    # before they are scaled; SD's defaults keep its modules as they were
    use_quant_conv: bool = True
    use_post_quant_conv: bool = True
    shift_factor: Optional[float] = None
    dtype: str = "float32"      # the compute dtype: "float32" | "bfloat16"

    @property
    def compute_dtype(self) -> torch.dtype:
        return compute_dtype(self.dtype)


class VAEAttention(nn.Module):
    """Single-head mid-block attention with linear q/k/v/out."""

    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.group_norm = GroupNorm(groups, channels, eps=1e-6)
        self.to_q = Linear(channels, channels)
        self.to_k = Linear(channels, channels)
        self.to_v = Linear(channels, channels)
        self.to_out = nn.ModuleList([Linear(channels, channels)])

    def forward(self, x):
        b, c, h, w = x.shape
        res = x
        x = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        q, k, v = self.to_q(x), self.to_k(x), self.to_v(x)
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(c))
        x = self.to_out[0](torch.matmul(scores.softmax(dim=-1).to(v.dtype), v))
        # the residual first: the sum keeps its contiguous NCHW layout (the
        # first operand's), so the next GroupNorm needs no NCHW copy of it
        return res + x.reshape(b, h, w, c).permute(0, 3, 1, 2)


class _Level(nn.Module):
    def __init__(self, in_ch, out_ch, layers, groups, sampler=None):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(in_ch if j == 0 else out_ch, out_ch, None, groups,
                           eps=1e-6) for j in range(layers)])
        if sampler == "down":
            self.downsamplers = nn.ModuleList(
                [Downsample2D(out_ch, asymmetric_pad=True)])
        elif sampler == "up":
            self.upsamplers = nn.ModuleList([Upsample2D(out_ch)])

    def forward(self, h):
        for resnet in self.resnets:
            h = resnet(h)
        for s in getattr(self, "downsamplers", getattr(self, "upsamplers", [])):
            h = s(h)
        return h


class _Mid(nn.Module):
    def __init__(self, ch, groups):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(ch, ch, None, groups, eps=1e-6) for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttention(ch, groups)])

    def forward(self, h):
        return self.resnets[1](self.attentions[0](self.resnets[0](h)))


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch, g = list(cfg.block_out_channels), cfg.norm_num_groups
        self.conv_in = Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        self.down_blocks = nn.ModuleList(
            [_Level(ch[max(i - 1, 0)], ch[i], cfg.layers_per_block, g,
                    "down" if i < len(ch) - 1 else None)
             for i in range(len(ch))])
        self.mid_block = _Mid(ch[-1], g)
        self.conv_norm_out = GroupNorm(g, ch[-1], eps=1e-6)
        self.conv_out = Conv2d(ch[-1], 2 * cfg.latent_channels, 3, padding=1,
                               f32=True)
        self.compute_dtype = cfg.compute_dtype

    def forward(self, x):
        # contiguous NCHW from the cast on (a rendered image may come in
        # channels-last, and the convs would keep it so): the layout the
        # GroupNorms' kernel reads, so none of them copies its input
        h = self.conv_in(x.to(self.compute_dtype, memory_format=torch.contiguous_format))
        for blk in self.down_blocks:
            h = blk(h)
        h = self.mid_block(h)
        return self.conv_out(self.conv_norm_out(h, silu=True))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        rev, g = list(reversed(cfg.block_out_channels)), cfg.norm_num_groups
        self.conv_in = Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = _Mid(rev[0], g)
        self.up_blocks = nn.ModuleList(
            [_Level(rev[max(i - 1, 0)], rev[i], cfg.layers_per_block + 1, g,
                    "up" if i < len(rev) - 1 else None)
             for i in range(len(rev))])
        self.conv_norm_out = GroupNorm(g, rev[-1], eps=1e-6)
        self.conv_out = Conv2d(rev[-1], cfg.in_channels, 3, padding=1, f32=True)
        self.compute_dtype = cfg.compute_dtype

    def forward(self, z):
        h = self.mid_block(self.conv_in(z.to(self.compute_dtype)))
        for blk in self.up_blocks:
            h = blk(h)
        return self.conv_out(self.conv_norm_out(h, silu=True))


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: VAEConfig = VAEConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        if cfg.use_quant_conv:
            self.quant_conv = Conv2d(2 * cfg.latent_channels,
                                     2 * cfg.latent_channels, 1, f32=True)
        if cfg.use_post_quant_conv:
            self.post_quant_conv = Conv2d(cfg.latent_channels,
                                          cfg.latent_channels, 1, f32=True)

    def moments(self, images):
        """images [B, 3, H, W] in [-1, 1] → (mean, logvar), each
        [B, latent_channels, H/8, W/8]."""
        h = self.encoder(images)
        if self.cfg.use_quant_conv:
            h = self.quant_conv(h)
        mean, logvar = h.chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def encode(self, images, generator=None, noise=None):
        """Sample the posterior, shift (FLUX) and scale.  The noise is
        ``noise`` when given, else drawn from ``generator``."""
        mean, logvar = self.moments(images)
        if noise is None:
            noise = torch.randn(mean.shape, generator=generator,
                                device=mean.device, dtype=mean.dtype)
        z = mean + torch.exp(0.5 * logvar) * noise
        if self.cfg.shift_factor is not None:
            z = z - self.cfg.shift_factor
        return z * self.cfg.scaling_factor

    def decode(self, latents):
        z = latents / self.cfg.scaling_factor
        if self.cfg.shift_factor is not None:
            z = z + self.cfg.shift_factor
        if self.cfg.use_post_quant_conv:
            z = self.post_quant_conv(z)
        return self.decoder(z)
