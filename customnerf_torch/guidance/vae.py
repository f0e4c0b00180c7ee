"""Stable Diffusion AutoencoderKL, NCHW (counterpart of
``customnerf_tpu/guidance/vae.py``).

Module names are diffusers' (``encoder.down_blocks.0.resnets.1``,
``encoder.mid_block.attentions.0.to_q``, ``quant_conv``).  SDS uses
``encode``: images in [-1, 1] → posterior sample × 0.18215
(reference ``nerf/sd.py:97-105``); ``decode`` inverts it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from customnerf_torch.guidance.layers import (Downsample2D, ResnetBlock2D,
                                              Upsample2D)


@dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215


class VAEAttention(nn.Module):
    """Single-head mid-block attention with linear q/k/v/out."""

    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, channels, eps=1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x):
        b, c, h, w = x.shape
        res = x
        x = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        q, k, v = self.to_q(x), self.to_k(x), self.to_v(x)
        scores = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(c))
        x = self.to_out[0](torch.matmul(scores.softmax(dim=-1), v))
        return x.reshape(b, h, w, c).permute(0, 3, 1, 2) + res


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
        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        self.down_blocks = nn.ModuleList(
            [_Level(ch[max(i - 1, 0)], ch[i], cfg.layers_per_block, g,
                    "down" if i < len(ch) - 1 else None)
             for i in range(len(ch))])
        self.mid_block = _Mid(ch[-1], g)
        self.conv_norm_out = nn.GroupNorm(g, ch[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(ch[-1], 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for blk in self.down_blocks:
            h = blk(h)
        h = self.mid_block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        rev, g = list(reversed(cfg.block_out_channels)), cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = _Mid(rev[0], g)
        self.up_blocks = nn.ModuleList(
            [_Level(rev[max(i - 1, 0)], rev[i], cfg.layers_per_block + 1, g,
                    "up" if i < len(rev) - 1 else None)
             for i in range(len(rev))])
        self.conv_norm_out = nn.GroupNorm(g, rev[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(rev[-1], cfg.in_channels, 3, padding=1)

    def forward(self, z):
        h = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            h = blk(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: VAEConfig = VAEConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = nn.Conv2d(2 * cfg.latent_channels,
                                    2 * cfg.latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(cfg.latent_channels,
                                         cfg.latent_channels, 1)

    def moments(self, images):
        """images [B, 3, H, W] in [-1, 1] → (mean, logvar), each
        [B, 4, H/8, W/8]."""
        mean, logvar = self.quant_conv(self.encoder(images)).chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def encode(self, images, generator=None, noise=None):
        """Sample the posterior and scale.  The noise is ``noise`` when given,
        else drawn from ``generator``."""
        mean, logvar = self.moments(images)
        if noise is None:
            noise = torch.randn(mean.shape, generator=generator,
                                device=mean.device, dtype=mean.dtype)
        return (mean + torch.exp(0.5 * logvar) * noise) * self.cfg.scaling_factor

    def decode(self, latents):
        return self.decoder(self.post_quant_conv(latents / self.cfg.scaling_factor))
