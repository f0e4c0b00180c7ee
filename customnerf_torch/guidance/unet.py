"""Stable Diffusion UNet2DConditionModel, NCHW (counterpart of
``customnerf_tpu/guidance/unet.py``).

Module names are diffusers' state-dict keys (``down_blocks.0.resnets.1``,
``…attentions.0.transformer_blocks.0.attn1.to_out.0``), so a diffusers UNet
loads with ``load_state_dict`` as is.  SD 1.x layout: 1×1-conv
``proj_in``/``proj_out``, exact-erf GEGLU, cross-attention without q/k/v
biases.  Attention is computed as the JAX package computes it: matmul →
softmax → matmul in plain PyTorch, which at 64×64 latents and batch 2
materialises 2×8×4096×4096 f32 scores (1.07 GB) per self-attention call.
Custom Diffusion's K/V overrides (``cd_kv``) are not ported.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from customnerf_torch.guidance.layers import (Downsample2D, ResnetBlock2D,
                                              Upsample2D)


@dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    # diffusers' (misnamed) attention_head_dim: head COUNTS, an int for every
    # level (SD 1.5: 8) or one per level
    attention_head_dim: Union[int, Tuple[int, ...]] = 8
    norm_num_groups: int = 32

    def heads_at(self, level: int) -> int:
        hd = self.attention_head_dim
        return int(hd[level]) if isinstance(hd, (tuple, list)) else int(hd)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: int = 10000):
    """SD's sinusoidal embedding with flip_sin_to_cos: [cos | sin]."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device)
                      / half)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, t):
        return self.linear_2(F.silu(self.linear_1(t)))


def attention(q, k, v, heads: int):
    """[b, n, h·d] queries against [b, m, h·d] keys/values: matmul →
    softmax → matmul, in the input's dtype."""
    b, n, inner = q.shape
    m = k.shape[1]
    d = inner // heads
    q = q.view(b, n, heads, d).transpose(1, 2)
    k = k.view(b, m, heads, d).transpose(1, 2)
    v = v.view(b, m, heads, d).transpose(1, 2)
    scores = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    out = torch.matmul(scores.softmax(dim=-1), v)
    return out.transpose(1, 2).reshape(b, n, inner)


class Attention(nn.Module):
    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 context_dim: int | None = None):
        super().__init__()
        inner = heads * dim_head
        ctx = context_dim or query_dim
        self.heads = heads
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(ctx, inner, bias=False)
        self.to_v = nn.Linear(ctx, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim)])

    def forward(self, x, context=None):
        context = x if context is None else context
        out = attention(self.to_q(x), self.to_k(context), self.to_v(context),
                        self.heads)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)          # exact erf gelu, as diffusers


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        # net.1 is diffusers' dropout: no parameters
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(),
                                  nn.Linear(dim * mult, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, ctx_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn1 = Attention(dim, heads, dim_head)
        self.norm2 = nn.LayerNorm(dim)
        self.attn2 = Attention(dim, heads, dim_head, context_dim=ctx_dim)
        self.norm3 = nn.LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2DModel(nn.Module):
    """GroupNorm → 1×1 conv → one transformer block → 1×1 conv, residual."""

    def __init__(self, channels: int, heads: int, ctx_dim: int, groups: int):
        super().__init__()
        self.norm = nn.GroupNorm(groups, channels, eps=1e-6)
        self.proj_in = nn.Conv2d(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(channels, heads, channels // heads, ctx_dim)])
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x, context):
        b, c, h, w = x.shape
        res = x
        x = self.proj_in(self.norm(x))
        x = x.permute(0, 2, 3, 1).reshape(b, h * w, c)
        x = self.transformer_blocks[0](x, context)
        x = x.reshape(b, h, w, c).permute(0, 3, 1, 2)
        return self.proj_out(x) + res


class _Block(nn.Module):
    """A down or up level: ``resnets``, optional ``attentions`` and
    ``downsamplers``/``upsamplers`` (diffusers' names)."""

    def __init__(self, in_chs, out_ch, temb_ch, groups, heads, ctx_dim,
                 has_attn, sampler=None):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(c, out_ch, temb_ch, groups) for c in in_chs])
        if has_attn:
            # one a resnet; the mid block (has_attn=1) has one for two
            n_attn = len(in_chs) if has_attn is True else int(has_attn)
            self.attentions = nn.ModuleList(
                [Transformer2DModel(out_ch, heads, ctx_dim, groups)
                 for _ in range(n_attn)])
        if sampler == "down":
            self.downsamplers = nn.ModuleList([Downsample2D(out_ch)])
        elif sampler == "up":
            self.upsamplers = nn.ModuleList([Upsample2D(out_ch)])


class UNet2DCondition(nn.Module):
    """``forward(sample [B, 4, h, w], timesteps [B] or scalar,
    context [B, 77, D]) → ε [B, 4, h, w]``."""

    def __init__(self, cfg: UNetConfig = UNetConfig()):
        super().__init__()
        self.cfg = cfg
        ch = list(cfg.block_out_channels)
        n = len(ch)
        temb_ch = ch[0] * 4
        groups, ctx, L = cfg.norm_num_groups, cfg.cross_attention_dim, cfg.layers_per_block

        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch[0], temb_ch)

        self.down_blocks = nn.ModuleList()
        skips = [ch[0]]
        for i in range(n):
            last = i == n - 1
            in_chs = [ch[max(i - 1, 0)]] + [ch[i]] * (L - 1)
            self.down_blocks.append(_Block(
                in_chs, ch[i], temb_ch, groups, cfg.heads_at(i), ctx,
                has_attn=not last, sampler=None if last else "down"))
            skips += [ch[i]] * (L if last else L + 1)

        self.mid_block = _Block([ch[-1], ch[-1]], ch[-1], temb_ch, groups,
                                cfg.heads_at(n - 1), ctx, has_attn=1)

        self.up_blocks = nn.ModuleList()
        rev = list(reversed(ch))
        prev = ch[-1]
        for i in range(n):
            skip = [skips.pop() for _ in range(L + 1)]
            in_chs = [(prev if j == 0 else rev[i]) + skip[j] for j in range(L + 1)]
            self.up_blocks.append(_Block(
                in_chs, rev[i], temb_ch, groups, cfg.heads_at(n - 1 - i), ctx,
                has_attn=i > 0, sampler="up" if i < n - 1 else None))
            prev = rev[i]

        self.conv_norm_out = nn.GroupNorm(groups, ch[0], eps=1e-5)
        self.conv_out = nn.Conv2d(ch[0], cfg.out_channels, 3, padding=1)

    def forward(self, sample, timesteps, context):
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.ndim == 0:
            timesteps = timesteps[None]
        temb = self.time_embedding(
            timestep_embedding(timesteps, self.cfg.block_out_channels[0]))
        temb = temb.expand(sample.shape[0], -1)

        h = self.conv_in(sample)
        skips = [h]
        for blk in self.down_blocks:
            for j, resnet in enumerate(blk.resnets):
                h = resnet(h, temb)
                if hasattr(blk, "attentions"):
                    h = blk.attentions[j](h, context)
                skips.append(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
                skips.append(h)

        mid = self.mid_block
        h = mid.resnets[1](mid.attentions[0](mid.resnets[0](h, temb), context), temb)

        for blk in self.up_blocks:
            for j, resnet in enumerate(blk.resnets):
                h = resnet(torch.cat([h, skips.pop()], dim=1), temb)
                if hasattr(blk, "attentions"):
                    h = blk.attentions[j](h, context)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))
