"""Plain PyTorch Stable Diffusion XL base 1.0: its UNet with the "text_time"
conditioning and its two CLIP text towers with their pooling rule, written
from the published configs (huggingface.co/stabilityai/
stable-diffusion-xl-base-1.0: ``unet/config.json``, ``text_encoder/``,
``text_encoder_2/``; the SDXL report, arXiv:2307.01952).  Run here in f32
with TF32 off as the reference that decides ``correct``; the VAE is SD's
AutoencoderKL (``sd.py``) at 1024² with scaling 0.13025.  Parameter names
are diffusers' and Hugging Face's, so one state dict loads into this module
and into the program's.

The UNet (x: [B, 4, h, w] latents, t: [B] timesteps, c: [B, 77, 2048]
context, p: [B, 1280] pooled text embedding, ids: [B, 6] time ids):

    e      = W2·SiLU(W1·sin(t) + b1) + b2             sin(t): [cos | sin] of t·f_k,
                                                      f_k = 10000^(−k/160), k < 160
    e     += A2·SiLU(A1·[p | sin256(ids_1) … sin256(ids_6)] + a1) + a2   (2816 → 1280)
    h      = conv_in(x)
    level i of (320, 640, 1280), 2 resnets a level, each resnet
           h = h + conv2(SiLU(GN(conv1(SiLU(GN(h))) + P·SiLU(e))))   (1×1 shortcut
                                                      where the width changes)
    followed at levels 1 and 2 (CrossAttn blocks; level 0 is DownBlock2D)
    by a transformer of (1, 2, 10)[i] blocks:
           u = Lin_in(GN(h)) as tokens; each block
           u += Attn(LN(u)); u += Attn(LN(u), c); u += W·(a ⊙ GELU(g)), [a | g] = V·LN(u)
           h = h + Lin_out(u)
    a stride-2 3×3 conv after levels 0 and 1; the mid block: resnet,
    transformer of 10 blocks, resnet; the up path mirrors the down path
    with 3 resnets a level on the skips concatenated, nearest ×2 then a
    3×3 conv after the two deeper levels; ε = conv_out(SiLU(GN(h))).
    Heads are 64 wide (5, 10, 20 a level); attention is softmax(q·kᵀ/8)·v.

Time ids: (original height, width, crop top, left, target height, width);
the base pipeline's defaults at 1024² are (1024, 1024, 0, 0, 1024, 1024).

The text towers: CLIP ViT-L/14 (12 layers, 768 wide, quick GELU) and
OpenCLIP ViT-bigG/14 (32 layers, 1280 wide, 20 heads, an MLP of 5120, exact
GELU, a bias-free 1280 projection), pre-LayerNorm layers under a causal
mask.  The context is each tower's penultimate hidden state (the input of
its last layer), concatenated to [77, 2048]; the pooled embedding is bigG's
projection of its final-LayerNorm state at the first EOS.  An empty
negative prompt gives zeros for both (``force_zeros_for_empty_prompt``).

Departures: diffusers' ``tokenizer_2`` pads with "!" where both tokenizers
here are left to the caller (the reference takes ids); the UNet's compute
dtype follows ``sd.py``'s policy (f32 logits and softmax), which in f32 is
plain attention.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.sd import (BasicTransformerBlock, Conv2d, Downsample2D,
                                    GroupNorm, Linear, ResnetBlock2D, TimestepEmbedding,
                                    Upsample2D, compute_dtype, timestep_embedding)


@dataclass(frozen=True)
class UNetConfig:
    """``unet/config.json`` of SDXL base 1.0 by default."""
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 2048
    attention_head_dim: Tuple[int, ...] = (5, 10, 20)      # head counts a level
    norm_num_groups: int = 32
    down_block_types: Tuple[str, ...] = ("DownBlock2D", "CrossAttnDownBlock2D",
                                         "CrossAttnDownBlock2D")
    up_block_types: Tuple[str, ...] = ("CrossAttnUpBlock2D", "CrossAttnUpBlock2D",
                                       "UpBlock2D")
    transformer_layers_per_block: Tuple[int, ...] = (1, 2, 10)
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 2816
    dtype: str = "float32"

    @property
    def compute_dtype(self) -> torch.dtype:
        return compute_dtype(self.dtype)


def unet_config(d: dict, dtype: str = "float32") -> UNetConfig:
    """The config for a configuration file's ``unet`` block."""
    names = set(UNetConfig.__dataclass_fields__) - {"dtype"}
    return UNetConfig(dtype=dtype, **{k: tuple(v) if isinstance(v, list) else v
                                      for k, v in d.items() if k in names})


class Transformer(nn.Module):
    """``use_linear_projection``: GroupNorm, the tokens, a linear in,
    ``depth`` transformer blocks, a linear out, the residual."""

    def __init__(self, ch: int, heads: int, ctx: int, groups: int, depth: int):
        super().__init__()
        self.norm = GroupNorm(groups, ch, eps=1e-6)
        self.proj_in = Linear(ch, ch)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(ch, heads, ch // heads, ctx) for _ in range(depth)])
        self.proj_out = Linear(ch, ch)

    def forward(self, x, context):
        b, c, h, w = x.shape
        u = self.proj_in(self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c))
        for block in self.transformer_blocks:
            u = block(u, context)
        return self.proj_out(u).reshape(b, h, w, c).permute(0, 3, 1, 2) + x


class Level(nn.Module):
    """A down or up block: resnets, a transformer after each where the
    block type attends, and a resampler."""

    def __init__(self, in_chs, out_ch, temb, cfg, level: int, attends: bool, sampler):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(c, out_ch, temb, cfg.norm_num_groups) for c in in_chs])
        if attends:
            self.attentions = nn.ModuleList(
                [Transformer(out_ch, cfg.attention_head_dim[level], cfg.cross_attention_dim,
                             cfg.norm_num_groups, cfg.transformer_layers_per_block[level])
                 for _ in in_chs])
        if sampler == "down":
            self.downsamplers = nn.ModuleList([Downsample2D(out_ch)])
        elif sampler == "up":
            self.upsamplers = nn.ModuleList([Upsample2D(out_ch)])

    def step(self, j, h, temb, context):
        h = self.resnets[j](h, temb)
        return self.attentions[j](h, context) if hasattr(self, "attentions") else h


class UNet(nn.Module):
    """``forward(sample, timesteps, context, text_embeds, time_ids) → ε``."""

    def __init__(self, cfg: UNetConfig = UNetConfig()):
        super().__init__()
        self.cfg = cfg
        ch, L, n = list(cfg.block_out_channels), cfg.layers_per_block, len(cfg.block_out_channels)
        temb = 4 * ch[0]
        self.conv_in = Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch[0], temb)
        self.add_embedding = TimestepEmbedding(cfg.projection_class_embeddings_input_dim, temb)
        self.down_blocks = nn.ModuleList()
        skips = [ch[0]]
        for i in range(n):
            ins = [ch[i - 1] if i else ch[0]] + [ch[i]] * (L - 1)
            down = i < n - 1
            self.down_blocks.append(Level(ins, ch[i], temb, cfg, i,
                                          cfg.down_block_types[i].startswith("CrossAttn"),
                                          "down" if down else None))
            skips += [ch[i]] * (L + 1 if down else L)
        self.mid_block = Level([ch[-1], ch[-1]], ch[-1], temb, cfg, n - 1, False, None)
        self.mid_block.attentions = nn.ModuleList(
            [Transformer(ch[-1], cfg.attention_head_dim[-1], cfg.cross_attention_dim,
                         cfg.norm_num_groups, cfg.transformer_layers_per_block[-1])])
        self.up_blocks = nn.ModuleList()
        prev = ch[-1]
        for k in range(n):
            i = n - 1 - k                                   # the level
            ins = [(prev if j == 0 else ch[i]) + skips.pop() for j in range(L + 1)]
            self.up_blocks.append(Level(ins, ch[i], temb, cfg, i,
                                        cfg.up_block_types[k].startswith("CrossAttn"),
                                        "up" if i > 0 else None))
            prev = ch[i]
        self.conv_norm_out = GroupNorm(cfg.norm_num_groups, ch[0], eps=1e-5)
        self.conv_out = Conv2d(ch[0], cfg.out_channels, 3, padding=1, f32=True)

    def forward(self, sample, timesteps, context, text_embeds, time_ids):
        cfg, dt = self.cfg, self.cfg.compute_dtype
        B = sample.shape[0]
        t = torch.as_tensor(timesteps, device=sample.device).reshape(-1).expand(B)
        e = self.time_embedding(timestep_embedding(t, cfg.block_out_channels[0]).to(dt))
        ids = timestep_embedding(time_ids.reshape(-1), cfg.addition_time_embed_dim)
        e = e + self.add_embedding(
            torch.cat([text_embeds.float(), ids.reshape(B, -1)], dim=-1).to(dt))
        context = context.to(dt)
        h = self.conv_in(sample.to(dt))
        states = [h]
        for blk in self.down_blocks:
            for j in range(len(blk.resnets)):
                h = blk.step(j, h, e, context)
                states.append(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
                states.append(h)
        mid = self.mid_block
        h = mid.resnets[1](mid.attentions[0](mid.resnets[0](h, e), context), e)
        for blk in self.up_blocks:
            for j in range(len(blk.resnets)):
                h = blk.step(j, torch.cat([h, states.pop()], dim=1), e, context)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


# ---- the text towers
@dataclass(frozen=True)
class TextConfig:
    """CLIP ViT-L/14's text tower by default (SDXL's ``text_encoder``)."""
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    hidden_act: str = "quick_gelu"
    vocab_size: int = 49408
    max_position_embeddings: int = 77
    eos_token_id: int = 49407
    projection_dim: int = 0           # 0: no text_projection


BIGG = TextConfig(hidden_size=1280, intermediate_size=5120, num_hidden_layers=32,
                  num_attention_heads=20, hidden_act="gelu", projection_dim=1280)


class _Attention(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj = nn.Linear(dim, dim), nn.Linear(dim, dim)
        self.v_proj, self.out_proj = nn.Linear(dim, dim), nn.Linear(dim, dim)

    def forward(self, x, mask):
        b, n, dim = x.shape
        d = dim // self.heads
        q, k, v = (p(x).view(b, n, self.heads, d).transpose(1, 2)
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        w = torch.softmax((q @ k.transpose(-1, -2)) / d ** 0.5 + mask, dim=-1)
        return self.out_proj((w @ v).transpose(1, 2).reshape(b, n, dim))


class _MLP(nn.Module):
    def __init__(self, dim, inner, act):
        super().__init__()
        self.fc1, self.fc2 = nn.Linear(dim, inner), nn.Linear(inner, dim)
        self.act = act

    def forward(self, x):
        h = self.fc1(x)
        h = h * torch.sigmoid(1.702 * h) if self.act == "quick_gelu" else F.gelu(h)
        return self.fc2(h)


class _Layer(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size)
        self.self_attn = _Attention(cfg.hidden_size, cfg.num_attention_heads)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size)
        self.mlp = _MLP(cfg.hidden_size, cfg.intermediate_size, cfg.hidden_act)

    def forward(self, x, mask):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)


class _Encoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.layers = nn.ModuleList([_Layer(cfg) for _ in range(cfg.num_hidden_layers)])


class _TextModel(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size)


class TextTower(nn.Module):
    """Hugging Face's ``CLIPTextModel`` (``CLIPTextModelWithProjection``
    with a ``projection_dim``) names."""

    def __init__(self, cfg: TextConfig = TextConfig()):
        super().__init__()
        self.cfg = cfg
        self.text_model = _TextModel(cfg)
        if cfg.projection_dim:
            self.text_projection = nn.Linear(cfg.hidden_size, cfg.projection_dim, bias=False)

    def forward(self, ids):
        """ids [B, 77] → (the penultimate hidden state [B, 77, D], the
        projected pooled state [B, projection] or None)."""
        m = self.text_model
        n = ids.shape[1]
        x = m.embeddings.token_embedding(ids) + m.embeddings.position_embedding(
            torch.arange(n, device=ids.device))[None]
        mask = torch.full((n, n), float("-inf"), device=ids.device).triu(1)
        states = [x]
        for layer in m.encoder.layers:
            states.append(layer(states[-1], mask))
        if not self.cfg.projection_dim:
            return states[-2], None
        last = m.final_layer_norm(states[-1])
        eos = (ids == self.cfg.eos_token_id).int().argmax(dim=-1)
        return states[-2], self.text_projection(last[torch.arange(ids.shape[0]), eos])


def text_embeds(tower_1: TextTower, tower_2: TextTower, ids_1, ids_2, empty=None):
    """The context [B, 77, D1 + D2] and the pooled embedding [B, P] of
    prompts tokenized for each tower; rows where ``empty`` ([B] bool, an
    empty negative prompt) holds are zeros in both."""
    pen_1, _ = tower_1(ids_1)
    pen_2, pooled = tower_2(ids_2)
    context = torch.cat([pen_1, pen_2], dim=-1)
    if empty is not None:
        keep = (~empty).float()
        context, pooled = context * keep[:, None, None], pooled * keep[:, None]
    return context, pooled
