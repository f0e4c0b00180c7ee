"""Plain PyTorch Stable Diffusion UNet2DConditionModel, AutoencoderKL and
DDPM schedule: a frozen copy of the port's modules (diffusers' state-dict
names, NCHW), run here in f32 as the reference that decides ``correct``.

Each model follows flax's compute-dtype policy through its config's
``dtype``: the reference runs "float32"; the control of ``correct`` runs
"bfloat16" with every Linear and Conv2d operand rounded to fp8 (e4m3, one
scale a tensor: :func:`set_fp8`), the precision below the bf16 that the
configuration states for the UNet and the VAE.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

FP8_MAX = 448.0           # the largest finite float8_e4m3fn


class _FP8(torch.autograd.Function):
    """Round to fp8 e4m3 under one scale for the tensor; the gradient goes
    through unchanged (the backward's products then take the rounded
    operands that the forward saved)."""

    @staticmethod
    def forward(ctx, x):
        s = x.detach().abs().amax().float().clamp(min=1e-30) / FP8_MAX
        return ((x.float() / s).to(torch.float8_e4m3fn).float() * s).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to fp8 e4m3 under one scale for the tensor, back in
    its dtype."""
    return _FP8.apply(x)


def set_fp8(model: nn.Module) -> nn.Module:
    """Round the operands of every Linear and Conv2d of ``model`` to fp8."""
    for m in model.modules():
        if isinstance(m, (Linear, Conv2d)):
            m.fp8 = True
    return model


# ---- layers
def _like(t, x):
    return None if t is None else t.to(x.dtype)


def _q(m, t):
    return fp8_round(t) if m.fp8 and t is not None else t


class Linear(nn.Linear):
    """``nn.Linear`` in its input's dtype, the weights cast at use."""
    fp8 = False

    def forward(self, x):
        return F.linear(_q(self, x), _q(self, _like(self.weight, x)),
                        _like(self.bias, x))


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` in its input's dtype, the weights cast at use; in f32
    whatever its input with ``f32=True``."""

    fp8 = False

    def __init__(self, *args, f32: bool = False, **kw):
        super().__init__(*args, **kw)
        self.f32 = f32

    def forward(self, x):
        if self.f32:
            x = x.float()
        return self._conv_forward(_q(self, x), _q(self, _like(self.weight, x)),
                                  _like(self.bias, x))


class GroupNorm(nn.GroupNorm):
    """Statistics and normalisation in f32, the input's dtype out."""

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


class LayerNorm(nn.LayerNorm):
    """Statistics and normalisation in f32, the input's dtype out."""

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


class ResnetBlock2D(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, temb_ch: Optional[int],
                 groups: int, eps: float = 1e-5):
        super().__init__()
        self.norm1 = GroupNorm(groups, in_ch, eps=eps)
        self.conv1 = Conv2d(in_ch, out_ch, 3, padding=1)
        if temb_ch:
            self.time_emb_proj = Linear(temb_ch, out_ch)
        self.norm2 = GroupNorm(groups, out_ch, eps=eps)
        self.conv2 = Conv2d(out_ch, out_ch, 3, padding=1)
        if in_ch != out_ch:
            self.conv_shortcut = Conv2d(in_ch, out_ch, 1)

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class Downsample2D(nn.Module):
    """Stride-2 3×3 conv; the VAE encoder pads (0, 1, 0, 1) first."""

    def __init__(self, channels: int, asymmetric_pad: bool = False):
        super().__init__()
        self.asymmetric_pad = asymmetric_pad
        self.conv = Conv2d(channels, channels, 3, stride=2,
                           padding=0 if asymmetric_pad else 1)

    def forward(self, x):
        if self.asymmetric_pad:
            x = F.pad(x, (0, 1, 0, 1))
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


def build(cls, *args, device=None, **kw):
    """Construct ``cls(*args, **kw)`` with uninitialised parameters on
    ``device``; the caller loads its weights."""
    with torch.device("meta"):
        module = cls(*args, **kw)
    return module.to_empty(device=torch.device(device or "cpu"))


def compute_dtype(name: str) -> torch.dtype:
    """A config's ``dtype`` name ("float32" | "bfloat16") as a torch dtype."""
    if name not in ("float32", "bfloat16"):
        raise ValueError(f"dtype must be float32|bfloat16, got {name}")
    return getattr(torch, name)



# ---- unet
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
    dtype: str = "float32"      # the compute dtype: "float32" | "bfloat16"

    @property
    def compute_dtype(self) -> torch.dtype:
        return compute_dtype(self.dtype)

    def heads_at(self, level: int) -> int:
        hd = self.attention_head_dim
        return int(hd[level]) if isinstance(hd, (tuple, list)) else int(hd)


def sd2_unet_config(dtype: str = "float32") -> UNetConfig:
    """SD 2.0/2.1 (the JAX package's ``sd2_unet_config``): a 1024-wide
    context and (5, 10, 20, 20) heads, 64 wide at every level.  diffusers
    stores 2.x's ``proj_in``/``proj_out`` as linear layers
    (``use_linear_projection``); they are the 1×1 convs here, and
    ``weights.py`` reshapes them."""
    return UNetConfig(cross_attention_dim=1024, attention_head_dim=(5, 10, 20, 20),
                      dtype=dtype)


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
        self.linear_1 = Linear(in_dim, dim)
        self.linear_2 = Linear(dim, dim)

    def forward(self, t):
        return self.linear_2(F.silu(self.linear_1(t)))


def attention(q, k, v, heads: int):
    """[b, n, h·d] queries against [b, m, h·d] keys/values: the logits and
    the softmax in f32 (products of the inputs' values, exact in f32, summed
    in f32), the probabilities cast to the values' dtype for the value
    product."""
    b, n, inner = q.shape
    m = k.shape[1]
    d = inner // heads
    q = q.view(b, n, heads, d).transpose(1, 2)
    k = k.view(b, m, heads, d).transpose(1, 2)
    v = v.view(b, m, heads, d).transpose(1, 2)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(d))
    out = torch.matmul(scores.softmax(dim=-1).to(v.dtype), v)
    return out.transpose(1, 2).reshape(b, n, inner)


class Attention(nn.Module):
    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 context_dim: int | None = None):
        super().__init__()
        inner = heads * dim_head
        ctx = context_dim or query_dim
        self.heads = heads
        self.to_q = Linear(query_dim, inner, bias=False)
        self.to_k = Linear(ctx, inner, bias=False)
        self.to_v = Linear(ctx, inner, bias=False)
        self.to_out = nn.ModuleList([Linear(inner, query_dim)])

    def forward(self, x, context=None, cd_kv=None):
        """``cd_kv``: Custom Diffusion weights replacing K and V (and Q and
        the output projection where the entry has them), cast to the
        compute dtype at use (the adapters stay f32 master weights)."""
        context = x if context is None else context
        kv = cd_kv or {}

        def proj(name, inp):
            if name in kv:
                return F.linear(inp, kv[name].to(inp.dtype))
            return getattr(self, name)(inp)

        out = attention(proj("to_q", x), proj("to_k", context), proj("to_v", context),
                        self.heads)
        if "to_out" in kv:
            return F.linear(out, kv["to_out"].to(out.dtype),
                            kv["to_out_bias"].to(out.dtype))
        return self.to_out[0](out)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = Linear(dim, inner * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)          # exact erf gelu, as diffusers


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        # net.1 is diffusers' dropout: no parameters
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(),
                                  Linear(dim * mult, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, ctx_dim: int):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn1 = Attention(dim, heads, dim_head)
        self.norm2 = LayerNorm(dim)
        self.attn2 = Attention(dim, heads, dim_head, context_dim=ctx_dim)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context, cd_kv=None):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context, cd_kv)
        return x + self.ff(self.norm3(x))


class Transformer2DModel(nn.Module):
    """GroupNorm → 1×1 conv → one transformer block → 1×1 conv, residual."""

    def __init__(self, channels: int, heads: int, ctx_dim: int, groups: int):
        super().__init__()
        self.norm = GroupNorm(groups, channels, eps=1e-6)
        self.proj_in = Conv2d(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(channels, heads, channels // heads, ctx_dim)])
        self.proj_out = Conv2d(channels, channels, 1)

    def forward(self, x, context, cd_kv=None):
        b, c, h, w = x.shape
        res = x
        x = self.proj_in(self.norm(x))
        x = x.permute(0, 2, 3, 1).reshape(b, h * w, c)
        x = self.transformer_blocks[0](x, context, cd_kv)
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
    context [B, 77, D], cd_kv=None) → ε [B, 4, h, w]``."""

    def __init__(self, cfg: UNetConfig = UNetConfig()):
        super().__init__()
        self.cfg = cfg
        ch = list(cfg.block_out_channels)
        n = len(ch)
        temb_ch = ch[0] * 4
        groups, ctx, L = cfg.norm_num_groups, cfg.cross_attention_dim, cfg.layers_per_block

        self.conv_in = Conv2d(cfg.in_channels, ch[0], 3, padding=1)
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

        self.conv_norm_out = GroupNorm(groups, ch[0], eps=1e-5)
        self.conv_out = Conv2d(ch[0], cfg.out_channels, 3, padding=1, f32=True)

    def forward(self, sample, timesteps, context, cd_kv=None):
        cd_kv = cd_kv or {}
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.ndim == 0:
            timesteps = timesteps[None]
        dt = self.cfg.compute_dtype
        temb = self.time_embedding(
            timestep_embedding(timesteps, self.cfg.block_out_channels[0]).to(dt))
        temb = temb.expand(sample.shape[0], -1)
        context = context.to(dt)

        h = self.conv_in(sample.to(dt))
        skips = [h]
        for i, blk in enumerate(self.down_blocks):
            for j, resnet in enumerate(blk.resnets):
                h = resnet(h, temb)
                if hasattr(blk, "attentions"):
                    h = blk.attentions[j](h, context,
                                          cd_kv.get(f"down_blocks.{i}.attentions.{j}"))
                skips.append(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
                skips.append(h)

        mid = self.mid_block
        h = mid.attentions[0](mid.resnets[0](h, temb), context,
                              cd_kv.get("mid_block.attentions.0"))
        h = mid.resnets[1](h, temb)

        for i, blk in enumerate(self.up_blocks):
            for j, resnet in enumerate(blk.resnets):
                h = resnet(torch.cat([h, skips.pop()], dim=1), temb)
                if hasattr(blk, "attentions"):
                    h = blk.attentions[j](h, context,
                                          cd_kv.get(f"up_blocks.{i}.attentions.{j}"))
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


# ---- vae
@dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215
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
        h = self.conv_in(x.to(self.compute_dtype))
        for blk in self.down_blocks:
            h = blk(h)
        h = self.mid_block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


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
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: VAEConfig = VAEConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = Conv2d(2 * cfg.latent_channels,
                                 2 * cfg.latent_channels, 1, f32=True)
        self.post_quant_conv = Conv2d(cfg.latent_channels,
                                      cfg.latent_channels, 1, f32=True)

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


# ---- scheduler
class DDPMSchedule:
    def __init__(self, num_train_timesteps: int = 1000,
                 beta_start: float = 0.00085, beta_end: float = 0.012,
                 beta_schedule: str = "scaled_linear", device=None):
        self.num_train_timesteps = num_train_timesteps
        if beta_schedule == "scaled_linear":
            betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                                num_train_timesteps, dtype=np.float64) ** 2
        elif beta_schedule == "linear":
            betas = np.linspace(beta_start, beta_end, num_train_timesteps,
                                dtype=np.float64)
        else:
            raise ValueError(beta_schedule)
        self.alphas_cumprod = torch.tensor(
            np.cumprod(1.0 - betas).astype(np.float32), device=device)

    def add_noise(self, latents, noise, t):
        """x_t = √ᾱ_t·x_0 + √(1−ᾱ_t)·ε  (t: int or a [B] tensor)."""
        a = self.alphas_cumprod.to(latents.device)[t]
        while a.ndim < latents.ndim:
            a = a[..., None]
        return torch.sqrt(a) * latents + torch.sqrt(1.0 - a) * noise
