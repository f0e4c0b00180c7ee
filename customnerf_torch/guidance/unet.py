"""Stable Diffusion UNet2DConditionModel, NCHW (counterpart of
``customnerf_tpu/guidance/unet.py``).

Module names are diffusers' state-dict keys (``down_blocks.0.resnets.1``,
``…attentions.0.transformer_blocks.0.attn1.to_out.0``), so a diffusers UNet
loads with ``load_state_dict`` as is.  SD 1.x layout: 1×1-conv
``proj_in``/``proj_out``, exact-erf GEGLU, cross-attention without q/k/v
biases; SD 2.x (:func:`sd2_unet_config`) is the same layout with a wider
context and per-level head counts.  SDXL base 1.0 (:func:`sdxl_unet_config`)
is that layout at three levels, with diffusers' block types deciding which
levels attend (``DownBlock2D`` / ``UpBlock2D`` have no attention), stacks
of ``transformer_layers_per_block`` transformer blocks (1, 2, 10; the mid
block takes the deepest level's) and its "text_time" conditioning: six
time ids, each embedded sinusoidally at ``addition_time_embed_dim``
(flip_sin_to_cos, shift 0), concatenated after the pooled text embedding
and mapped by ``add_embedding`` (linear, SiLU, linear) onto the timestep
embedding, to which it is added.  Attention is computed as the JAX
package computes it (:func:`attention`: matmul → softmax → matmul in plain
PyTorch, which at 64×64 latents and batch 2 materialises 2×heads×4096×4096
f32 scores per self-attention call of the first level, 1.07 GB for 1.x).
On the card, bf16 inputs that need no gradient take one hand-written kernel
(:func:`attend`, ``csrc/attention.cu``) that rounds where :func:`attention`
rounds and stores no score.

``UNetConfig.dtype`` is the compute dtype (flax's policy, ``layers.py``):
the sample and context are cast to it at entry, the timestep features are
computed in f32 and then cast (``unet.py:66,254-255``), the attention
logits are f32 (``preferred_element_type=jnp.float32``, ``unet.py:141-144``)
with the softmax in f32 and its output cast back before the value product,
and ``conv_out`` computes in f32, so ε comes out f32.  The guidance
(``sds.py``) stores the weights in the compute dtype.

Custom Diffusion (``cd_kv``): a table keyed by the diffusers prefix of each
cross-attention block (``down_blocks.0.attentions.0``, …,
``mid_block.attentions.0``, ``up_blocks.3.attentions.2``; 16 at full
width) whose entries hold torch ``[out, in]`` weights ``to_k`` and ``to_v``
and, for ``--freeze_model crossattn``, ``to_q``, ``to_out`` and
``to_out_bias``; each ``attn2`` takes those in place of its own, as the JAX
package's ``CrossAttention`` does.  Blocks a smaller config lacks are
skipped.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from customnerf_torch.engine import spans
from customnerf_torch.guidance.layers import (Conv2d, Downsample2D, GroupNorm,
                                              LayerNorm, Linear, ResnetBlock2D,
                                              Upsample2D, compute_dtype)
from customnerf_torch.ops import kernels

KERNEL_MAX_HEAD = 160        # the kernel's widest head (csrc/attention.cu)
KERNEL_MAX_BLOCKS = 65535    # batch × heads: the launch grid's y extent
KERNEL_MAX_ROW_STRIDE = 1 << 24   # k's and v's rows, in elements (int32 offsets)


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
    # diffusers' block types, one a level; None: SD 1.x/2.x's, attention at
    # every level but the deepest
    down_block_types: Optional[Tuple[str, ...]] = None
    up_block_types: Optional[Tuple[str, ...]] = None
    # transformer blocks in each Transformer2DModel: an int for every level
    # or one per level; the mid block takes the deepest level's
    transformer_layers_per_block: Union[int, Tuple[int, ...]] = 1
    # SDXL's added conditioning: None, or "text_time" with the width of a
    # time id's embedding and add_embedding's input width (pooled + 6 ids)
    addition_embed_type: Optional[str] = None
    addition_time_embed_dim: Optional[int] = None
    projection_class_embeddings_input_dim: Optional[int] = None
    dtype: str = "float32"      # the compute dtype: "float32" | "bfloat16"

    def __post_init__(self):
        n = len(self.block_out_channels)
        for name, kinds in (("down_block_types", _DOWN), ("up_block_types", _UP)):
            types = getattr(self, name)
            if types is not None and (len(types) != n or not set(types) <= set(kinds)):
                raise ValueError(f"{name} must give one of {kinds} for each of the "
                                 f"{n} levels, got {types}")
        if self.addition_embed_type not in (None, "text_time"):
            raise ValueError(f"addition_embed_type must be None or 'text_time', "
                             f"got {self.addition_embed_type!r}")

    @property
    def compute_dtype(self) -> torch.dtype:
        return compute_dtype(self.dtype)

    def heads_at(self, level: int) -> int:
        hd = self.attention_head_dim
        return int(hd[level]) if isinstance(hd, (tuple, list)) else int(hd)

    def depth_at(self, level: int) -> int:
        d = self.transformer_layers_per_block
        return int(d[level]) if isinstance(d, (tuple, list)) else int(d)

    def attends(self, kind: str, i: int) -> bool:
        """Whether the ``kind`` ("down" | "up") block ``i`` has attention."""
        n = len(self.block_out_channels)
        types = self.down_block_types if kind == "down" else self.up_block_types
        if types is None:
            return i < n - 1 if kind == "down" else i > 0
        return types[i].startswith("CrossAttn")

    @property
    def text_embeds_dim(self) -> Optional[int]:
        """The pooled text embedding's width the "text_time" branch takes."""
        if self.addition_embed_type is None:
            return None
        return self.projection_class_embeddings_input_dim - 6 * self.addition_time_embed_dim


_DOWN = ("CrossAttnDownBlock2D", "DownBlock2D")
_UP = ("CrossAttnUpBlock2D", "UpBlock2D")


def sd2_unet_config(dtype: str = "float32") -> UNetConfig:
    """SD 2.0/2.1 (the JAX package's ``sd2_unet_config``): a 1024-wide
    context and (5, 10, 20, 20) heads, 64 wide at every level.  diffusers
    stores 2.x's ``proj_in``/``proj_out`` as linear layers
    (``use_linear_projection``); they are the 1×1 convs here, and
    ``weights.py`` reshapes them."""
    return UNetConfig(cross_attention_dim=1024, attention_head_dim=(5, 10, 20, 20),
                      dtype=dtype)


def sdxl_unet_config(dtype: str = "float32") -> UNetConfig:
    """SDXL base 1.0 (``unet/config.json``): widths (320, 640, 1280), no
    attention at the first level, (1, 2, 10) transformer blocks a level,
    64-wide heads, a 2048-wide context and the "text_time" conditioning
    (256-wide time-id embeddings, 2816 = 1280 pooled + 6 × 256).  diffusers
    stores ``proj_in``/``proj_out`` as linear layers; they are the 1×1
    convs here, as for 2.x."""
    return UNetConfig(block_out_channels=(320, 640, 1280), cross_attention_dim=2048,
                      attention_head_dim=(5, 10, 20),
                      down_block_types=("DownBlock2D", "CrossAttnDownBlock2D",
                                        "CrossAttnDownBlock2D"),
                      up_block_types=("CrossAttnUpBlock2D", "CrossAttnUpBlock2D",
                                      "UpBlock2D"),
                      transformer_layers_per_block=(1, 2, 10),
                      addition_embed_type="text_time", addition_time_embed_dim=256,
                      projection_class_embeddings_input_dim=2816, dtype=dtype)


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


def attend(q, k, v, heads: int):
    """:func:`attention` on the route its inputs call for.  On the card,
    bf16 inputs that need no gradient (:func:`takes_kernel`) launch the
    kernel (:func:`attention_kernel`); any other input on the card (the f32
    UNet, or a graph that autograd differentiates: Custom Diffusion tuning)
    takes the plain function and adds one to the tracer's
    ``attention_plain`` counter; CPU inputs take the plain function."""
    if _on_card(q):
        if takes_kernel(q, k, v):
            return attention_kernel(q, k, v, heads)
        spans.count("attention_plain")
    return attention(q, k, v, heads)


def _on_card(t) -> bool:
    return t.device.type == "cuda"


def takes_kernel(q, k, v) -> bool:
    """Whether inputs on the card go to the kernel: all bf16, and no
    autograd history wanted (grad mode off, or no input requiring grad)."""
    ts = (q, k, v)
    return (all(t.dtype == torch.bfloat16 for t in ts)
            and not (torch.is_grad_enabled() and any(t.requires_grad for t in ts)))


def check_kernel(q, k, v, heads: int) -> None:
    """Raise on what the kernel does not take: q [b, n, h·d] and k, v
    [b, m, h·d] bf16 on one device, m ≥ 1, d a multiple of 8 up to
    KERNEL_MAX_HEAD, b·h ≤ KERNEL_MAX_BLOCKS, each with unit column stride,
    its other strides multiples of 8 and its base 16-byte aligned (the
    kernel copies 16-byte chunks of a head's row), k's and v's row strides
    below KERNEL_MAX_ROW_STRIDE."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"attention: the kernel takes [b, n, h·d] tensors, not "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, n, inner = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != inner or k.shape[1] < 1:
        raise ValueError(f"attention: keys and values [{b}, m ≥ 1, {inner}] for "
                         f"queries {tuple(q.shape)}, not {tuple(k.shape)}, {tuple(v.shape)}")
    if heads < 1 or inner % heads:
        raise ValueError(f"attention: {inner} channels do not split into {heads} heads")
    d = inner // heads
    if d % 8 or not 8 <= d <= KERNEL_MAX_HEAD:
        raise ValueError(f"attention: the kernel takes head widths that are multiples "
                         f"of 8 up to {KERNEL_MAX_HEAD}, not {d}")
    if b * heads > KERNEL_MAX_BLOCKS:
        raise ValueError(f"attention: the kernel takes batch × heads ≤ "
                         f"{KERNEL_MAX_BLOCKS}, not {b * heads}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"attention: the kernel takes bfloat16, not {name} {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"attention: {name} on {t.device}, q on {q.device}")
        if t.stride(2) != 1 or t.stride(0) % 8 or t.stride(1) % 8 or t.data_ptr() % 16:
            raise ValueError(f"attention: the kernel reads 16-byte chunks of {name}'s "
                             f"rows: unit column stride, strides multiples of 8 and a "
                             f"16-byte aligned base, not strides {t.stride()}")
        if name != "q" and t.stride(1) >= KERNEL_MAX_ROW_STRIDE:
            raise ValueError(f"attention: the kernel takes {name}'s row stride below "
                             f"{KERNEL_MAX_ROW_STRIDE}, not {t.stride(1)}")


def attention_kernel(q, k, v, heads: int):
    """:func:`attention` by the kernel (``csrc/attention.cu``) on CUDA bf16
    tensors, the output written as [b, n, h·d] bf16.  The kernel counts its
    launches, graph replays included: ``kernels.device_launches("attention")``."""
    check_kernel(q, k, v, heads)
    b, n, inner = q.shape
    m, d = k.shape[1], inner // heads
    out = torch.empty(b, n, inner, dtype=q.dtype, device=q.device)
    if n:
        with torch.cuda.device(q.device):
            err = kernels.library().cn_attention_forward(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                v.stride(0), v.stride(1), out.stride(0), out.stride(1),
                b, heads, n, m, d, 1.0 / math.sqrt(d),
                torch.cuda.current_stream().cuda_stream)
        kernels.check(err, "attention")
    return out


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

        out = attend(proj("to_q", x), proj("to_k", context), proj("to_v", context),
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
    """GroupNorm → 1×1 conv → ``depth`` transformer blocks → 1×1 conv,
    residual."""

    def __init__(self, channels: int, heads: int, ctx_dim: int, groups: int,
                 depth: int = 1):
        super().__init__()
        self.norm = GroupNorm(groups, channels, eps=1e-6)
        self.proj_in = Conv2d(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(channels, heads, channels // heads, ctx_dim)
             for _ in range(depth)])
        self.proj_out = Conv2d(channels, channels, 1)

    def forward(self, x, context, cd_kv=None):
        b, c, h, w = x.shape
        res = x
        x = self.proj_in(self.norm(x))
        x = x.permute(0, 2, 3, 1).reshape(b, h * w, c)
        for block in self.transformer_blocks:
            x = block(x, context, cd_kv)
        x = x.reshape(b, h, w, c).permute(0, 3, 1, 2)
        # the residual first: the sum takes its contiguous NCHW layout (the
        # first operand's), not the channels-last one of proj_out's output,
        # so the next GroupNorm needs no NCHW copy of it
        return res + self.proj_out(x)


class _Block(nn.Module):
    """A down or up level: ``resnets``, ``n_attn`` ``attentions`` of
    ``depth`` transformer blocks (none without attention) and
    ``downsamplers``/``upsamplers`` (diffusers' names)."""

    def __init__(self, in_chs, out_ch, temb_ch, groups, heads, ctx_dim,
                 n_attn, depth=1, sampler=None):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(c, out_ch, temb_ch, groups) for c in in_chs])
        if n_attn:
            self.attentions = nn.ModuleList(
                [Transformer2DModel(out_ch, heads, ctx_dim, groups, depth)
                 for _ in range(n_attn)])
        if sampler == "down":
            self.downsamplers = nn.ModuleList([Downsample2D(out_ch)])
        elif sampler == "up":
            self.upsamplers = nn.ModuleList([Upsample2D(out_ch)])


class UNet2DCondition(nn.Module):
    """``forward(sample [B, 4, h, w], timesteps [B] or scalar,
    context [B, 77, D], cd_kv=None, added_cond=None) → ε [B, 4, h, w]``.

    The tracer's device spans (``engine/spans.py``): ``unet.level<i>``
    around each down and each up block of level i (both summed under one
    name), ``unet.mid``, and, with "text_time", ``unet.text_time`` around
    the added embedding."""

    def __init__(self, cfg: UNetConfig = UNetConfig()):
        super().__init__()
        self.cfg = cfg
        ch = list(cfg.block_out_channels)
        n = len(ch)
        temb_ch = ch[0] * 4
        groups, ctx, L = cfg.norm_num_groups, cfg.cross_attention_dim, cfg.layers_per_block

        self.conv_in = Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch[0], temb_ch)
        if cfg.addition_embed_type == "text_time":
            self.add_embedding = TimestepEmbedding(
                cfg.projection_class_embeddings_input_dim, temb_ch)

        self.down_blocks = nn.ModuleList()
        skips = [ch[0]]
        for i in range(n):
            last = i == n - 1
            in_chs = [ch[max(i - 1, 0)]] + [ch[i]] * (L - 1)
            self.down_blocks.append(_Block(
                in_chs, ch[i], temb_ch, groups, cfg.heads_at(i), ctx,
                n_attn=L if cfg.attends("down", i) else 0, depth=cfg.depth_at(i),
                sampler=None if last else "down"))
            skips += [ch[i]] * (L if last else L + 1)

        self.mid_block = _Block([ch[-1], ch[-1]], ch[-1], temb_ch, groups,
                                cfg.heads_at(n - 1), ctx, n_attn=1,
                                depth=cfg.depth_at(n - 1))

        self.up_blocks = nn.ModuleList()
        rev = list(reversed(ch))
        prev = ch[-1]
        for i in range(n):
            skip = [skips.pop() for _ in range(L + 1)]
            in_chs = [(prev if j == 0 else rev[i]) + skip[j] for j in range(L + 1)]
            self.up_blocks.append(_Block(
                in_chs, rev[i], temb_ch, groups, cfg.heads_at(n - 1 - i), ctx,
                n_attn=L + 1 if cfg.attends("up", i) else 0,
                depth=cfg.depth_at(n - 1 - i), sampler="up" if i < n - 1 else None))
            prev = rev[i]
        self._level_spans = [f"unet.level{i}" for i in range(n)]

        self.conv_norm_out = GroupNorm(groups, ch[0], eps=1e-5)
        self.conv_out = Conv2d(ch[0], cfg.out_channels, 3, padding=1, f32=True)

    def forward(self, sample, timesteps, context, cd_kv=None, added_cond=None):
        """``added_cond`` (diffusers' ``added_cond_kwargs``): with
        "text_time", ``{"text_embeds": [B, P], "time_ids": [B, 6]}``, the
        pooled text embedding and the time ids; refused without it."""
        cd_kv = cd_kv or {}
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.ndim == 0:
            timesteps = timesteps[None]
        dt = self.cfg.compute_dtype
        temb = self.time_embedding(
            timestep_embedding(timesteps, self.cfg.block_out_channels[0]).to(dt))
        if hasattr(self, "add_embedding"):
            if added_cond is None:
                raise ValueError("the text-time UNet needs added_cond "
                                 "(text_embeds and time_ids)")
            with spans.device("unet.text_time"):
                temb = temb + self._text_time(added_cond, dt)
        elif added_cond is not None:
            raise ValueError("added_cond given to a UNet without addition_embed_type")
        temb = temb.expand(sample.shape[0], -1)
        context = context.to(dt)
        levels = self._level_spans

        h = self.conv_in(sample.to(dt))
        skips = [h]
        for i, blk in enumerate(self.down_blocks):
            with spans.device(levels[i]):
                for j, resnet in enumerate(blk.resnets):
                    h = resnet(h, temb)
                    if hasattr(blk, "attentions"):
                        h = blk.attentions[j](h, context,
                                              cd_kv.get(f"down_blocks.{i}.attentions.{j}"))
                    skips.append(h)
                if hasattr(blk, "downsamplers"):
                    h = blk.downsamplers[0](h)
                    skips.append(h)

        with spans.device("unet.mid"):
            mid = self.mid_block
            h = mid.attentions[0](mid.resnets[0](h, temb), context,
                                  cd_kv.get("mid_block.attentions.0"))
            h = mid.resnets[1](h, temb)

        for i, blk in enumerate(self.up_blocks):
            with spans.device(levels[len(levels) - 1 - i]):
                for j, resnet in enumerate(blk.resnets):
                    h = resnet(torch.cat([h, skips.pop()], dim=1), temb)
                    if hasattr(blk, "attentions"):
                        h = blk.attentions[j](h, context,
                                              cd_kv.get(f"up_blocks.{i}.attentions.{j}"))
                if hasattr(blk, "upsamplers"):
                    h = blk.upsamplers[0](h)
        return self.conv_out(self.conv_norm_out(h, silu=True))

    def _text_time(self, added_cond, dt):
        """``add_embedding([text_embeds | sinusoids of the time ids])``: each
        id embedded at ``addition_time_embed_dim`` in f32, then cast."""
        text, ids = added_cond["text_embeds"], added_cond["time_ids"]
        ids = timestep_embedding(ids.reshape(-1), self.cfg.addition_time_embed_dim)
        cond = torch.cat([text.float(), ids.reshape(text.shape[0], -1)], dim=-1)
        return self.add_embedding(cond.to(dt))
