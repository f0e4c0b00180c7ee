"""The FLUX.1-dev transformer, the denoiser of ``--sd_version flux-dev``
(no counterpart in the JAX package).

Black Forest Labs' ``src/flux/model.py`` and ``modules/layers.py``, with
their state-dict names (``double_blocks.0.img_attn.qkv``,
``single_blocks.3.linear1``, ``final_layer.adaLN_modulation.1``), at the
widths of ``transformer/config.json`` (:class:`FluxConfig`: D = 3072, 24
heads of 128, 19 double-stream and 38 single-stream blocks):

* the latents [B, 16, h, w] packed in 2×2 patches into [B, hw/4, 64]
  (``sampling.py::prepare``), ``img_in`` 64 → D; the T5 context through
  ``txt_in`` 4096 → D; position ids (0, 0, 0) for every text token and
  (0, i, j) for image patch (i, j);
* vec = ``time_in``(emb(1000·σ)) + ``guidance_in``(emb(1000·g)) +
  ``vector_in``(pooled CLIP), emb the 256-wide sinusoid with the cosines
  first, each embedder linear → SiLU → linear;
* RoPE over three axes of (16, 56, 56) channels, θ = 10,000, rotating the
  adjacent pairs (x₂ₖ, x₂ₖ₊₁) of q and k after their RMSNorm;
* double-stream blocks: each stream modulated by (shift, scale, gate) × 2 =
  Linear(SiLU(vec)), LayerNorm without affine (ε 1e-6), its own q, k, v
  with RMSNorm on q and k, one joint attention over [txt; img], then
  x += gate₁·proj(attn) and x += gate₂·MLP((1 + scale₂)·LN(x) + shift₂),
  the MLP D → 4D → D with tanh-GELU;
* single-stream blocks over [txt; img]: one modulation (shift, scale,
  gate), ``linear1`` to [q, k, v, mlp], attention and the MLP in parallel,
  x += gate·``linear2``([attn, GELU(mlp)]);
* the image tokens' output layer, (shift, scale) = Linear(SiLU(vec)) in
  that order (BFL's ``LastLayer``; diffusers' ``AdaLayerNormContinuous``
  takes scale first, and its converted weights swap the halves), a linear
  D → 64, unpacked to the velocity [B, 16, h, w].

Precision follows the SD stack's policy (``layers.py``): the latents and
the context are cast to ``FluxConfig.dtype`` at entry, every linear takes
its weight in its input's dtype, the norms compute in f32 and give the
input's dtype back, RoPE rotates in f32, the sinusoids are f32 until the
embedders cast them, and the velocity comes out f32.  σ and g enter the
sinusoids in f32 (the published pipelines round them to bf16 first).

The attention goes through ``unet.attend``: on the card, bf16 inputs that
need no gradient take ``csrc/attention.cu`` (d = 128), once a block, 57
launches a call.  The tracer's device spans (``engine/spans.py``):
``dit.embed`` (the embedders and the rotary table), ``dit.double`` and
``dit.single`` (each group of blocks).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from customnerf_torch.engine import spans
from customnerf_torch.guidance.layers import Linear, compute_dtype
from customnerf_torch.guidance.unet import attend, timestep_embedding

TIME_DIM = 256          # the sinusoids' width of σ and g
TIME_FACTOR = 1000.0    # σ and g enter the sinusoids × 1000
PATCH = 2               # the latents' 2×2 packing


@dataclass(frozen=True)
class FluxConfig:
    """FLUX.1-dev's ``transformer/config.json`` (diffusers' names) and the
    BFL constants it leaves out (``mlp_ratio``, ``theta``, ``qkv_bias``)."""
    in_channels: int = 64
    num_layers: int = 19
    num_single_layers: int = 38
    attention_head_dim: int = 128
    num_attention_heads: int = 24
    joint_attention_dim: int = 4096
    pooled_projection_dim: int = 768
    guidance_embeds: bool = True
    axes_dims_rope: Tuple[int, ...] = (16, 56, 56)
    mlp_ratio: float = 4.0
    theta: int = 10_000
    dtype: str = "float32"      # the compute dtype: "float32" | "bfloat16"

    def __post_init__(self):
        if sum(self.axes_dims_rope) != self.attention_head_dim:
            raise ValueError(f"the rotary axes {self.axes_dims_rope} must sum to the "
                             f"head width {self.attention_head_dim}")
        if any(a % 2 for a in self.axes_dims_rope):
            raise ValueError(f"each rotary axis takes whole pairs, not {self.axes_dims_rope}")

    @property
    def compute_dtype(self) -> torch.dtype:
        return compute_dtype(self.dtype)

    @property
    def hidden(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @property
    def mlp_hidden(self) -> int:
        return int(self.hidden * self.mlp_ratio)

    @property
    def cross_attention_dim(self) -> int:
        """The context's width: T5's d_model."""
        return self.joint_attention_dim



# ----------------------------------------------------------------- pieces
def layer_norm(x):
    """LayerNorm without affine, ε 1e-6, in f32; the input's dtype out."""
    return F.layer_norm(x.float(), x.shape[-1:], eps=1e-6).to(x.dtype)


def pack(latents):
    """[B, C, h, w] → [B, hw/4, 4C]: 2×2 patches, channel-major within a
    patch (``rearrange "b c (h ph) (w pw) -> b (h w) (c ph pw)"``)."""
    b, c, h, w = latents.shape
    x = latents.reshape(b, c, h // PATCH, PATCH, w // PATCH, PATCH)
    return x.permute(0, 2, 4, 1, 3, 5).reshape(b, (h // PATCH) * (w // PATCH),
                                               c * PATCH * PATCH)


def unpack(x, h: int, w: int):
    """:func:`pack`'s inverse for latents of side h × w."""
    b, _, d = x.shape
    c = d // (PATCH * PATCH)
    x = x.reshape(b, h // PATCH, w // PATCH, c, PATCH, PATCH)
    return x.permute(0, 3, 1, 4, 2, 5).reshape(b, c, h, w)


def position_ids(n_txt: int, h: int, w: int, device) -> torch.Tensor:
    """[n_txt + hw/4, 3]: (0, 0, 0) for each text token, (0, i, j) for image
    patch (i, j) of latents of side h × w."""
    hp, wp = h // PATCH, w // PATCH
    img = torch.zeros(hp, wp, 3, device=device)
    img[..., 1] = torch.arange(hp, device=device, dtype=torch.float32)[:, None]
    img[..., 2] = torch.arange(wp, device=device, dtype=torch.float32)[None, :]
    return torch.cat([torch.zeros(n_txt, 3, device=device), img.reshape(hp * wp, 3)])


def rope_table(ids, axes, theta: int) -> torch.Tensor:
    """[L, Σaxes/2, 2, 2] f32 rotations of each position (``layers.py::EmbedND``
    and ``math.py::rope``): for axis a, the pairs of its ``axes[a]`` channels
    turn by ids[:, a]·θ^(−2k/axes[a]), as [[cos, −sin], [sin, cos]]."""
    parts = []
    for a, dim in enumerate(axes):
        scale = torch.arange(0, dim, 2, dtype=torch.float64, device=ids.device) / dim
        angle = ids[:, a].double()[:, None] / (theta ** scale)[None]
        cos, sin = torch.cos(angle), torch.sin(angle)
        parts.append(torch.stack([cos, -sin, sin, cos], dim=-1).reshape(*angle.shape, 2, 2))
    return torch.cat(parts, dim=-3).float()


def apply_rope(x, table):
    """x [B, L, H, d] rotated pair by pair by ``table`` [L, d/2, 2, 2], in
    f32, in x's dtype out (``math.py::apply_rope``)."""
    xf = x.float().reshape(*x.shape[:-1], -1, 1, 2)
    f = table[None, :, None]
    out = f[..., 0] * xf[..., 0] + f[..., 1] * xf[..., 1]
    return out.reshape(x.shape).to(x.dtype)


class RMSNorm(nn.Module):
    """x·rsqrt(mean(x²) + 1e-6) in f32, cast back, times the learned scale."""
    unit_init = True

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        xf = x.float()
        y = (xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + 1e-6)).to(x.dtype)
        return y * self.scale.to(x.dtype)


class QKNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.query_norm = RMSNorm(dim)
        self.key_norm = RMSNorm(dim)


class SelfAttention(nn.Module):
    """The fused q, k, v projection, the q/k norms and the output projection
    of one stream; the attention itself is joint (:func:`joint_attention`)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = Linear(dim, dim * 3, bias=True)
        self.norm = QKNorm(dim // heads)
        self.proj = Linear(dim, dim)

    def qkv_heads(self, x):
        """q, k (normalised), v, each [B, L, H, d]."""
        b, n, _ = x.shape
        q, k, v = self.qkv(x).view(b, n, 3, self.heads, -1).unbind(2)
        return self.norm.query_norm(q), self.norm.key_norm(k), v


def joint_attention(q, k, v, table):
    """RoPE on q and k, then softmax(q·kᵀ/√d)·v over all L tokens: [B, L, H, d]
    in, [B, L, H·d] out (``unet.attend``: the kernel on the card)."""
    b, n, heads, d = q.shape
    q = apply_rope(q, table).reshape(b, n, heads * d)
    k = apply_rope(k, table).reshape(b, n, heads * d)
    return attend(q, k, v.reshape(b, n, heads * d), heads)


class Modulation(nn.Module):
    """``lin``(SiLU(vec)) split into (shift, scale, gate) once, or twice for
    a double-stream block, each [B, 1, D]."""

    def __init__(self, dim: int, double: bool):
        super().__init__()
        self.parts = 6 if double else 3
        self.lin = Linear(dim, self.parts * dim, bias=True)

    def forward(self, vec):
        return self.lin(F.silu(vec))[:, None, :].chunk(self.parts, dim=-1)


def _mlp(dim: int, hidden: int) -> nn.ModuleList:
    """BFL's ``nn.Sequential(Linear, GELU(tanh), Linear)`` (names 0 and 2)."""
    return nn.ModuleList([Linear(dim, hidden, bias=True), nn.GELU(approximate="tanh"),
                          Linear(hidden, dim, bias=True)])


def _run_mlp(mlp, x):
    return mlp[2](F.gelu(mlp[0](x), approximate="tanh"))


class MLPEmbedder(nn.Module):
    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.in_layer = Linear(in_dim, dim, bias=True)
        self.out_layer = Linear(dim, dim, bias=True)

    def forward(self, x):
        return self.out_layer(F.silu(self.in_layer(x)))


class DoubleStreamBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_hidden: int):
        super().__init__()
        self.img_mod = Modulation(dim, double=True)
        self.img_attn = SelfAttention(dim, heads)
        self.img_mlp = _mlp(dim, mlp_hidden)
        self.txt_mod = Modulation(dim, double=True)
        self.txt_attn = SelfAttention(dim, heads)
        self.txt_mlp = _mlp(dim, mlp_hidden)

    def forward(self, img, txt, vec, table):
        i_shift1, i_scale1, i_gate1, i_shift2, i_scale2, i_gate2 = self.img_mod(vec)
        t_shift1, t_scale1, t_gate1, t_shift2, t_scale2, t_gate2 = self.txt_mod(vec)
        iq, ik, iv = self.img_attn.qkv_heads((1 + i_scale1) * layer_norm(img) + i_shift1)
        tq, tk, tv = self.txt_attn.qkv_heads((1 + t_scale1) * layer_norm(txt) + t_shift1)
        attn = joint_attention(torch.cat([tq, iq], 1), torch.cat([tk, ik], 1),
                               torch.cat([tv, iv], 1), table)
        n_txt = txt.shape[1]
        img = img + i_gate1 * self.img_attn.proj(attn[:, n_txt:])
        img = img + i_gate2 * _run_mlp(self.img_mlp,
                                       (1 + i_scale2) * layer_norm(img) + i_shift2)
        txt = txt + t_gate1 * self.txt_attn.proj(attn[:, :n_txt])
        txt = txt + t_gate2 * _run_mlp(self.txt_mlp,
                                       (1 + t_scale2) * layer_norm(txt) + t_shift2)
        return img, txt


class SingleStreamBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_hidden: int):
        super().__init__()
        self.heads = heads
        self.dim, self.mlp_hidden = dim, mlp_hidden
        self.linear1 = Linear(dim, dim * 3 + mlp_hidden, bias=True)
        self.linear2 = Linear(dim + mlp_hidden, dim, bias=True)
        self.norm = QKNorm(dim // heads)
        self.modulation = Modulation(dim, double=False)

    def forward(self, x, vec, table):
        shift, scale, gate = self.modulation(vec)
        b, n, _ = x.shape
        qkv, mlp = torch.split(self.linear1((1 + scale) * layer_norm(x) + shift),
                               [3 * self.dim, self.mlp_hidden], dim=-1)
        q, k, v = qkv.reshape(b, n, 3, self.heads, -1).unbind(2)
        attn = joint_attention(self.norm.query_norm(q), self.norm.key_norm(k), v, table)
        out = self.linear2(torch.cat([attn, F.gelu(mlp, approximate="tanh")], dim=2))
        return x + gate * out


class LastLayer(nn.Module):
    def __init__(self, dim: int, out: int):
        super().__init__()
        self.linear = Linear(dim, out, bias=True)
        # BFL's nn.Sequential(SiLU, Linear): the linear is entry 1
        self.adaLN_modulation = nn.ModuleList([nn.SiLU(), Linear(dim, 2 * dim, bias=True)])

    def forward(self, x, vec):
        shift, scale = self.adaLN_modulation[1](F.silu(vec)).chunk(2, dim=1)
        return self.linear((1 + scale[:, None, :]) * layer_norm(x) + shift[:, None, :])


class FluxTransformer(nn.Module):
    """``forward(latents [B, C, h, w], sigma [B], context [B, T, 4096],
    pooled [B, 768], guidance [B]) → v̂ [B, C, h, w]`` f32, C the VAE's
    latent channels (16)."""

    def __init__(self, cfg: FluxConfig = FluxConfig()):
        super().__init__()
        self.cfg = cfg
        D, H = cfg.hidden, cfg.num_attention_heads
        self.img_in = Linear(cfg.in_channels, D, bias=True)
        self.time_in = MLPEmbedder(TIME_DIM, D)
        self.vector_in = MLPEmbedder(cfg.pooled_projection_dim, D)
        if cfg.guidance_embeds:
            self.guidance_in = MLPEmbedder(TIME_DIM, D)
        self.txt_in = Linear(cfg.joint_attention_dim, D, bias=True)
        self.double_blocks = nn.ModuleList(
            [DoubleStreamBlock(D, H, cfg.mlp_hidden) for _ in range(cfg.num_layers)])
        self.single_blocks = nn.ModuleList(
            [SingleStreamBlock(D, H, cfg.mlp_hidden) for _ in range(cfg.num_single_layers)])
        self.final_layer = LastLayer(D, cfg.in_channels)

    def embed(self, sigma, pooled, guidance):
        """vec [B, D]: the time, guidance and pooled-text embeddings summed."""
        dt = self.cfg.compute_dtype

        def emb(v):
            return timestep_embedding(TIME_FACTOR * v.float().reshape(-1), TIME_DIM).to(dt)
        vec = self.time_in(emb(sigma))
        if self.cfg.guidance_embeds:
            if guidance is None:
                raise ValueError("FLUX.1-dev is guidance-distilled: pass the guidance g")
            vec = vec + self.guidance_in(emb(guidance))
        return vec + self.vector_in(pooled.to(dt))

    def forward(self, latents, sigma, context, pooled, guidance=None):
        dt = self.cfg.compute_dtype
        b, _, h, w = latents.shape
        with spans.device("dit.embed"):
            img = self.img_in(pack(latents.to(dt)))
            txt = self.txt_in(context.to(dt))
            vec = self.embed(sigma, pooled, guidance).expand(b, -1)
            table = rope_table(position_ids(txt.shape[1], h, w, latents.device),
                               self.cfg.axes_dims_rope, self.cfg.theta)
        with spans.device("dit.double"):
            for block in self.double_blocks:
                img, txt = block(img, txt, vec, table)
        n_txt = txt.shape[1]
        x = torch.cat([txt, img], dim=1)
        with spans.device("dit.single"):
            for block in self.single_blocks:
                x = block(x, vec, table)
        out = self.final_layer(x[:, n_txt:], vec)
        return unpack(out.float(), h, w)
