"""Plain PyTorch FLUX.1-dev: its rectified-flow transformer, T5 v1.1 XXL's
encoder and its VAE, written from Black Forest Labs' reference code
(github.com/black-forest-labs/flux: ``src/flux/model.py``,
``src/flux/modules/layers.py``, ``src/flux/math.py``,
``src/flux/sampling.py``) and the published configs
(huggingface.co/black-forest-labs/FLUX.1-dev: ``transformer/config.json``,
``vae/config.json``, ``scheduler/scheduler_config.json``,
``text_encoder_2/config.json``).  Run in f32 with TF32 off as the reference
that decides ``correct``; parameter names are BFL's (the transformer) and
Hugging Face's (T5), so one state dict loads here and into the program.

The transformer (D = 3072, 24 heads of d = 128):

    img  = img_in(pack(x))                       x [B, 16, h, w] → [B, hw/4, 64] → D
    txt  = txt_in(c)                             c [B, 512, 4096] (T5) → D
    vec  = time_in(e(1000σ)) + guidance_in(e(1000g)) + vector_in(y)
           e: 256 sinusoids [cos | sin] of t·10000^(−k/128); each embedder
           linear → SiLU → linear; y [B, 768] pooled CLIP-L
    pe   = RoPE of ids: text (0, 0, 0), patch (i, j) → (0, i, j); axes of
           (16, 56, 56) channels, θ = 10,000; pairs (x₂ₖ, x₂ₖ₊₁) rotate by
           [[cos, −sin], [sin, cos]] of id·θ^(−2k/axis)
    19 double blocks, each stream s ∈ {img, txt} with its own weights:
           (a₁, b₁, g₁, a₂, b₂, g₂) = Lin_s(SiLU(vec))          (shift, scale, gate)
           q, k, v = split(qkv_s((1 + b₁)·LN(s) + a₁)); q, k = RMSNorm(q), RMSNorm(k)
           attention over [txt; img] with RoPE, softmax(q·kᵀ/√128)·v
           s += g₁·proj_s(attn_s); s += g₂·MLP_s((1 + b₂)·LN(s) + a₂)
           MLP: D → 4D, tanh-GELU, → D; LN without affine, ε 1e-6
    38 single blocks over x = [txt; img]:
           (a, b, g) = Lin(SiLU(vec)); [q k v | m] = linear1((1 + b)·LN(x) + a)
           x += g·linear2([attention(q, k, v) | GELU(m)])
    out  = linear((1 + b)·LN(img) + a), (a, b) = Lin(SiLU(vec)) (shift first)
    v̂    = unpack(out)

T5 v1.1 XXL's encoder: 24 pre-RMSNorm layers (ε 1e-6) of d_model 4096, 64
heads of 64 with no 1/√d on the logits and a bidirectional relative-position
bias (32 buckets, exact below 8, logarithmic to 128) from layer 0 added in
every layer, and a gated tanh-GELU MLP of 10240; a final RMSNorm.

The VAE is SD's AutoencoderKL (``sd.py``) with 16 latent channels and no
``quant_conv`` / ``post_quant_conv``; latents are (z − 0.1159)·0.3611.

The SDS step on rectified flow: σ₀ = t/1000 for the integer t the program
samples, σ = e^μ / (e^μ + 1/σ₀ − 1) with μ linear in the image's tokens
from 0.5 at 256 to 1.15 at 4,096 (``sampling.py::get_lin_function``,
``time_shift``); x_σ = (1 − σ)·x₀ + σ·ε; ε̂ = x_σ + (1 − σ)·v̂;
grad = w(σ)·(ε̂ − ε)·λ_sd with w(σ) = σ² / ((1 − σ)² + σ²).

Departures from the published code, none of which changes the function:
the attention is ``F.scaled_dot_product_attention`` on [B, H, L, d] as
BFL's, in the given dtype; σ and g enter the sinusoids as f32 (BFL's
sampler holds them in the image's dtype); ``pack``/``unpack`` are reshapes
in place of ``einops``; the blocks can be built one at a time from their
seeded draws (:func:`streamed`), since the f32 transformer (47.6 GB) is
not held whole beside the VAE's graph on one card.

Weights come from :func:`draw`: each tensor from its own generator, seeded
from the run's seed and the tensor's name, so that any subset of them can
be made on its own in any order and in any dtype.
"""

from __future__ import annotations

import math
import zlib
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.lib import inputs
from benchmark.reference import sd

PATCH = 2
TIME_DIM = 256
# the q/k RMS norms' drawn scale: at 1 the logits over 4,608 keys spread by
# about 1 and the attention is near uniform, so that neither RoPE nor the
# norms move the output past bf16's rounding; at 2 they spread by about 4,
# a peaked attention as a trained model's is
QK_NORM_SCALE = 2.0
SHIFT = ((256, 0.5), (4096, 1.15))      # (image tokens, μ) of the scheduler's line


# ------------------------------------------------------------------ weights
def draw(name: str, shape, seed: int, purpose: int, device) -> torch.Tensor:
    """The f32 value of the parameter ``name``: the q/k RMS norms' scales
    :data:`QK_NORM_SCALE`, T5's norm weights 1, biases 0, matrices
    N(0, 1/fan_in), other vectors and embeddings N(0, 0.02²), from a
    generator of its own."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "scale":
        return torch.full(tuple(shape), QK_NORM_SCALE, device=device)
    if name.endswith("layer_norm.weight"):
        return torch.ones(shape, device=device)
    if leaf == "bias":
        return torch.zeros(shape, device=device)
    g = torch.Generator(device=device).manual_seed(
        (inputs.stream(seed, purpose) ^ zlib.crc32(name.encode())) & inputs.MASK64)
    std = 0.02 if len(shape) == 1 or "relative_attention_bias" in name or \
        name.endswith("shared.weight") else math.prod(shape[1:]) ** -0.5
    return torch.randn(tuple(shape), generator=g, device=device) * std


@torch.no_grad()
def fill(module: nn.Module, seed: int, purpose: int, device, prefix: str = "") -> None:
    """Write :func:`draw`'s values into ``module``'s parameters, whatever
    their dtype, one tensor at a time; ``prefix``: the module's name in the
    whole model."""
    for name, p in module.named_parameters():
        p.copy_(draw(prefix + name, p.shape, seed, purpose, device))


# --------------------------------------------------------------- transformer
@dataclass(frozen=True)
class FluxParams:
    """BFL's ``FluxParams`` (``model.py``)."""
    in_channels: int = 64
    vec_in_dim: int = 768
    context_in_dim: int = 4096
    hidden_size: int = 3072
    mlp_ratio: float = 4.0
    num_heads: int = 24
    depth: int = 19
    depth_single_blocks: int = 38
    axes_dim: Tuple[int, ...] = (16, 56, 56)
    theta: int = 10_000
    qkv_bias: bool = True
    guidance_embed: bool = True


def flux_params(u: dict) -> FluxParams:
    """BFL's parameters for a diffusers ``transformer/config.json``."""
    return FluxParams(in_channels=u["in_channels"], vec_in_dim=u["pooled_projection_dim"],
                      context_in_dim=u["joint_attention_dim"],
                      hidden_size=u["num_attention_heads"] * u["attention_head_dim"],
                      num_heads=u["num_attention_heads"], depth=u["num_layers"],
                      depth_single_blocks=u["num_single_layers"],
                      axes_dim=tuple(u["axes_dims_rope"]),
                      guidance_embed=u["guidance_embeds"])


def rope(pos, dim: int, theta: int):
    """``math.py::rope``: [..., n] positions → [..., n, dim/2, 2, 2]."""
    scale = torch.arange(0, dim, 2, dtype=torch.float64, device=pos.device) / dim
    omega = 1.0 / (theta ** scale)
    out = pos.double()[..., None] * omega
    out = torch.stack([torch.cos(out), -torch.sin(out), torch.sin(out), torch.cos(out)], -1)
    return out.reshape(*out.shape[:-1], 2, 2).float()


def apply_rope(xq, xk, freqs_cis):
    """``math.py::apply_rope``."""
    xq_ = xq.float().reshape(*xq.shape[:-1], -1, 1, 2)
    xk_ = xk.float().reshape(*xk.shape[:-1], -1, 1, 2)
    xq_out = freqs_cis[..., 0] * xq_[..., 0] + freqs_cis[..., 1] * xq_[..., 1]
    xk_out = freqs_cis[..., 0] * xk_[..., 0] + freqs_cis[..., 1] * xk_[..., 1]
    return xq_out.reshape(*xq.shape).type_as(xq), xk_out.reshape(*xk.shape).type_as(xk)


def attention(q, k, v, pe):
    """``math.py::attention``: q, k, v [B, H, L, d] → [B, L, H·d]."""
    q, k = apply_rope(q, k, pe)
    x = F.scaled_dot_product_attention(q, k, v)
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


class EmbedND(nn.Module):
    def __init__(self, dim: int, theta: int, axes_dim):
        super().__init__()
        self.dim, self.theta, self.axes_dim = dim, theta, axes_dim

    def forward(self, ids):
        n_axes = ids.shape[-1]
        emb = torch.cat([rope(ids[..., i], self.axes_dim[i], self.theta)
                         for i in range(n_axes)], dim=-3)
        return emb.unsqueeze(1)


def timestep_embedding(t, dim: int, max_period: int = 10000, time_factor: float = 1000.0):
    """``layers.py::timestep_embedding``: [cos | sin] of (1000·t)·f_k."""
    t = time_factor * t.float()
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                           device=t.device) / half)
    args = t[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class MLPEmbedder(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int):
        super().__init__()
        self.in_layer = sd.Linear(in_dim, hidden_dim, bias=True)
        self.out_layer = sd.Linear(hidden_dim, hidden_dim, bias=True)

    def forward(self, x):
        return self.out_layer(F.silu(self.in_layer(x)))


class RMSNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        x_dtype = x.dtype
        x = x.float()
        rrms = torch.rsqrt(torch.mean(x ** 2, dim=-1, keepdim=True) + 1e-6)
        return (x * rrms).to(dtype=x_dtype) * self.scale.to(x_dtype)


class QKNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.query_norm = RMSNorm(dim)
        self.key_norm = RMSNorm(dim)

    def forward(self, q, k, v):
        return self.query_norm(q).to(v), self.key_norm(k).to(v)


def split_qkv(qkv, heads: int):
    """``rearrange(qkv, "B L (K H D) -> K B H L D", K=3, H=heads)``."""
    b, n, _ = qkv.shape
    return qkv.reshape(b, n, 3, heads, -1).permute(2, 0, 3, 1, 4)


class SelfAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, qkv_bias: bool):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = sd.Linear(dim, dim * 3, bias=qkv_bias)
        self.norm = QKNorm(dim // num_heads)
        self.proj = sd.Linear(dim, dim)


def layer_norm(x):
    """``nn.LayerNorm(hidden, elementwise_affine=False, eps=1e-6)``."""
    return F.layer_norm(x, x.shape[-1:], eps=1e-6)


class Modulation(nn.Module):
    def __init__(self, dim: int, double: bool):
        super().__init__()
        self.multiplier = 6 if double else 3
        self.lin = sd.Linear(dim, self.multiplier * dim, bias=True)

    def forward(self, vec):
        return self.lin(F.silu(vec))[:, None, :].chunk(self.multiplier, dim=-1)


def _mlp(hidden: int, mlp_hidden: int) -> nn.Sequential:
    return nn.Sequential(sd.Linear(hidden, mlp_hidden, bias=True),
                         nn.GELU(approximate="tanh"), sd.Linear(mlp_hidden, hidden, bias=True))


class DoubleStreamBlock(nn.Module):
    def __init__(self, hidden: int, heads: int, mlp_ratio: float, qkv_bias: bool):
        super().__init__()
        mlp_hidden = int(hidden * mlp_ratio)
        self.num_heads = heads
        self.img_mod = Modulation(hidden, double=True)
        self.img_attn = SelfAttention(hidden, heads, qkv_bias)
        self.img_mlp = _mlp(hidden, mlp_hidden)
        self.txt_mod = Modulation(hidden, double=True)
        self.txt_attn = SelfAttention(hidden, heads, qkv_bias)
        self.txt_mlp = _mlp(hidden, mlp_hidden)

    def forward(self, img, txt, vec, pe):
        a1, b1, g1, a2, b2, g2 = self.img_mod(vec)
        ta1, tb1, tg1, ta2, tb2, tg2 = self.txt_mod(vec)
        img_q, img_k, img_v = split_qkv(self.img_attn.qkv((1 + b1) * layer_norm(img) + a1),
                                        self.num_heads)
        img_q, img_k = self.img_attn.norm(img_q, img_k, img_v)
        txt_q, txt_k, txt_v = split_qkv(self.txt_attn.qkv((1 + tb1) * layer_norm(txt) + ta1),
                                        self.num_heads)
        txt_q, txt_k = self.txt_attn.norm(txt_q, txt_k, txt_v)
        attn = attention(torch.cat((txt_q, img_q), dim=2), torch.cat((txt_k, img_k), dim=2),
                         torch.cat((txt_v, img_v), dim=2), pe)
        txt_attn, img_attn = attn[:, :txt.shape[1]], attn[:, txt.shape[1]:]
        img = img + g1 * self.img_attn.proj(img_attn)
        img = img + g2 * self.img_mlp((1 + b2) * layer_norm(img) + a2)
        txt = txt + tg1 * self.txt_attn.proj(txt_attn)
        txt = txt + tg2 * self.txt_mlp((1 + tb2) * layer_norm(txt) + ta2)
        return img, txt


class SingleStreamBlock(nn.Module):
    def __init__(self, hidden: int, heads: int, mlp_ratio: float):
        super().__init__()
        self.hidden_size, self.num_heads = hidden, heads
        self.mlp_hidden_dim = int(hidden * mlp_ratio)
        self.linear1 = sd.Linear(hidden, hidden * 3 + self.mlp_hidden_dim)
        self.linear2 = sd.Linear(hidden + self.mlp_hidden_dim, hidden)
        self.norm = QKNorm(hidden // heads)
        self.mlp_act = nn.GELU(approximate="tanh")
        self.modulation = Modulation(hidden, double=False)

    def forward(self, x, vec, pe):
        shift, scale, gate = self.modulation(vec)
        x_mod = (1 + scale) * layer_norm(x) + shift
        qkv, mlp = torch.split(self.linear1(x_mod), [3 * self.hidden_size, self.mlp_hidden_dim],
                               dim=-1)
        q, k, v = split_qkv(qkv, self.num_heads)
        q, k = self.norm(q, k, v)
        attn = attention(q, k, v, pe)
        return x + gate * self.linear2(torch.cat((attn, self.mlp_act(mlp)), 2))


class LastLayer(nn.Module):
    def __init__(self, hidden: int, out_channels: int):
        super().__init__()
        self.linear = sd.Linear(hidden, out_channels, bias=True)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), sd.Linear(hidden, 2 * hidden, bias=True))

    def forward(self, x, vec):
        shift, scale = self.adaLN_modulation(vec).chunk(2, dim=1)
        return self.linear((1 + scale[:, None, :]) * layer_norm(x) + shift[:, None, :])


class Flux(nn.Module):
    """BFL's ``Flux`` (``model.py``).  ``forward``'s ``take(name, module)``
    hands each top-level part over before it runs (:func:`streamed`)."""

    def __init__(self, p: FluxParams = FluxParams()):
        super().__init__()
        self.params = p
        self.in_channels = self.out_channels = p.in_channels
        self.hidden_size, self.num_heads = p.hidden_size, p.num_heads
        self.pe_embedder = EmbedND(p.hidden_size // p.num_heads, p.theta, p.axes_dim)
        self.img_in = sd.Linear(p.in_channels, p.hidden_size, bias=True)
        self.time_in = MLPEmbedder(TIME_DIM, p.hidden_size)
        self.vector_in = MLPEmbedder(p.vec_in_dim, p.hidden_size)
        if p.guidance_embed:
            self.guidance_in = MLPEmbedder(TIME_DIM, p.hidden_size)
        self.txt_in = sd.Linear(p.context_in_dim, p.hidden_size)
        self.double_blocks = nn.ModuleList([
            DoubleStreamBlock(p.hidden_size, p.num_heads, p.mlp_ratio, p.qkv_bias)
            for _ in range(p.depth)])
        self.single_blocks = nn.ModuleList([
            SingleStreamBlock(p.hidden_size, p.num_heads, p.mlp_ratio)
            for _ in range(p.depth_single_blocks)])
        self.final_layer = LastLayer(p.hidden_size, self.out_channels)

    def forward(self, img, img_ids, txt, txt_ids, timesteps, y, guidance=None, take=None):
        take = take or (lambda name, module: module)
        img = take("img_in", self.img_in)(img)
        vec = take("time_in", self.time_in)(timestep_embedding(timesteps, TIME_DIM).to(img.dtype))
        if self.params.guidance_embed:
            vec = vec + take("guidance_in", self.guidance_in)(
                timestep_embedding(guidance, TIME_DIM).to(img.dtype))
        vec = vec + take("vector_in", self.vector_in)(y)
        txt = take("txt_in", self.txt_in)(txt)
        pe = self.pe_embedder(torch.cat((txt_ids, img_ids), dim=1))
        for i, block in enumerate(self.double_blocks):
            img, txt = take(f"double_blocks.{i}", block)(img, txt, vec, pe)
        img = torch.cat((txt, img), 1)
        for i, block in enumerate(self.single_blocks):
            img = take(f"single_blocks.{i}", block)(img, vec, pe)
        img = img[:, txt.shape[1]:, ...]
        return take("final_layer", self.final_layer)(img, vec)


def streamed(seed: int, purpose: int, device, dtype=torch.float32, fp8: bool = False):
    """A ``take`` for :meth:`Flux.forward` on a model built on the meta
    device: each part made on ``device`` from :func:`draw` just before it
    runs, in ``dtype`` (its Linear operands rounded to fp8 with ``fp8``), and
    given back to the meta device after the next part is taken."""
    held = []

    def release():
        while held:
            held.pop().to_empty(device="meta")

    def take(name, module):
        release()
        module.to_empty(device=device)
        fill(module, seed, purpose, device, prefix=name + ".")
        module.to(dtype)
        if fp8:
            sd.set_fp8(module)
        held.append(module)
        return module
    take.release = release
    return take


def pack(x):
    """``rearrange(x, "b c (h ph) (w pw) -> b (h w) (c ph pw)", ph=2, pw=2)``."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // PATCH, PATCH, w // PATCH, PATCH).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b, (h // PATCH) * (w // PATCH), c * PATCH * PATCH)


def unpack(x, h: int, w: int):
    """``rearrange(x, "b (h w) (c ph pw) -> b c (h ph) (w pw)", ph=2, pw=2)``."""
    b, _, d = x.shape
    c = d // (PATCH * PATCH)
    x = x.reshape(b, h // PATCH, w // PATCH, c, PATCH, PATCH).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(b, c, h, w)


def ids(b: int, n_txt: int, h: int, w: int, device):
    """``sampling.py::prepare``'s img_ids [b, hw/4, 3] and txt_ids [b, n_txt, 3]."""
    img_ids = torch.zeros(h // PATCH, w // PATCH, 3, device=device)
    img_ids[..., 1] = img_ids[..., 1] + torch.arange(h // PATCH, device=device)[:, None]
    img_ids[..., 2] = img_ids[..., 2] + torch.arange(w // PATCH, device=device)[None, :]
    img_ids = img_ids.reshape(1, -1, 3).expand(b, -1, -1)
    return img_ids, torch.zeros(b, n_txt, 3, device=device)


def velocity(model: Flux, x, sigma, context, pooled, guidance, take=None,
             dtype=torch.float32):
    """v̂ [B, C, h, w] of latents x at σ [B] for the context [B, T, 4096],
    pooled [B, 768] and guidance [B]: packed, run in ``dtype``, unpacked,
    f32."""
    b, _, h, w = x.shape
    img_ids, txt_ids = ids(b, context.shape[1], h, w, x.device)
    out = model(pack(x).to(dtype), img_ids, context.to(dtype), txt_ids, sigma,
                pooled.to(dtype), guidance, take=take)
    return unpack(out.float(), h, w)


# ---------------------------------------------------------------- the step
def time_shift_mu(tokens: int) -> float:
    """``sampling.py::get_lin_function``'s μ at the image's token count."""
    (x1, y1), (x2, y2) = SHIFT
    m = (y2 - y1) / (x2 - x1)
    return m * tokens + (y1 - m * x1)


def sigma_of(t, tokens: int):
    """σ of the integer timestep t: ``time_shift(μ, 1, t/1000)``."""
    s0 = t.double() / 1000.0
    em = math.exp(time_shift_mu(tokens))
    return (em / (em + (1.0 / s0 - 1.0))).float()


def sds_grad(model, latents, noise, t, context, pooled, guidance: float, lambda_sd: float,
             take=None, dtype=torch.float32):
    """The flow SDS cotangent and its loss 0.5·Σ grad² (module docstring)."""
    b, _, h, w = latents.shape
    sigma = sigma_of(t, (h // PATCH) * (w // PATCH)).expand(b)
    s = sigma.reshape(b, 1, 1, 1)
    noisy = (1.0 - s) * latents + s * noise
    g = torch.full((b,), float(guidance), device=latents.device)
    v = velocity(model, noisy, sigma, context, pooled, g, take, dtype)
    eps_hat = noisy + (1.0 - s) * v
    weight = s * s / ((1.0 - s) ** 2 + s * s)
    grad = torch.nan_to_num(weight * (eps_hat - noise) * lambda_sd)
    return grad, 0.5 * (grad ** 2).sum()


# ------------------------------------------------------------------------ VAE
class VAE(nn.Module):
    """SD's AutoencoderKL without quant convs (FLUX's ``vae/config.json``:
    ``use_quant_conv`` and ``use_post_quant_conv`` false)."""

    def __init__(self, cfg: sd.VAEConfig, shift_factor: float):
        super().__init__()
        self.cfg, self.shift_factor = cfg, shift_factor
        self.encoder = sd.Encoder(cfg)
        self.decoder = sd.Decoder(cfg)

    def moments(self, images):
        mean, logvar = self.encoder(images).chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def latents(self, mean, logvar, noise):
        """(the posterior sample − shift)·scale."""
        return (mean + torch.exp(0.5 * logvar) * noise - self.shift_factor) \
            * self.cfg.scaling_factor


def vae_config(v: dict, dtype: str = "float32") -> sd.VAEConfig:
    return sd.VAEConfig(in_channels=v["in_channels"], latent_channels=v["latent_channels"],
                        block_out_channels=tuple(v["block_out_channels"]),
                        layers_per_block=v["layers_per_block"],
                        norm_num_groups=v["norm_num_groups"],
                        scaling_factor=v["scaling_factor"], dtype=dtype)


# ------------------------------------------------------------------------- T5
@dataclass(frozen=True)
class T5Config:
    """``text_encoder_2/config.json`` (T5 v1.1 XXL)."""
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6


def t5_config(t: dict) -> T5Config:
    return T5Config(**{k: t[k] for k in T5Config.__dataclass_fields__})


def _relative_position_bucket(relative_position, num_buckets: int, max_distance: int):
    """transformers' ``T5Attention._relative_position_bucket``, bidirectional."""
    num_buckets //= 2
    relative_buckets = (relative_position > 0).to(torch.long) * num_buckets
    relative_position = torch.abs(relative_position)
    max_exact = num_buckets // 2
    is_small = relative_position < max_exact
    large = max_exact + (torch.log(relative_position.float() / max_exact)
                         / math.log(max_distance / max_exact)
                         * (num_buckets - max_exact)).to(torch.long)
    large = torch.min(large, torch.full_like(large, num_buckets - 1))
    return relative_buckets + torch.where(is_small, relative_position, large)


class T5LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.variance_epsilon = eps

    def forward(self, x):
        variance = x.float().pow(2).mean(-1, keepdim=True)
        return self.weight * (x.float() * torch.rsqrt(variance + self.variance_epsilon)
                              ).to(self.weight.dtype)


class T5Attention(nn.Module):
    def __init__(self, c: T5Config, has_relative_attention_bias: bool):
        super().__init__()
        self.c = c
        inner = c.num_heads * c.d_kv
        self.q = sd.Linear(c.d_model, inner, bias=False)
        self.k = sd.Linear(c.d_model, inner, bias=False)
        self.v = sd.Linear(c.d_model, inner, bias=False)
        self.o = sd.Linear(inner, c.d_model, bias=False)
        if has_relative_attention_bias:
            self.relative_attention_bias = nn.Embedding(c.relative_attention_num_buckets,
                                                        c.num_heads)

    def compute_bias(self, n: int, device):
        pos = torch.arange(n, dtype=torch.long, device=device)
        buckets = _relative_position_bucket(pos[None, :] - pos[:, None],
                                            self.c.relative_attention_num_buckets,
                                            self.c.relative_attention_max_distance)
        return self.relative_attention_bias(buckets).permute(2, 0, 1).unsqueeze(0)

    def forward(self, x, position_bias):
        b, n, _ = x.shape

        def shape(t):
            return t.view(b, n, self.c.num_heads, self.c.d_kv).transpose(1, 2)
        q, k, v = shape(self.q(x)), shape(self.k(x)), shape(self.v(x))
        scores = torch.matmul(q, k.transpose(3, 2)) + position_bias
        weights = F.softmax(scores.float(), dim=-1).type_as(scores)
        out = torch.matmul(weights, v).transpose(1, 2).reshape(b, n, -1)
        return self.o(out)


class T5LayerSelfAttention(nn.Module):
    def __init__(self, c: T5Config, has_bias: bool):
        super().__init__()
        self.SelfAttention = T5Attention(c, has_bias)
        self.layer_norm = T5LayerNorm(c.d_model, c.layer_norm_epsilon)

    def forward(self, x, position_bias):
        return x + self.SelfAttention(self.layer_norm(x), position_bias)


class T5DenseGatedActDense(nn.Module):
    def __init__(self, c: T5Config):
        super().__init__()
        self.wi_0 = sd.Linear(c.d_model, c.d_ff, bias=False)
        self.wi_1 = sd.Linear(c.d_model, c.d_ff, bias=False)
        self.wo = sd.Linear(c.d_ff, c.d_model, bias=False)

    def forward(self, x):
        return self.wo(F.gelu(self.wi_0(x), approximate="tanh") * self.wi_1(x))


class T5LayerFF(nn.Module):
    def __init__(self, c: T5Config):
        super().__init__()
        self.DenseReluDense = T5DenseGatedActDense(c)
        self.layer_norm = T5LayerNorm(c.d_model, c.layer_norm_epsilon)

    def forward(self, x):
        return x + self.DenseReluDense(self.layer_norm(x))


class T5Block(nn.Module):
    def __init__(self, c: T5Config, has_bias: bool):
        super().__init__()
        self.layer = nn.ModuleList([T5LayerSelfAttention(c, has_bias), T5LayerFF(c)])

    def forward(self, x, position_bias):
        return self.layer[1](self.layer[0](x, position_bias))


class T5Stack(nn.Module):
    def __init__(self, c: T5Config):
        super().__init__()
        self.block = nn.ModuleList([T5Block(c, i == 0) for i in range(c.num_layers)])
        self.final_layer_norm = T5LayerNorm(c.d_model, c.layer_norm_epsilon)


class T5EncoderModel(nn.Module):
    """transformers' ``T5EncoderModel`` with no attention mask (FLUX's
    pipelines pass none)."""

    def __init__(self, c: T5Config = T5Config()):
        super().__init__()
        self.shared = nn.Embedding(c.vocab_size, c.d_model)
        self.encoder = T5Stack(c)

    def forward(self, input_ids):
        x = self.shared(input_ids)
        bias = self.encoder.block[0].layer[0].SelfAttention.compute_bias(input_ids.shape[1],
                                                                         input_ids.device)
        for block in self.encoder.block:
            x = block(x, bias)
        return self.encoder.final_layer_norm(x)
