"""CLIP text encoding for SD prompts (counterpart of
``customnerf_tpu/guidance/text.py``).

The transformer is a PyTorch CLIP text model in place of transformers'
``FlaxCLIPTextModel``, named after Hugging Face's ``CLIPTextModel`` state
dict (``text_model.encoder.layers.0.self_attn.q_proj``): pre-LayerNorm
layers under a causal mask and a final LayerNorm; ``last_hidden_state`` is
taken after it.  :func:`text_config` gives the JAX package's towers
(``customnerf_tpu/guidance/text.py::_text_config``): for SD 1.x CLIP
ViT-L/14's (768 wide, 12 layers, ``quick_gelu``), for SD 2.x OpenCLIP
ViT-H's (1024 wide, 23 layers, 16 heads, exact-erf ``gelu``, which flax
lowers as ``nn.gelu(approximate=False)``).

SDXL (``--sd_version xl``, :class:`DualTextEncoder`) runs two towers, as
diffusers' ``StableDiffusionXLPipeline.encode_prompt`` does: CLIP ViT-L/14
(``text_encoder``) and OpenCLIP ViT-bigG/14 (``text_encoder_2``: 1280 wide,
32 layers, 20 heads, an MLP of 5120, exact GELU, and a bias-free
``text_projection`` to 1280).  The context is each tower's penultimate
hidden state (the input of its last layer, before the final LayerNorm),
concatenated to [77, 768 + 1280]; the pooled embedding is bigG's
``text_projection`` of its final-LayerNorm state at the first EOS.  An
empty negative prompt gives zeros for both (``force_zeros_for_empty_prompt``,
the base pipeline's default with no negative prompt).  Each tower has its
tokenizer (``tokenizer/``, ``tokenizer_2/``); both pad with EOS, where
diffusers' ``tokenizer_2`` pads with "!" (id 0): the deviation stated for
2.x, which changes the context at the padded positions only (the causal
mask keeps every earlier position, the EOS state among them, as it is).

Tokenizer: the real CLIP BPE (``guidance/bpe.py``) when a ``tokenizer/`` dir
exists under ``--sd_weights``, else :class:`HashTokenizer`, which gives the
JAX package's ids (md5 word buckets).  Both pad to 77 with EOS, as the JAX
package's do, for either SD version (diffusers' SD 2.x tokenizer pads with
"!", id 0: a stated deviation of the reference, ROADMAP.md).  Both take added modifier tokens such
as Custom Diffusion's ``<new1>`` (ids from 49408 on); :func:`register_token`
adds one and installs its embedding row, growing the token table.
"""

from __future__ import annotations

import hashlib
import math
import os
from dataclasses import dataclass
from typing import List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from customnerf_torch.guidance.bpe import ClipBPETokenizer
from customnerf_torch.guidance.layers import build

MAX_LEN = 77
BOS, EOS = 49406, 49407
VOCAB = 49408


class HashTokenizer:
    """Deterministic stand-in tokenizer: word → stable md5 bucket, BOS/EOS
    framing and EOS padding to 77, like CLIP's; added modifier tokens keep
    their own ids."""

    def __init__(self):
        self.added_tokens = {}
        self.next_id = VOCAB

    def add_token(self, token: str) -> int:
        if token not in self.added_tokens:
            self.added_tokens[token] = self.next_id
            self.next_id += 1
        return self.added_tokens[token]

    @property
    def vocab_size(self) -> int:
        return self.next_id

    def __call__(self, prompts: List[str], **_):
        ids = np.full((len(prompts), MAX_LEN), EOS, dtype=np.int32)
        for i, p in enumerate(prompts):
            toks = [BOS]
            for w in p.lower().split():
                if w in self.added_tokens:
                    toks.append(self.added_tokens[w])
                else:
                    h = int(hashlib.md5(w.encode()).hexdigest(), 16)
                    toks.append(h % (BOS - 1) + 1)
                if len(toks) >= MAX_LEN - 1:
                    break
            toks.append(EOS)
            ids[i, : len(toks)] = toks
        return ids


@dataclass(frozen=True)
class CLIPTextConfig:
    """SD 1.x's CLIP ViT-L/14 text tower by default."""
    vocab_size: int = VOCAB
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = MAX_LEN
    layer_norm_eps: float = 1e-5
    eos_token_id: int = EOS
    hidden_act: str = "quick_gelu"      # "quick_gelu" | "gelu" (exact erf)


def quick_gelu(h):
    return h * torch.sigmoid(1.702 * h)


_ACTIVATIONS = {"quick_gelu": quick_gelu, "gelu": F.gelu}


class CLIPAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x, bias=None):
        b, n, dim = x.shape
        d = dim // self.heads

        def split(t):
            return t.view(b, n, self.heads, d).transpose(1, 2)

        q, k, v = split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x))
        scores = torch.matmul(q * d ** -0.5, k.transpose(-1, -2))
        if bias is not None:
            scores = scores + bias
        out = torch.matmul(scores.softmax(dim=-1), v)
        return self.out_proj(out.transpose(1, 2).reshape(b, n, dim))


class CLIPMLP(nn.Module):
    """fc1 → the activation → fc2: quick_gelu (x·σ(1.702x)) for the
    ViT-L/14 and ViT-B/32 towers, exact gelu for OpenCLIP ViT-H."""

    def __init__(self, dim: int, inner: int, act: str = "quick_gelu"):
        super().__init__()
        if act not in _ACTIVATIONS:
            raise ValueError(f"hidden_act must be one of {sorted(_ACTIVATIONS)}, got {act}")
        self.act = _ACTIVATIONS[act]
        self.fc1 = nn.Linear(dim, inner)
        self.fc2 = nn.Linear(inner, dim)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, dim, inner, heads, eps, act="quick_gelu"):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(dim, eps=eps)
        self.self_attn = CLIPAttention(dim, heads)
        self.layer_norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = CLIPMLP(dim, inner, act)

    def forward(self, x, bias=None):
        x = x + self.self_attn(self.layer_norm1(x), bias)
        return x + self.mlp(self.layer_norm2(x))


class CLIPEncoder(nn.Module):
    def __init__(self, dim, inner, heads, n_layers, eps, act="quick_gelu"):
        super().__init__()
        self.layers = nn.ModuleList(
            [CLIPEncoderLayer(dim, inner, heads, eps, act) for _ in range(n_layers)])

    def forward(self, x, bias=None, penultimate=False):
        """The last layer's output; with ``penultimate`` also its input."""
        for layer in self.layers[:-1]:
            x = layer(x, bias)
        out = self.layers[-1](x, bias)
        return (out, x) if penultimate else out


class CLIPTextEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings,
                                               cfg.hidden_size)

    def forward(self, ids, row=None, row_id=None):
        """``row``: a [hidden] tensor taking the place of token ``row_id``'s
        table row (Custom Diffusion's trainable modifier token: the gradient
        reaches that row alone)."""
        pos = torch.arange(ids.shape[1], device=ids.device)
        tok = self.token_embedding(ids)
        if row is not None:
            tok = torch.where((ids == row_id)[..., None], row.to(tok.dtype), tok)
        return tok + self.position_embedding(pos)[None]


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = CLIPTextEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg.hidden_size, cfg.intermediate_size,
                                   cfg.num_attention_heads,
                                   cfg.num_hidden_layers, cfg.layer_norm_eps,
                                   cfg.hidden_act)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, ids, row=None, row_id=None, penultimate=False):
        """ids [B, L] int → (last_hidden_state [B, L, D], pooled [B, D]: the
        state at each row's first EOS), and with ``penultimate`` the hidden
        state before the last layer [B, L, D] third; ``row``/``row_id`` as
        in :class:`CLIPTextEmbeddings`."""
        x = self.embeddings(ids, row, row_id)
        L = ids.shape[1]
        causal = torch.ones(L, L, dtype=torch.bool, device=ids.device).tril()
        bias = torch.zeros(L, L, device=ids.device, dtype=x.dtype).masked_fill(
            ~causal, torch.finfo(x.dtype).min)
        h, pen = self.encoder(x, bias, penultimate=True)
        h = self.final_layer_norm(h)
        eos = (ids == self.cfg.eos_token_id).int().argmax(dim=-1)
        out = (h, h[torch.arange(h.shape[0], device=h.device), eos])
        return out + (pen,) if penultimate else out


class CLIPTextModel(nn.Module):
    """Hugging Face's ``CLIPTextModel`` layout: everything under
    ``text_model``."""

    def __init__(self, cfg: CLIPTextConfig = CLIPTextConfig()):
        super().__init__()
        self.text_model = CLIPTextTransformer(cfg)

    def forward(self, ids):
        return self.text_model(ids)[0]


class CLIPTextModelWithProjection(nn.Module):
    """Hugging Face's ``CLIPTextModelWithProjection`` layout: the tower
    under ``text_model`` and a bias-free ``text_projection`` of its pooled
    state (SDXL's ``text_encoder_2``)."""

    def __init__(self, cfg: CLIPTextConfig, projection_dim: int):
        super().__init__()
        self.text_model = CLIPTextTransformer(cfg)
        self.text_projection = nn.Linear(cfg.hidden_size, projection_dim, bias=False)


def text_config(sd_version: str) -> CLIPTextConfig:
    """The JAX package's text tower for ``sd_version``: OpenCLIP ViT-H for
    2.x, CLIP ViT-L/14 otherwise (SDXL's first tower too)."""
    if str(sd_version).startswith("2"):
        return CLIPTextConfig(hidden_size=1024, intermediate_size=4096,
                              num_hidden_layers=23, num_attention_heads=16,
                              hidden_act="gelu")
    return CLIPTextConfig()


# SDXL's second tower, OpenCLIP ViT-bigG/14 (text_encoder_2/config.json)
BIGG = CLIPTextConfig(hidden_size=1280, intermediate_size=5120, num_hidden_layers=32,
                      num_attention_heads=20, hidden_act="gelu")
BIGG_PROJECTION = 1280


def make_text_encoder(sd_version: str, weights_dir: Optional[str] = None, device=None,
                      generator=None, dtype: Optional[torch.dtype] = None):
    """The text encoder ``--sd_version`` takes: :class:`DualTextEncoder`
    for xl, :class:`FluxTextEncoder` for flux-dev (T5 stored in ``dtype``),
    else :class:`TextEncoder`."""
    version = str(sd_version).lower()
    if version == "xl":
        return DualTextEncoder(weights_dir=weights_dir, device=device, generator=generator)
    if version == "flux-dev":
        return FluxTextEncoder(weights_dir=weights_dir, device=device, generator=generator,
                               t5_dtype=dtype)
    return TextEncoder(sd_version, weights_dir=weights_dir, device=device,
                       generator=generator)


def _tokenizer(weights_dir: Optional[str], sub: str):
    """The CLIP BPE of ``weights_dir/sub`` where it loads, else
    :class:`HashTokenizer`."""
    tok_dir = os.path.join(weights_dir, sub) if weights_dir else None
    if tok_dir and os.path.isdir(tok_dir):
        try:
            return ClipBPETokenizer.from_dir(tok_dir)
        except (OSError, ValueError, KeyError) as e:
            print(f"[WARN] tokenizer load failed ({e}); hash fallback.")
    return HashTokenizer()


class TextEncoder:
    """Tokenizer + CLIP text model; ``get_text_embeds`` gives the
    ``[uncond; cond]`` stack SDS expects (reference sd.py:77-94)."""

    def __init__(self, sd_version: str = "1.5", weights_dir: Optional[str] = None,
                 device=None, generator=None, model: nn.Module | None = None):
        self.tokenizer = _tokenizer(weights_dir, "tokenizer")
        self.model = model if model is not None else build(
            CLIPTextModel, text_config(sd_version), device=device,
            generator=generator)

    @property
    def width(self) -> int:
        """The context's width."""
        return self.model.text_model.cfg.hidden_size

    def tokenize(self, prompts: List[str]) -> np.ndarray:
        return np.asarray(self.tokenizer(prompts, max_length=MAX_LEN),
                          dtype=np.int32)

    @torch.no_grad()
    def encode(self, prompts: List[str]) -> torch.Tensor:
        """[n] prompts → last_hidden_state [n, 77, hidden]."""
        dev = next(self.model.parameters()).device
        ids = torch.from_numpy(self.tokenize(prompts)).long().to(dev)
        return self.model(ids)

    def get_text_embeds(self, prompt: List[str], negative_prompt: List[str]):
        return torch.cat([self.encode(negative_prompt), self.encode(prompt)])


class PooledText(NamedTuple):
    """SDXL's embedding of prompts, the context [n, 77, 2048] and the pooled
    embedding [n, 1280], or FLUX's, T5's context [n, 512, 4096] and CLIP-L's
    pooled state [n, 768]: the two travel together."""
    context: torch.Tensor
    pooled: torch.Tensor


class SDXLTextTowers(nn.Module):
    """The two towers under diffusers' directory names."""

    def __init__(self, cfg_1: CLIPTextConfig = CLIPTextConfig(),
                 cfg_2: CLIPTextConfig = BIGG, projection_dim: int = BIGG_PROJECTION):
        super().__init__()
        self.text_encoder = CLIPTextModel(cfg_1)
        self.text_encoder_2 = CLIPTextModelWithProjection(cfg_2, projection_dim)


class DualTextEncoder:
    """SDXL's two tokenizers and towers (module docstring); ``get_text_embeds``
    gives a :class:`PooledText` of ``[uncond; cond]``.  ``model``: an
    :class:`SDXLTextTowers` (reduced widths in tests), else the full-width
    towers built on ``device`` from ``generator``."""

    def __init__(self, weights_dir: Optional[str] = None, device=None, generator=None,
                 model: SDXLTextTowers | None = None):
        self.tokenizer = _tokenizer(weights_dir, "tokenizer")
        self.tokenizer_2 = _tokenizer(weights_dir, "tokenizer_2")
        self.model = model if model is not None else build(
            SDXLTextTowers, device=device, generator=generator)

    @property
    def width(self) -> int:
        """The context's width: the two towers' together."""
        return sum(m.text_model.cfg.hidden_size for m in
                   (self.model.text_encoder, self.model.text_encoder_2))

    @torch.no_grad()
    def encode(self, prompts: List[str]) -> PooledText:
        """[n] prompts → (the penultimate states of both towers side by side
        [n, 77, width], bigG's projected pooled state [n, projection])."""
        dev = next(self.model.parameters()).device

        def ids(tok):
            return torch.from_numpy(np.asarray(tok(prompts, max_length=MAX_LEN),
                                               dtype=np.int64)).to(dev)
        _, _, pen_1 = self.model.text_encoder.text_model(ids(self.tokenizer),
                                                         penultimate=True)
        tower_2 = self.model.text_encoder_2
        _, pooled, pen_2 = tower_2.text_model(ids(self.tokenizer_2), penultimate=True)
        return PooledText(torch.cat([pen_1, pen_2], dim=-1), tower_2.text_projection(pooled))

    def get_text_embeds(self, prompt: List[str], negative_prompt: List[str]) -> PooledText:
        """[uncond; cond]: an empty negative prompt's context and pooled
        embedding are zeros."""
        cond, neg = self.encode(prompt), self.encode(negative_prompt)
        empty = torch.tensor([not n for n in negative_prompt], device=cond.context.device)
        neg = PooledText(neg.context.masked_fill(empty[:, None, None], 0.0),
                         neg.pooled.masked_fill(empty[:, None], 0.0))
        return PooledText(torch.cat([neg.context, cond.context]),
                          torch.cat([neg.pooled, cond.pooled]))


# ------------------------------------------------------------------- FLUX
@dataclass(frozen=True)
class T5Config:
    """T5 v1.1 XXL's encoder (FLUX.1-dev's ``text_encoder_2/config.json``):
    24 layers of d_model 4096, 64 heads of 64, a gated tanh-GELU MLP of
    10240, RMS norms of ε 1e-6 and 32 bidirectional relative-position
    buckets up to a distance of 128; prompts of ``max_length`` tokens."""
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    max_length: int = 512


T5_PAD, T5_EOS = 0, 1


class T5HashTokenizer:
    """The stand-in for T5's SentencePiece model (its package is not part
    of the port): word → stable md5 bucket past the specials, EOS after the
    last word, padding to ``max_length`` with 0, as the published
    tokenizer pads."""

    def __init__(self, max_length: int = 512, vocab_size: int = 32128):
        self.max_length, self.vocab_size = max_length, vocab_size

    def __call__(self, prompts: List[str], **_):
        ids = np.full((len(prompts), self.max_length), T5_PAD, dtype=np.int64)
        for i, p in enumerate(prompts):
            toks = [int(hashlib.md5(w.encode()).hexdigest(), 16) % (self.vocab_size - 3) + 3
                    for w in p.lower().split()][: self.max_length - 1]
            ids[i, : len(toks) + 1] = toks + [T5_EOS]
        return ids


class T5LayerNorm(nn.Module):
    """T5's RMS norm: x·rsqrt(mean(x²) + ε) in f32, cast back, times the
    weight (no bias, no mean)."""
    unit_init = True

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        xf = x.float()
        y = (xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + self.eps)).to(x.dtype)
        return self.weight.to(x.dtype) * y


def relative_position_bucket(rel, num_buckets: int, max_distance: int):
    """T5's bidirectional bucket of each key − query offset: half the
    buckets a sign, exact up to a quarter of them, then logarithmic up to
    ``max_distance``."""
    half = num_buckets // 2
    out = (rel > 0).long() * half
    n = rel.abs()
    exact = half // 2
    large = exact + (torch.log(n.float().clamp(min=1) / exact) / math.log(max_distance / exact)
                     * (half - exact)).long()
    return out + torch.where(n < exact, n, large.clamp(max=half - 1))


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        self.cfg = cfg
        self.q = nn.Linear(cfg.d_model, inner, bias=False)
        self.k = nn.Linear(cfg.d_model, inner, bias=False)
        self.v = nn.Linear(cfg.d_model, inner, bias=False)
        self.o = nn.Linear(inner, cfg.d_model, bias=False)
        if has_bias:
            self.relative_attention_bias = nn.Embedding(cfg.relative_attention_num_buckets,
                                                        cfg.num_heads)

    def position_bias(self, n: int, device) -> torch.Tensor:
        """[1, heads, n, n] f32: each head's bias of each key − query offset."""
        pos = torch.arange(n, device=device)
        buckets = relative_position_bucket(pos[None, :] - pos[:, None],
                                           self.cfg.relative_attention_num_buckets,
                                           self.cfg.relative_attention_max_distance)
        return self.relative_attention_bias(buckets).float().permute(2, 0, 1)[None]

    def forward(self, x, bias):
        """No 1/√d on the logits (T5's scale sits in its weights); logits,
        bias and softmax in f32, the probabilities in the values' dtype."""
        b, n, _ = x.shape
        h, d = self.cfg.num_heads, self.cfg.d_kv

        def split(t):
            return t.view(b, n, h, d).transpose(1, 2)
        q, k, v = split(self.q(x)), split(self.k(x)), split(self.v(x))
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) + bias
        out = torch.matmul(scores.softmax(dim=-1).to(v.dtype), v)
        return self.o(out.transpose(1, 2).reshape(b, n, h * d))


class T5SelfAttentionLayer(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool):
        super().__init__()
        self.SelfAttention = T5Attention(cfg, has_bias)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon)


class T5DenseGatedAct(nn.Module):
    """wo(gelu_tanh(wi_0(x)) · wi_1(x))."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)

    def forward(self, x):
        return self.wo(F.gelu(self.wi_0(x), approximate="tanh") * self.wi_1(x))


class T5FFLayer(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.DenseReluDense = T5DenseGatedAct(cfg)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon)


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool):
        super().__init__()
        self.layer = nn.ModuleList([T5SelfAttentionLayer(cfg, has_bias), T5FFLayer(cfg)])

    def forward(self, x, bias):
        att, ff = self.layer
        x = x + att.SelfAttention(att.layer_norm(x), bias)
        return x + ff.DenseReluDense(ff.layer_norm(x))


class T5Stack(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.block = nn.ModuleList([T5Block(cfg, i == 0) for i in range(cfg.num_layers)])
        self.final_layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon)


class T5EncoderModel(nn.Module):
    """Hugging Face's ``T5EncoderModel`` layout (``shared``,
    ``encoder.block.<i>.layer.<0|1>``, ``encoder.final_layer_norm``); the
    relative-position bias lives in block 0 and every block adds it.  No
    attention mask: FLUX's pipelines run T5 on the whole padded prompt."""

    def __init__(self, cfg: T5Config = T5Config()):
        super().__init__()
        self.cfg = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.encoder = T5Stack(cfg)

    def forward(self, ids):
        """ids [B, L] → the final-norm state [B, L, d_model]."""
        x = self.shared(ids)
        blocks = self.encoder.block
        bias = blocks[0].layer[0].SelfAttention.position_bias(ids.shape[1], ids.device)
        for block in blocks:
            x = block(x, bias)
        return self.encoder.final_layer_norm(x)


class FluxTextTowers(nn.Module):
    """FLUX.1-dev's towers under diffusers' directory names: CLIP ViT-L/14
    (``text_encoder``, its pooled state) and T5 v1.1 XXL's encoder
    (``text_encoder_2``, the context)."""

    def __init__(self, clip_cfg: CLIPTextConfig = CLIPTextConfig(),
                 t5_cfg: T5Config = T5Config()):
        super().__init__()
        self.text_encoder = CLIPTextModel(clip_cfg)
        self.text_encoder_2 = T5EncoderModel(t5_cfg)


def flux_text_towers(device=None, generator=None, t5_dtype=None,
                     clip_cfg: CLIPTextConfig = CLIPTextConfig(),
                     t5_cfg: T5Config = T5Config()) -> FluxTextTowers:
    """The towers with seeded random weights, CLIP-L in f32 and T5 stored in
    ``t5_dtype`` (drawn one tensor at a time, never whole in f32)."""
    towers = build(FluxTextTowers, clip_cfg, t5_cfg, device="meta")
    towers.text_encoder = build(CLIPTextModel, clip_cfg, device=device, generator=generator)
    towers.text_encoder_2 = build(T5EncoderModel, t5_cfg, device=device, generator=generator,
                                  dtype=t5_dtype)
    return towers


class FluxTextEncoder:
    """FLUX's prompts: ``get_text_embeds`` gives a :class:`PooledText` of
    T5's final state over the prompt padded to 512 tokens and CLIP-L's
    pooled state (no negative prompt: the model is guidance-distilled and
    runs no CFG batch).  The CLIP tokenizer is the BPE of
    ``weights_dir/tokenizer`` where it loads, else :class:`HashTokenizer`;
    T5's is :class:`T5HashTokenizer`.  ``model``: a :class:`FluxTextTowers`
    (reduced widths in tests), else the full-width towers built on
    ``device`` from ``generator``, T5 stored in ``t5_dtype``."""

    def __init__(self, weights_dir: Optional[str] = None, device=None, generator=None,
                 model: FluxTextTowers | None = None, t5_dtype=None):
        self.tokenizer = _tokenizer(weights_dir, "tokenizer")
        self.model = model if model is not None else flux_text_towers(device, generator,
                                                                      t5_dtype)
        t5 = self.model.text_encoder_2.cfg
        self.tokenizer_2 = T5HashTokenizer(t5.max_length, t5.vocab_size)

    @property
    def width(self) -> int:
        """The context's width: T5's d_model."""
        return self.model.text_encoder_2.cfg.d_model

    @torch.no_grad()
    def encode(self, prompts: List[str]) -> PooledText:
        """[n] prompts → (T5's context [n, 512, d_model] f32, CLIP-L's pooled
        state [n, 768])."""
        clip, t5 = self.model.text_encoder, self.model.text_encoder_2
        dev = next(t5.parameters()).device
        ids = torch.from_numpy(self.tokenizer_2(prompts)).to(dev)
        clip_ids = torch.from_numpy(np.asarray(self.tokenizer(prompts, max_length=MAX_LEN),
                                               dtype=np.int64)).to(dev)
        return PooledText(t5(ids).float(), clip.text_model(clip_ids)[1])

    def get_text_embeds(self, prompt: List[str], negative_prompt: List[str]) -> PooledText:
        """The prompts' embedding; ``negative_prompt`` has no use here."""
        return self.encode(prompt)


@torch.no_grad()
def register_token(text_encoder: TextEncoder, token: str, embedding) -> int:
    """Add ``token`` to the encoder's tokenizer and install ``embedding`` as
    its row of ``text_model.embeddings.token_embedding``, growing the table
    to ``token_id + 1`` rows (the rows it has are kept).  Returns the id."""
    token_id = text_encoder.tokenizer.add_token(token)
    emb = text_encoder.model.text_model.embeddings
    table = emb.token_embedding.weight
    if token_id >= table.shape[0]:
        grown = nn.Embedding(token_id + 1, table.shape[1], device=table.device,
                             dtype=table.dtype)
        grown.weight.zero_()
        grown.weight[: table.shape[0]] = table
        grown.requires_grad_(table.requires_grad)
        emb.token_embedding = grown
        table = grown.weight
    row = torch.as_tensor(np.asarray(embedding, np.float32).reshape(-1))
    table[token_id] = row[: table.shape[1]].to(table.device, table.dtype)
    return token_id
