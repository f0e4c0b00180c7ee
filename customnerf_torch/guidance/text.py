"""CLIP text encoding for SD prompts (counterpart of
``customnerf_tpu/guidance/text.py``).

The transformer is a PyTorch CLIP text model in place of transformers'
``FlaxCLIPTextModel``, named after Hugging Face's ``CLIPTextModel`` state
dict (``text_model.encoder.layers.0.self_attn.q_proj``): pre-LayerNorm
layers under a causal mask, ``quick_gelu`` for SD 1.x's ViT-L/14 text tower,
and a final LayerNorm; ``last_hidden_state`` is taken after it.

Tokenizer: the real CLIP BPE (``guidance/bpe.py``) when a ``tokenizer/`` dir
exists under ``--sd_weights``, else :class:`HashTokenizer`, which gives the
JAX package's ids (md5 word buckets).
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from customnerf_torch.guidance.bpe import ClipBPETokenizer
from customnerf_torch.guidance.layers import build

MAX_LEN = 77
BOS, EOS = 49406, 49407
VOCAB = 49408


class HashTokenizer:
    """Deterministic stand-in tokenizer: word → stable md5 bucket, BOS/EOS
    framing and EOS padding to 77, like CLIP's.  (The JAX package's modifier
    tokens serve Custom Diffusion, which is not ported.)"""

    def __call__(self, prompts: List[str], **_):
        ids = np.full((len(prompts), MAX_LEN), EOS, dtype=np.int32)
        for i, p in enumerate(prompts):
            toks = [BOS]
            for w in p.lower().split():
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
    """fc1 → quick_gelu (x·σ(1.702x), the ViT-L/14 and ViT-B/32 towers') → fc2."""

    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, inner)
        self.fc2 = nn.Linear(inner, dim)

    def forward(self, x):
        h = self.fc1(x)
        return self.fc2(h * torch.sigmoid(1.702 * h))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, dim, inner, heads, eps):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(dim, eps=eps)
        self.self_attn = CLIPAttention(dim, heads)
        self.layer_norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = CLIPMLP(dim, inner)

    def forward(self, x, bias=None):
        x = x + self.self_attn(self.layer_norm1(x), bias)
        return x + self.mlp(self.layer_norm2(x))


class CLIPEncoder(nn.Module):
    def __init__(self, dim, inner, heads, n_layers, eps):
        super().__init__()
        self.layers = nn.ModuleList(
            [CLIPEncoderLayer(dim, inner, heads, eps) for _ in range(n_layers)])

    def forward(self, x, bias=None):
        for layer in self.layers:
            x = layer(x, bias)
        return x


class CLIPTextEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings,
                                               cfg.hidden_size)

    def forward(self, ids):
        pos = torch.arange(ids.shape[1], device=ids.device)
        return self.token_embedding(ids) + self.position_embedding(pos)[None]


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = CLIPTextEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg.hidden_size, cfg.intermediate_size,
                                   cfg.num_attention_heads,
                                   cfg.num_hidden_layers, cfg.layer_norm_eps)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, ids):
        """ids [B, L] int → (last_hidden_state [B, L, D], pooled [B, D]: the
        state at each row's first EOS)."""
        x = self.embeddings(ids)
        L = ids.shape[1]
        causal = torch.ones(L, L, dtype=torch.bool, device=ids.device).tril()
        bias = torch.zeros(L, L, device=ids.device, dtype=x.dtype).masked_fill(
            ~causal, torch.finfo(x.dtype).min)
        h = self.final_layer_norm(self.encoder(x, bias))
        eos = (ids == self.cfg.eos_token_id).int().argmax(dim=-1)
        return h, h[torch.arange(h.shape[0], device=h.device), eos]


class CLIPTextModel(nn.Module):
    """Hugging Face's ``CLIPTextModel`` layout: everything under
    ``text_model``."""

    def __init__(self, cfg: CLIPTextConfig = CLIPTextConfig()):
        super().__init__()
        self.text_model = CLIPTextTransformer(cfg)

    def forward(self, ids):
        return self.text_model(ids)[0]


def text_config(sd_version: str) -> CLIPTextConfig:
    if sd_version.startswith("2"):
        raise NotImplementedError(
            "SD 2.x (OpenCLIP ViT-H text tower) is not ported yet (ROADMAP.md "
            "queue A, item 'SD 2.x')")
    return CLIPTextConfig()


class TextEncoder:
    """Tokenizer + CLIP text model; ``get_text_embeds`` gives the
    ``[uncond; cond]`` stack SDS expects (reference sd.py:77-94)."""

    def __init__(self, sd_version: str = "1.5", weights_dir: Optional[str] = None,
                 device=None, generator=None, model: nn.Module | None = None):
        self.tokenizer = None
        if weights_dir:
            tok_dir = os.path.join(weights_dir, "tokenizer")
            if os.path.isdir(tok_dir):
                try:
                    self.tokenizer = ClipBPETokenizer.from_dir(tok_dir)
                except (OSError, ValueError, KeyError) as e:
                    print(f"[WARN] tokenizer load failed ({e}); hash fallback.")
        if self.tokenizer is None:
            self.tokenizer = HashTokenizer()
        self.model = model if model is not None else build(
            CLIPTextModel, text_config(sd_version), device=device,
            generator=generator)

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
