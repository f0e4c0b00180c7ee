"""CLIP view-direction matching for per-view prompt selection (counterpart
of ``customnerf_tpu/guidance/clip_view.py``).

A PyTorch CLIP ViT-B/32 in place of transformers' ``FlaxCLIPModel``, named
after Hugging Face's ``CLIPModel`` state dict: the vision tower
(``vision_model``: 32×32 patches, class token, ``pre_layrnorm``,
``post_layernorm``), the text tower (``text_model``, from ``text.py``), the
two bias-free projections and ``logit_scale``.  ``match_probs`` embeds the
frozen-model render and three canonical view texts and softmaxes the
logits; the editing step takes the argmax view's prompt
(reference ``nerf/utils_init_nerf.py:254-280``).  ``clip_score`` and
``clip_directional_score`` score ``--test`` renders (``--clip_metrics``).
Weights load from ``--clip_weights`` (a Hugging Face layout dir) or are
random.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from customnerf_torch.guidance.bpe import ClipBPETokenizer
from customnerf_torch.guidance.layers import build
from customnerf_torch.guidance.text import (MAX_LEN, CLIPEncoder,
                                            CLIPTextConfig, CLIPTextTransformer,
                                            HashTokenizer)

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)

MATCH_PROMPTS = ["front face of an object", "side face of an object",
                 "back face of an object"]
VIEW_NAMES = ["front", "side", "back"]


@dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    image_size: int = 224
    patch_size: int = 32
    layer_norm_eps: float = 1e-5


VIT_B32_TEXT = CLIPTextConfig(hidden_size=512, intermediate_size=2048,
                              num_hidden_layers=12, num_attention_heads=8)


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        d = cfg.hidden_size
        self.class_embedding = nn.Parameter(torch.empty(d))
        self.patch_embedding = nn.Conv2d(3, d, cfg.patch_size,
                                         stride=cfg.patch_size, bias=False)
        n_pos = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.position_embedding = nn.Embedding(n_pos, d)

    def forward(self, pixels):
        x = self.patch_embedding(pixels).flatten(2).transpose(1, 2)
        cls = self.class_embedding.expand(x.shape[0], 1, -1)
        return torch.cat([cls, x], dim=1) + self.position_embedding.weight[None]


class CLIPVisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.embeddings = CLIPVisionEmbeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.encoder = CLIPEncoder(cfg.hidden_size, cfg.intermediate_size,
                                   cfg.num_attention_heads,
                                   cfg.num_hidden_layers, cfg.layer_norm_eps)
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, pixels):
        h = self.encoder(self.pre_layrnorm(self.embeddings(pixels)))
        return self.post_layernorm(h[:, 0])


class CLIPModel(nn.Module):
    def __init__(self, text_cfg: CLIPTextConfig = VIT_B32_TEXT,
                 vision_cfg: CLIPVisionConfig = CLIPVisionConfig(),
                 projection_dim: int = 512):
        super().__init__()
        self.text_model = CLIPTextTransformer(text_cfg)
        self.vision_model = CLIPVisionTransformer(vision_cfg)
        self.visual_projection = nn.Linear(vision_cfg.hidden_size,
                                           projection_dim, bias=False)
        self.text_projection = nn.Linear(text_cfg.hidden_size, projection_dim,
                                         bias=False)
        self.logit_scale = nn.Parameter(torch.empty(()))

    def get_image_features(self, pixels):
        return self.visual_projection(self.vision_model(pixels))

    def get_text_features(self, ids):
        return self.text_projection(self.text_model(ids)[1])

    def logits_per_image(self, ids, pixels):
        img = F.normalize(self.get_image_features(pixels), dim=-1)
        txt = F.normalize(self.get_text_features(ids), dim=-1)
        return self.logit_scale.exp() * img @ txt.T


def _hf_state(path: str) -> dict:
    """A Hugging Face CLIP state dict from ``pytorch_model.bin``; buffers
    (``position_ids``) dropped."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.float() for k, v in sd.items() if not k.endswith("position_ids")}


class CLIPViewMatcher:
    def __init__(self, weights_dir: Optional[str] = None, seed: int = 0,
                 device=None, model: CLIPModel | None = None):
        """A full-width ViT-B/32 seeded on ``device`` unless ``model`` is
        given; weights from ``weights_dir/pytorch_model.bin`` when it exists."""
        if model is None:
            gen = torch.Generator(device=device or "cpu").manual_seed(int(seed))
            model = build(CLIPModel, device=device, generator=gen)
        if weights_dir:
            path = os.path.join(weights_dir, "pytorch_model.bin")
            if os.path.exists(path):
                dev = model.logit_scale.device
                model.load_state_dict({k: v.to(dev) for k, v in _hf_state(path).items()})
            else:
                print(f"[WARN] no CLIP weights at {path}; random init.")
        self.model = model.eval().requires_grad_(False)
        self.tokenizer = HashTokenizer()
        if weights_dir and os.path.exists(os.path.join(weights_dir, "vocab.json")):
            self.tokenizer = ClipBPETokenizer.from_dir(weights_dir)
        self._match_ids = self._tokenize(MATCH_PROMPTS)

    @property
    def device(self):
        return self.model.logit_scale.device

    def _tokenize(self, prompts: List[str]) -> torch.Tensor:
        ids = np.asarray(self.tokenizer(prompts, max_length=MAX_LEN), np.int64)
        return torch.from_numpy(ids).to(self.device)

    def preprocess(self, images_nhwc):
        """[B, H, W, 3] in [0, 1] → CLIP input [B, 3, 224, 224] (bilinear
        resize, then normalise; reference nerf/clip.py:13-17)."""
        x = torch.as_tensor(images_nhwc, dtype=torch.float32,
                            device=self.device).permute(0, 3, 1, 2)
        x = F.interpolate(x, size=(224, 224), mode="bilinear",
                          align_corners=False, antialias=True)
        mean = torch.tensor(CLIP_MEAN, device=x.device)[None, :, None, None]
        std = torch.tensor(CLIP_STD, device=x.device)[None, :, None, None]
        return (x - mean) / std

    @torch.no_grad()
    def match_probs(self, images_nhwc) -> np.ndarray:
        """[B, H, W, 3] render in [0, 1] → softmax over (front, side, back)."""
        logits = self.model.logits_per_image(self._match_ids,
                                             self.preprocess(images_nhwc))
        return logits.softmax(dim=-1).cpu().numpy()

    @torch.no_grad()
    def image_embeds(self, images_nhwc) -> np.ndarray:
        """[B, H, W, 3] in [0, 1] → L2-normalised CLIP image embeddings."""
        out = self.model.get_image_features(self.preprocess(images_nhwc))
        return F.normalize(out, dim=-1).cpu().numpy()

    @torch.no_grad()
    def text_embeds(self, prompts: List[str]) -> np.ndarray:
        """prompts → L2-normalised CLIP text embeddings."""
        out = self.model.get_text_features(self._tokenize(prompts))
        return F.normalize(out, dim=-1).cpu().numpy()


def _embed_chunked(matcher: CLIPViewMatcher, images_nhwc, chunk: int):
    """image_embeds in chunks, so full-resolution test frames never sit on
    the device all at once."""
    images_nhwc = np.asarray(images_nhwc)
    outs = [matcher.image_embeds(images_nhwc[i:i + chunk])
            for i in range(0, len(images_nhwc), chunk)]
    return np.concatenate(outs, axis=0)


def clip_score(matcher: CLIPViewMatcher, images_nhwc, prompt: str,
               chunk: int = 8) -> float:
    """Mean CLIP text-image cosine similarity over rendered views (the
    CLIP-score family of the CustomNeRF paper's Table 1)."""
    img = _embed_chunked(matcher, images_nhwc, chunk)  # [B, D]
    txt = matcher.text_embeds([prompt])                # [1, D]
    return float(np.mean(img @ txt.T))


def clip_directional_score(matcher: CLIPViewMatcher, images_before,
                           images_after, prompt_before: str,
                           prompt_after: str, chunk: int = 8) -> float:
    """CLIP directional similarity (Gal et al.): cosine between the image
    edit direction and the text edit direction, averaged over views."""
    di = (_embed_chunked(matcher, images_after, chunk)
          - _embed_chunked(matcher, images_before, chunk))
    dt = matcher.text_embeds([prompt_after]) - matcher.text_embeds([prompt_before])
    di_n = di / np.maximum(np.linalg.norm(di, axis=-1, keepdims=True), 1e-8)
    dt_n = dt / np.maximum(np.linalg.norm(dt, axis=-1, keepdims=True), 1e-8)
    return float(np.mean(di_n @ dt_n.T))
