"""Layers the SD UNet and VAE share (diffusers state-dict names), and the
seeded random initialisation of a whole guidance model."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class ResnetBlock2D(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, temb_ch: Optional[int],
                 groups: int, eps: float = 1e-5):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, in_ch, eps=eps)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        if temb_ch:
            self.time_emb_proj = nn.Linear(temb_ch, out_ch)
        self.norm2 = nn.GroupNorm(groups, out_ch, eps=eps)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        if in_ch != out_ch:
            self.conv_shortcut = nn.Conv2d(in_ch, out_ch, 1)

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
        self.conv = nn.Conv2d(channels, channels, 3, stride=2,
                              padding=0 if asymmetric_pad else 1)

    def forward(self, x):
        if self.asymmetric_pad:
            x = F.pad(x, (0, 1, 0, 1))
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


def build(cls, *args, device=None, generator=None, **kw):
    """Construct ``cls(*args, **kw)`` without PyTorch's default init, on
    ``device`` (``"meta"`` gives shapes only), then, unless on ``meta``,
    initialise it from ``generator`` with :func:`init_random_`."""
    with torch.device("meta"):
        module = cls(*args, **kw)
    device = torch.device(device or "cpu")
    if device.type == "meta":
        return module
    module = module.to_empty(device=device)
    init_random_(module, generator)
    return module


@torch.no_grad()
def init_random_(module: nn.Module, generator=None):
    """The flax defaults, drawn in parameter order from one generator:
    LeCun-normal kernels (std = fan_in^-½), zero biases, unit norm scales,
    N(0, 0.02) embeddings and CLIP class embeddings."""
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        owner = module.get_submodule(name.rsplit(".", 1)[0]) if "." in name else module
        if isinstance(owner, (nn.GroupNorm, nn.LayerNorm)):
            p.fill_(1.0 if leaf == "weight" else 0.0)
        elif leaf == "bias":
            p.zero_()
        elif isinstance(owner, nn.Embedding) or p.ndim == 1:
            p.normal_(0.0, 0.02, generator=generator)
        elif p.ndim == 0:
            p.fill_(2.6592)     # CLIP logit_scale_init_value
        else:
            fan_in = p[0].numel()
            p.normal_(0.0, fan_in ** -0.5, generator=generator)
    return module


def n_params(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
