"""The inputs a run hands to the program and to the reference alike, made
from ``--seed``: the scene's views, the order in which steps take them, the
field's initial weights, the Stable Diffusion weights and the prompt
embeddings.

Every seed gives the same sizes (views, pixels, parameters, steps); the
seed moves the cameras along their orbit, the scene's colours and light,
the order of the views and every weight.  Weights are made on the run's
device in a few large calls of one ``torch.Generator``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

MASK64 = (1 << 63) - 1


def stream(seed: int, purpose: int) -> int:
    """A generator seed for one purpose of a run's ``--seed``."""
    return (int(seed) * 1_000_003 + purpose * 7_919) & MASK64


def generator(seed: int, purpose: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream(seed, purpose))


def program_seed(seed: int) -> int:
    """The trainer's ``--seed`` (its generator and its LGIE gate's
    ``RandomState``, which takes 32 bits)."""
    return int(seed) % (2 ** 32)


# ------------------------------------------------------------------ scene
def _normalize(v):
    return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-10)


def views(seed: int, n_views: int, H: int, W: int, device, radius: float = 1.6,
          theta_deg: float = 70.0, sphere_r: float = 0.5):
    """``n_views`` orbit cameras at ``theta_deg`` looking at a shaded sphere
    over a checkered ground plane, ray-traced (the synthetic provider's
    scene).  Returns rays_o, rays_d, rgbs [V, H·W, 3] and masks [V, H·W]
    (1 on the sphere) as f32 tensors on ``device``."""
    rng = np.random.RandomState(stream(seed, 1) % (2 ** 32))
    phase = rng.uniform(0, 2 * np.pi)
    tint = rng.uniform(0.2, 1.0, size=3)
    light = _normalize(rng.normal(size=3) + np.array([0.5, 0.8, -0.3]))
    phis = phase + np.linspace(0, 2 * np.pi, n_views, endpoint=False)
    th = np.deg2rad(theta_deg)
    centers = np.stack([radius * np.sin(th) * np.sin(phis),
                        np.full(n_views, radius * np.cos(th)),
                        radius * np.sin(th) * np.cos(phis)], -1)
    fwd = _normalize(centers)
    right = _normalize(np.cross(fwd, np.array([0.0, 1.0, 0.0])))
    up = _normalize(np.cross(right, fwd))
    focal = 0.9 * W
    js, is_ = np.meshgrid(np.arange(H, dtype=np.float64), np.arange(W, dtype=np.float64),
                          indexing="ij")
    cam = _normalize(np.stack([(is_ - W / 2) / focal, -(js - H / 2) / focal,
                               -np.ones_like(is_)], -1))
    out = {k: [] for k in ("rays_o", "rays_d", "rgbs", "masks")}
    for i in range(n_views):
        rot = np.stack([right[i], up[i], fwd[i]], -1)
        d = _normalize(cam @ rot.T).reshape(-1, 3)
        o = np.broadcast_to(centers[i], d.shape)
        rgb, mask = _trace(o, d, sphere_r, tint, light)
        out["rays_o"].append(o)
        out["rays_d"].append(d)
        out["rgbs"].append(rgb)
        out["masks"].append(mask)
    return {k: torch.from_numpy(np.stack(v).astype(np.float32)).to(device)
            for k, v in out.items()}


def _trace(o, d, r, tint, light):
    with np.errstate(invalid="ignore", divide="ignore"):
        b = np.sum(o * d, -1)
        disc = b * b - (np.sum(o * o, -1) - r * r)
        t_sph = np.where(disc > 0, -b - np.sqrt(np.maximum(disc, 0)), np.inf)
        t_sph = np.where(t_sph > 0, t_sph, np.inf)
        dy = np.where(np.abs(d[:, 1]) > 1e-6, d[:, 1], 1e-6)
        t_pln = (-r - o[:, 1]) / dy
        t_pln = np.where(t_pln > 0, t_pln, np.inf)
        hit = t_sph < t_pln
        n = (o + np.where(np.isfinite(t_sph), t_sph, 0)[:, None] * d) / r
        lam = np.clip(np.sum(n * light, -1), 0.1, 1.0)
        p = o + np.where(np.isfinite(t_pln), t_pln, 0)[:, None] * d
        checker = (np.floor(p[:, 0] * 4) + np.floor(p[:, 2] * 4)) % 2
        rgb = np.where(hit[:, None], lam[:, None] * tint,
                       np.where(np.isfinite(t_pln)[:, None],
                                (0.25 + 0.2 * checker)[:, None].repeat(3, 1), 0.1))
    return np.nan_to_num(rgb), hit.astype(np.float32)


def view_order(seed: int, n_views: int, n_steps: int) -> list:
    """The view of each step: every view once in a seeded order, then
    views drawn uniformly (the provider's random image a step)."""
    rng = np.random.RandomState(stream(seed, 2) % (2 ** 32))
    first = list(rng.permutation(n_views))
    return [int(v) for v in first + list(rng.randint(0, n_views, max(n_steps - n_views, 0)))]


# ----------------------------------------------------------------- weights
def field_weights(seed: int, table_shape, head_shapes: dict, device) -> dict:
    """The field's initial parameters under the port's names: the encoder
    table U(−1e-4, 1e-4), each bias-free head a normal truncated to ±2σ of
    variance 1/fan_in (flax's LeCun normal)."""
    g = generator(seed, 3, device)
    out = {"grid_table": torch.rand(*table_shape, generator=g, device=device) * 2e-4 - 1e-4}
    total = sum(math.prod(s) for s in head_shapes.values())
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = lo + (1.0 - 2.0 * lo) * torch.rand(total, generator=g, device=device)
    z = torch.clamp(math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0), -2.0, 2.0)
    off = 0
    for name in sorted(head_shapes):
        shape = head_shapes[name]
        n = math.prod(shape)
        out[name] = (z[off:off + n].reshape(shape) * (shape[1] ** -0.5 / 0.87962566103423978)
                     ).contiguous()
        off += n
    return out


def _kind(module: nn.Module, name: str, p) -> str:
    owner = module.get_submodule(name.rsplit(".", 1)[0]) if "." in name else module
    if isinstance(owner, (nn.GroupNorm, nn.LayerNorm)):
        return "one" if name.endswith("weight") else "zero"
    if name.endswith("bias"):
        return "zero"
    return "small" if p.ndim <= 1 else "kernel"


@torch.no_grad()
def fill_sd(module: nn.Module, seed: int, purpose: int, device) -> None:
    """Write a Stable Diffusion model's random weights into ``module``'s
    parameters, whatever their dtype: norm scales 1, biases 0, kernels
    N(0, 1/fan_in), other vectors N(0, 0.02²), all from one f32 draw in the
    parameters' sorted-name order (the same values for the program's
    modules and the reference's, which share the diffusers names)."""
    params = dict(module.named_parameters())
    names = sorted(params)
    kinds = {n: _kind(module, n, params[n]) for n in names}
    total = sum(params[n].numel() for n in names if kinds[n] in ("kernel", "small"))
    flat = torch.randn(total, generator=generator(seed, purpose, device), device=device)
    off = 0
    for n in names:
        p, k = params[n], kinds[n]
        if k in ("one", "zero"):
            p.fill_(1.0 if k == "one" else 0.0)
            continue
        std = 0.02 if k == "small" else p[0].numel() ** -0.5
        p.copy_(flat[off:off + p.numel()].view(p.shape) * std)
        off += p.numel()
    del flat


def embeddings(seed: int, device, width: int = 768, tokens: int = 77) -> dict:
    """The prompts' [uncond; cond] embeddings, [2, tokens, width] each, as
    the text tower would hand them over: one shared negative prompt."""
    g = generator(seed, 4, device)
    z = torch.randn(6, tokens, width, generator=g, device=device)
    uncond = z[0]
    names = ("text_z", "text_z_fg", "text_z_norm", "text_z_norm_fg", "text_z_bg")
    return {n: torch.stack([uncond, z[i + 1]]) for i, n in enumerate(names)}
