"""DDPM noise schedule for SDS (counterpart of
``customnerf_tpu/guidance/scheduler.py``).

Stable Diffusion's scaled-linear betas (0.00085 → 0.012 over 1000 steps,
betas = linspace(√β0, √β1)², in float64), ``alphas_cumprod`` stored as
float32, and ``add_noise``."""

from __future__ import annotations

import numpy as np
import torch


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
