"""DDIM sampler: text-to-image generation with the SD stack (counterpart of
``customnerf_tpu/guidance/sampler.py``), for Custom Diffusion's class images
when none exist (reference ``train_custom_diffusion.py:706-769``) and its
validation samples.

``linspace(T − 1, 0, n).round()`` steps, ᾱ of the step after the last equal
to 1; **standard** classifier-free guidance ``uncond + s·(cond − uncond)``
(not SDS's text-anchored form); the guidance's ``cd_kv`` adapters in the
UNet; then the VAE decode.  The latents and ε stay f32 between steps; the
UNet and VAE compute in the guidance's dtype (bf16 on the card).
"""

from __future__ import annotations

import numpy as np
import torch


@torch.no_grad()
def ddim_sample(guidance, prompt: str, generator=None, num_steps: int = 50,
                guidance_scale: float = 7.5, height: int = 512, width: int = 512,
                negative: str = "", draws=None) -> torch.Tensor:
    """One image [H, W, 3] in [0, 1].  The initial latents [1, 4, H/8, W/8]
    are ``draws`` when given, else drawn from ``generator``."""
    dev = guidance.device
    text = guidance.get_text_embeds([prompt], [negative])        # [uncond; cond]
    alphas = guidance.scheduler.alphas_cumprod.to(dev)
    T = guidance.scheduler.num_train_timesteps
    ts = np.linspace(T - 1, 0, num_steps).round().astype(np.int64).tolist()
    cd_kv = getattr(guidance, "cd_kv", None)
    if draws is None:
        lat = torch.randn((1, 4, height // 8, width // 8), generator=generator, device=dev)
    else:
        lat = torch.as_tensor(draws, dtype=torch.float32).to(dev)
    for i, t in enumerate(ts):
        t_prev = ts[i + 1] if i + 1 < num_steps else -1
        eps = guidance.unet(torch.cat([lat, lat]), torch.full((2,), t, device=dev),
                            text, cd_kv=cd_kv)
        uncond, cond = eps.chunk(2)
        eps = uncond + guidance_scale * (cond - uncond)
        a_t = alphas[t]
        a_prev = alphas[t_prev] if t_prev >= 0 else torch.ones((), device=dev)
        x0 = (lat - torch.sqrt(1 - a_t) * eps) / torch.sqrt(a_t)
        lat = torch.sqrt(a_prev) * x0 + torch.sqrt(1 - a_prev) * eps
    img = guidance.vae.decode(lat)
    return (img[0] / 2 + 0.5).clamp(0.0, 1.0).permute(1, 2, 0)
