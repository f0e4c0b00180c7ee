"""Volume-rendering compositing (counterpart of
``customnerf_tpu/ops/composite.py:14-28``; reference ``nerf/renderer.py:420-424``).
"""

import torch


def alphas_from_sigmas(sigmas, deltas):
    """alpha_i = 1 − exp(−delta_i · sigma_i).  sigmas, deltas: [..., T]."""
    return 1.0 - torch.exp(-deltas * sigmas)


def weights_from_alphas(alphas):
    """w_i = alpha_i · prod_{j<i}(1 − alpha_j + 1e-15): the reference's
    shifted cumprod."""
    shifted = torch.cat(
        [torch.ones_like(alphas[..., :1]), 1.0 - alphas[..., :-1] + 1e-15],
        dim=-1)
    return alphas * torch.cumprod(shifted, dim=-1)
