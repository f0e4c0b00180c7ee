"""Volume-rendering compositing and inverse-CDF importance sampling
(counterpart of ``customnerf_tpu/ops/composite.py``; reference
``nerf/renderer.py:21-111, 420-424``).
"""

import torch


def alphas_from_sigmas(sigmas, deltas):
    """alpha_i = 1 − exp(−delta_i · sigma_i).  sigmas, deltas: [..., T]."""
    return 1.0 - torch.exp(-deltas * sigmas)


class _CumprodNonzero(torch.autograd.Function):
    """``torch.cumprod`` along the last axis of an input with no zeros.

    Its backward is the one ``torch.cumprod`` takes when the input has no
    zeros, ``flip(cumsum(flip(out · grad))) / input``, the same operations
    in the same order; ``torch.cumprod``'s own backward first reads on the
    host whether the input has a zero, a sync that a CUDA graph's capture
    cannot hold."""

    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, dim=-1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        if x.shape[-1] <= 1:
            return grad
        return (out * grad).flip(-1).cumsum(-1).flip(-1).div(x)


def weights_from_alphas(alphas):
    """w_i = alpha_i · prod_{j<i}(1 − alpha_j + 1e-15): the reference's
    shifted cumprod.  Every factor is ≥ 1e-15 (alpha ≤ 1), so the product
    runs through :class:`_CumprodNonzero`."""
    shifted = torch.cat(
        [torch.ones_like(alphas[..., :1]), 1.0 - alphas[..., :-1] + 1e-15],
        dim=-1)
    return alphas * _CumprodNonzero.apply(shifted)


def cdf_phi_s(x, s):
    """NeuS Φ_s CDF (reference renderer.py:58-62); part of the op surface,
    though the grid pipeline never trains an SDF."""
    return torch.sigmoid(x * s)


def sdf_to_alpha(sdf, s):
    """SDF → per-section opacity (reference renderer.py:65-72)."""
    cdf = cdf_phi_s(sdf, s)
    alpha = (cdf[..., :-1] - cdf[..., 1:]) / (cdf[..., :-1] + 1e-10)
    return cdf, torch.clamp(alpha, min=0.0)


def alpha_to_w(alpha):
    """Opacity → visibility weights (reference renderer.py:97-111)."""
    shifted = torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-10],
                        dim=-1)
    return alpha * torch.cumprod(shifted, dim=-1)[..., :-1]


def sdf_to_w(sdf, s):
    """SDF → visibility weights (reference renderer.py:75-94)."""
    cdf, alpha = sdf_to_alpha(sdf, s)
    return cdf, alpha, alpha_to_w(alpha)


def sample_pdf(bins, weights, n_samples: int, det: bool = False,
               generator=None, u=None):
    """Inverse-CDF sampling of new depths (NeRF hierarchical sampling,
    reference renderer.py:21-55).

    bins [B, T] (z midpoints), weights [B, T-1] → [B, n_samples].  ``det``
    takes evenly spaced u; otherwise u ~ U[0, 1) from ``generator`` (not
    ``jax.random``'s stream), or the given ``u`` [B, n_samples]."""
    weights = weights + 1e-5
    pdf = weights / weights.sum(dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)   # [B, T]

    B = cdf.shape[0]
    if u is None:
        if det:
            u = torch.linspace(0.5 / n_samples, 1.0 - 0.5 / n_samples, n_samples,
                               device=cdf.device, dtype=cdf.dtype).expand(B, n_samples)
        else:
            u = torch.rand(B, n_samples, generator=generator, device=cdf.device,
                           dtype=cdf.dtype)
    u = u.contiguous()

    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)

    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(bins, -1, below)
    bins_above = torch.gather(bins, -1, above)

    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)
