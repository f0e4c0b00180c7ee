"""Truncated-exponential density activation (counterpart of
``customnerf_tpu/ops/activations.py:13-26``).

Forward ``exp(min(x, 80))`` keeps the f32 result finite; backward
``grad · exp(clip(x, −15, 15))`` bounds the gradient for large densities
(reference ``nerf/provider_utils.py:16-29``).
"""

import torch


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(torch.clamp(x, max=80.0))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -15.0, 15.0))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    return _TruncExp.apply(x)
