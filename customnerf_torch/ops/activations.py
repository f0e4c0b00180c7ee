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


def sigmoid_bf16(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` of a bf16 array, the way JAX lowers it:
    1 / (1 + exp(−x)), each of the three ops rounded to bf16 (flax's heads
    under a bf16 compute dtype, ``models/field.py:101-104``).  A sigmoid
    rounded once differs from it by an ulp on about a third of the inputs."""
    return torch.reciprocal(1.0 + torch.exp(-x.to(torch.bfloat16)))
