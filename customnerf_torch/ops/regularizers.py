"""Total variation on the multiresolution grid (counterpart of
``customnerf_tpu/ops/regularizers.py``; reference CUDA ``kernel_grad_tv``,
``gridencoder.cu:505-609``).

A plain differentiable loss: add ``weight · grid_total_variation(...)`` to
the training loss and autograd adds its gradient into the table.  As in the
JAX package, nothing wires it into the trainer's loss.
"""

from __future__ import annotations

import torch

from customnerf_torch.ops.grid import GridSpec, grid_encode


def grid_total_variation(table, spec: GridSpec, generator=None,
                         n_samples: int = 65536, bound: float = 1.0, x=None):
    """Stochastic TV: the mean squared change of the encoding under a
    one-finest-cell offset along each axis, at random points.  The points
    are U(−bound, bound) from ``generator`` (not ``jax.random``'s stream), or
    ``x`` [n, D] when given."""
    if x is None:
        x = (torch.rand(n_samples, spec.input_dim, generator=generator,
                        device=table.device) * 2.0 - 1.0) * bound
    x01 = (x + bound) / (2 * bound)
    base = grid_encode(x01, table, spec)
    eps = 1.0 / (float(spec.level_meta["scales"][-1]) + 1.0)
    tv = 0.0
    for d in range(spec.input_dim):
        x_off = x01.clone()
        x_off[:, d] += eps
        shifted = grid_encode(torch.clamp(x_off, 0.0, 1.0), table, spec)
        tv = tv + ((shifted - base) ** 2).mean()
    return tv
