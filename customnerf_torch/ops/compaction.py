"""Cross-ray active-sample compaction (counterpart of
``customnerf_tpu/ops/compaction.py``).

G consecutive (permuted) rays form a block with a fixed budget of M slots;
the block's valid samples are packed into the slots in order, and the field
runs on NB·M samples instead of N·K.  A block with more than M valid samples
keeps an even-stride subsample and reports a quadrature scale n_valid/M.

The JAX version packs with one-hot MXU matmuls; here the same linear maps
are index gathers and scatters (:func:`compact_plan` returns the indices),
so gradients flow through ``gather``/``index`` instead of ``dot_general``.
"""

from __future__ import annotations

import numpy as np
import torch


def block_budget(block_rays: int, n_keep: int, frac: float) -> int:
    """Static per-block slot budget: ceil(G·K·frac) rounded up to a multiple
    of 128 (the JAX version's lane rounding, kept so both evaluate the same
    sample set), capped at G·K."""
    raw = int(np.ceil(block_rays * n_keep * float(frac)))
    budget = max(128, -(-raw // 128) * 128)
    return min(budget, block_rays * n_keep)


def compact_plan(valid: torch.Tensor, block_rays: int, budget: int):
    """Compaction bookkeeping for a [N, K] bool slab (N divisible by G).

    Returns:
      keep:        [NB, G·K] bool — positions that get a slot.
      slot:        [NB, G·K] int64 — their slot (M for positions not kept).
      slot_valid:  [NB, M] bool — live slots.
      block_scale: [NB, 1] f32 — even-stride quadrature scale (≥ 1).
    """
    N, K = valid.shape
    G = block_rays
    if N % G:
        raise ValueError(f"compact_plan: N={N} not divisible by G={G}")
    NB = N // G
    v = valid.reshape(NB, G * K)
    vi = v.long()
    count = torch.cumsum(vi, dim=-1)
    n_val = count[:, -1:]
    rank = count - vi
    scale = torch.clamp(n_val, min=budget)
    bucket = torch.div(rank * budget, scale, rounding_mode="floor")
    prev_bucket = torch.where(
        rank > 0, torch.div((rank - 1) * budget, scale, rounding_mode="floor"),
        torch.full_like(rank, -1))
    keep = v & (bucket != prev_bucket)
    slot = torch.cumsum(keep.long(), dim=-1) - 1
    slot = torch.where(keep, slot, torch.full_like(slot, budget))
    slot_valid = (torch.arange(budget, device=valid.device)[None, :]
                  < torch.clamp(n_val, max=budget))
    block_scale = torch.clamp(n_val.to(torch.float32) / budget, min=1.0)
    return keep, slot, slot_valid, block_scale


def slot_sources(slot: torch.Tensor, budget: int) -> torch.Tensor:
    """[NB, M] in-block position that fills each slot (0 for dead slots —
    callers mask those with ``slot_valid``)."""
    NB, GK = slot.shape
    src = torch.zeros(NB, budget + 1, dtype=torch.long, device=slot.device)
    pos = torch.arange(GK, device=slot.device).expand(NB, GK)
    src.scatter_(1, slot, pos)
    return src[:, :budget]


def ray_permutation(n: int):
    """Fixed coprime-stride permutation of ray indices (stride 7919, bumped
    by 2 until coprime with n).  Returns (perm, inv_perm) int64 arrays."""
    stride = 7919  # prime
    while np.gcd(stride, n) != 1:
        stride += 2
    perm = (np.arange(n, dtype=np.int64) * stride) % n
    inv = np.empty_like(perm)
    inv[perm] = np.arange(n, dtype=np.int64)
    return perm, inv
