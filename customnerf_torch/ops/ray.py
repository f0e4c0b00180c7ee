"""Ray/AABB slab intersection (counterpart of
``customnerf_tpu/ops/ray.py:17-40``; reference CUDA
``raymarching/src/raymarching.cu:92-145``).

A miss sets near = far = FLT_MAX; near is clamped to ``min_near``.
"""

import torch

_MISS = torch.finfo(torch.float32).max  # FLT_MAX miss sentinel (CUDA parity)


def near_far_from_aabb(rays_o, rays_d, aabb, min_near: float = 0.05):
    """rays_o, rays_d: [..., 3]; aabb: [6] (min xyz, max xyz) tensor.
    Returns (nears, fars) [...] float32; misses give FLT_MAX for both."""
    rd = 1.0 / rays_d
    t0 = (aabb[:3] - rays_o) * rd
    t1 = (aabb[3:] - rays_o) * rd
    tmin = torch.minimum(t0, t1)
    tmax = torch.maximum(t0, t1)
    near = tmin.amax(dim=-1)
    far = tmax.amin(dim=-1)
    miss = near > far
    near = torch.clamp(near, min=min_near)
    miss_val = torch.full_like(near, _MISS)
    near = torch.where(miss, miss_val, near)
    far = torch.where(miss, miss_val, far)
    return near, far
