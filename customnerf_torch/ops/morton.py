"""Morton (Z-order) 3-D encode/decode and the sphere intersection helper
(counterpart of ``customnerf_tpu/ops/morton.py``; reference
``raymarching/src/raymarching.cu:163-198, 214-260``).

The codes are uint32 in the reference; PyTorch has no general uint32
arithmetic, so they are computed in int64 and masked to 32 bits.  The
occupancy grid indexes its cells linearly; these are exposed for tooling
parity.
"""

from __future__ import annotations

import torch

_U32 = 0xFFFFFFFF


def _expand_bits(v):
    """Spread the low 10 bits of v so there are 2 zeros between each."""
    v = v.to(torch.int64) & _U32
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton3D(coords):
    """coords: [..., 3] int in [0, 1024) → [...] morton codes (int64 holding
    the uint32 values)."""
    return (_expand_bits(coords[..., 0]) | (_expand_bits(coords[..., 1]) << 1)
            | (_expand_bits(coords[..., 2]) << 2)) & _U32


def _compact_bits(v):
    v = v & 0x49249249
    v = (v | (v >> 2)) & 0xC30C30C3
    v = (v | (v >> 4)) & 0x0F00F00F
    v = (v | (v >> 8)) & 0xFF0000FF
    v = (v | (v >> 16)) & 0x000003FF
    return v


def morton3D_invert(codes):
    """[...] morton codes → [..., 3] int32 coords."""
    c = codes.to(torch.int64) & _U32
    return torch.stack([_compact_bits(c), _compact_bits(c >> 1),
                        _compact_bits(c >> 2)], dim=-1).to(torch.int32)


def sph_from_ray(rays_o, rays_d, radius: float):
    """The forward intersection of rays with a sphere of ``radius`` about the
    origin → [..., 3] points (the origin is assumed inside the sphere)."""
    b = (rays_o * rays_d).sum(dim=-1)
    c = (rays_o * rays_o).sum(dim=-1) - radius * radius
    disc = torch.clamp(b * b - c, min=0.0)
    t = -b + torch.sqrt(disc)
    return rays_o + t[..., None] * rays_d
