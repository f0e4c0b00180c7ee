"""Tri-plane factorized position encoding (counterpart of
``customnerf_tpu/ops/triplane.py``).

Per level of resolution R, three planes (XY, XZ, YZ) of an R×R texel grid;
a point's feature is the bilinear interpolation of each plane at its
projected coordinates, concatenated over planes and levels.  All planes live
in one flat table ``[table_size, max_C]``; a level of width C reads the
leading C columns.

Forward: four row gathers per plane (the JAX ``_encode_impl`` semantics —
the TPU's packed single-row gathers are a TPU device and are not ported).
Backward: an ``autograd.Function`` whose table gradient goes through the dT
kernel (``ops/triplane_kernels.py``), written in place into the flat
gradient, and whose input gradient is ``_encode_mm_bwd``'s
(``triplane.py:608-619``).

Semantics: inputs in [0, 1]³, align-corners texel centres, the lower corner
clipped to R−2, out-of-range inputs give zero features and zero gradients,
tables init U(−1e-4, 1e-4).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from customnerf_torch.ops.triplane_kernels import plane_dtable

# plane axis pairs: XY, XZ, YZ
PLANES = ((0, 1), (0, 2), (1, 2))


@dataclass(frozen=True)
class TriplaneSpec:
    """Static metadata of a multi-resolution tri-plane encoding.

    ``channels`` is an int (same width every level) or a per-level tuple,
    e.g. ``resolutions=(128, 512), channels=(16, 8)``."""

    resolutions: Tuple[int, ...] = (128, 512)
    channels: int | Tuple[int, ...] = 16
    input_dim: int = 3

    def __post_init__(self):
        if self.input_dim != 3:
            raise ValueError("tri-plane encoding requires 3-D inputs")
        object.__setattr__(self, "resolutions",
                           tuple(int(r) for r in self.resolutions))
        if any(r < 2 for r in self.resolutions):
            raise ValueError("tri-plane resolutions must be ≥ 2")
        if isinstance(self.channels, (tuple, list)):
            object.__setattr__(self, "channels",
                               tuple(int(c) for c in self.channels))
            if len(self.channels) != len(self.resolutions):
                raise ValueError("per-level channels must match resolutions")

    def channels_at(self, level: int) -> int:
        c = self.channels
        return int(c[level]) if isinstance(c, tuple) else int(c)

    @property
    def max_channels(self) -> int:
        c = self.channels
        return int(max(c)) if isinstance(c, tuple) else int(c)

    @property
    def num_levels(self) -> int:
        return len(self.resolutions)

    @property
    def output_dim(self) -> int:
        return 3 * sum(self.channels_at(l) for l in range(self.num_levels))

    @functools.cached_property
    def plane_offsets(self) -> np.ndarray:
        """Row offset of each (level, plane) block in the flat table."""
        offs = np.zeros((self.num_levels, 3), dtype=np.int64)
        acc = 0
        for li, r in enumerate(self.resolutions):
            for pi in range(3):
                offs[li, pi] = acc
                acc += r * r
        return offs

    @property
    def table_size(self) -> int:
        return int(sum(3 * r * r for r in self.resolutions))


def triplane_init(spec: TriplaneSpec, generator=None, device=None,
                  dtype=torch.float32) -> torch.Tensor:
    """Flat table [table_size, max_channels], U(−1e-4, 1e-4)."""
    t = torch.rand(spec.table_size, spec.max_channels, generator=generator,
                   device=device, dtype=dtype)
    return t * 2e-4 - 1e-4


def corner_data(x: torch.Tensor, spec: TriplaneSpec):
    """Per (level, plane): (u0 [B] int32, v0 [B] int32, fu [B], fv [B],
    axes (a, b), R, C, base row).  Align-corners, lower corner clipped to
    R−2 so the fractions stay right on the far border."""
    out = []
    for li, R in enumerate(spec.resolutions):
        pos = x * (R - 1)
        p0 = torch.clamp(torch.floor(pos), 0, R - 2)
        f = pos - p0
        p0 = p0.to(torch.int32)
        C = spec.channels_at(li)
        for pi, (a, b) in enumerate(PLANES):
            out.append((p0[:, a].contiguous(), p0[:, b].contiguous(),
                        f[:, a].contiguous(), f[:, b].contiguous(), (a, b), R,
                        C, int(spec.plane_offsets[li, pi])))
    return out


def _gather_corners(table, u0, v0, R, C, base):
    """Corner values [B, 4, C] in the order (u,v) (u,v+1) (u+1,v) (u+1,v+1)."""
    r00 = base + u0.long() * R + v0.long()
    rows = torch.stack([r00, r00 + 1, r00 + R, r00 + R + 1], dim=1)
    return table[:, :C][rows]


def _out_of_range(x):
    return ((x < 0.0) | (x > 1.0)).any(dim=-1, keepdim=True)


def _encode_forward(x, table, spec: TriplaneSpec):
    outs = []
    for u0, v0, fu, fv, _ab, R, C, base in corner_data(x, spec):
        vals = _gather_corners(table, u0, v0, R, C, base)
        w = torch.stack([(1 - fu) * (1 - fv), (1 - fu) * fv,
                         fu * (1 - fv), fu * fv], dim=1)
        outs.append((vals * w[:, :, None]).sum(dim=1))
    out = torch.cat(outs, dim=-1)
    return torch.where(_out_of_range(x), torch.zeros_like(out), out)


class _TriplaneEncode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, table, spec):
        ctx.spec = spec
        ctx.save_for_backward(x, table)
        return _encode_forward(x, table, spec)

    @staticmethod
    def backward(ctx, g):
        x, table = ctx.saved_tensors
        spec = ctx.spec
        need_dx, need_dt = ctx.needs_input_grad[0], ctx.needs_input_grad[1]
        g = torch.where(_out_of_range(x), torch.zeros_like(g), g.float())
        dtable = (torch.zeros(spec.table_size, spec.max_channels,
                              device=g.device, dtype=torch.float32)
                  if need_dt else None)
        dx = torch.zeros_like(x) if need_dx else None
        col = 0
        for u0, v0, fu, fv, (a, b), R, C, base in corner_data(x, spec):
            gk = g[:, col:col + C]
            col += C
            if need_dt:
                # in place into the level's leading C columns; the others
                # stay zero (the JAX backward pads them, triplane.py:604-605)
                plane_dtable(u0, v0, fu, fv, gk, R, C,
                             out=dtable[base:base + R * R])
            if need_dx:
                vals = _gather_corners(table, u0, v0, R, C, base)
                gv = (vals * gk[:, None, :]).sum(dim=-1)        # [B, 4]
                g00, g01, g10, g11 = gv.unbind(dim=1)
                dfu = (g10 - g00) * (1 - fv) + (g11 - g01) * fv
                dfv = (g01 - g00) * (1 - fu) + (g11 - g10) * fu
                dx[:, a] += dfu * (R - 1)
                dx[:, b] += dfv * (R - 1)
        if need_dx:
            dx = torch.where(_out_of_range(x), torch.zeros_like(dx), dx)
        if dtable is not None:
            dtable = dtable.to(table.dtype)
        return dx, dtable, None


def triplane_encode(x01: torch.Tensor, table: torch.Tensor,
                    spec: TriplaneSpec) -> torch.Tensor:
    """x01 [..., 3] in [0, 1] → [..., output_dim] features."""
    prefix = x01.shape[:-1]
    x = x01.reshape(-1, 3).float()
    out = _TriplaneEncode.apply(x, table, spec)
    return out.reshape(*prefix, spec.output_dim)
