"""Tri-plane table gradient (dT): hand-written CUDA kernel + its plain
version (counterpart of ``customnerf_tpu/ops/triplane_pallas.py`` and of its
XLA twin ``customnerf_tpu/ops/triplane.py::_plane_dtable``).

Contract, per plane of resolution R with C channels::

    dT[u·R + v, c] = Σ_b U[b, u] · V[b, v] · g[b, c]

U and V are the 2-nonzero bilinear weights of (u0, fu) and (v0, fv).  The
kernel (``csrc/triplane_dtable.cu``) scatters each sample's 4 corner
contributions with f32 atomics; the plain version is the same scatter as one
``index_add_``.  Both accumulate INTO ``out`` when it is given (a
``[R·R, ≥C]`` view with unit column stride, e.g. a row block of the flat
``[table_size, max_C]`` table gradient: columns ≥ C are left untouched).
"""

from __future__ import annotations

import torch

from customnerf_torch.ops import kernels


def corner_rows_weights(u0, v0, fu, fv, R: int):
    """Local plane rows [B, 4] (int64) and bilinear weights [B, 4] in the
    corner order (u,v) (u,v+1) (u+1,v) (u+1,v+1)."""
    r00 = u0.long() * R + v0.long()
    rows = torch.stack([r00, r00 + 1, r00 + R, r00 + R + 1], dim=1)
    w = torch.stack([(1 - fu) * (1 - fv), (1 - fu) * fv,
                     fu * (1 - fv), fu * fv], dim=1)
    return rows, w


def plane_dtable_reference(u0, v0, fu, fv, g, R: int, C: int, out=None):
    """Plain PyTorch version: one ``index_add_`` of the 4·B weighted rows."""
    if out is None:
        out = torch.zeros(R * R, C, device=g.device, dtype=torch.float32)
    rows, w = corner_rows_weights(u0, v0, fu, fv, R)
    vals = (w[:, :, None] * g[:, None, :C]).reshape(-1, C)
    out[:, :C].index_add_(0, rows.reshape(-1), vals)
    return out


def _check(u0, v0, fu, fv, g, R, C, out):
    B = u0.shape[0]
    for t, dt in ((u0, torch.int32), (v0, torch.int32), (fu, torch.float32),
                  (fv, torch.float32), (g, torch.float32)):
        if t.device != g.device:
            raise ValueError("plane_dtable: all tensors must share a device")
        if t.dtype != dt:
            raise TypeError(f"plane_dtable: expected {dt}, got {t.dtype}")
        if t.shape[0] != B:
            raise ValueError("plane_dtable: batch sizes differ")
    for t in (u0, v0, fu, fv):
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError("plane_dtable: u0, v0, fu, fv must be contiguous [B]")
    if g.dim() != 2 or g.shape[1] != C or g.stride(1) != 1:
        raise ValueError("plane_dtable: g must be [B, C] with unit column stride")
    if R < 2:
        raise ValueError("plane_dtable: R must be ≥ 2")
    if out is not None:
        if (out.device != g.device or out.dtype != torch.float32
                or out.dim() != 2 or out.shape[0] != R * R
                or out.shape[1] < C or out.stride(1) != 1):
            raise ValueError("plane_dtable: out must be a float32 [R·R, ≥C] "
                             "view with unit column stride on g's device")


def plane_dtable(u0, v0, fu, fv, g, R: int, C: int, out=None):
    """Table gradient of one plane, [R·R, C] f32 (or accumulated into ``out``).

    u0, v0: [B] int32 corners (0 ≤ · ≤ R−2); fu, fv: [B] f32 fractions;
    g: [B, C] f32 cotangent (a column slice is fine).  CUDA tensors launch
    the kernel; CPU tensors take the plain version."""
    _check(u0, v0, fu, fv, g, R, C, out)
    if g.device.type == "cpu":
        return plane_dtable_reference(u0, v0, fu, fv, g, R, C, out)
    if g.device.type != "cuda":
        raise ValueError(f"plane_dtable: unsupported device {g.device}")
    if out is None:
        out = torch.zeros(R * R, C, device=g.device, dtype=torch.float32)
    lib = kernels.library()
    with torch.cuda.device(g.device):
        err = lib.cn_plane_dtable(
            u0.data_ptr(), v0.data_ptr(), fu.data_ptr(), fv.data_ptr(),
            g.data_ptr(), g.stride(0), out.data_ptr(), out.stride(0),
            u0.shape[0], R, C, torch.cuda.current_stream().cuda_stream)
    kernels.check(err, "plane_dtable")
    plane_dtable.launches += 1
    return out


plane_dtable.launches = 0
