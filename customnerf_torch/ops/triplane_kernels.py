"""Tri-plane table gradient (dT): hand-written CUDA kernel + its plain
version (counterpart of ``customnerf_tpu/ops/triplane_pallas.py`` and of its
XLA twin ``customnerf_tpu/ops/triplane.py::_plane_dtable``).

Contract, per plane of resolution R with C channels::

    dT[u·R + v, c] = Σ_b U[b, u] · V[b, v] · g[b, c]

U and V are the 2-nonzero bilinear weights of (u0, fu) and (v0, fv).  With
``bf16`` (the JAX package's default, ``TriplaneSpec.mm_bf16``), the
operands are rounded to bf16 before the product and the sums stay f32, as
``_plane_dtable(use_bf16=True)`` and the Pallas kernel compute them::

    dT[u·R + v, c] = Σ_b bf16(U[b, u]) · bf16(V[b, v] · g[b, c])

The kernel (``csrc/triplane_dtable.cu``) sums runs of consecutive samples that
share a cell in registers and scatters the 4 corners with 128-bit float4
atomics; the plain version is the same scatter as one ``index_add_``.  Both
accumulate INTO ``out`` when it is given (a ``[R·R, ≥C]`` view with unit
column stride, e.g. a row block of the flat ``[table_size, max_C]`` table
gradient: columns ≥ C are left untouched).  The kernel's float4 accesses
need C, both row strides and both base addresses of g and out aligned to
4 floats; the wrapper raises otherwise.
"""

from __future__ import annotations

import torch

from customnerf_torch.ops import kernels


def _bf16(t):
    return t.to(torch.bfloat16).float()


def corner_values(u0, v0, fu, fv, g, R: int, C: int, bf16: bool = False):
    """Local plane rows [B, 4] (int64) in the corner order (u,v) (u,v+1)
    (u+1,v) (u+1,v+1), and the corners' contributions [B, 4, C]: U·V·g, or
    with ``bf16`` bf16(U)·bf16(V·g) (the u-weights and the v-weight products
    rounded, their product exact in f32)."""
    r00 = u0.long() * R + v0.long()
    rows = torch.stack([r00, r00 + 1, r00 + R, r00 + R + 1], dim=1)
    g = g[:, :C]
    if not bf16:
        w = torch.stack([(1 - fu) * (1 - fv), (1 - fu) * fv,
                         fu * (1 - fv), fu * fv], dim=1)
        return rows, w[:, :, None] * g[:, None, :]
    wu = torch.stack([_bf16(1 - fu), _bf16(fu)], dim=1)                 # [B, 2]
    vg = torch.stack([_bf16((1 - fv)[:, None] * g), _bf16(fv[:, None] * g)],
                     dim=1)                                             # [B, 2, C]
    return rows, (wu[:, :, None, None] * vg[:, None]).reshape(-1, 4, C)


def plane_dtable_reference(u0, v0, fu, fv, g, R: int, C: int, out=None,
                           bf16: bool = False):
    """Plain PyTorch version: one ``index_add_`` of the 4·B weighted rows."""
    if out is None:
        out = torch.zeros(R * R, C, device=g.device, dtype=torch.float32)
    rows, vals = corner_values(u0, v0, fu, fv, g, R, C, bf16)
    out[:, :C].index_add_(0, rows.reshape(-1), vals.reshape(-1, C))
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


def _check_kernel(g, C, out):
    """The kernel's float4 alignment (beyond the function's contract)."""
    for name, t in (("g", g), ("out", out)):
        if t.data_ptr() % 16 or t.stride(0) % 4:
            raise ValueError(f"plane_dtable: the kernel needs {name} 16-byte "
                             f"aligned with a row stride that is a multiple "
                             f"of 4 floats (stride {t.stride(0)})")
    if C % 4:
        raise ValueError(f"plane_dtable: the kernel needs C % 4 == 0 (C={C})")


def plane_dtable(u0, v0, fu, fv, g, R: int, C: int, out=None,
                 bf16: bool = False):
    """Table gradient of one plane, [R·R, C] f32 (or accumulated into ``out``).

    u0, v0: [B] int32 corners (0 ≤ · ≤ R−2); fu, fv: [B] f32 fractions;
    g: [B, C] f32 cotangent (a column slice is fine); ``bf16`` picks the
    bf16-operand mode.  CUDA tensors launch the kernel (``launches`` counts
    the f32 mode's launches, ``launches_bf16`` the bf16 mode's, none while a
    CUDA graph is captured; the kernel counts its own, a graph's replays
    included: ``kernels.device_launches``); CPU tensors take the plain
    version."""
    _check(u0, v0, fu, fv, g, R, C, out)
    if g.device.type == "cpu":
        return plane_dtable_reference(u0, v0, fu, fv, g, R, C, out, bf16)
    if g.device.type != "cuda":
        raise ValueError(f"plane_dtable: unsupported device {g.device}")
    if out is None:
        out = torch.zeros(R * R, C, device=g.device, dtype=torch.float32)
    _check_kernel(g, C, out)
    lib = kernels.library()
    launch = lib.cn_plane_dtable_bf16 if bf16 else lib.cn_plane_dtable
    with torch.cuda.device(g.device):
        err = launch(
            u0.data_ptr(), v0.data_ptr(), fu.data_ptr(), fv.data_ptr(),
            g.data_ptr(), g.stride(0), out.data_ptr(), out.stride(0),
            u0.shape[0], R, C, torch.cuda.current_stream().cuda_stream)
    kernels.check(err, "plane_dtable")
    # a launch (a capture only records one; B = 0 launches nothing)
    if u0.shape[0] > 0 and not torch.cuda.is_current_stream_capturing():
        if bf16:
            plane_dtable.launches_bf16 += 1
        else:
            plane_dtable.launches += 1
    return out


plane_dtable.launches = 0
plane_dtable.launches_bf16 = 0
