"""Multiresolution tiled / hash grid encoding (counterpart of
``customnerf_tpu/ops/grid.py``; reference CUDA ``gridencoder.cu:88-339``).

On the card the encode and its backward are hand-written kernels
(``csrc/grid_encode.cu``): a level-major forward, one thread a (point,
level), and a backward that adds each corner's gradient with one float2
atomic.  The JAX package runs this encoder as plain XLA (no Pallas kernel),
and the plain PyTorch version stays here as the CPU path and the oracle the
card's tests hold the kernels to: one gather of every level's eight cell
corners and a trilinear sum, and a backward that recomputes the corners and
adds every level's rows with ONE ``index_add_`` into one zeroed gradient.
Indexing the table with ``table[idx]`` instead would backpropagate through
``index_put_(accumulate=True)``, which sorts its indices on CUDA; and a
differentiable ``index_select`` per level would allocate and sum a
full-table gradient per level (16 × 192 MB at the parity spec).  A CUDA
tensor launches the kernels or raises (:func:`check_kernel`); a CPU tensor
takes the plain version.

Semantics kept exactly (the JAX module's "traps"):
  * ``scale_l = 2^(l·S)·H − 1``, ``res_l = ceil(scale_l) + 1`` with
    ``S = log2(per_level_scale)``;
  * ``pos = x·scale + 0.5`` (align_corners=False), floor → corner,
    fraction → trilinear weights;
  * the dense stride sum takes only the axes whose stride fits the level's
    table (``include``); the xor-prime hash (1, 2654435761, 805459861) only
    on *hash*-type levels that overflow; then ``% size``.  The arithmetic is
    uint32 with wraparound in the JAX package, the CUDA reference and the
    kernels; in the plain version it is int64 masked to 32 bits before the
    modulo;
  * per-level sizes capped at ``2^log2_hashmap_size``, rounded up to 8;
  * inputs outside [0, 1] give zeros (and zero gradients);
  * levels ≥ ``max_level`` give zeros.

The kernels take the level constants as one packed argument
(:func:`kernel_levels`) and compute the same uint32 index arithmetic.

The table's initial draw is the field's (``models/field.py::encoder_init``).
The tracer's device spans (``engine/spans.py``): ``grid_encode`` around a
forward, ``grid_encode.bwd`` around the backward.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from customnerf_torch.engine import spans
from customnerf_torch.ops import kernels

# xor-hash primes for up to 3 input dims (gridencoder.cu:51-63)
PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF


@dataclass(frozen=True)
class GridSpec:
    """Static metadata of a multiresolution grid encoding; the defaults of
    the JAX ``GridSpec``."""

    input_dim: int = 3
    num_levels: int = 16
    level_dim: int = 2
    base_resolution: int = 16
    log2_hashmap_size: int = 19
    desired_resolution: int = 2048
    gridtype: str = "hash"  # "hash" | "tiled"
    align_corners: bool = False

    @property
    def per_level_scale(self) -> float:
        if self.num_levels == 1:
            return 1.0
        return float(np.exp2(np.log2(self.desired_resolution / self.base_resolution)
                             / (self.num_levels - 1)))

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.level_dim

    @functools.cached_property
    def level_meta(self):
        """Per-level numpy arrays: scales, resolutions, sizes, offsets,
        partial strides, include masks, hash flags."""
        L, D = self.num_levels, self.input_dim
        S = np.log2(self.per_level_scale)
        max_params = 2 ** self.log2_hashmap_size

        scales = np.exp2(np.arange(L) * S) * self.base_resolution - 1.0
        res = np.ceil(scales).astype(np.int64) + 1
        side = res if self.align_corners else res + 1

        sizes, offsets = [], [0]
        for l in range(L):
            params = min(max_params, int(side[l]) ** D)
            params = int(np.ceil(params / 8) * 8)
            sizes.append(params)
            offsets.append(offsets[-1] + params)

        strides = np.ones((L, D), dtype=np.int64)
        include = np.zeros((L, D), dtype=bool)
        use_hash = np.zeros((L,), dtype=bool)
        for l in range(L):
            stride = 1
            for d in range(D):
                strides[l, d] = stride
                include[l, d] = stride <= sizes[l]
                stride *= int(side[l])
            use_hash[l] = self.gridtype == "hash" and stride > sizes[l]

        return dict(scales=scales.astype(np.float32), resolutions=res,
                    sizes=np.asarray(sizes, dtype=np.int64),
                    offsets=np.asarray(offsets, dtype=np.int64),
                    strides=strides, include=include, use_hash=use_hash)

    @property
    def table_size(self) -> int:
        return int(self.level_meta["offsets"][-1])


def _axis_view(t: torch.Tensor, d: int, D: int) -> torch.Tensor:
    """[B, L, 2] → [B, L, 1, …, 2 (at corner axis d), …, 1]."""
    return t.reshape(*t.shape[:2], *([1] * d), 2, *([1] * (D - 1 - d)))


_CONSTS = {}


def _level_consts(spec: GridSpec, n_levels: int, device):
    """The levels' scales, strides (0 on the axes a level leaves out of its
    dense sum), sizes, offsets and hash flags as tensors on ``device``."""
    key = (spec, n_levels, str(device))
    if key not in _CONSTS:
        meta = spec.level_meta
        L = n_levels
        strides = np.where(meta["include"], meta["strides"], 0)[:L]
        _CONSTS[key] = dict(
            scales=torch.tensor(meta["scales"][:L], dtype=torch.float32, device=device),
            strides=torch.tensor(strides, dtype=torch.int64, device=device),
            sizes=torch.tensor(meta["sizes"][:L], dtype=torch.int64, device=device),
            offsets=torch.tensor(meta["offsets"][:L], dtype=torch.int64, device=device),
            use_hash=torch.tensor(meta["use_hash"][:L], device=device),
            any_hash=bool(meta["use_hash"][:L].any()),
            all_hash=bool(meta["use_hash"][:L].all()))
    return _CONSTS[key]


def _corners(x, spec: GridSpec, n_levels: int):
    """All levels' corners at once, one [B, L, 2] pair per axis broadcast
    over the 2^D corners (the JAX corner order: axis 0 slowest): table rows
    [B, L, 2^D], the per-axis weight factors ``(1 − f, f)`` as [B, L, 2]
    each, and the level constants."""
    c = _level_consts(spec, n_levels, x.device)
    D = spec.input_dim
    pos = x[:, None, :] * c["scales"][None, :, None] + (
        0.0 if spec.align_corners else 0.5)                            # [B, L, D]
    pos_grid = torch.floor(pos)
    frac = pos - pos_grid
    c0 = pos_grid.to(torch.int64)
    dense = hashed = None
    factors = []
    for d in range(D):
        cd = torch.stack([c0[..., d], c0[..., d] + 1], dim=-1) & _U32  # [B, L, 2]
        if not c["all_hash"]:
            term = _axis_view(cd * c["strides"][None, :, d, None], d, D)
            dense = term if dense is None else dense + term
        if c["any_hash"]:
            term = _axis_view((cd * PRIMES[d]) & _U32, d, D)
            hashed = term if hashed is None else hashed ^ term
        factors.append(torch.stack([1.0 - frac[..., d], frac[..., d]], dim=-1))
    if dense is None:
        idx = hashed
    elif hashed is None:
        idx = dense
    else:
        mask = c["use_hash"].reshape(1, -1, *([1] * D))
        idx = torch.where(mask, hashed, dense)
    idx = idx.reshape(*x.shape[:1], n_levels, -1)
    idx = (idx & _U32) % c["sizes"][None, :, None] + c["offsets"][None, :, None]
    return idx, factors, c


def _weights(factors, skip: int = -1):
    """Trilinear weights [B, L, 2^D]: the product of the axes' factors
    (axis ``skip`` left out)."""
    D = len(factors)
    w = None
    for d, f in enumerate(factors):
        if d == skip:
            continue
        f = _axis_view(f, d, D)
        w = f if w is None else w * f
    B, L = factors[0].shape[:2]
    return w.expand(B, L, *([2] * D)).reshape(B, L, -1)


def _out_of_range(x):
    return ((x < 0.0) | (x > 1.0)).any(dim=-1, keepdim=True)


def _encode_forward(x, table, spec: GridSpec, n_levels: int):
    C, B = spec.level_dim, x.shape[0]
    idx, factors, _ = _corners(x, spec, n_levels)
    w = _weights(factors)                                              # [B, L, K]
    vals = table.index_select(0, idx.reshape(-1)).reshape(B, n_levels, -1, C)
    out = (vals.float() * w[..., None]).sum(dim=2).reshape(B, n_levels * C)
    if n_levels < spec.num_levels:
        out = torch.cat([out, x.new_zeros(B, (spec.num_levels - n_levels) * C)], -1)
    return torch.where(_out_of_range(x), torch.zeros_like(out), out)


def _plain_backward(x, table, g, spec: GridSpec, n_levels: int, need_dx: bool,
                    need_dt: bool):
    """(dx, dtable) of the plain version; None where not needed."""
    C, D, B = spec.level_dim, spec.input_dim, x.shape[0]
    g = torch.where(_out_of_range(x), torch.zeros_like(g), g.float())
    gl = g[:, :n_levels * C].reshape(B, n_levels, 1, C)
    idx, factors, c = _corners(x, spec, n_levels)
    dtable = dx = None
    if need_dt:
        # one zeroed gradient, every level's corners added in one call
        contrib = _weights(factors)[..., None] * gl                     # [B, L, K, C]
        dtable = torch.zeros_like(table, dtype=torch.float32)
        dtable.index_add_(0, idx.reshape(-1), contrib.reshape(-1, C))
        dtable = dtable.to(table.dtype)
    if need_dx:
        vals = table.index_select(0, idx.reshape(-1)).float()
        gv = (vals.reshape(B, n_levels, -1, C) * gl).sum(dim=-1)       # [B, L, K]
        sign = torch.tensor([-1.0, 1.0], device=x.device).expand(B, n_levels, 2)
        dx = torch.empty_like(x)
        for d in range(D):
            # d w / d frac_d: the other axes' factors, signed by the
            # corner's side along d; d frac / d x = the level's scale
            dw = _weights(factors, skip=d) * _weights(
                [sign if e == d else torch.ones_like(f)
                 for e, f in enumerate(factors)])
            dx[:, d] = ((gv * dw).sum(dim=-1) * c["scales"][None, :]).sum(dim=-1)
        dx = torch.where(_out_of_range(x), torch.zeros_like(dx), dx)
    return dx, dtable


# ------------------------------------------------------------------ kernels
KERNEL_LEVELS = 16                  # levels the kernels' argument holds
KERNEL_CHANNELS = (1, 2, 4, 8)      # level_dim values the kernels are built for
LEVEL_WORDS = 8                     # uint32 words a level (csrc/grid_encode.cu::Level)


@functools.lru_cache(maxsize=None)
def kernel_levels(spec: GridSpec, n_levels: int) -> np.ndarray:
    """The kernels' level argument, [KERNEL_LEVELS, LEVEL_WORDS] uint32 (C
    order, as ``csrc/grid_encode.cu::Levels``): per level the f32 scale's
    bits, the size, the offset, the three dense strides (0 on an axis the
    level leaves out of its dense sum), the hash flag and a 0; rows ≥
    ``n_levels`` are 0."""
    meta = spec.level_meta
    packed = np.zeros((KERNEL_LEVELS, LEVEL_WORDS), dtype=np.uint32)
    L = n_levels
    packed[:L, 0] = meta["scales"][:L].astype(np.float32).view(np.uint32)
    packed[:L, 1] = meta["sizes"][:L]
    packed[:L, 2] = meta["offsets"][:L]
    packed[:L, 3:6] = np.where(meta["include"], meta["strides"], 0)[:L]
    packed[:L, 6] = meta["use_hash"][:L]
    packed.flags.writeable = False
    return packed


def check_kernel(x, table, spec: GridSpec, n_levels: int) -> None:
    """Raise on what the kernels do not take: 3-D inputs, C in
    KERNEL_CHANNELS, at most KERNEL_LEVELS levels, a table of < 2^32 rows,
    f32 [rows, C] contiguous and aligned to a row's vector width, on x's
    device."""
    C = spec.level_dim
    if spec.input_dim != 3:
        raise ValueError(f"grid_encode: the kernels take input_dim 3, not {spec.input_dim}")
    if C not in KERNEL_CHANNELS:
        raise ValueError(f"grid_encode: the kernels take level_dim in "
                         f"{KERNEL_CHANNELS}, not {C}")
    if not 1 <= n_levels <= KERNEL_LEVELS:
        raise ValueError(f"grid_encode: the kernels take 1-{KERNEL_LEVELS} "
                         f"levels, not {n_levels}")
    if spec.table_size >= 2 ** 32:
        raise ValueError(f"grid_encode: the kernels index < 2^32 rows, not "
                         f"{spec.table_size}")
    if table.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(f"grid_encode: the kernels take float32 tables and "
                        f"inputs, not {table.dtype} / {x.dtype}")
    if tuple(table.shape) != (spec.table_size, C) or not table.is_contiguous():
        raise ValueError(f"grid_encode: the kernels take a contiguous "
                         f"[{spec.table_size}, {C}] table, not "
                         f"{tuple(table.shape)} with strides {table.stride()}")
    if table.data_ptr() % (4 * min(C, 4)):
        raise ValueError("grid_encode: the kernels read a table row as one "
                         "vector: its base must be aligned to it")
    if table.device != x.device:
        raise ValueError(f"grid_encode: table on {table.device}, inputs on {x.device}")


def _on_card(x) -> bool:
    """True for CUDA tensors (the kernels), False for CPU ones (the plain
    version); raises for any other device."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"grid_encode: unsupported device {x.device}")
    return x.device.type == "cuda"


def _vector_aligned(t, C):
    """``t`` contiguous with its base aligned to a row of C floats' vector."""
    t = t.contiguous()
    return t if t.data_ptr() % (4 * min(C, 4)) == 0 else t.clone()


def _shift(spec: GridSpec) -> float:
    return 0.0 if spec.align_corners else 0.5


def _kernel_forward(x, table, spec: GridSpec, n_levels: int):
    check_kernel(x, table, spec, n_levels)
    x = x.contiguous()
    B = x.shape[0]
    # levels ≥ n_levels are not launched: zeros there
    alloc = torch.empty if n_levels == spec.num_levels else torch.zeros
    out = alloc(B, spec.output_dim, device=x.device, dtype=torch.float32)
    if B:
        lib = kernels.library()
        with torch.cuda.device(x.device):
            err = lib.cn_grid_encode_forward(
                x.data_ptr(), table.data_ptr(), out.data_ptr(), spec.output_dim, B,
                n_levels, spec.level_dim, _shift(spec),
                kernel_levels(spec, n_levels).ctypes.data,
                torch.cuda.current_stream().cuda_stream)
        kernels.check(err, "grid_encode")
        if not torch.cuda.is_current_stream_capturing():  # a capture only records one
            grid_encode.launches += 1
    return out


def _kernel_backward(x, table, g, spec: GridSpec, n_levels: int, need_dx: bool,
                     need_dt: bool):
    check_kernel(x, table, spec, n_levels)
    x = x.contiguous()
    g = _vector_aligned(g.float(), spec.level_dim)
    B = x.shape[0]
    dtable = torch.zeros_like(table) if need_dt else None
    dx = torch.zeros_like(x) if need_dx else None
    if B and (need_dt or need_dx):
        lib = kernels.library()
        with torch.cuda.device(x.device):
            err = lib.cn_grid_encode_backward(
                x.data_ptr(), table.data_ptr(), g.data_ptr(), g.stride(0),
                None if dtable is None else dtable.data_ptr(),
                None if dx is None else dx.data_ptr(), B, n_levels, spec.level_dim,
                _shift(spec), kernel_levels(spec, n_levels).ctypes.data,
                torch.cuda.current_stream().cuda_stream)
        kernels.check(err, "grid_encode.bwd")
        if not torch.cuda.is_current_stream_capturing():
            grid_encode.launches_bwd += 1
    return dx, dtable


class _GridEncode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, table, spec, n_levels):
        ctx.spec, ctx.n_levels = spec, n_levels
        ctx.save_for_backward(x, table)
        if _on_card(x):
            return _kernel_forward(x, table, spec, n_levels)
        return _encode_forward(x, table, spec, n_levels).to(table.dtype)

    @staticmethod
    def backward(ctx, g):
        with spans.device("grid_encode.bwd"):
            x, table = ctx.saved_tensors
            run = _kernel_backward if _on_card(x) else _plain_backward
            dx, dtable = run(x, table, g, ctx.spec, ctx.n_levels,
                             ctx.needs_input_grad[0], ctx.needs_input_grad[1])
            return dx, dtable, None, None


def grid_encode(x01: torch.Tensor, table: torch.Tensor, spec: GridSpec,
                max_level: int | None = None) -> torch.Tensor:
    """x01 [..., D] in [0, 1] → [..., L·C] features; levels ≥ ``max_level``
    output zeros (the reference's progressive-level option).  CUDA tensors
    launch the kernels (``launches`` counts the forward's launches,
    ``launches_bwd`` the backward's, none while a CUDA graph is captured;
    the kernels count their own, a graph's replays included:
    ``kernels.device_launches("grid_encode")``); CPU tensors take the plain
    version."""
    L = spec.num_levels
    n_levels = L if max_level is None else min(max_level, L)
    prefix = x01.shape[:-1]
    x = x01.reshape(-1, spec.input_dim).float()
    with spans.device("grid_encode"):
        out = _GridEncode.apply(x, table, spec, n_levels)
    return out.reshape(*prefix, spec.output_dim)


grid_encode.launches = 0
grid_encode.launches_bwd = 0
