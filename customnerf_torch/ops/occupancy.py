"""Occupancy grid: multi-cascade density grid + empty-space-skipping march
(counterpart of ``customnerf_tpu/ops/occupancy.py``).

State: ``density_grid`` [CAS, G³] f32 refreshed as an EMA max of jittered
cell-centre density queries, threshold ``min(mean_density, density_thresh)``
baked into a packed uint8 bitfield (LSB-first per byte, the CUDA
``packbits`` order).  Cascade c spans [−2^c, 2^c]; a point lands in the
smallest cascade containing it.

The march gives every ray ``n_coarse`` stratified candidates, looks each up
in the bitfield, keeps at most ``n_keep`` occupied ones with an even-stride
subsample over the whole occupied span, and packs them in depth order into a
fixed [N, n_keep] slab (index scatter; the JAX version's one-hot matmul is a
TPU device).  The kept set and slot order are the JAX version's.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

GRID_SIZE = 128

# during the first WARMUP_UPDATES refreshes every in-bounds cell counts as
# occupied — a cold grid only marks the init density blob (bootstrap)
WARMUP_UPDATES = 4


@dataclass
class OccupancyState:
    density_grid: torch.Tensor   # [CAS, G³] f32
    bitfield: torch.Tensor       # [CAS·G³/8] uint8
    mean_density: torch.Tensor   # 0-d f32
    iter_density: int = 0        # number of refreshes so far (host int)
    grid_size: int = GRID_SIZE


def init_state(cascade: int, grid_size: int = GRID_SIZE,
               device=None) -> OccupancyState:
    n = grid_size ** 3
    return OccupancyState(
        density_grid=torch.zeros(cascade, n, device=device),
        bitfield=torch.zeros(cascade * n // 8, dtype=torch.uint8, device=device),
        mean_density=torch.zeros((), device=device),
        iter_density=0,
        grid_size=grid_size,
    )


def packbits(grid: torch.Tensor, thresh) -> torch.Tensor:
    """Grid [CAS, G³] → bitfield [CAS·G³/8] uint8, LSB-first per byte."""
    occ = (grid > thresh).reshape(-1, 8).to(torch.int32)
    shifts = 1 << torch.arange(8, device=grid.device, dtype=torch.int32)
    return (occ * shifts).sum(dim=-1).to(torch.uint8)


def state_from_grid(density_grid, mean_density, density_thresh: float,
                    iter_density: int = 10,
                    grid_size: int = GRID_SIZE) -> OccupancyState:
    """A consistent state from a raw density grid (bitfield packed with the
    same threshold rule as :func:`update_grid`)."""
    density_grid = torch.as_tensor(density_grid, dtype=torch.float32)
    mean_density = torch.as_tensor(mean_density, dtype=torch.float32,
                                   device=density_grid.device)
    thresh = torch.clamp(mean_density, max=density_thresh)
    return OccupancyState(
        density_grid=density_grid,
        bitfield=packbits(density_grid, thresh),
        mean_density=mean_density,
        iter_density=int(iter_density),
        grid_size=grid_size,
    )


def cell_centers(cascade_idx: int, bound: float, jitter: torch.Tensor,
                 grid_size: int) -> torch.Tensor:
    """Jittered world-space centres of all cells of one cascade [G³, 3];
    jitter [G³, 3] in [0, 1).  Cell order x·G² + y·G + z."""
    g = grid_size
    idx = torch.arange(g ** 3, device=jitter.device)
    coords = torch.stack([idx // (g * g), (idx // g) % g, idx % g],
                         dim=-1).to(torch.float32)
    half = min(2.0 ** cascade_idx, bound)
    cell = 2.0 * half / g
    return (coords + jitter) * cell - half


@torch.no_grad()
def update_grid(state: OccupancyState, density_fn, bound: float,
                density_thresh: float, generator=None, decay: float = 0.95,
                chunk: int = 2 ** 22, jitter=None) -> OccupancyState:
    """One EMA refresh of all cascades (reference renderer.py:1659-1717):
    full re-query with jitter, EMA max, mean over nonnegative cells.

    All cascades' cell centres go to ``density_fn`` together, in chunks of
    ``chunk`` points (the default keeps the flagship's 2 × 128³ refresh in
    one call).  ``jitter`` [CAS, G³, 3] overrides the generator's draw."""
    cas, n = state.density_grid.shape
    dev = state.density_grid.device
    if jitter is None:
        jitter = torch.rand(cas, n, 3, generator=generator, device=dev)
    xyz = torch.cat([cell_centers(c, bound, jitter[c], state.grid_size)
                     for c in range(cas)])
    sig = torch.cat([density_fn(xyz[i:i + chunk])
                     for i in range(0, xyz.shape[0], chunk)])
    grid = torch.maximum(state.density_grid * decay, sig.reshape(cas, n))
    mean_density = torch.clamp(grid, min=0.0).mean()
    thresh = torch.clamp(mean_density, max=density_thresh)
    return OccupancyState(
        density_grid=grid,
        bitfield=packbits(grid, thresh),
        mean_density=mean_density,
        iter_density=state.iter_density + 1,
        grid_size=state.grid_size,
    )


def occupancy_lookup(state: OccupancyState, xyz: torch.Tensor,
                     bound: float) -> torch.Tensor:
    """xyz [..., 3] → bool occupied, via the cascade each point lives in."""
    cascade = state.density_grid.shape[0]
    g = state.grid_size
    ax = xyz.abs().amax(dim=-1)
    inside = ax <= bound
    if state.iter_density <= WARMUP_UPDATES:
        return inside
    # smallest cascade c with 2^c ≥ |x|_inf, by branchless compares
    mip = torch.zeros(ax.shape, dtype=torch.int64, device=xyz.device)
    half = torch.full(ax.shape, min(1.0, bound), device=xyz.device)
    for c in range(cascade - 1):
        above = ax > (2.0 ** c)
        mip = mip + above.long()
        half = torch.where(above, torch.full_like(half, min(2.0 ** (c + 1), bound)),
                           half)
    scaled = (xyz / (2.0 * half[..., None]) + 0.5) * g
    cell = torch.clamp(scaled.to(torch.int32), 0, g - 1).long()
    flat = cell[..., 0] * (g * g) + cell[..., 1] * g + cell[..., 2]
    bit = mip * (g ** 3) + flat
    byte = state.bitfield[bit // 8].long()
    return (((byte >> (bit % 8)) & 1) > 0) & inside


def march_rays_occupancy(state: OccupancyState, rays_o, rays_d, nears, fars,
                         bound: float, n_coarse: int = 256, n_keep: int = 64,
                         perturb: bool = False, generator=None, jitter=None):
    """Static-shape empty-space-skipping march.  ``jitter`` [N, n_coarse]
    in [0, 1) replaces the generator's draw under ``perturb``.

    Returns (z [N, n_keep], valid [N, n_keep] bool, dt_scale [N, 1] f32): up
    to n_keep occupied stratified candidates per ray in depth order.  A ray
    with more than n_keep occupied candidates keeps an even-stride subsample
    over the whole occupied span; ``dt_scale = max(n_occ / n_keep, 1)`` is
    the per-ray quadrature stride."""
    N = rays_o.shape[0]
    dev = rays_o.device
    u = (torch.arange(n_coarse, dtype=torch.float32, device=dev) + 0.5) / n_coarse
    z = nears[:, None] + (fars - nears)[:, None] * u[None, :]      # [N, T]
    if perturb:
        dz = (fars - nears)[:, None] / n_coarse
        if jitter is None:
            jitter = torch.rand(z.shape, generator=generator, device=dev)
        z = z + (jitter - 0.5) * dz

    xyz = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
    occ = occupancy_lookup(state, xyz, bound)                        # [N, T]

    occ_i = occ.long()
    count = torch.cumsum(occ_i, dim=-1)
    n_occ = count[:, -1:]
    rank = count - occ_i
    scale = torch.clamp(n_occ, min=n_keep)
    bucket = torch.div(rank * n_keep, scale, rounding_mode="floor")
    prev_bucket = torch.where(
        rank > 0, torch.div((rank - 1) * n_keep, scale, rounding_mode="floor"),
        torch.full_like(rank, -1))
    keep = occ & (bucket != prev_bucket)

    # stable pack: kept candidate → slot = rank among kept; the rest go to a
    # dump column that is dropped
    slot = torch.cumsum(keep.long(), dim=-1) - 1
    slot = torch.where(keep, slot, torch.full_like(slot, n_keep))
    z_keep = torch.zeros(N, n_keep + 1, device=dev, dtype=z.dtype)
    z_keep.scatter_(1, slot, z)
    z_keep = z_keep[:, :n_keep]
    valid = (torch.arange(n_keep, device=dev)[None, :]
             < torch.clamp(n_occ, max=n_keep))
    dt_scale = torch.clamp(n_occ.to(torch.float32) / n_keep, min=1.0)
    return z_keep, valid, dt_scale
