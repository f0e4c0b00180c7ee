"""Plain PyTorch NeRF field and renderers: the reference that decides
``correct`` for the reconstruction and editing cells.

It follows the port's plain code paths (``customnerf_torch/ops`` and
``models``, frozen here) in f32: the ray/AABB slab test, the occupancy grid
(refresh, bitfield, march), cross-ray compaction, the tri-plane and the
tiled/hash grid encodings, the field's bias-free 64-wide heads, the
constant-dt and the dense two-pass composites with the fg/bg split, and
``sample_pdf``.  Every random number is drawn with the same call, shape and
order as the port draws it, from a ``torch.Generator`` seeded as the
trainer's is, so both sides take the same draws.

Where the port runs a hand-written kernel, the reference runs plain
operations: the fused head is a chain of matmuls, the tri-plane table
gradient comes from autograd through a gather.  ``Precision`` sets what
the control of ``correct`` lowers: the heads' matmul operands (to bf16 or
fp8) and the encoded features (to bf16).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

import numpy as np
import torch

from benchmark.reference.sd import fp8_round

_MISS = torch.finfo(torch.float32).max
WARMUP_UPDATES = 4
PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF
PLANES = ((0, 1), (0, 2), (1, 2))


@dataclass(frozen=True)
class Precision:
    """f32 everywhere (the reference), or lower steps: the heads' matmul
    operands in "bfloat16" or "fp8", the encoded features in bf16."""
    heads: str = "float32"
    features_bf16: bool = False


# ------------------------------------------------------------------ rays
def near_far_from_aabb(rays_o, rays_d, aabb, min_near: float):
    rd = 1.0 / rays_d
    t0 = (aabb[:3] - rays_o) * rd
    t1 = (aabb[3:] - rays_o) * rd
    near = torch.minimum(t0, t1).amax(dim=-1)
    far = torch.maximum(t0, t1).amin(dim=-1)
    miss = near > far
    near = torch.clamp(near, min=min_near)
    miss_val = torch.full_like(near, _MISS)
    return torch.where(miss, miss_val, near), torch.where(miss, miss_val, far)


def aabb_of(bound: float, device):
    return torch.tensor([-bound] * 3 + [bound] * 3, dtype=torch.float32,
                        device=device)


# ------------------------------------------------------------- composite
def weights_from_alphas(alphas):
    shifted = torch.cat([torch.ones_like(alphas[..., :1]),
                         1.0 - alphas[..., :-1] + 1e-15], dim=-1)
    return alphas * torch.cumprod(shifted, dim=-1)


def alphas_from_sigmas(sigmas, deltas):
    return 1.0 - torch.exp(-deltas * sigmas)


def sample_pdf(bins, weights, n_samples: int, det: bool, generator):
    weights = weights + 1e-5
    pdf = weights / weights.sum(dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    B = cdf.shape[0]
    if det:
        u = torch.linspace(0.5 / n_samples, 1.0 - 0.5 / n_samples, n_samples,
                           device=cdf.device, dtype=cdf.dtype).expand(B, n_samples)
    else:
        u = torch.rand(B, n_samples, generator=generator, device=cdf.device,
                       dtype=cdf.dtype)
    u = u.contiguous()
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    cdf_below, cdf_above = torch.gather(cdf, -1, below), torch.gather(cdf, -1, above)
    bins_below, bins_above = torch.gather(bins, -1, below), torch.gather(bins, -1, above)
    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    return bins_below + (u - cdf_below) / denom * (bins_above - bins_below)


# -------------------------------------------------------------- occupancy
@dataclass
class Occupancy:
    density_grid: torch.Tensor
    bitfield: torch.Tensor
    mean_density: torch.Tensor
    iter_density: int = 0
    grid_size: int = 128


def init_occupancy(cascade: int, grid_size: int, device) -> Occupancy:
    n = grid_size ** 3
    return Occupancy(torch.zeros(cascade, n, device=device),
                     torch.zeros(cascade * n // 8, dtype=torch.uint8, device=device),
                     torch.zeros((), device=device), 0, grid_size)


def packbits(grid, thresh):
    occ = (grid > thresh).reshape(-1, 8).to(torch.int32)
    shifts = 1 << torch.arange(8, device=grid.device, dtype=torch.int32)
    return (occ * shifts).sum(dim=-1).to(torch.uint8)


@torch.no_grad()
def refresh(occ: Occupancy, density_fn, bound: float, density_thresh: float,
            generator, decay: float = 0.95):
    """One EMA refresh of every cascade, in place."""
    cas, n = occ.density_grid.shape
    g = occ.grid_size
    jitter = torch.rand(cas, n, 3, generator=generator, device=occ.density_grid.device)
    idx = torch.arange(n, device=jitter.device)
    coords = torch.stack([idx // (g * g), (idx // g) % g, idx % g], dim=-1).float()
    xyz = []
    for c in range(cas):
        half = min(2.0 ** c, bound)
        xyz.append((coords + jitter[c]) * (2.0 * half / g) - half)
    sig = density_fn(torch.cat(xyz)).reshape(cas, n)
    grid = torch.maximum(occ.density_grid * decay, sig)
    mean = torch.clamp(grid, min=0.0).mean()
    occ.density_grid = grid
    occ.mean_density = mean
    occ.bitfield = packbits(grid, torch.clamp(mean, max=density_thresh))
    occ.iter_density += 1


def occupancy_lookup(occ: Occupancy, xyz, bound: float):
    cascade, g = occ.density_grid.shape[0], occ.grid_size
    ax = xyz.abs().amax(dim=-1)
    inside = ax <= bound
    if occ.iter_density <= WARMUP_UPDATES:
        return inside
    mip = torch.zeros(ax.shape, dtype=torch.int64, device=xyz.device)
    half = torch.full(ax.shape, min(1.0, bound), device=xyz.device)
    for c in range(cascade - 1):
        above = ax > (2.0 ** c)
        mip = mip + above.long()
        half = torch.where(above, torch.full_like(half, min(2.0 ** (c + 1), bound)), half)
    scaled = (xyz / (2.0 * half[..., None]) + 0.5) * g
    cell = torch.clamp(scaled.to(torch.int32), 0, g - 1).long()
    bit = mip * (g ** 3) + cell[..., 0] * (g * g) + cell[..., 1] * g + cell[..., 2]
    byte = occ.bitfield[bit // 8].long()
    return (((byte >> (bit % 8)) & 1) > 0) & inside


def march(occ, rays_o, rays_d, nears, fars, bound, n_coarse, n_keep, generator):
    """Up to n_keep occupied stratified candidates a ray, in depth order
    (an even-stride subsample of the occupied span), jittered."""
    N, dev = rays_o.shape[0], rays_o.device
    u = (torch.arange(n_coarse, dtype=torch.float32, device=dev) + 0.5) / n_coarse
    z = nears[:, None] + (fars - nears)[:, None] * u[None, :]
    dz = (fars - nears)[:, None] / n_coarse
    z = z + (torch.rand(z.shape, generator=generator, device=dev) - 0.5) * dz
    occupied = occupancy_lookup(occ, rays_o[:, None, :] + rays_d[:, None, :] * z[..., None],
                                bound)
    occ_i = occupied.long()
    count = torch.cumsum(occ_i, dim=-1)
    n_occ = count[:, -1:]
    rank = count - occ_i
    scale = torch.clamp(n_occ, min=n_keep)
    bucket = torch.div(rank * n_keep, scale, rounding_mode="floor")
    prev = torch.where(rank > 0, torch.div((rank - 1) * n_keep, scale, rounding_mode="floor"),
                       torch.full_like(rank, -1))
    keep = occupied & (bucket != prev)
    slot = torch.cumsum(keep.long(), dim=-1) - 1
    slot = torch.where(keep, slot, torch.full_like(slot, n_keep))
    z_keep = torch.zeros(N, n_keep + 1, device=dev).scatter_(1, slot, z)[:, :n_keep]
    valid = torch.arange(n_keep, device=dev)[None, :] < torch.clamp(n_occ, max=n_keep)
    return z_keep, valid, torch.clamp(n_occ.float() / n_keep, min=1.0)


# ------------------------------------------------------------- compaction
def block_budget(block_rays: int, n_keep: int, frac: float) -> int:
    raw = int(np.ceil(block_rays * n_keep * float(frac)))
    return min(max(128, -(-raw // 128) * 128), block_rays * n_keep)


def ray_permutation(n: int):
    stride = 7919
    while np.gcd(stride, n) != 1:
        stride += 2
    perm = (np.arange(n, dtype=np.int64) * stride) % n
    inv = np.empty_like(perm)
    inv[perm] = np.arange(n, dtype=np.int64)
    return perm, inv


def compact_plan(valid, G: int, M: int):
    N, K = valid.shape
    NB = N // G
    v = valid.reshape(NB, G * K)
    vi = v.long()
    count = torch.cumsum(vi, dim=-1)
    n_val = count[:, -1:]
    rank = count - vi
    scale = torch.clamp(n_val, min=M)
    bucket = torch.div(rank * M, scale, rounding_mode="floor")
    prev = torch.where(rank > 0, torch.div((rank - 1) * M, scale, rounding_mode="floor"),
                       torch.full_like(rank, -1))
    keep = v & (bucket != prev)
    slot = torch.cumsum(keep.long(), dim=-1) - 1
    slot = torch.where(keep, slot, torch.full_like(slot, M))
    slot_valid = torch.arange(M, device=valid.device)[None, :] < torch.clamp(n_val, max=M)
    src = torch.zeros(NB, M + 1, dtype=torch.long, device=valid.device)
    src.scatter_(1, slot, torch.arange(G * K, device=valid.device).expand(NB, G * K))
    return src[:, :M], slot_valid, torch.clamp(n_val.float() / M, min=1.0)


# --------------------------------------------------------------- encoders
@dataclass(frozen=True)
class TriplaneSpec:
    resolutions: tuple
    channels: tuple

    @property
    def table_size(self) -> int:
        return sum(3 * r * r for r in self.resolutions)

    @property
    def max_channels(self) -> int:
        return max(self.channels)

    @property
    def output_dim(self) -> int:
        return 3 * sum(self.channels)


def triplane_encode(x, table, spec: TriplaneSpec):
    """Bilinear samples of each plane (XY, XZ, YZ) of each level, align-
    corners, the lower corner clipped to R−2; zero outside [0, 1]³."""
    outs, base = [], 0
    for R, C in zip(spec.resolutions, spec.channels):
        pos = x * (R - 1)
        p0 = torch.clamp(torch.floor(pos), 0, R - 2)
        f = pos - p0
        p0 = p0.long()
        for a, b in PLANES:
            r00 = base + p0[:, a] * R + p0[:, b]
            fu, fv = f[:, a:a + 1], f[:, b:b + 1]
            t = table[:, :C]
            outs.append(t[r00] * (1 - fu) * (1 - fv) + t[r00 + 1] * (1 - fu) * fv
                        + t[r00 + R] * fu * (1 - fv) + t[r00 + R + 1] * fu * fv)
            base += R * R
    out = torch.cat(outs, dim=-1)
    bad = ((x < 0.0) | (x > 1.0)).any(dim=-1, keepdim=True)
    return torch.where(bad, torch.zeros_like(out), out)


@dataclass(frozen=True)
class GridSpec:
    num_levels: int = 16
    level_dim: int = 2
    base_resolution: int = 16
    log2_hashmap_size: int = 21
    desired_resolution: int = 8192
    gridtype: str = "tiled"

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.level_dim

    def meta(self):
        """Per-level scales, sizes, offsets, strides (0 where a level leaves
        an axis out of its dense sum) and hash flags."""
        L, D = self.num_levels, 3
        S = np.log2(np.exp2(np.log2(self.desired_resolution / self.base_resolution)
                            / (L - 1)))
        scales = np.exp2(np.arange(L) * S) * self.base_resolution - 1.0
        side = np.ceil(scales).astype(np.int64) + 2
        sizes, offsets = [], [0]
        for l in range(L):
            params = min(2 ** self.log2_hashmap_size, int(side[l]) ** D)
            sizes.append(int(np.ceil(params / 8) * 8))
            offsets.append(offsets[-1] + sizes[-1])
        strides = np.zeros((L, D), dtype=np.int64)
        use_hash = np.zeros(L, dtype=bool)
        for l in range(L):
            stride = 1
            for d in range(D):
                strides[l, d] = stride if stride <= sizes[l] else 0
                stride *= int(side[l])
            use_hash[l] = self.gridtype == "hash" and stride > sizes[l]
        return scales.astype(np.float32), np.asarray(sizes), np.asarray(offsets), strides, use_hash

    @property
    def table_size(self) -> int:
        return int(self.meta()[2][-1])


def grid_encode(x, table, spec: GridSpec):
    """Trilinear samples of every level's eight cell corners (align_corners
    False: pos = x·scale + 0.5), the dense stride sum or the xor-prime hash,
    uint32 arithmetic, ``% size``; zero outside [0, 1]³."""
    scales, sizes, offsets, strides, use_hash = spec.meta()
    dev, B, L, C = x.device, x.shape[0], spec.num_levels, spec.level_dim
    sc = torch.tensor(scales, device=dev)
    pos = x[:, None, :] * sc[None, :, None] + 0.5
    c0 = torch.floor(pos)
    frac = pos - c0
    c0 = c0.long()
    st = torch.tensor(strides, device=dev)
    hashed_lv = torch.tensor(use_hash, device=dev)
    out = 0.0
    for corner in range(8):
        bits = [(corner >> (2 - d)) & 1 for d in range(3)]
        dense = 0
        hashed = 0
        w = 1.0
        for d in range(3):
            cd = (c0[..., d] + bits[d]) & _U32
            dense = dense + cd * st[None, :, d]
            hashed = hashed ^ ((cd * PRIMES[d]) & _U32)
            w = w * (frac[..., d] if bits[d] else 1.0 - frac[..., d])
        idx = torch.where(hashed_lv[None], hashed, dense)
        idx = (idx & _U32) % torch.tensor(sizes, device=dev)[None] \
            + torch.tensor(offsets[:-1], device=dev)[None]
        out = out + table[idx.reshape(-1)].reshape(B, L, C) * w[..., None]
    out = out.reshape(B, L * C)
    bad = ((x < 0.0) | (x > 1.0)).any(dim=-1, keepdim=True)
    return torch.where(bad, torch.zeros_like(out), out)


# ----------------------------------------------------------------- field
HEADS = ("feature_net.hidden_0.weight", "feature_net.hidden_1.weight",
         "feature_net.out.weight", "density_net.hidden_0.weight",
         "density_net.out.weight", "rgb_net.hidden_0.weight", "rgb_net.out.weight")


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(torch.clamp(x, max=80.0))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -15.0, 15.0))


def freq_encode(x, multires: int = 4):
    out = [x]
    for i in range(multires):
        out += [torch.sin(x * 2.0 ** i), torch.cos(x * 2.0 ** i)]
    return torch.cat(out, dim=-1)


@dataclass
class Field:
    """The field's parameters (the port's state-dict names) and encoder:
    σ = trunc_exp(density_raw + gaussian_blob(x)), radiance = sigmoid of
    the rgb head on ``[freq(d) ‖ feature]``, 3 colours and 1 confidence."""
    params: dict
    spec: object
    bound: float
    prec: Precision = dc_field(default_factory=Precision)

    def _encode(self, x):
        xf = x.reshape(-1, 3)
        x01 = (xf + self.bound) / (2.0 * self.bound)
        enc = triplane_encode if isinstance(self.spec, TriplaneSpec) else grid_encode
        feats = enc(x01, self.params["grid_table"], self.spec)
        if self.prec.features_bf16:
            feats = feats.to(torch.bfloat16).float()
        return xf, feats

    def _mm(self, h, name):
        w = self.params[name]
        if self.prec.heads == "float32":
            return h @ w.t()
        h, w = h.to(torch.bfloat16), w.to(torch.bfloat16)
        if self.prec.heads == "fp8":
            h, w = fp8_round(h), fp8_round(w)
        return (h @ w.t()).float()

    def _features(self, x_en):
        h = torch.relu(self._mm(x_en, HEADS[0]))
        h = torch.relu(self._mm(h, HEADS[1]))
        return self._mm(h, HEADS[2])

    def _sigma(self, xf, fea):
        raw = self._mm(torch.relu(self._mm(fea, HEADS[3])), HEADS[4])[..., 0]
        blob = 5.0 * torch.exp(-(xf * xf).sum(dim=-1) / (2.0 * 0.2 ** 2))
        return _TruncExp.apply(raw + blob)

    def __call__(self, x, d):
        prefix = x.shape[:-1]
        xf, x_en = self._encode(x)
        fea = self._features(x_en)
        view = freq_encode(d.reshape(-1, 3))
        rgb = torch.sigmoid(self._mm(torch.relu(self._mm(torch.cat([view, fea], -1),
                                                         HEADS[5])), HEADS[6]))
        return self._sigma(xf, fea).reshape(prefix), rgb.reshape(*prefix, rgb.shape[-1])

    def density(self, x):
        xf, x_en = self._encode(x)
        return self._sigma(xf, self._features(x_en)).reshape(x.shape[:-1])


# --------------------------------------------------------------- renderers
@dataclass(frozen=True)
class Settings:
    bound: float = 2.0
    min_near: float = 0.01
    num_steps: int = 64
    upsample_steps: int = 64
    soft_mask: bool = True
    conf_thr: float = 0.5
    detach_bg: bool = False


def _composite(sigmas, rgbs, masks, z_vals, sample_dist, nears, fars,
               detach_nonedit=False, bg_color=None, const_dt=False):
    if detach_nonedit:
        edit = masks.mean(dim=-1) >= 0.5
        sigmas = torch.where(edit, sigmas, sigmas.detach())
        rgbs = torch.where(edit[..., None], rgbs, rgbs.detach())
    if const_dt:
        deltas = sample_dist.expand_as(z_vals)
    else:
        deltas = z_vals[..., 1:] - z_vals[..., :-1]
        deltas = torch.cat([deltas, sample_dist.expand_as(deltas[..., :1])], -1)
    weights = weights_from_alphas(alphas_from_sigmas(sigmas, deltas))
    weights_sum = weights.sum(dim=-1)
    span = torch.where(fars > nears, fars - nears, torch.ones_like(fars))
    depth = (weights * torch.clamp((z_vals - nears) / span, 0.0, 1.0)).sum(dim=-1)
    image = (weights[..., None] * rgbs).sum(dim=-2)
    if bg_color is not None:
        image = image + (1.0 - weights_sum)[..., None] * bg_color
    return {"image": image, "depth": depth, "weights_sum": weights_sum,
            "render_mask": (weights[..., None] * masks).sum(dim=-2)}


def _fg_bg(res, sigmas, rgbs, masks, z, sample_dist, nears, fars, s, const_dt):
    conf = masks[..., 0]
    edit = (torch.sigmoid((conf - s.conf_thr) * 100.0) if s.soft_mask
            else (conf > 0.5).float())
    res["fg"] = _composite(sigmas * edit, rgbs, masks, z, sample_dist, nears, fars,
                           const_dt=const_dt)
    res["bg"] = _composite(sigmas * (1.0 - edit), rgbs, masks, z, sample_dist, nears,
                           fars, const_dt=const_dt)
    return res


def render_dense(field, rays_o, rays_d, s: Settings, generator, train: bool = True,
                 bg_color=None):
    """The ``-O2`` two-pass render: jittered stratified depths, a
    density-only coarse pass without a graph steering ``sample_pdf`` (at
    drawn u in training, evenly spaced u in a full-frame render), the fine
    pass on the merged sorted depths."""
    dev, T = rays_o.device, s.num_steps
    aabb = aabb_of(s.bound, dev)
    nears, fars = near_far_from_aabb(rays_o, rays_d, aabb, s.min_near)
    nears, fars = nears[:, None], fars[:, None]
    lin = torch.arange(T, dtype=torch.float32, device=dev) * (1.0 / max(T - 1, 1))
    z_vals = nears + (fars - nears) * lin[None]
    sample_dist = (fars - nears) / T
    z_vals = z_vals + (torch.rand(z_vals.shape, generator=generator, device=dev) - 0.5) \
        * sample_dist

    def xyzs(z):
        xyz = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
        return torch.minimum(torch.maximum(xyz, aabb[:3]), aabb[3:])

    z_all = z_vals
    if s.upsample_steps > 0:
        with torch.no_grad():
            sig_c = field.density(xyzs(z_vals))
            deltas = z_vals[..., 1:] - z_vals[..., :-1]
            deltas = torch.cat([deltas, sample_dist.expand_as(deltas[..., :1])], -1)
            w_c = weights_from_alphas(alphas_from_sigmas(sig_c, deltas))
            z_mid = z_vals[..., :-1] + 0.5 * deltas[..., :-1]
            new_z = sample_pdf(z_mid, w_c[:, 1:-1], s.upsample_steps, not train, generator)
            z_all, _ = torch.sort(torch.cat([z_vals, new_z], dim=1), dim=1)
    x = xyzs(z_all)
    sigmas, rad = field(x, rays_d[:, None, :].expand_as(x))
    rgbs, masks = rad[..., :3], rad[..., 3:]
    res = _composite(sigmas, rgbs, masks, z_all, sample_dist, nears, fars,
                     detach_nonedit=s.detach_bg, bg_color=bg_color)
    return _fg_bg(res, sigmas, rgbs, masks, z_all, sample_dist, nears, fars, s, False)


def render_fast(field, rays_o, rays_d, occ, s: Settings, n_coarse, n_keep,
                frac, block, generator, bg_color=None):
    """The ``-O`` render: the occupancy march, the field on the cross-ray
    compaction of the [N, n_keep] slab into blocks of ``block`` rays, the
    constant-dt composite."""
    dev = rays_o.device
    aabb = aabb_of(s.bound, dev)
    nears, fars = near_far_from_aabb(rays_o, rays_d, aabb, s.min_near)
    miss = nears >= fars
    nears_ = torch.where(miss, torch.zeros_like(nears), nears)
    fars_ = torch.where(miss, torch.ones_like(fars), fars)
    z, valid, dt_scale = march(occ, rays_o, rays_d, nears_, fars_, s.bound, n_coarse,
                               n_keep, generator)
    valid = valid & ~miss[:, None]
    z = torch.where(valid, z, fars_[:, None].expand_as(z))

    N, K, G = z.shape[0], n_keep, block
    n_pad = (-N) % G
    ro, rd, zp, vp = rays_o, rays_d, z, valid
    if n_pad:
        ro = torch.cat([ro, ro[-1:].expand(n_pad, 3)])
        rd = torch.cat([rd, rd[-1:].expand(n_pad, 3)])
        zp = torch.cat([zp, zp[-1:].expand(n_pad, K)])
        vp = torch.cat([vp, vp.new_zeros(n_pad, K)])
    Np = N + n_pad
    NB = Np // G
    perm, inv = (torch.from_numpy(a).to(dev) for a in ray_permutation(Np))
    M = block_budget(G, K, frac)
    src, slot_valid, block_scale = compact_plan(vp[perm], G, M)
    ray = perm[torch.arange(NB, device=dev)[:, None] * G + src // K].reshape(-1)
    k = (src % K).reshape(-1)
    live = slot_valid.reshape(-1)
    z_c = zp[ray, k] * live
    o_c, d_c = ro[ray] * live[:, None], rd[ray] * live[:, None]
    xyz = torch.minimum(torch.maximum(o_c + d_c * z_c[:, None], aabb[:3]), aabb[3:])
    sig_c, rad_c = field(xyz, d_c)
    out_c = torch.cat([sig_c[:, None], rad_c], dim=-1) * live[:, None].float()
    dest = torch.where(live, ray * K + k, torch.full_like(k, Np * K))
    out = out_c.new_zeros(Np * K + 1, out_c.shape[1]).index_put((dest,), out_c)
    out = out[:N * K].reshape(N, K, -1)
    dt_scale = dt_scale * block_scale[:, 0].repeat_interleave(G)[inv][:N, None]

    sigmas = out[..., 0] * valid.float()
    rgbs, masks = out[..., 1:4], out[..., 4:]
    sample_dist = ((fars_ - nears_) / n_coarse)[:, None] * dt_scale
    n2, f2 = nears[:, None], fars[:, None]
    res = _composite(sigmas, rgbs, masks, z, sample_dist, n2, f2,
                     detach_nonedit=s.detach_bg, bg_color=bg_color, const_dt=True)
    return _fg_bg(res, sigmas, rgbs, masks, z, sample_dist, n2, f2, s, True)
