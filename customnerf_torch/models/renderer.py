"""Volume renderers (counterpart of ``customnerf_tpu/models/renderer.py``:
``RenderSettings``, ``_composite``, ``_add_fg_bg``, ``render_rays``,
``_eval_field_compacted_pl`` and ``render_rays_fast``).

``render_rays`` is the dense two-pass path (``-O2``, reference
renderer.py:278-474): stratified coarse depths, a density-only coarse pass
whose weights only steer ``sample_pdf``, importance resampling, one fused
field evaluation on the merged, sorted depths, and the composite over
consecutive depth gaps.  ``render_rays_fast`` is the occupancy-grid path
(``-O``): march occupied cells only, evaluate the field on a fixed
[N, n_keep] slab — or, with ``compact_frac`` > 0, on its cross-ray
compaction — and composite every kept sample over its own march step
(const dt).  Both add the fg/bg σ decomposition through the confidence
mask (reference renderer.py:383-418, 597-718).  The field hands back f32
σ and radiance under either head precision (the bf16 heads widen their
outputs), so the composites, ``sample_pdf`` and their gradients run in f32,
as the JAX renderer's do.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from customnerf_torch.ops.compaction import (block_budget, compact_plan,
                                             ray_permutation, slot_sources)
from customnerf_torch.ops.composite import (alphas_from_sigmas, sample_pdf,
                                            weights_from_alphas)
from customnerf_torch.ops.occupancy import march_rays_occupancy
from customnerf_torch.ops.ray import near_far_from_aabb


_CONSTS = {}


def scene_aabb(bound: float, device) -> torch.Tensor:
    """[−b, −b, −b, b, b, b] on ``device``, made once: a host-to-device copy
    inside a step would sync the host and break a CUDA graph's capture."""
    key = ("aabb", float(bound), str(device))
    if key not in _CONSTS:
        _CONSTS[key] = torch.tensor([-bound] * 3 + [bound] * 3,
                                    dtype=torch.float32, device=device)
    return _CONSTS[key]


def _ray_perm(n: int, device):
    """``ray_permutation(n)`` as device tensors, made once per (n, device)."""
    key = ("perm", n, str(device))
    if key not in _CONSTS:
        perm, inv = ray_permutation(n)
        _CONSTS[key] = (torch.from_numpy(perm).to(device),
                        torch.from_numpy(inv).to(device))
    return _CONSTS[key]


@dataclass(frozen=True)
class RenderSettings:
    bound: float = 2.0
    min_near: float = 0.01
    num_steps: int = 64
    upsample_steps: int = 64
    train_conf: bool = True
    soft_mask: bool = False
    conf_thr: float = 0.5
    detach_bg: bool = False
    detach_mask_from_field: bool = False


def _composite(sigmas, rgbs, masks, z_vals, sample_dist, nears, fars,
               s: RenderSettings, detach_nonedit: bool = False, bg_color=None,
               const_dt: bool = False):
    """One masked-cumprod composite (reference renderer.py:407-474).

    sigmas [N, T], rgbs [N, T, 3], masks [N, T, M] or None, z_vals [N, T],
    sample_dist / nears / fars [N, 1].  ``const_dt`` composites every sample
    over ``sample_dist`` (the occupancy march's per-sample step)."""
    if detach_nonedit and masks is not None:
        # detach_bg: gradients flow only through "edit" points (mask ≥ 0.5)
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
    # AABB misses: depth 0 instead of the reference's 0/0
    span = torch.where(fars > nears, fars - nears, torch.ones_like(fars))
    ori_z = torch.clamp((z_vals - nears) / span, 0.0, 1.0)
    depth = (weights * ori_z).sum(dim=-1)
    image = (weights[..., None] * rgbs).sum(dim=-2)

    out = {}
    if bg_color is not None:
        out["black_image"] = image
        image = image + (1.0 - weights_sum)[..., None] * bg_color
    out["image"] = image
    out["depth"] = depth
    out["weights_sum"] = weights_sum
    out["weights"] = weights
    out["mask"] = (nears < fars)[..., 0]
    if masks is not None:
        w = weights.detach() if s.detach_mask_from_field else weights
        out["render_mask"] = (w[..., None] * masks).sum(dim=-2)
    return out


def _add_fg_bg(results, sigmas, rgbs, masks, z_all, sample_dist, nears, fars,
               s: RenderSettings, const_dt: bool = False):
    """fg/bg σ decomposition via the confidence mask (renderer.py:383-405)."""
    if not (s.train_conf and masks is not None):
        return
    conf = masks[..., 0]
    if s.soft_mask:
        edit_mask = torch.sigmoid((conf - s.conf_thr) * 100.0)
    else:
        edit_mask = (conf > 0.5).to(sigmas.dtype)
    results["sigma"] = sigmas
    results["rgbs"] = rgbs
    results["edit_mask"] = edit_mask
    results["fg"] = _composite(sigmas * edit_mask, rgbs, masks, z_all,
                               sample_dist, nears, fars, s, const_dt=const_dt)
    results["bg"] = _composite(sigmas * (1.0 - edit_mask), rgbs, masks, z_all,
                               sample_dist, nears, fars, s, const_dt=const_dt)


def render_rays(field, rays_o, rays_d, s: RenderSettings, train: bool = False,
                perturb: bool = False, generator=None, bg_color=None,
                draws=None, mark=None):
    """The dense two-pass path.  ``field`` is a ``NeRFField`` (its
    ``density`` runs the coarse pass, its call the fine one).  The depth
    jitter (``perturb``) and, when ``train``, ``sample_pdf``'s u come from
    ``generator``; ``draws`` may fix them (``jitter`` [N, num_steps],
    ``u`` [N, upsample_steps]).  Evaluation (``train`` False) samples the
    pdf at evenly spaced u.  ``mark(name)`` is called at the stage
    boundaries ``coarse``, ``resample``, ``fine`` and ``composite``.
    Returns the same dict as ``render_rays_fast`` (``stats`` empty)."""
    draws = draws or {}
    mark = mark or (lambda _: None)
    dev = rays_o.device
    T = s.num_steps
    aabb = scene_aabb(s.bound, dev)
    nears, fars = near_far_from_aabb(rays_o, rays_d, aabb, s.min_near)
    nears, fars = nears[:, None], fars[:, None]

    # jnp.linspace(0, 1, T) as XLA computes it: i · (1 / (T − 1)) in f32
    lin = torch.arange(T, dtype=torch.float32, device=dev) * (1.0 / max(T - 1, 1))
    z_vals = nears + (fars - nears) * lin[None]
    sample_dist = (fars - nears) / T                                # [N, 1]
    if perturb:
        jitter = draws.get("jitter")
        if jitter is None:
            jitter = torch.rand(z_vals.shape, generator=generator, device=dev)
        z_vals = z_vals + (jitter - 0.5) * sample_dist

    def make_xyzs(z):
        xyz = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
        return torch.minimum(torch.maximum(xyz, aabb[:3]), aabb[3:])

    if s.upsample_steps > 0:
        # importance resampling on the coarse pass's weights, which carry no
        # gradient (renderer.py:333-367): run it without a graph
        with torch.no_grad():
            sigmas_coarse = field.density(make_xyzs(z_vals))        # [N, T]
            mark("coarse")
            deltas = z_vals[..., 1:] - z_vals[..., :-1]
            deltas = torch.cat([deltas, sample_dist.expand_as(deltas[..., :1])], -1)
            weights_c = weights_from_alphas(alphas_from_sigmas(sigmas_coarse, deltas))
            z_mid = z_vals[..., :-1] + 0.5 * deltas[..., :-1]
            new_z = sample_pdf(z_mid, weights_c[:, 1:-1], s.upsample_steps,
                               det=not train, generator=generator,
                               u=draws.get("u") if train else None)
            z_all, _ = torch.sort(torch.cat([z_vals, new_z], dim=1), dim=1)
            mark("resample")
    else:
        z_all = z_vals
    # a point is a function of its depth alone: computing the points from
    # the sorted depths equals sorting the coarse and fine points (as the
    # JAX package does with a stable argsort), ties included
    xyz_all = make_xyzs(z_all)

    sigmas, radiance = field(xyz_all, rays_d[:, None, :].expand_as(xyz_all))
    mark("fine")
    rgbs = radiance[..., :3]
    masks = radiance[..., 3:] if radiance.shape[-1] > 3 else None
    results = _composite(sigmas, rgbs, masks, z_all, sample_dist, nears, fars, s,
                         detach_nonedit=s.detach_bg, bg_color=bg_color)
    _add_fg_bg(results, sigmas, rgbs, masks, z_all, sample_dist, nears, fars, s)
    mark("composite")
    results["stats"] = {}
    return results


def _eval_field_compacted(apply_fn, rays_o, rays_d, z, valid, frac: float,
                          block_rays: int, aabb):
    """Evaluate the field on the cross-ray-compacted slab.

    Rays are edge-replicate padded to a multiple of G, permuted with the
    fixed coprime stride, cut into blocks of G; each block's valid samples
    are gathered into its budget of M slots, the field runs on NB·M
    samples, dead slots' outputs are zeroed, and σ/radiance are scattered
    back to the [N, K] slab (zeros where nothing was kept).

    Returns (sigmas [N, K], radiance [N, K, R], dt_mult [N], stats) where
    dt_mult is the per-ray even-stride quadrature scale (1 unless the ray's
    block overflowed) and stats holds the slab fill and overflow share."""
    N, K = z.shape
    G = block_rays
    dev = z.device
    n_pad = (-N) % G
    if n_pad:
        # edge-replicate: zero-padded rays poison grads via NaN activations
        rays_o = torch.cat([rays_o, rays_o[-1:].expand(n_pad, 3)])
        rays_d = torch.cat([rays_d, rays_d[-1:].expand(n_pad, 3)])
        z = torch.cat([z, z[-1:].expand(n_pad, K)])
        valid = torch.cat([valid, valid.new_zeros(n_pad, K)])
    Np = N + n_pad
    NB = Np // G

    perm, inv_perm = _ray_perm(Np, dev)

    M = block_budget(G, K, frac)
    valid_p = valid[perm]
    _, slot, slot_valid, block_scale = compact_plan(valid_p, G, M)

    # slot → original (ray, k): in-block position t of block b is permuted
    # ray b·G + t // K, sample t % K
    src = slot_sources(slot, M)                                   # [NB, M]
    ray_p = torch.arange(NB, device=dev)[:, None] * G + src // K
    ray = perm[ray_p].reshape(-1)                                 # [NB·M]
    k = (src % K).reshape(-1)
    live = slot_valid.reshape(-1)
    z_c = z[ray, k] * live
    o_c = rays_o[ray] * live[:, None]
    d_c = rays_d[ray] * live[:, None]
    xyz_c = torch.minimum(torch.maximum(o_c + d_c * z_c[:, None], aabb[:3]),
                          aabb[3:])

    sig_c, rad_c = apply_fn(xyz_c, d_c)                           # [NB·M(, R)]
    out_c = torch.cat([sig_c[:, None].float(), rad_c.float()], dim=-1)
    out_c = out_c * live[:, None].to(out_c.dtype)

    # scatter each live slot back to its own slab position (ray, k); dead
    # slots go to a dump row that is dropped.  Written as an index_put so
    # its backward is a plain gather: a gather FROM a dump row instead
    # would send ~2/3 of the slab's gradient rows to one row, which the
    # sort-based index backward serialises (121 ms a flagship step on an
    # H100, engine/step_profile.py).
    dump = Np * K
    dest = torch.where(live, ray * K + k, torch.full_like(k, dump))
    out = out_c.new_zeros(dump + 1, out_c.shape[1]).index_put((dest,), out_c)
    out = out[:N * K].reshape(N, K, -1)                           # [N, K, 1+R]

    dt_mult = block_scale[:, 0].repeat_interleave(G)[inv_perm][:N]
    n_val = valid_p.reshape(NB, G * K).sum(dim=-1)
    stats = {"slab_fill": valid[:N].float().mean().detach(),
             "overflow_frac": (n_val > M).float().mean().detach(),
             "budget": M}
    return out[..., 0], out[..., 1:], dt_mult, stats


def render_rays_fast(field, rays_o, rays_d, occ_state, s: RenderSettings,
                     n_coarse: int = 256, n_keep: int = 64,
                     perturb: bool = False, generator=None, bg_color=None,
                     compact_frac: float = 0.0, compact_block: int = 16):
    """Occupancy-grid fast path (the reference's ``-O`` mode).

    ``field`` is a callable (x [..., 3], d [..., 3]) → (sigma, radiance).
    Returns the reference's output dict: ``image``, ``depth``,
    ``weights_sum``, ``weights``, ``mask``, ``render_mask``, ``sigma``,
    ``rgbs``, ``edit_mask``, nested ``fg``/``bg``, and ``stats`` (slab fill
    and overflow share when compaction is on)."""
    dev = rays_o.device
    aabb = scene_aabb(s.bound, dev)
    nears, fars = near_far_from_aabb(rays_o, rays_d, aabb, s.min_near)
    miss = nears >= fars
    nears_ = torch.where(miss, torch.zeros_like(nears), nears)
    fars_ = torch.where(miss, torch.ones_like(fars), fars)

    z, valid, dt_scale = march_rays_occupancy(
        occ_state, rays_o, rays_d, nears_, fars_, s.bound, n_coarse=n_coarse,
        n_keep=n_keep, perturb=perturb, generator=generator)
    valid = valid & ~miss[:, None]
    # invalid tail slots hold depths of unoccupied candidates that can be
    # SMALLER than the last valid one → negative deltas → NaN: pin to far
    z = torch.where(valid, z, fars_[:, None].expand_as(z))

    stats = {}
    if compact_frac and compact_frac > 0.0:
        sigmas, radiance, dt_mult, stats = _eval_field_compacted(
            field, rays_o, rays_d, z, valid, compact_frac, compact_block, aabb)
        dt_scale = dt_scale * dt_mult[:, None]
    else:
        xyz = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
        xyz = torch.minimum(torch.maximum(xyz, aabb[:3]), aabb[3:])
        sigmas, radiance = field(xyz, rays_d[:, None, :].expand_as(xyz))
    sigmas = sigmas * valid.to(sigmas.dtype)
    rgbs = radiance[..., :3]
    masks = radiance[..., 3:] if radiance.shape[-1] > 3 else None

    sample_dist = ((fars_ - nears_) / n_coarse)[:, None] * dt_scale
    nears2, fars2 = nears[:, None], fars[:, None]
    results = _composite(sigmas, rgbs, masks, z, sample_dist, nears2, fars2, s,
                         detach_nonedit=s.detach_bg, bg_color=bg_color,
                         const_dt=True)
    _add_fg_bg(results, sigmas, rgbs, masks, z, sample_dist, nears2, fars2, s,
               const_dt=True)
    results["stats"] = stats
    return results
