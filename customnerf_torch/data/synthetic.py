"""Synthetic scene provider — the port's copy of
``customnerf_tpu/data/synthetic.py``: a self-contained dataset for tests and
benchmarking with no files on disk.

Generates an analytically ray-traced scene (a colored sphere = "foreground"
over a shaded ground plane = "background") from orbit cameras, with exact
foreground masks — the same item contract as the real providers, so the whole
trainer/CLI stack can be exercised end-to-end anywhere (SURVEY.md §4's
"tiny-res integration test" requirement; the reference has no equivalent).
"""

from __future__ import annotations

import numpy as np

from customnerf_torch.data.base import Provider
from customnerf_torch.data.camera import circle_poses


def _trace(o, d, sphere_c, sphere_r):
    """Analytic sphere + plane tracing → rgb, mask."""
    err = np.seterr(invalid="ignore")  # inf·0 in miss lanes is masked below
    oc = o - sphere_c
    b = np.sum(oc * d, -1)
    c = np.sum(oc * oc, -1) - sphere_r ** 2
    disc = b * b - c
    t_sph = np.where(disc > 0, -b - np.sqrt(np.maximum(disc, 0)), np.inf)
    t_sph = np.where(t_sph > 0, t_sph, np.inf)

    # ground plane y = -sphere_r
    t_pln = (-sphere_r - o[..., 1]) / np.where(np.abs(d[..., 1]) > 1e-6,
                                               d[..., 1], 1e-6)
    t_pln = np.where(t_pln > 0, t_pln, np.inf)

    hit_sph = t_sph < t_pln
    rgb = np.zeros(o.shape, np.float32)

    # sphere: diffuse red-ish shading by normal·light
    pt = o + t_sph[..., None] * d
    n = (pt - sphere_c) / sphere_r
    light = np.array([0.5, 0.8, -0.3]); light = light / np.linalg.norm(light)
    lam = np.clip(np.sum(n * light, -1), 0.1, 1.0)
    sph_rgb = np.stack([0.9 * lam, 0.25 * lam, 0.2 * lam], -1)

    # plane: checker
    ppt = o + t_pln[..., None] * d
    checker = ((np.floor(ppt[..., 0] * 4) + np.floor(ppt[..., 2] * 4)) % 2)
    pln_rgb = np.stack([0.25 + 0.2 * checker] * 3, -1)

    hit_any = np.minimum(t_sph, t_pln) < np.inf
    rgb = np.where(hit_sph[..., None], sph_rgb, np.where(
        (t_pln < np.inf)[..., None], pln_rgb, rgb))
    rgb = np.where(hit_any[..., None], rgb, 0.1)  # dim sky
    mask = hit_sph.astype(np.float32)
    np.seterr(**err)
    return np.nan_to_num(rgb.astype(np.float32)), mask


class SyntheticProvider(Provider):
    def __init__(self, split: str = "train", opt=None, n_views: int = 12,
                 H: int = 64, W: int = 64, radius: float = 1.6,
                 sphere_r: float = 0.5, device=None):
        super().__init__(split, train_size=getattr(opt, "train_size", 100),
                         seed=getattr(opt, "seed", 0))
        if opt is not None and getattr(opt, "h", 0) and split == "train":
            H, W = min(int(opt.h), 128), min(int(opt.w), 128)
        n = n_views if split == "train" else 4
        poses, _ = circle_poses(size=n, radius=radius, theta=70.0)
        focal = 0.9 * W

        sphere_c = np.array([0.0, 0.0, 0.0])
        js, is_ = np.meshgrid(np.arange(H, dtype=np.float32),
                              np.arange(W, dtype=np.float32), indexing="ij")
        dirs_cam = np.stack([(is_ - W / 2) / focal, -(js - H / 2) / focal,
                             -np.ones_like(is_)], -1)
        dirs_cam /= np.linalg.norm(dirs_cam, axis=-1, keepdims=True)

        for i in range(n):
            c2w = poses[i]
            # poses store columns [right, up, forward] with forward pointing
            # away from the origin; OpenGL-style pixel rays have z = -1, so
            # the center ray maps to -forward → toward the scene.
            rot = c2w[:3, :3]
            d = dirs_cam @ rot.T
            d /= np.linalg.norm(d, axis=-1, keepdims=True)
            o = np.broadcast_to(c2w[:3, 3], d.shape).astype(np.float32).copy()
            rgb, mask = _trace(o, d, sphere_c, sphere_r)
            self.origins.append(o)
            self.directions.append(d.astype(np.float32))
            self.images.append(rgb)
            self.masks.append(mask)
            self.H.append(H)
            self.W.append(W)
            self.images_lis.append(f"synthetic_{split}_{i:03d}")
        self.finalize(device)
