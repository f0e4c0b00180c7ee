"""DTU provider (cameras_sphere.npz / cameras_large.npz) — the port's copy
of ``customnerf_tpu/data/dtu.py``, reading PNGs through ``utils/png.py``.

Re-derivation of reference ``nerf/provider.py:496-640``: projection matrices
``P = world_mat @ scale_mat`` decomposed into K, R, t; rays from the inverse
intrinsics through pixel centers, rotated by the pose.
"""

from __future__ import annotations

import glob
import os

import numpy as np
import scipy.linalg

from customnerf_torch.data.base import Provider
from customnerf_torch.utils import png, resample


def load_K_Rt_from_P(P: np.ndarray):
    """Decompose a 3×4 projection matrix into intrinsics + c2w pose
    (reference provider.py:472-493): P[:, :3] = K·R by RQ, the camera
    centre the null vector of P."""
    P = np.asarray(P, np.float64)
    K, R = scipy.linalg.rq(P[:, :3])
    signs = np.diag(np.sign(np.diag(K)))
    K, R = K @ signs, signs @ R
    if np.linalg.det(R) < 0:
        K[:, 2], R[2] = -K[:, 2], -R[2]
    K = K / K[2, 2]
    intrinsics = np.eye(4)
    intrinsics[:3, :3] = K
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = R.transpose()
    pose[:3, 3] = -np.linalg.solve(P[:, :3], P[:, 3])
    return intrinsics.astype(np.float32), pose


class DTUProvider(Provider):
    def __init__(self, data_dir: str, split: str = "train", resolution_level=1,
                 opt=None, R_path=None, device=None):
        super().__init__(split, train_size=getattr(opt, "train_size", 100),
                         seed=getattr(opt, "seed", 0))
        self.data_dir = data_dir
        self.resolution_level = float(resolution_level)
        self.opt = opt
        self.R_path = R_path
        self._load()
        self._generate_rays()
        self.finalize(device)

    def _load(self):
        if getattr(self.opt, "if_sphere", False):
            cams = np.load(os.path.join(self.data_dir, "cameras_sphere.npz"))
        else:
            cams = np.load(os.path.join(self.data_dir, "cameras_large.npz"))

        self.images_lis = sorted(glob.glob(os.path.join(self.data_dir, "image/*.png")))
        self.masks_lis = sorted(glob.glob(os.path.join(self.data_dir, "mask/*.png")))
        self.n_images = len(self.images_lis)

        intrinsics_all, pose_all = [], []
        for idx in range(self.n_images):
            world_mat = cams[f"world_mat_{idx}"].astype(np.float32)
            scale_mat = cams[f"scale_mat_{idx}"].astype(np.float32)
            P = (world_mat @ scale_mat)[:3, :4]
            K, pose = load_K_Rt_from_P(P)
            intrinsics_all.append(K)
            pose_all.append(pose)
        self.intrinsics_all = np.stack(intrinsics_all)
        self.intrinsics_all_inv = np.linalg.inv(self.intrinsics_all)
        self.pose_all = np.stack(pose_all)
        if self.R_path:
            R = np.load(self.R_path).astype(np.float32)
            self.pose_all = R @ self.pose_all

        H, W = [], []
        for p in self.images_lis:
            h0, w0 = png.dims(p)
            H.append(int(h0 / self.resolution_level))
            W.append(int(w0 / self.resolution_level))
        images = resample.load_many(zip(self.images_lis, H, W), scale=1.0 / 256.0)
        masks = resample.load_many([(p, H[0], W[0]) for p in self.masks_lis],
                                   gray=True, scale=1.0 / 256.0)
        for m in masks:
            m[m > 0] = 1.0
        if not masks:
            masks = [np.zeros((H[0], W[0]), np.float32) for _ in images]
        self.images, self.masks, self.H, self.W = images, masks, H, W

    def _generate_rays(self):
        origins, directions = [], []
        lvl = self.resolution_level
        for i in range(self.n_images):
            H, W = self.H[i], self.W[i]
            tx = np.linspace(0, W * lvl - 1, W, dtype=np.float32)
            ty = np.linspace(0, H * lvl - 1, H, dtype=np.float32)
            px, py = np.meshgrid(tx, ty, indexing="ij")  # [W, H]
            p = np.stack([px, py, np.ones_like(py)], -1)  # [W, H, 3]
            p = (self.intrinsics_all_inv[i, :3, :3] @ p[..., None])[..., 0]
            rays_v = p / np.linalg.norm(p, axis=-1, keepdims=True)
            rays_v = (self.pose_all[i, :3, :3] @ rays_v[..., None])[..., 0]
            rays_v = rays_v / np.linalg.norm(rays_v, axis=-1, keepdims=True)
            rays_o = np.broadcast_to(self.pose_all[i, :3, 3], rays_v.shape)
            origins.append(rays_o.transpose(1, 0, 2).astype(np.float32).copy())
            directions.append(rays_v.transpose(1, 0, 2).astype(np.float32))
        self.origins, self.directions = origins, directions
