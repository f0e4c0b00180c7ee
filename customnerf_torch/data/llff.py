"""LLFF provider (poses_bounds.npy), with NDC rays for forward-facing scenes
— the port's copy of ``customnerf_tpu/data/llff.py``, reading PNGs through
``utils/png.py`` and resizing bilinearly with ``utils/resample.py``.

Re-derivation of reference ``nerf/llff.py``:
  * poses_bounds rows = [3×5 pose | near far]; axes permuted
    "down right back" → "right up back"; poses centered on the average pose;
    translations scaled so the nearest depth lands at 1/0.75 ≈ 1.33
    (llff.py:285-326).
  * camera rays: pinhole with ``(i−W/2)/f, −(j−H/2)/f, −1`` (llff.py:19-33),
    converted to NDC unless ``--is360Scene`` (llff.py:36-77, 370-371).
  * masks via the ``images→{keyword}`` directory swap with jpg→png
    (llff.py:285-292); missing masks → zeros.
  * test split: slerp chain when ``--inter_pose`` else a 2-turn spiral path
    (llff.py:150-223, 333-359).
  * split lengths: train 100 random draws, val 6, test = path length
    (llff.py:402-408).
"""

from __future__ import annotations

import glob
import os

import numpy as np

from customnerf_torch.data.base import Provider
from customnerf_torch.data.camera import inter_pose_num
from customnerf_torch.utils import png, resample


def _normalize(v):
    return v / np.linalg.norm(v)


def average_pose(poses):
    center = poses[..., 3].mean(0)
    z = _normalize(poses[..., 2].mean(0))
    y_ = poses[..., 1].mean(0)
    x = _normalize(np.cross(y_, z))
    y = np.cross(z, x)
    return np.stack([x, y, z, center], 1)


def center_poses(poses):
    avg = average_pose(poses)
    avg_h = np.eye(4)
    avg_h[:3] = avg
    last = np.tile(np.array([0, 0, 0, 1.0]), (len(poses), 1, 1))
    poses_h = np.concatenate([poses, last], 1)
    centered = (np.linalg.inv(avg_h) @ poses_h)[:, :3]
    return centered, np.linalg.inv(avg_h)


def get_ray_directions(H, W, focal):
    j, i = np.meshgrid(np.arange(H, dtype=np.float32),
                       np.arange(W, dtype=np.float32), indexing="ij")
    return np.stack([(i - W / 2) / focal, -(j - H / 2) / focal,
                     -np.ones_like(i)], -1)  # [H, W, 3]


def get_rays(directions, c2w):
    rays_d = directions @ c2w[:, :3].T
    rays_d = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    rays_o = np.broadcast_to(c2w[:, 3], rays_d.shape)
    return rays_o.reshape(-1, 3).copy(), rays_d.reshape(-1, 3)


def get_ndc_rays(H, W, focal, near, rays_o, rays_d):
    """World → NDC transform for forward-facing scenes (llff.py:36-77)."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    ox_oz = rays_o[..., 0] / rays_o[..., 2]
    oy_oz = rays_o[..., 1] / rays_o[..., 2]
    o0 = -1.0 / (W / (2.0 * focal)) * ox_oz
    o1 = -1.0 / (H / (2.0 * focal)) * oy_oz
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]
    d0 = -1.0 / (W / (2.0 * focal)) * (rays_d[..., 0] / rays_d[..., 2] - ox_oz)
    d1 = -1.0 / (H / (2.0 * focal)) * (rays_d[..., 1] / rays_d[..., 2] - oy_oz)
    d2 = 1.0 - o2
    return (np.stack([o0, o1, o2], -1).astype(np.float32),
            np.stack([d0, d1, d2], -1).astype(np.float32))


def create_spiral_poses(radii, focus_depth, n_poses=120):
    out = []
    for t in np.linspace(0, 4 * np.pi, n_poses + 1)[:-1]:
        center = np.array([np.cos(t), -np.sin(t), -np.sin(0.5 * t)]) * radii
        z = _normalize(center - np.array([0, 0, -focus_depth]))
        y_ = np.array([0, 1, 0])
        x = _normalize(np.cross(y_, z))
        y = np.cross(z, x)
        out.append(np.stack([x, y, z, center], 1))
    return np.stack(out, 0)


def create_spheric_poses(radius, n_poses=120):
    def spheric_pose(theta, phi, radius):
        trans_t = np.array([[1, 0, 0, 0], [0, 1, 0, -0.9 * radius],
                            [0, 0, 1, radius], [0, 0, 0, 1.0]])
        rot_phi = np.array([[1, 0, 0, 0], [0, np.cos(phi), -np.sin(phi), 0],
                            [0, np.sin(phi), np.cos(phi), 0], [0, 0, 0, 1]])
        rot_theta = np.array([[np.cos(theta), 0, -np.sin(theta), 0], [0, 1, 0, 0],
                              [np.sin(theta), 0, np.cos(theta), 0], [0, 0, 0, 1]])
        c2w = rot_theta @ rot_phi @ trans_t
        c2w = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1.0]]) @ c2w
        return c2w[:3]

    return np.stack(
        [spheric_pose(th, -np.pi / 5, radius)
         for th in np.linspace(0, 2 * np.pi, n_poses + 1)[:-1]], 0)


class LLFFProvider(Provider):
    def __init__(self, data_dir: str, split: str = "train", resolution_level=1,
                 opt=None, R_path=None, device=None):
        super().__init__(split, train_size=getattr(opt, "train_size", 100),
                         seed=getattr(opt, "seed", 0))
        self.data_dir = data_dir
        self.opt = opt

        first = sorted(glob.glob(os.path.join(data_dir, "images", "*")))[0]
        h, w = png.dims(first)
        self.img_wh = (int(w // resolution_level), int(h // resolution_level))
        self._read_meta()
        self.finalize(device)

    def _read_meta(self):
        opt = self.opt
        poses_bounds = np.load(os.path.join(self.data_dir, "poses_bounds.npy"))
        self.image_paths = sorted(
            glob.glob(os.path.join(self.data_dir, "images/*[0-9].[Jjp]*")))
        keyword = getattr(opt, "keyword", None)
        if keyword is not None:
            mask_paths = [p.replace("JPG", "png").replace("jpg", "png")
                          for p in self.image_paths]
        else:
            keyword = "masks"
            mask_paths = [p.replace("JPG", "png").replace(".png", "_mask.png")
                          for p in self.image_paths]
        self.mask_paths = [p.replace("images", keyword) for p in mask_paths]

        poses = poses_bounds[:, :15].reshape(-1, 3, 5)
        self.bounds = poses_bounds[:, -2:]

        H0, W0, focal = poses[0, :, -1]
        self.focal = focal * self.img_wh[0] / W0

        poses = np.concatenate(
            [poses[..., 1:2], -poses[..., :1], poses[..., 2:4]], -1)
        self.poses, self.pose_avg = center_poses(poses)

        near_original = self.bounds.min()
        scale_factor = near_original * 0.75
        self.bounds = self.bounds / scale_factor
        self.poses[..., 3] /= scale_factor

        W, H = self.img_wh
        directions = get_ray_directions(H, W, self.focal)

        poses_use = self.poses
        if self.split == "test":
            if getattr(opt, "inter_pose", False):
                idxs = np.linspace(0, len(self.poses) - 1, 4).astype(int)
                keyp = self.poses[idxs]
                chain = []
                for i in range(3):
                    a = np.eye(4); a[:3, :4] = keyp[i]
                    b = np.eye(4); b[:3, :4] = keyp[i + 1]
                    seg = inter_pose_num(a, b, 25)[:, :3, :4]
                    chain.extend(seg if i == 0 else seg[1:])
                poses_use = np.stack(chain[::-1])
            else:
                radii = np.percentile(np.abs(self.poses[..., 3]), 90, axis=0)
                poses_use = create_spiral_poses(radii, focus_depth=3.5)

        origins, dirs = [], []
        for c2w in poses_use:
            o, d = get_rays(directions, np.asarray(c2w, np.float32))
            if not getattr(opt, "is360Scene", False):
                o, d = get_ndc_rays(H, W, self.focal, 1.0, o, d)
            origins.append(o.reshape(H, W, 3))
            dirs.append(d.reshape(H, W, 3))
        self.origins, self.directions = origins, dirs

        n_imgs = 1 if self.split == "test" else len(self.image_paths)
        images = [resample.load(p, H, W, interp="linear")
                  for p in self.image_paths[:n_imgs]]
        masks = [resample.load(p, H, W, gray=True, interp="linear")
                 if os.path.isfile(p) else np.zeros((H, W), np.float32)
                 for p in self.mask_paths[:n_imgs]]
        self.images, self.masks = images, masks
        self.images_lis = self.image_paths[:n_imgs]
        self.H = [H] * len(self.origins)
        self.W = [W] * len(self.origins)

    def __len__(self):
        if self.split == "test":
            return len(self.origins)
        if self.split == "train":
            return self.train_size
        return min(6, self.n_images)
