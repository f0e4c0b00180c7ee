"""Nerfstudio-format provider (``transforms.json``) — the port's copy of
``customnerf_tpu/data/nerfstudio.py``, reading PNGs through
``utils/png.py`` and resizing with ``utils/resample.py``.

Re-derivation of reference ``nerf/provider.py:183-470``:
  * frames sorted by ``file_path``; masks at ``images→{keyword}`` with
    ``.jpg/.JPG→.png`` (provider.py:216-223).
  * auto-orient "up" + center + scale translations to max-abs 1
    (provider.py:226-234).
  * train split = ``linspace(0, n−1, ceil(0.9·n))`` indices (provider.py:240-248).
  * per-image area resize by 1/resolution_level, pixels / 256; masks resized
    to the *first* image's size and binarised ``>0`` (provider.py:266-291).
  * pinhole rays from full-res intrinsics with +0.5 pixel centers, y flipped,
    z = −1, rotated by c2w (provider.py:402-467); OPENCV_FISHEYE applies
    Newton undistortion + equidistant mapping (provider.py:421-433).
  * test split: 4 keyframes → 25 slerp-interpolated poses per gap, order
    reversed (provider.py:370-387); val: 4 linspace views (provider.py:389-400).
"""

from __future__ import annotations

import json
import math
import os

import numpy as np

from customnerf_torch.data.base import Provider
from customnerf_torch.data.camera import (auto_orient_and_center_poses,
                                          inter_pose_num,
                                          radial_and_tangential_undistort)
from customnerf_torch.utils import png, resample


def focal_lengths_from_meta(meta):
    def fov_to_focal(rad, res):
        return 0.5 * res / np.tan(0.5 * rad)

    fl_x = meta.get("fl_x") or (
        fov_to_focal(np.deg2rad(meta["x_fov"]), meta["w"]) if "x_fov" in meta
        else fov_to_focal(meta["camera_angle_x"], meta["w"]) if "camera_angle_x" in meta
        else 0
    )
    fl_y = meta.get("fl_y") or (
        fov_to_focal(np.deg2rad(meta["y_fov"]), meta["h"]) if "y_fov" in meta
        else fov_to_focal(meta["camera_angle_y"], meta["h"]) if "camera_angle_y" in meta
        else 0
    )
    if not fl_x or not fl_y:
        raise AttributeError("focal length missing from transforms.json")
    return float(fl_x), float(fl_y)


class NerfstudioProvider(Provider):
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

    # -- loading -----------------------------------------------------------
    def _load(self):
        json_file = os.path.join(self.data_dir, "transforms.json")
        if not os.path.exists(json_file):
            json_file = os.path.join(self.data_dir, "transforms_train.json")
        with open(json_file, encoding="UTF-8") as f:
            self.meta = json.load(f)

        frames = sorted(self.meta["frames"], key=lambda x: x["file_path"])
        poses = np.array([f["transform_matrix"] for f in frames], np.float32)
        self.images_lis = [os.path.join(self.data_dir, f["file_path"]) for f in frames]
        keyword = getattr(self.opt, "keyword", None) or "masks"
        self.masks_lis = [
            p.replace("images", keyword).replace(".jpg", ".png").replace(".JPG", ".png")
            for p in self.images_lis
        ]

        poses34, _ = auto_orient_and_center_poses(poses, method="up", center_poses=True)
        scale = 1.0 / float(np.max(np.abs(poses34[:, :3, 3])))
        poses34[:, :3, 3] *= scale

        n = len(self.images_lis)
        i_train = np.linspace(0, n - 1, math.ceil(n * 0.9), dtype=int)
        self.images_lis = [self.images_lis[i] for i in i_train]
        self.masks_lis = [self.masks_lis[i] for i in i_train]
        poses34 = poses34[i_train]
        self.n_images = len(self.images_lis)

        self.if_distortion = self.meta.get("camera_model") == "OPENCV_FISHEYE"
        self.camera_to_world = poses34[:, :3]  # [n, 3, 4]

        if self.R_path:
            self.pose_optimizer = np.load(self.R_path).astype(np.float32)
        else:
            self.pose_optimizer = np.tile(np.eye(4, dtype=np.float32),
                                          (self.n_images, 1, 1))

        H, W = [], []
        for p in self.images_lis:
            h0, w0 = png.dims(p)
            H.append(int(h0 / self.resolution_level))
            W.append(int(w0 / self.resolution_level))
        images = resample.load_many(zip(self.images_lis, H, W), scale=1.0 / 256.0)

        present = [os.path.isfile(p) for p in self.masks_lis]
        loaded = iter(resample.load_many(
            [(p, H[0], W[0]) for p, ok in zip(self.masks_lis, present) if ok],
            gray=True, scale=1.0 / 256.0))
        masks = []
        for p, ok in zip(self.masks_lis, present):
            if not ok:
                print(f"[warning] missing mask {p}")
                mask = np.zeros((H[0], W[0]), np.float32)
            else:
                mask = next(loaded)
            mask[mask > 0] = 1.0
            masks.append(mask)
        self.images, self.masks, self.H, self.W = images, masks, H, W

    # -- rays ---------------------------------------------------------------
    def _generate_rays(self):
        meta = self.meta
        cx, cy = float(meta["cx"]), float(meta["cy"])
        fx, fy = focal_lengths_from_meta(meta)
        dist = np.array(
            [float(meta.get(k, 0.0)) for k in ("k1", "k2", "k3", "k4", "p1", "p2")],
            np.float32,
        )

        W, H = self.W[0], self.H[0]

        if self.split == "test" and not getattr(self.opt, "dont_inter_test", False):
            keyframes = 4
            idxs = np.linspace(0, len(self.camera_to_world) - 1, keyframes).astype(int)
            key_poses = self.camera_to_world[idxs]
            chain = []
            for i in range(keyframes - 1):
                a = np.eye(4, dtype=np.float32)
                a[:3, :4] = key_poses[i]
                b = np.eye(4, dtype=np.float32)
                b[:3, :4] = key_poses[i + 1]
                seg = inter_pose_num(a, b, 25,
                                     scale=np.asarray(self.opt.dis_scale))[:, :3, :4]
                chain.extend(seg if i == 0 else seg[1:])
            self.camera_to_world = np.stack(chain[::-1])
            self.n_images = len(self.camera_to_world)
        elif self.split == "val" and not getattr(self.opt, "val_all_images", False):
            idxs = np.linspace(0, len(self.camera_to_world) - 1, 4).astype(int)
            self.camera_to_world = self.camera_to_world[idxs]
            self.images = [self.images[i] for i in idxs]
            self.masks = [self.masks[i] for i in idxs]
            self.images_lis = [self.images_lis[i] for i in idxs]
            self.H = [self.H[i] for i in idxs]
            self.W = [self.W[i] for i in idxs]
            self.n_images = 4

        lvl = self.resolution_level
        tx = np.linspace(0, W * lvl - 1, W, dtype=np.float32)
        ty = np.linspace(0, H * lvl - 1, H, dtype=np.float32)
        x, y = np.meshgrid(tx, ty, indexing="ij")  # [W, H]
        x = x.reshape(-1) + 0.5
        y = y.reshape(-1) + 0.5

        coord = np.stack([(x - cx) / fx, -(y - cy) / fy], -1)  # [WH, 2]
        if self.if_distortion:
            coord = radial_and_tangential_undistort(
                coord, np.tile(dist, (coord.shape[0], 1))
            )
            theta = np.clip(np.sqrt(np.sum(coord ** 2, -1)), 1e-9, math.pi)
            sin_t = np.sin(theta)
            dirs_cam = np.stack(
                [coord[:, 0] * sin_t / theta, coord[:, 1] * sin_t / theta,
                 -np.cos(theta)], -1)
        else:
            dirs_cam = np.concatenate(
                [coord, -np.ones_like(coord[:, :1])], -1)  # [WH, 3]

        origins_list, directions_list = [], []
        for i in range(self.n_images):
            c2w = np.asarray(self.camera_to_world[i], np.float32)  # [3,4]
            if self.R_path:
                R1, t1 = c2w[:3, :3], c2w[:3, 3:]
                opt_mat = self.pose_optimizer[i]
                R2, t2 = opt_mat[:3, :3], opt_mat[:3, 3:]
                c2w = np.concatenate([R1 @ R2, t1 + R1 @ t2], axis=-1)
            rot = c2w[:3, :3]
            dirs = dirs_cam @ rot.T  # rotate into world
            dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
            origins = np.tile(c2w[:3, 3], (dirs.shape[0], 1))
            # reshape [W,H,3] → transpose to [H,W,3] (reference provider.py:460-464)
            origins = origins.reshape(W, H, 3).transpose(1, 0, 2)
            dirs = dirs.reshape(W, H, 3).transpose(1, 0, 2)
            origins_list.append(origins.astype(np.float32))
            directions_list.append(dirs.astype(np.float32))

        self.origins = origins_list
        self.directions = directions_list
        if self.split == "test":
            # test uses placeholder image 0 (provider.py:179)
            self.images = self.images[:1]
            self.masks = self.masks[:1]
