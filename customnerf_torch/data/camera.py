"""Camera and pose utilities (NumPy, host-side, run once at load time) —
the port's copy of ``customnerf_tpu/data/camera.py``:

  * ``rotation_matrix`` / ``auto_orient_and_center_poses`` — nerfstudio-style
    orientation (reference ``nerf/provider_utils.py:33-115``).
  * ``inter_pose`` / ``inter_pose_num`` — slerp pose interpolation in
    world-to-camera space (reference ``nerf/provider.py:31-60``).
  * ``radial_and_tangential_undistort`` — Newton-iteration fisheye
    undistortion (reference ``nerf/provider_utils.py:129-234``).
  * ``get_rays`` — the torch-ngp pinhole ray utility
    (``nerf/provider_utils.py:238-302``).
  * ``get_view_direction`` / ``circle_poses`` — orbit poses (reference
    ``nerf/data_utils.py:46-64, 146-178``).
"""

from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation, Slerp


def rotation_matrix(a: np.ndarray, b: np.ndarray, rng=None) -> np.ndarray:
    """Rotation taking unit-ish vector a to b (Rodrigues form)."""
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    v = np.cross(a, b)
    c = float(np.dot(a, b))
    if c < -1 + 1e-8:
        rng = rng or np.random.RandomState(0)
        eps = (rng.rand(3) - 0.5) * 0.01
        return rotation_matrix(a + eps, b, rng)
    s = np.linalg.norm(v)
    skew = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + skew + skew @ skew * ((1 - c) / (s ** 2 + 1e-8))


def auto_orient_and_center_poses(poses: np.ndarray, method: str = "up",
                                 center_poses: bool = True):
    """Orient (+center) a [N,4,4] pose stack; returns ([N,3,4], transform)."""
    translation_all = poses[:, :3, 3]
    mean_translation = translation_all.mean(axis=0)
    translation_diff = translation_all - mean_translation
    translation = mean_translation if center_poses else np.zeros(3)

    if method == "pca":
        _, eigvec = np.linalg.eigh(translation_diff.T @ translation_diff)
        eigvec = eigvec[:, ::-1].copy()
        if np.linalg.det(eigvec) < 0:
            eigvec[:, 2] = -eigvec[:, 2]
        transform = np.concatenate([eigvec, eigvec @ -translation[:, None]], axis=-1)
        oriented = transform @ poses
        if oriented.mean(axis=0)[2, 1] < 0:
            oriented[:, 1:3] = -oriented[:, 1:3]
    elif method == "up":
        up = poses[:, :3, 1].mean(axis=0)
        up = up / np.linalg.norm(up)
        rot = rotation_matrix(up, np.array([0.0, 0.0, 1.0]))
        transform = np.concatenate([rot, rot @ -translation[:, None]], axis=-1)
        oriented = transform @ poses
    elif method == "none":
        transform = np.eye(4)[:3]
        transform[:3, 3] = -translation
        oriented = transform @ poses
    else:
        raise ValueError(method)
    return oriented.astype(np.float32), transform.astype(np.float32)


def inter_pose(pose_0: np.ndarray, pose_1: np.ndarray, ratio: float, scale=1.0):
    """Slerp between two c2w poses, interpolating in w2c space."""
    w2c_0 = np.linalg.inv(pose_0)
    w2c_1 = np.linalg.inv(pose_1)
    rots = Rotation.from_matrix(np.stack([w2c_0[:3, :3], w2c_1[:3, :3]]))
    slerp = Slerp([0, 1], rots)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = slerp(ratio).as_matrix()
    pose[:3, 3] = np.asarray(scale) * ((1.0 - ratio) * w2c_0 + ratio * w2c_1)[:3, 3]
    return np.linalg.inv(pose).astype(np.float32)


def inter_pose_num(pose_0, pose_1, num: int = 120, scale=1.0):
    return np.stack(
        [inter_pose(pose_0, pose_1, r, scale) for r in np.linspace(0, 1, num)], axis=0
    )


def radial_and_tangential_undistort(coords: np.ndarray, distortion_params: np.ndarray,
                                    eps: float = 1e-3, max_iterations: int = 10):
    """Invert the OpenCV radial+tangential distortion model by Newton
    iteration (coords [..., 2], params [..., 6] = k1..k4, p1, p2)."""
    k1, k2, k3, k4 = (distortion_params[..., i] for i in range(4))
    p1, p2 = distortion_params[..., 4], distortion_params[..., 5]
    x = coords[..., 0].copy()
    y = coords[..., 1].copy()

    for _ in range(max_iterations):
        r2 = x * x + y * y
        d = 1.0 + r2 * (k1 + r2 * (k2 + r2 * (k3 + r2 * k4)))
        fx = d * x + 2 * p1 * x * y + p2 * (r2 + 2 * x * x) - coords[..., 0]
        fy = d * y + 2 * p2 * x * y + p1 * (r2 + 2 * y * y) - coords[..., 1]
        d_r = k1 + r2 * (2 * k2 + r2 * (3 * k3 + r2 * 4 * k4))
        fx_x = d + 2 * x * x * d_r + 2 * p1 * y + 6 * p2 * x
        fx_y = 2 * x * y * d_r + 2 * p1 * x + 2 * p2 * y
        fy_x = fx_y
        fy_y = d + 2 * y * y * d_r + 2 * p2 * x + 6 * p1 * y
        det = fx_x * fy_y - fx_y * fy_x
        det = np.where(np.abs(det) > eps, det, np.ones_like(det))
        dx = (fx * fy_y - fy * fx_y) / det
        dy = (fy * fx_x - fx * fy_x) / det
        x = x - dx
        y = y - dy
    return np.stack([x, y], axis=-1)


def get_rays(poses, intrinsics, H: int, W: int, N: int = -1,
             error_map=None, rng=None, offset=(0.5, 0.5)):
    """Pinhole ray generation with optional per-image ray subsampling and
    error-map importance sampling.

    API-surface parity with the reference's torch-ngp utility
    (``nerf/provider_utils.py:238-302``) — unused by the reference's own
    providers but part of its public surface.  Uses that utility's +z
    camera convention (torch-ngp), NOT the OpenGL -z convention of the
    nerfstudio loader.

    Args:
      poses: [B, 4, 4] cam2world.
      intrinsics: (fx, fy, cx, cy).
      N: >0 → subsample N rays/image: uniform with replacement, or — given
        ``error_map`` [B, 128*128] — multinomial WITHOUT replacement over
        the coarse 128×128 error grid, each picked coarse cell jittered to
        a uniform fine pixel inside its footprint.
      rng: np.random.RandomState (defaults to the global stream, like the
        reference's global torch RNG).

    Returns dict: rays_o/rays_d [B, N, 3] (unit directions), inds [B, N]
    when subsampled, plus inds_coarse [B, N] when error_map was used (the
    caller updates its error statistics at those coarse bins).
    """
    poses = np.asarray(poses, np.float32)
    rng = rng if rng is not None else np.random
    B = poses.shape[0]
    fx, fy, cx, cy = [float(v) for v in intrinsics]
    results = {}

    if N > 0:
        N = min(N, H * W)
        if error_map is None:
            inds = rng.randint(0, H * W, size=N)  # may duplicate
            inds = np.broadcast_to(inds, (B, N)).copy()
        else:
            em = np.asarray(error_map, np.float64).reshape(B, 128 * 128)
            inds_coarse = np.stack([
                rng.choice(128 * 128, size=N, replace=False,
                           p=em[b] / em[b].sum())
                for b in range(B)
            ]).astype(np.int64)
            # map to full resolution with a uniform jitter inside the cell
            ix, iy = inds_coarse // 128, inds_coarse % 128
            sx, sy = H / 128.0, W / 128.0
            ix = np.minimum((ix * sx + rng.rand(B, N) * sx).astype(np.int64),
                            H - 1)
            iy = np.minimum((iy * sy + rng.rand(B, N) * sy).astype(np.int64),
                            W - 1)
            inds = ix * W + iy
            results["inds_coarse"] = inds_coarse
        results["inds"] = inds
    else:
        inds = np.broadcast_to(np.arange(H * W, dtype=np.int64), (B, H * W))

    x = (inds % W).astype(np.float32) + offset[0]
    y = (inds // W).astype(np.float32) + offset[1]
    dirs = np.stack([(x - cx) / fx, (y - cy) / fy, np.ones_like(x)], axis=-1)
    dirs = _safe_normalize(dirs)
    rays_d = np.einsum("bnk,bjk->bnj", dirs, poses[:, :3, :3])
    rays_o = np.broadcast_to(poses[:, None, :3, 3], rays_d.shape)
    results["rays_o"] = np.ascontiguousarray(rays_o, np.float32)
    results["rays_d"] = rays_d.astype(np.float32)
    return results


def _safe_normalize(v, axis=-1):
    return v / np.maximum(np.linalg.norm(v, axis=axis, keepdims=True), 1e-10)


def get_view_direction(thetas, phis, overhead: float, front: float):
    """Bin view angles: 0 front / 1,3 side / 2 back / 4 top / 5 bottom."""
    res = np.zeros(thetas.shape[0], dtype=np.int64)
    res[(phis < front) & (phis > (2 * np.pi - front))] = 0
    res[(phis >= front) & (phis < (np.pi - front))] = 1
    res[(phis >= (np.pi - front)) & (phis < (np.pi + front))] = 2
    res[(phis >= (np.pi + front)) & (phis <= (2 * np.pi - front))] = 3
    res[thetas <= overhead] = 4
    res[thetas >= (np.pi - overhead)] = 5
    return res


def circle_poses(size: int = 8, radius: float = 1.25, theta: float = 60.0,
                 angle_overhead: float = 30, angle_front: float = 60):
    """Evenly spaced orbit at fixed elevation → ([size, 4, 4], view dirs)."""
    theta = np.deg2rad(theta)
    angle_overhead = np.deg2rad(angle_overhead)
    angle_front = np.deg2rad(angle_front)
    phis = np.linspace(0, 2 * np.pi, size, endpoint=False)
    thetas = np.full(size, theta)
    centers = np.stack(
        [
            radius * np.sin(thetas) * np.sin(phis),
            radius * np.cos(thetas),
            radius * np.sin(thetas) * np.cos(phis),
        ],
        axis=-1,
    )
    forward = _safe_normalize(centers)
    up = np.tile(np.array([0.0, 1.0, 0.0]), (size, 1))
    right = _safe_normalize(np.cross(forward, up))
    up = _safe_normalize(np.cross(right, forward))
    poses = np.tile(np.eye(4, dtype=np.float32), (size, 1, 1))
    poses[:, :3, :3] = np.stack([right, up, forward], axis=-1)
    poses[:, :3, 3] = centers
    dirs = get_view_direction(thetas, phis, angle_overhead, angle_front)
    return poses.astype(np.float32), dirs
