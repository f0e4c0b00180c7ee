"""Orbit camera poses (NumPy, host-side) — the port's copy of
``circle_poses`` and what it needs from ``customnerf_tpu/data/camera.py``
(reference ``nerf/data_utils.py:46-64, 146-178``)."""

from __future__ import annotations

import numpy as np


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
