"""sRGB conversion (reference provider_utils.py:337-344) and the density
grid's PLY export (reference renderer.py:128-196): the counterparts of
``customnerf_tpu/utils/image.py``.

:func:`srgb_to_linear` and :func:`linear_to_srgb` take and return torch
tensors (numpy arrays are taken as tensors).  :func:`export_density_to_ply`
writes the same ASCII PLY as the JAX package's: a marching-cubes surface
where scikit-image is installed, else the occupied voxels' centres as a
point cloud.
"""

from __future__ import annotations

import numpy as np
import torch


def srgb_to_linear(x):
    x = torch.as_tensor(x)
    return torch.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(x):
    x = torch.as_tensor(x)
    return torch.where(x <= 0.0031308, 12.92 * x,
                       1.055 * torch.pow(torch.clamp(x, min=1e-8), 1 / 2.4) - 0.055)


def export_density_to_ply(sigma_grid: np.ndarray, origin, volume_size,
                          path: str, level: float = 5.0):
    """Marching-cubes the density grid at ``level`` (vertices scaled by
    ``volume_size`` and moved by ``origin``) and write an ASCII PLY at
    ``path``; without scikit-image, the centres of the voxels above
    ``level``.  Returns ``path``."""
    try:
        from skimage.measure import marching_cubes
    except ImportError:
        marching_cubes = None
    if marching_cubes is not None:
        verts, faces, _, _ = marching_cubes(sigma_grid, level=level,
                                            spacing=volume_size)
        verts = verts + np.asarray(origin)[None, :]
        with open(path, "w") as f:
            f.write("ply\nformat ascii 1.0\n")
            f.write(f"element vertex {len(verts)}\n")
            f.write("property float x\nproperty float y\nproperty float z\n")
            f.write(f"element face {len(faces)}\n")
            f.write("property list uchar int vertex_indices\nend_header\n")
            for v in verts:
                f.write(f"{v[0]} {v[1]} {v[2]}\n")
            for face in faces:
                f.write(f"3 {face[0]} {face[1]} {face[2]}\n")
        return path
    idx = np.argwhere(sigma_grid > level)
    pts = idx * np.asarray(volume_size)[None, :] + np.asarray(origin)[None, :]
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(pts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("end_header\n")
        for v in pts:
            f.write(f"{v[0]} {v[1]} {v[2]}\n")
    return path
