"""Image resampling in numpy: the port's copies of ``resize_area`` and
``resize_bilinear`` of the JAX package's native data engine
(``csrc/dataio.cpp:228-312``), which give cv2's ``INTER_AREA`` (downscale)
and ``INTER_LINEAR`` results.  Both filters are separable, so each is one
row-weight matrix and one column-weight matrix, in float64 as there.

:func:`load` is the loaders' decode-and-resize: a PNG through
``utils/png.py`` or a JPEG through ``utils/jpeg.py``, RGB or the BT.601
luma that ``dataio.cpp:251`` takes for grayscale reads, resized and scaled
to float32; :func:`load_many` decodes a scene's images on a thread pool, as
the JAX package's ``decode_resize_batch`` threads its decodes.

:func:`resize_cv_area` is ``cv2.resize(…, INTER_AREA)`` itself, for the
Custom Diffusion images (``guidance/custom_diffusion.py``), whose JAX
counterpart calls cv2: coverage weights that drop slivers under 1e-3 when
it shrinks, cv2's linear-like taps in 11-bit fixed point when it enlarges,
uint8 results rounded.
"""

from __future__ import annotations

import concurrent.futures
import os

import numpy as np

from customnerf_torch.utils import png


def _area_weights(src: int, dst: int) -> np.ndarray:
    """[dst, src]: the share of source cell j inside destination cell i,
    whose span is [i·s, (i+1)·s) with s = src / dst."""
    s = src / dst
    lo = np.arange(dst, dtype=np.float64)[:, None] * s
    hi = (np.arange(dst, dtype=np.float64)[:, None] + 1) * s
    j = np.arange(src, dtype=np.float64)[None, :]
    return np.clip(np.minimum(j + 1, hi) - np.maximum(j, lo), 0.0, None)


def _linear_weights(src: int, dst: int) -> np.ndarray:
    """[dst, src]: bilinear taps at (i + 0.5)·s − 0.5, clamped to the edge."""
    s = src / dst
    f = np.maximum((np.arange(dst) + 0.5) * s - 0.5, 0.0)
    i0 = np.minimum(f.astype(np.int64), src - 1)
    i1 = np.minimum(i0 + 1, src - 1)
    w1 = f - i0
    out = np.zeros((dst, src))
    rows = np.arange(dst)
    np.add.at(out, (rows, i0), 1.0 - w1)
    np.add.at(out, (rows, i1), w1)
    return out


def _apply(img, wy, wx, scale, norm=None):
    a = np.asarray(img, np.float64)
    h, w = a.shape[:2]
    rows = (wy @ a.reshape(h, -1)).reshape(wy.shape[0], w, -1)   # [dh, w, c]
    out = np.einsum("lk,ikc->ilc", wx, rows)
    if norm is not None:
        out = out / norm[..., None]
    out = (out * scale).astype(np.float32)
    return out.reshape(wy.shape[0], wx.shape[0], *a.shape[2:])


def resize_area(img, dh: int, dw: int, scale: float = 1.0) -> np.ndarray:
    """[H, W(, C)] → float32 [dh, dw(, C)]: each output pixel the
    coverage-weighted mean of the source pixels under it, times ``scale``."""
    wy = _area_weights(img.shape[0], dh)
    wx = _area_weights(img.shape[1], dw)
    return _apply(img, wy, wx, scale, norm=np.outer(wy.sum(1), wx.sum(1)))


def resize_bilinear(img, dh: int, dw: int, scale: float = 1.0) -> np.ndarray:
    """[H, W(, C)] → float32 [dh, dw(, C)], bilinear at pixel centres."""
    wy = _linear_weights(img.shape[0], dh)
    wx = _linear_weights(img.shape[1], dw)
    return _apply(img, wy, wx, scale)


def luma(rgb) -> np.ndarray:
    """BT.601 luma of uint8 RGB, in float64."""
    p = np.asarray(rgb, np.float64)
    return 0.299 * p[..., 0] + 0.587 * p[..., 1] + 0.114 * p[..., 2]


def load(path: str, dh: int, dw: int, gray: bool = False,
         scale: float = 1.0 / 255.0, interp: str = "area") -> np.ndarray:
    """Decode a PNG or JPEG and resize it to (dh, dw): float32 [dh, dw, 3], or
    [dh, dw] of luma when ``gray``; ``interp`` is "area" or "linear"."""
    rgb = png.read_rgb(path)
    src = luma(rgb) if gray else rgb
    fn = resize_bilinear if interp == "linear" else resize_area
    return fn(src, dh, dw, scale)


def load_many(jobs, **kw) -> list:
    """:func:`load` of every ``(path, dh, dw)`` in ``jobs`` on a pool of
    ``os.cpu_count()`` threads (the JPEG entropy stage and zlib release the
    GIL): the images in ``jobs``' order, equal to loading them one by one.
    ``kw`` goes to every :func:`load`."""
    jobs = list(jobs)
    if len(jobs) <= 1:
        return [load(*job, **kw) for job in jobs]
    workers = min(len(jobs), os.cpu_count() or 1)
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        return list(pool.map(lambda job: load(*job, **kw), jobs))


def _cv_area_taps(src: int, dst: int) -> np.ndarray:
    """[dst, src]: ``cv2``'s ``computeResizeAreaTab`` (shrinking)."""
    scale = 1.0 / (dst / src)
    w = np.zeros((dst, src))
    for d in range(dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, src - f1)
        s2 = min(int(np.floor(f2)), src - 1)
        s1 = min(int(np.ceil(f1)), s2)
        if s1 - f1 > 1e-3:
            w[d, s1 - 1] = np.float32((s1 - f1) / cell)
        w[d, s1:s2] = np.float32(1.0 / cell)
        if f2 - s2 > 1e-3:
            w[d, s2] = np.float32(min(min(f2 - s2, 1.0), cell) / cell)
    return w


def _cv_enlarge_taps(src: int, dst: int):
    """cv2's INTER_AREA taps when enlarging: source index and weight of
    the second tap, clamped at the far edge."""
    inv = dst / src
    scale = 1.0 / inv
    d = np.arange(dst)
    sx = np.floor(d * scale).astype(np.int64)
    fx = ((d + 1) - (sx + 1) * inv).astype(np.float32)
    fx = np.where(fx <= 0, 0.0, fx - np.floor(fx)).astype(np.float32)
    edge = sx >= src - 1
    fx[edge] = 0.0
    sx[edge] = src - 1
    return sx, fx


def resize_cv_area(img, dh: int, dw: int) -> np.ndarray:
    """``cv2.resize(img, (dw, dh), interpolation=cv2.INTER_AREA)`` for
    uint8 or float32 [H, W(, C)] with both axes shrinking or both
    enlarging."""
    a = np.asarray(img)
    h, w = a.shape[:2]
    if (h, w) == (dh, dw):
        return a.copy()
    u8 = a.dtype == np.uint8
    if h >= dh and w >= dw:
        ky, kx = h / dh, w / dw
        if u8 and ky == int(ky) and kx == int(kx):
            # cv2's integer-scale path: box sums, 2×2 as (Σ + 2) >> 2
            ky, kx = int(ky), int(kx)
            box = a.reshape(dh, ky, dw, kx, -1).astype(np.int64).sum(axis=(1, 3))
            if ky == kx == 2:
                out = (box + 2) >> 2
            else:
                out = np.rint(box.astype(np.float32) * np.float32(1.0 / (ky * kx)))
            return out.astype(np.uint8).reshape(dh, dw, *a.shape[2:])
        wy, wx = _cv_area_taps(h, dh), _cv_area_taps(w, dw)
        rows = (wy @ a.reshape(h, -1).astype(np.float64)).reshape(dh, w, -1)
        out = np.matmul(rows.transpose(0, 2, 1), wx.T).transpose(0, 2, 1)
        out = np.clip(np.rint(out), 0, 255).astype(np.uint8) if u8 else out.astype(a.dtype)
        return out.reshape(dh, dw, *a.shape[2:])
    if h > dh or w > dw:
        raise ValueError("resize_cv_area: one axis shrinks while the other grows")
    sy, fy = _cv_enlarge_taps(h, dh)
    sx, fx = _cv_enlarge_taps(w, dw)
    sy1, sx1 = np.minimum(sy + 1, h - 1), np.minimum(sx + 1, w - 1)
    x = a.reshape(h, w, -1)
    if u8:
        one = 1 << 11
        ax1 = np.rint(fx * one).astype(np.int64)
        ax0 = np.rint((1.0 - fx) * one).astype(np.int64)
        by1 = np.rint(fy * one).astype(np.int64)
        by0 = np.rint((1.0 - fy) * one).astype(np.int64)
        xi = x.astype(np.int64)
        rows = xi[:, sx] * ax0[None, :, None] + xi[:, sx1] * ax1[None, :, None]
        # the vectorised vertical pass: 16-bit high products, then (· + 2) >> 2
        s0 = ((rows[sy] >> 4) * by0[:, None, None]) >> 16
        s1 = ((rows[sy1] >> 4) * by1[:, None, None]) >> 16
        out = np.clip((s0 + s1 + 2) >> 2, 0, 255).astype(np.uint8)
    else:
        xf = x.astype(np.float32)
        rows = xf[:, sx] * (1 - fx)[None, :, None] + xf[:, sx1] * fx[None, :, None]
        out = (rows[sy] * (1 - fy)[:, None, None] + rows[sy1] * fy[:, None, None])
        out = out.astype(a.dtype)
    return out.reshape(dh, dw, *a.shape[2:])
