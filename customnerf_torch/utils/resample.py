"""Image resampling in numpy: the port's copies of ``resize_area`` and
``resize_bilinear`` of the JAX package's native data engine
(``csrc/dataio.cpp:228-312``), which give cv2's ``INTER_AREA`` (downscale)
and ``INTER_LINEAR`` results.  Both filters are separable, so each is one
row-weight matrix and one column-weight matrix, in float64 as there.

:func:`load` is the loaders' decode-and-resize: a PNG through
``utils/png.py``, RGB or the BT.601 luma that ``dataio.cpp:251`` takes for
grayscale reads, resized and scaled to float32.
"""

from __future__ import annotations

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
    """Decode a PNG and resize it to (dh, dw): float32 [dh, dw, 3], or
    [dh, dw] of luma when ``gray``; ``interp`` is "area" or "linear"."""
    rgb = png.read_rgb(path)
    src = luma(rgb) if gray else rgb
    fn = resize_bilinear if interp == "linear" else resize_area
    return fn(src, dh, dw, scale)
