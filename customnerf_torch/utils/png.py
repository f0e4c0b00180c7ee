"""PNG read and write with ``zlib`` and numpy: the port's stand-in for
``cv2.imread`` / ``cv2.imwrite`` on PNG files, so that it depends on
neither ``cv2`` nor PIL.  ``.jpg``/``.jpeg`` paths go to ``utils/jpeg.py``.

Reads non-interlaced 8-bit grayscale, gray+alpha, RGB and RGBA PNGs with
any of the five row filters.  Writes 8-bit grayscale and RGB with filter 0.
Everything else (interlacing, 16-bit or sub-byte samples, palettes) raises
``ValueError`` naming the file.  Arrays are RGB, not cv2's BGR.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from customnerf_torch.utils import jpeg

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type → samples a pixel
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunks(data: bytes, path: str):
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IEND":
            return
    raise ValueError(f"{path}: truncated PNG (no IEND chunk)")


def _paeth_average_row(kind: int, cur: bytearray, prior: bytes, bpp: int):
    """Undo filter 3 (average) or 4 (Paeth) of one row in place: each byte
    depends on the one ``bpp`` before it, so this runs byte by byte."""
    n = len(cur)
    if kind == 3:
        for i in range(n):
            a = cur[i - bpp] if i >= bpp else 0
            cur[i] = (cur[i] + ((a + prior[i]) >> 1)) & 0xFF
        return
    for i in range(n):
        if i >= bpp:
            a, c = cur[i - bpp], prior[i - bpp]
        else:
            a = c = 0
        b = prior[i]
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF


def _unfilter(raw: bytes, h: int, stride: int, bpp: int, path: str) -> np.ndarray:
    if len(raw) < h * (stride + 1):
        raise ValueError(f"{path}: image data is shorter than its header says")
    rows = np.frombuffer(raw, np.uint8, h * (stride + 1)).reshape(h, stride + 1)
    kinds, filt = rows[:, 0], rows[:, 1:]
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, f = int(kinds[y]), filt[y]
        if kind == 0:
            out[y] = f
        elif kind == 1:
            # each pixel adds the one before it: a running sum per byte lane
            lanes = f.reshape(-1, bpp).astype(np.int64)
            out[y] = (np.cumsum(lanes, axis=0) & 0xFF).reshape(-1)
        elif kind == 2:
            out[y] = f + prior
        elif kind in (3, 4):
            cur = bytearray(f.tobytes())
            _paeth_average_row(kind, cur, prior.tobytes(), bpp)
            out[y] = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"{path}: unknown PNG row filter {kind}")
        prior = out[y]
    return out


def read(path: str) -> np.ndarray:
    """A PNG file → uint8 [H, W] (gray) or [H, W, C] (C = 2, 3 or 4: gray
    and alpha, RGB, RGBA); a JPEG file → uint8 [H, W, 3] RGB."""
    if jpeg.is_jpeg_path(path):
        return jpeg.read(path)
    with open(path, "rb") as f:
        data = f.read()
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if interlace:
        raise ValueError(f"{path}: interlaced PNGs are not supported")
    if depth != 8:
        raise ValueError(f"{path}: {depth}-bit PNGs are not supported (8-bit only)")
    if color not in _CHANNELS:
        raise ValueError(f"{path}: PNG colour type {color} (palette) is not supported")
    c = _CHANNELS[color]
    pixels = _unfilter(zlib.decompress(b"".join(idat)), h, w * c, c, path)
    return pixels.reshape(h, w) if c == 1 else pixels.reshape(h, w, c)


def read_rgb(path: str) -> np.ndarray:
    """A PNG → uint8 [H, W, 3]: gray replicated, alpha dropped (what
    ``dataio.cpp``'s decoder hands its resamplers)."""
    img = read(path)
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=-1)
    if img.shape[-1] == 2:
        return np.repeat(img[..., :1], 3, axis=-1)
    return img[..., :3]


def dims(path: str):
    """(H, W) from the PNG header alone (a JPEG's from its frame header)."""
    if jpeg.is_jpeg_path(path):
        return jpeg.dims(path)
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    w, h = struct.unpack(">II", head[16:24])
    return h, w


def _chunk(kind: bytes, body: bytes) -> bytes:
    crc = zlib.crc32(kind + body) & 0xFFFFFFFF
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", crc)


def write(path: str, img: np.ndarray) -> str:
    """uint8 [H, W] (gray) or [H, W, 3] (RGB) → an 8-bit PNG at ``path``."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"{path}: PNG writing needs uint8 pixels, got {img.dtype}")
    if img.ndim == 2:
        color, c = 0, 1
    elif img.ndim == 3 and img.shape[-1] == 3:
        color, c = 2, 3
    else:
        raise ValueError(f"{path}: PNG writing takes [H, W] or [H, W, 3], got {img.shape}")
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(img).reshape(h, w * c)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    body = (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw))
            + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(body)
    return path
