"""Zstandard decompression for the port (the ``.orbax`` reader's codec),
through the host library's RFC 8878 frame decoder
(``csrc/host/zstd_decode.cpp``): no ``zstandard`` package.

:func:`decompress` takes one or more frames (skippable frames among them)
and returns their content.  A corrupt or truncated input raises
``ValueError``; the decoder checks every read and write against its
buffer's bounds and verifies a frame's XXH64 content checksum when the
frame carries one.
"""

from __future__ import annotations

import ctypes

import numpy as np

from customnerf_torch.utils import hostlib

_ERRLEN = 256


def _bytes_view(data) -> np.ndarray:
    return np.frombuffer(memoryview(data).cast("B"), np.uint8)


def decompress(data, name: str = "<zstd>") -> np.ndarray:
    """The content of the zstd frames in ``data`` (bytes-like) as a uint8
    array."""
    lib = hostlib.library()
    src = _bytes_view(data)
    n = len(src)
    size = lib.cn_zstd_content_size(hostlib.ptr(src), n)
    if size == -2:
        cap = 0
    else:
        cap = size if size >= 0 else max(4 * n, 1 << 16)
    err = ctypes.create_string_buffer(_ERRLEN)
    written = ctypes.c_int64(0)
    while True:
        out = np.empty(max(cap, 1), np.uint8)
        rc = lib.cn_zstd_decompress(hostlib.ptr(src), n, hostlib.ptr(out), cap,
                                    ctypes.byref(written), err, _ERRLEN)
        if rc == 0:
            return out[:written.value]
        if rc == 1 and size == -1:          # no size given: grow and retry
            cap *= 2
            continue
        raise ValueError(f"{name}: {err.value.decode(errors='replace')}")
