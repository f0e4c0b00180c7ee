"""Build and load the port's host-side C++ library.

Every ``customnerf_torch/csrc/host/*.cpp`` source is plain C++17 with a C
interface: the JPEG entropy decoder (``jpeg_entropy.cpp``), the zstd frame
decoder and the CRC-32C of OCDBT files (``zstd_decode.cpp``).  At first use
the sources are compiled by the host C++ compiler (``$CXX``, else ``c++``,
else ``g++``), one process per source, all started together, then linked
into ONE shared library under ``build/`` at the repository root and loaded
with ``ctypes``.  The library's name carries a hash of the sources, the
flags and the compiler's version, so an edit (or another machine's
compiler) rebuilds and an unchanged tree reuses the earlier build;
a build writes a temporary file and renames it, so processes that build at
once do not see each other's half-written files.

Nothing here runs at import time.  There is no fallback: without a
compiler, or when the build fails, :func:`library` raises ``RuntimeError``
naming the compiler and the source.  A ``ctypes`` call releases the GIL,
so threads decode in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_SRC_DIR = os.path.join(_PKG_DIR, "csrc", "host")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build")
CXX_FLAGS = ["-std=c++17", "-O3", "-fPIC", "-fno-strict-aliasing"]

_lib = None
_lock = threading.Lock()

_vp, _i32, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_i64p = ctypes.POINTER(ctypes.c_int64)

# C signatures of the exported functions (each returns an int status unless
# its restype is given beside it)
_SIGNATURES = {
    # see jpeg_entropy.cpp
    "cn_jpeg_decode_scan": ([
        _vp, _vp, _i32,                  # data, part offsets [n_parts + 1], n_parts
        _i32, _vp,                       # scan slots, coefficient arrays [slots]
        _vp, _vp, _vp,                   # bw_pad, h, v of each slot
        _i32, _i32,                      # one-component scan: its block grid bw, bh
        _i32, _i32,                      # frame MCU grid mx, my
        _vp, _vp,                        # DC and AC lookup tables [slots]
        _i32,                            # restart interval (0: none)
        _i32, _i32, _i32, _i32, _i32,    # progressive, Ss, Se, Ah, Al
    ], _i32),
    # see zstd_decode.cpp
    "cn_zstd_content_size": ([_vp, _i64], _i64),
    "cn_zstd_decompress": ([_vp, _i64, _vp, _i64, _i64p, _vp, _i32], _i32),
    "cn_crc32c": ([_vp, _i64, ctypes.c_uint32], ctypes.c_uint32),
}


def sources():
    return sorted(os.path.join(HOST_SRC_DIR, f) for f in os.listdir(HOST_SRC_DIR)
                  if f.endswith((".cpp", ".h")))


def compiler() -> str:
    """``$CXX``, else ``c++``, else ``g++`` on the PATH."""
    env = os.environ.get("CXX")
    if env:
        found = shutil.which(env)
        if not found:
            raise RuntimeError(f"host C++ compiler $CXX={env!r} not found: the "
                               f"port's host library ({HOST_SRC_DIR}) is built "
                               f"with it at first use")
        return found
    for name in ("c++", "g++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError(f"no host C++ compiler (c++ or g++, or $CXX) found: the "
                       f"port's host library ({HOST_SRC_DIR}) is built with it at "
                       f"first use")


def _digest(cxx: str, paths) -> str:
    """A hash of the sources, the flags and the compiler's version (a tree
    copied to another machine rebuilds there)."""
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True).stdout.splitlines()[:1]
    h = hashlib.sha256(" ".join([cxx, *version, platform.machine()] + CXX_FLAGS).encode())
    for p in paths:
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile (if needed) and return the path of the host library."""
    srcs = sources()
    cxx = compiler()
    so_path = os.path.join(BUILD_DIR, f"libcustomnerf_host_{_digest(cxx, srcs)}.so")
    if os.path.exists(so_path):
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        cpp = [s for s in srcs if s.endswith(".cpp")]
        objs = [os.path.join(tmp, os.path.basename(s) + ".o") for s in cpp]
        procs = [subprocess.Popen([cxx, *CXX_FLAGS, "-I", HOST_SRC_DIR, "-c", s,
                                   "-o", o], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(cpp, objs)]
        logs = [p.communicate()[0] for p in procs]
        for s, p, log in zip(cpp, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"{cxx} failed on {s}:\n{log}")
        tmp_so = os.path.join(tmp, "lib.so")
        link = subprocess.run([cxx, "-shared", *objs, "-o", tmp_so],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"{cxx} failed linking {HOST_SRC_DIR}:\n{link.stderr}")
        os.replace(tmp_so, so_path)
    return so_path


def library():
    """The loaded host library (built at first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
    return _lib


def ptr(a) -> int:
    """The data address of a contiguous numpy array (for ``ctypes``)."""
    return a.ctypes.data
