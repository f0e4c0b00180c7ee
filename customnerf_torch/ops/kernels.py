"""Build and load the port's hand-written CUDA kernels.

Every ``customnerf_torch/csrc/*.cu`` source has a plain C interface.  At
first use the sources are compiled for Hopper (``sm_90a``), one ``nvcc``
process per source, all started together, then linked into ONE shared
library under ``build/`` at the repository root and loaded with ``ctypes``.
The library's name carries a hash of the sources, so an edit rebuilds and an
unchanged tree reuses the earlier build.

Nothing here runs at import time: the CPU tests import every module, and
this module only touches ``nvcc`` when a kernel is actually launched on a
CUDA tensor (or :func:`build` is called).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
build_seconds = None   # wall time of the build that loaded the library
ptxas_log = ""         # register / shared-memory report of that build

_vp, _i32, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64

# C signatures of the exported launchers (each returns a cudaError_t).
_SIGNATURES = {
    "cn_fused_mlp_forward": [
        _vp, _vp,                                  # x_en, view_en
        _vp, _vp, _vp, _vp, _vp, _vp, _vp,         # w1 w2 w3 wd1 wd2 wr1 wr2
        _vp,                                       # packed weights (scratch)
        _vp, _vp,                                  # sigma_raw, rgb_raw
        _i64, _i32, _i32, _i32,                    # B, in_dim, dir_dim, n_out
        _i32,                                      # with_rgb
        _vp,                                       # stream
    ],
    "cn_fused_mlp_packed_floats": [_i32, _i32, _i32, _i32],  # in, dir, out, rgb
    "cn_plane_dtable": [
        _vp, _vp, _vp, _vp,                        # u0, v0, fu, fv
        _vp, _i64,                                 # g, g row stride
        _vp, _i64,                                 # out, out row stride
        _i64, _i32, _i32,                          # B, R, C
        _vp,                                       # stream
    ],
    "cn_grid_encode_forward": [
        _vp, _vp, _vp, _i64,                       # x, table, out, out row stride
        _i64, _i32, _i32, ctypes.c_float,          # B, n_levels, C, shift
        _vp, _vp,                                  # packed levels (host), stream
    ],
    "cn_grid_encode_backward": [
        _vp, _vp, _vp, _i64,                       # x, table, g, g row stride
        _vp, _vp,                                  # dtable, dx (either may be null)
        _i64, _i32, _i32, ctypes.c_float,          # B, n_levels, C, shift
        _vp, _vp,                                  # packed levels (host), stream
    ],
    "cn_attention_forward": [
        _vp, _vp, _vp, _vp,                        # q, k, v, out
        _i64, _i64, _i64, _i64,                    # q, k batch and row strides
        _i64, _i64, _i64, _i64,                    # v, out batch and row strides
        _i32, _i32, _i32, _i32, _i32,              # batch, heads, n, m, d
        ctypes.c_float, _vp,                       # scale, stream
    ],
    "cn_group_norm_forward": [
        _vp, _vp, _vp,                             # x, gamma, beta
        _vp, _vp, _vp, _vp,                        # y, partials, mean, rstd
        _i32, _i32, _i32, _i32,                    # rows, groups, cpg, hw
        _i32, _i32, ctypes.c_float, _i32,          # chunk, splits, eps, silu
        _vp,                                       # stream
    ],
    "cn_group_norm_backward": [
        _vp, _vp, _vp, _vp,                        # x, dy, gamma, beta
        _vp, _vp, _vp, _vp,                        # mean, rstd, dx, partials
        _i32, _i32, _i32, _i32,                    # rows, groups, cpg, hw
        _i32, _i32, _i32,                          # chunk, splits, silu
        _vp,                                       # stream
    ],
}
# the bf16 modes take the f32 modes' arguments (K1's scratch holds bf16)
_SIGNATURES["cn_fused_mlp_bf16_forward"] = _SIGNATURES["cn_fused_mlp_forward"]
_SIGNATURES["cn_fused_mlp_bf16_packed_elems"] = _SIGNATURES["cn_fused_mlp_packed_floats"]
_SIGNATURES["cn_plane_dtable_bf16"] = _SIGNATURES["cn_plane_dtable"]
# each kernel's launches as it counts them on the card (see device_launches)
COUNTED = ("fused_mlp", "plane_dtable", "grid_encode", "attention", "group_norm")
for _k in COUNTED:
    _SIGNATURES[f"cn_{_k}_launch_counts"] = [_vp]       # out: 2 × uint64
    _SIGNATURES[f"cn_{_k}_reset_launch_counts"] = []
# the tracer's stamps (csrc/spans.cu, engine/spans.py)
_SIGNATURES["cn_span_stamp"] = [ctypes.c_uint32, _vp]   # tag, stream
_SIGNATURES["cn_span_read"] = [_vp]                     # out: the ring
_SIGNATURES["cn_span_reset"] = []
_SIZES = ("cn_span_capacity", "cn_span_ring_bytes")     # return a uint64


def _sources():
    return sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def _digest(paths) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths:
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile (if needed) and return the path of the kernel library."""
    global build_seconds, ptxas_log
    srcs = _sources()
    so_path = os.path.join(BUILD_DIR, f"libcustomnerf_kernels_{_digest(srcs)}.so")
    if os.path.exists(so_path):
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.time()
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        cu = [s for s in srcs if s.endswith(".cu")]
        objs = [os.path.join(tmp, os.path.basename(s) + ".o") for s in cu]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-c", s,
                                   "-o", o],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(cu, objs)]
        logs = [p.communicate()[0] for p in procs]
        for s, p, log in zip(cu, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {s}:\n{log}")
        tmp_so = os.path.join(tmp, "lib.so")
        link = subprocess.run([nvcc, "-shared", *objs, "-o", tmp_so],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking the kernels failed:\n{link.stderr}")
        os.replace(tmp_so, so_path)
    build_seconds = time.time() - t0
    ptxas_log = "\n".join(logs)
    return so_path


def library():
    """The loaded kernel library (built at first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        for name in _SIZES:
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = [], ctypes.c_uint64
        lib.cn_error_string.argtypes = [ctypes.c_int]
        lib.cn_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def device_launches(kernel: str) -> tuple:
    """Launches of ``kernel`` since :func:`reset_device_launches`, as the
    kernel counts them itself on the card: a replayed CUDA graph's launches
    included, which no wrapper sees.  ``"fused_mlp"`` and ``"plane_dtable"``:
    (f32 mode, bf16 mode); ``"grid_encode"``: (forward, backward);
    ``"attention"``: (whole key tiles, a masked last key tile);
    ``"group_norm"``: (forward, backward).  (0, 0)
    before the library is loaded: nothing has launched then."""
    if _lib is None:
        return (0, 0)
    import torch
    torch.cuda.synchronize()
    out = (ctypes.c_uint64 * 2)()
    check(getattr(_lib, f"cn_{kernel}_launch_counts")(out), "device_launches")
    return tuple(out)


def reset_device_launches() -> None:
    """Set every kernel's own launch count on the card to 0."""
    if _lib is None:
        return
    import torch
    torch.cuda.synchronize()
    for kernel in COUNTED:
        check(getattr(_lib, f"cn_{kernel}_reset_launch_counts")(),
              "reset_device_launches")


def check(err: int, what: str) -> None:
    """Raise if a launcher reported a CUDA error (``cudaGetLastError``)."""
    if err != 0:
        msg = library().cn_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
