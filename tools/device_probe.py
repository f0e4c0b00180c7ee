"""Ceilings of the two device operations the port's kernels are built on.

    python -m tools.device_probe        # from the repository root

1. ``mma.sync.m16n8k8`` TF32 products (what K1, ``csrc/fused_mlp.cu``,
   issues): every warp of a full grid runs chains of independent products
   on registers, no memory traffic.  Reported as TFLOP/s of single TF32
   products, beside the dense TF32 peak of the data sheet (495 TFLOP/s,
   reached only by ``wgmma``).
2. f32 reductions into global memory (what dT, ``csrc/triplane_dtable.cu``,
   issues): float adds at random rows of an L2-resident table of 16-float
   rows, as scalar ``atomicAdd(float*)``, as ``atomicAdd(float4*)`` and as
   the PTX ``red.global.add.v4.f32``.  Reported as float adds a second.

The probe kernels are compiled by ``nvcc`` for ``sm_90a`` into ``build/``
at run time.  Prints one JSON line.  Needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess

import torch

from customnerf_torch.engine.measure import card_line, device_ms
from customnerf_torch.ops import kernels

_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void mma_loop(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1.0f + threadIdx.x * 1e-3f + i);
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(0.5f + i);
  float d[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  if (s == 12345.f) out[threadIdx.x] = s;  // keeps the loop alive
}

// one thread a (sample, 4-float group); rows[sample] picks a 16-float row
template <int MODE>
__global__ void scatter(const int* __restrict__ rows, float* table, int n) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * 4) return;
  const int s = t >> 2, q = t & 3;
  float* p = table + (int64_t)__ldg(rows + s) * 16 + 4 * q;
  const float4 v = make_float4(1.f, 2.f, 3.f, 4.f);
  if (MODE == 0) {
    atomicAdd(p, v.x); atomicAdd(p + 1, v.y);
    atomicAdd(p + 2, v.z); atomicAdd(p + 3, v.w);
  } else if (MODE == 1) {
    atomicAdd(reinterpret_cast<float4*>(p), v);
  } else {
#ifdef WITH_RED_V4
    asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};"
                 :: "l"(p), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w) : "memory");
#else
    __trap();
#endif
  }
}

extern "C" int probe_mma(float* out, int blocks, int warps, int iters, void* st) {
  mma_loop<<<blocks, warps * 32, 0, (cudaStream_t)st>>>(out, iters);
  return (int)cudaGetLastError();
}

extern "C" int probe_scatter(int mode, const int* rows, float* table, int n, void* st) {
  const int threads = 256, blocks = (n * 4 + threads - 1) / threads;
  if (mode == 0) scatter<0><<<blocks, threads, 0, (cudaStream_t)st>>>(rows, table, n);
  else if (mode == 1) scatter<1><<<blocks, threads, 0, (cudaStream_t)st>>>(rows, table, n);
  else scatter<2><<<blocks, threads, 0, (cudaStream_t)st>>>(rows, table, n);
  return (int)cudaGetLastError();
}
"""

MMA_FLOP = 2 * 16 * 8 * 8          # one m16n8k8 product
SCATTER_MODES = ("atomicAdd_f32", "atomicAdd_float4", "red_v4_f32")


def _build():
    """The probe library, and nvcc's complaint if the PTX vector reduction
    did not assemble (the library is then built without it)."""
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    src = os.path.join(kernels.BUILD_DIR, "device_probe.cu")
    so = os.path.join(kernels.BUILD_DIR, "libdevice_probe.so")
    with open(src, "w") as f:
        f.write(_SOURCE)
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", src, "-o", so]
    first = subprocess.run(cmd + ["-DWITH_RED_V4"], capture_output=True, text=True)
    red_error = None
    if first.returncode != 0:
        red_error = first.stdout + first.stderr
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.probe_mma.argtypes = [vp, i32, i32, i32, vp]
    lib.probe_scatter.argtypes = [i32, vp, vp, i32, vp]
    lib.probe_mma.restype = lib.probe_scatter.restype = i32
    return lib, red_error


def _sass_lines(pattern: str) -> list:
    """Distinct SASS instructions of the kernel library matching
    ``pattern`` (cuobjdump), to show what the atomics compiled to."""
    so = kernels.build()
    cuobjdump = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", so], capture_output=True,
                         text=True).stdout
    return sorted({tok for line in out.splitlines()
                   for tok in line.split(";")[0].split() if tok.startswith(pattern)})


def main():
    if not torch.cuda.is_available():
        raise SystemExit("device_probe: needs a CUDA device")
    lib, red_error = _build()
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.zeros(1024, device=dev)

    mma = {}
    iters = 4096
    for warps in (4, 8, 16):
        blocks = n_sm * (32 // warps)       # 32 warps an SM
        ms = device_ms(lambda: kernels.check(
            lib.probe_mma(out.data_ptr(), blocks, warps, iters, stream()),
            "probe_mma"), 5)
        n_mma = blocks * warps * iters * 8
        mma[f"{warps}_warps_a_block"] = n_mma * MMA_FLOP / (ms * 1e-3) / 1e12

    gen = torch.Generator(device=dev).manual_seed(0)
    scatter = {}
    for table_rows in (16_384, 262_144):             # 1 MB and 16 MB tables
        table = torch.zeros(table_rows, 16, device=dev)
        n = 1 << 20
        rows = torch.randint(0, table_rows, (n,), generator=gen, device=dev,
                             dtype=torch.int32)
        for mode, name in enumerate(SCATTER_MODES):
            if red_error and mode == 2:
                continue
            ms = device_ms(lambda: kernels.check(
                lib.probe_scatter(mode, rows.data_ptr(), table.data_ptr(), n,
                                  stream()), "probe_scatter"), 20)
            scatter[f"{name}_{table_rows}_rows"] = n * 16 / (ms * 1e-3)

    result = {"card": card_line(),
              "mma_sync_tf32_tflops": mma,
              "dense_tf32_peak_tflops": 495.0,
              "float_adds_per_s": scatter,
              "red_v4_build_error": red_error,
              "dtable_kernel_atomics_sass": _sass_lines("RED") + _sass_lines("ATOM")}
    print(json.dumps(result))


if __name__ == "__main__":
    main()
