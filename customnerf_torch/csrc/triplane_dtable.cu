// Tri-plane table gradient for Hopper (sm_90a): 4-corner atomic scatter.
//
// Replaces the TPU kernels customnerf_tpu/ops/triplane_pallas.py:57
// `_dtable_kernel` (plane_dtable_pallas :101) and :166 `_dtable_kernel_fw`
// (plane_dtable_pallas_fw :210), and their XLA twin
// customnerf_tpu/ops/triplane.py:301 `_plane_dtable`.  Same contract, per
// plane of resolution R with C channels:
//
//   dT[u·R + v, c] += Σ_b U[b, u] · V[b, v] · g[b, c]
//
// with U, V the 2-nonzero bilinear weights of (u0, fu) and (v0, fv).  The TPU
// kernels contract dense one-hot matrices on the MXU (O(B·R²·C) work); here
// each (sample, channel) thread adds w·g at its 4 corners with f32 atomicAdd
// (the upstream gridencoder.cu:248-339 form): O(B·4·C) work.
//
// Bound on an H100 SXM, per plane at the flagship (B = 229,376 samples):
//   * bytes: inputs 16 B (u0, v0, fu, fv) + 4·C B (g) a sample, 11-19 MB;
//     output R²·C·4 B written once (1 MB at R=128,C=16; 8.4 MB at R=512,C=8).
//     About 6-8 µs a plane at 3.35 TB/s.  The caller's zero-fill of the whole
//     [835,584, 16] f32 table gradient (53.5 MB) adds 16 µs once a step.
//   * operations: 8·C f32 FLOP a sample (negligible next to the bytes);
//   * atomics: 4·C a sample, 66M a step over the six planes.  Their rate at
//     the L2 (not the DRAM rate) is what limits this kernel: measured on an
//     H100 (chip_smoke.py) a plane takes 0.05-0.08 ms against its 0.006 ms
//     byte bound.  The table gradient (53.5 MB) nearly fits the 50 MB L2,
//     and the largest plane block (8.4 MB) fits with room to spare.
// What the design does about it: a zero cotangent adds nothing, so its
// thread returns before touching the table (a compacted train step's dead
// slots all carry g = 0 and sit on one texel, where their atomics would
// serialise); threads of a warp take consecutive channels
// of the same samples, so g is read coalesced and each corner's atomics hit
// consecutive addresses of one table row (C·4 = 32-64 B); `g_ld`/`out_ld`
// row strides let the caller pass a column slice of g and a view into the
// flat table gradient, so the six planes write in place with no concat and
// no copy.  The summation order of atomics varies from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
plane_dtable_kernel(const int* __restrict__ u0, const int* __restrict__ v0,
                    const float* __restrict__ fu, const float* __restrict__ fv,
                    const float* __restrict__ g, int64_t g_ld,
                    float* __restrict__ out, int64_t out_ld, int64_t B, int R,
                    int C) {
  const int64_t t = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (t >= B * C) return;
  const int64_t b = t / C;
  const int c = (int)(t - b * C);
  const float gv = __ldg(g + b * g_ld + c);
  // dead compaction slots carry g = 0 and all sit on the centre texel:
  // their atomics would serialise on 4 rows and add nothing
  if (gv == 0.f) return;
  const float a = __ldg(fu + b), w = __ldg(fv + b);
  const int64_t r00 = (int64_t)__ldg(u0 + b) * R + __ldg(v0 + b);
  float* o = out + r00 * out_ld + c;
  atomicAdd(o, (1.f - a) * (1.f - w) * gv);
  atomicAdd(o + out_ld, (1.f - a) * w * gv);
  atomicAdd(o + R * out_ld, a * (1.f - w) * gv);
  atomicAdd(o + (R + 1) * out_ld, a * w * gv);
}

}  // namespace

extern "C" int cn_plane_dtable(const int* u0, const int* v0, const float* fu,
                               const float* fv, const float* g, int64_t g_ld,
                               float* out, int64_t out_ld, int64_t B, int R,
                               int C, void* stream) {
  if (B <= 0) return 0;
  if (R < 2 || C < 1) return (int)cudaErrorInvalidValue;
  const int64_t n = B * C;
  const int64_t blocks = (n + THREADS - 1) / THREADS;
  plane_dtable_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      u0, v0, fu, fv, g, g_ld, out, out_ld, B, R, C);
  return (int)cudaGetLastError();
}
