// Tri-plane table gradient for Hopper (sm_90a): runs of samples merged in
// registers, flushed with 128-bit vector atomics.
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
// the 4 corner contributions of each sample are scattered with atomics, the
// upstream gridencoder.cu:248-339 form: O(B·4·C) work.
//
// Bound on an H100 SXM, per plane at the flagship (B = 229,376 samples):
//   * bytes: inputs 16 B (u0, v0, fu, fv) + 4·C B (g) a sample, 11-19 MB;
//     output R²·C·4 B written once (1 MB at R=128,C=16; 8.4 MB at R=512,C=8).
//     About 6 µs a plane at 3.35 TB/s;
//   * operations: 8·C f32 FLOP a sample (negligible next to the bytes);
//   * what sets the pace is the L2's atomic units: a scalar f32 atomic a
//     (sample, corner, channel) is 4·C atomics a sample, ≈ 66 M a step.
// What the design does about it:
//   * one thread takes a run of RUN = 8 consecutive samples × 4 channels
//     (run lengths 1-32 measured on an H100: 8 is within 2 % of the best at
//     both planes; PERF.md).  The
//     compaction packs each block's kept samples in ray order, so
//     neighbouring samples of a ray often fall in the same cell or in a
//     neighbouring one: the thread sums the four corners' float4
//     contributions in registers, and when the cell changes it flushes only
//     the corners the new cell does not share (all four when the run ends),
//     with Hopper's 128-bit atomicAdd(float4*, float4) (one
//     REDG.E.ADD.F32x4 in the SASS).  The L2 already merges a warp's scalar
//     atomics to one row into sector operations, so the vector width alone
//     saves instructions, not L2 work (tools/device_probe.py and PERF.md);
//     what saves L2 work is the merge;
//   * a sample whose 4 cotangents are all zero adds nothing and is skipped
//     (a compacted step's dead slots all carry g = 0 on the centre texel,
//     where their atomics would serialise); a run that is all zero issues
//     no atomic;
//   * `g_ld` / `out_ld` row strides let the caller pass a column slice of g
//     and a view into the flat table gradient, so the six planes write in
//     place with no concat and no copy.  The float4 accesses need g and out
//     16-byte aligned, both row strides and C multiples of 4; the wrapper
//     checks this.
// The order of the atomics, and so the last bits of a sum, varies from run
// to run; the merge inside a run is in sample order.
//
// bf16 mode (cn_plane_dtable_bf16): the JAX package's default, TriplaneSpec.mm_bf16 =
// True — `_dtable_kernel` with use_bf16 and `_plane_dtable` with
// mm_dtype = bfloat16 multiply bf16(U) by bf16(V·g) and sum in f32:
//
//   dT[u·R + v, c] += Σ_b bf16(U[b, u]) · bf16(V[b, v] · g[b, c])
//
// Each sample's factors are rounded (round to nearest even) BEFORE they
// enter the run's sums: the two u-weights (1 − fu, fu) and the two v-weight
// products (1 − fv)·g, fv·g.  The product of two bf16 values is exact in
// f32, so the run merge, the float4 atomics and the zero skip stay as they
// are; only the order of the f32 sums differs from the JAX kernel's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// Launches of the kernel, counted on the card by the kernel itself (block 0,
// thread 0): [0] the f32 mode, [1] the bf16 mode.  A replayed CUDA graph's
// launches count here too; no host code runs for them.
__device__ unsigned long long g_launches[2];

// Only a study build (tools/kernel_study.py) sets another run length with
// -DCN_DTABLE_RUN=n, or leaves the atomics out with -DCN_DTABLE_NO_ATOMICS
// (the time of everything else).
#ifndef CN_DTABLE_RUN
#define CN_DTABLE_RUN 8
#endif
constexpr int RUN = CN_DTABLE_RUN;

// x rounded to bf16 (to nearest even) and widened back
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float4 bf16_scaled(float w, const float4& g) {
  return make_float4(bf16_round(w * g.x), bf16_round(w * g.y),
                     bf16_round(w * g.z), bf16_round(w * g.w));
}

__device__ __forceinline__ void axpy(float4& acc, float w, const float4& g) {
  acc.x = fmaf(w, g.x, acc.x);
  acc.y = fmaf(w, g.y, acc.y);
  acc.z = fmaf(w, g.z, acc.z);
  acc.w = fmaf(w, g.w, acc.w);
}

// a[i][j] for runtime (i, j), zero outside {0,1}²: selects, not local memory
__device__ __forceinline__ float4 pick(const float4 (&a)[2][2], int i, int j) {
  float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int ii = 0; ii < 2; ++ii)
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
      if (i == ii && j == jj) r = a[ii][jj];
  return r;
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
plane_dtable_kernel(const int* __restrict__ u0, const int* __restrict__ v0,
                    const float* __restrict__ fu, const float* __restrict__ fv,
                    const float* __restrict__ g, int64_t g_ld,
                    float* __restrict__ out, int64_t out_ld, int64_t B, int R,
                    int C) {
  if (blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(&g_launches[BF16 ? 1 : 0], 1ull);
  const int groups = C / 4;
  const int64_t t = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const int64_t run = t / groups;
  const int q = (int)(t - run * groups);
  const int64_t b_begin = run * RUN;
  if (b_begin >= B) return;
  const int64_t b_end = min(b_begin + RUN, B);

  // a[i][j] sums the contributions to texel (cu + i, cv + j), the corners
  // of the cell being summed (cu < 0: none yet)
  int cu = -1, cv = 0;
  float4 a[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) a[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);
  auto flush = [&](int i, int j) {
    float* o = out + ((int64_t)(cu + i) * R + cv + j) * out_ld + 4 * q;
#ifdef CN_DTABLE_NO_ATOMICS
    if (a[i][j].x == 12345.f) o[0] = a[i][j].y;  // keeps the sums alive
#else
    atomicAdd(reinterpret_cast<float4*>(o), a[i][j]);
#endif
  };
  for (int64_t b = b_begin; b < b_end; ++b) {
    const float4 gv = __ldg(reinterpret_cast<const float4*>(g + b * g_ld) + q);
    if (gv.x == 0.f && gv.y == 0.f && gv.z == 0.f && gv.w == 0.f) continue;
    const int u = __ldg(u0 + b), v = __ldg(v0 + b);
    if (u != cu || v != cv) {
      // texel (cu + i, cv + j) is corner (i − du, j − dv) of the new cell:
      // the corners the two cells share stay in registers, the others go
      const int du = u - cu, dv = v - cv;
      float4 n[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          n[i][j] = pick(a, i + du, j + dv);
          const int ni = i - du, nj = j - dv;
          if (cu >= 0 && !(ni >= 0 && ni < 2 && nj >= 0 && nj < 2)) flush(i, j);
        }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) a[i][j] = n[i][j];
      cu = u;
      cv = v;
    }
    const float fa = __ldg(fu + b), fw = __ldg(fv + b);
    if (BF16) {
      const float wu0 = bf16_round(1.f - fa), wu1 = bf16_round(fa);
      const float4 g0 = bf16_scaled(1.f - fw, gv), g1 = bf16_scaled(fw, gv);
      axpy(a[0][0], wu0, g0);
      axpy(a[0][1], wu0, g1);
      axpy(a[1][0], wu1, g0);
      axpy(a[1][1], wu1, g1);
    } else {
      axpy(a[0][0], (1.f - fa) * (1.f - fw), gv);
      axpy(a[0][1], (1.f - fa) * fw, gv);
      axpy(a[1][0], fa * (1.f - fw), gv);
      axpy(a[1][1], fa * fw, gv);
    }
  }
  if (cu >= 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) flush(i, j);
  }
}

template <bool BF16>
int launch(const int* u0, const int* v0, const float* fu, const float* fv,
           const float* g, int64_t g_ld, float* out, int64_t out_ld, int64_t B,
           int R, int C, void* stream) {
  if (B <= 0) return 0;
  if (R < 2 || C < 4 || C % 4 || g_ld % 4 || out_ld % 4 ||
      (uintptr_t)g % 16 || (uintptr_t)out % 16)
    return (int)cudaErrorInvalidValue;
  const int64_t n = (B + RUN - 1) / RUN * (C / 4);
  const int64_t blocks = (n + THREADS - 1) / THREADS;
  plane_dtable_kernel<BF16><<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      u0, v0, fu, fv, g, g_ld, out, out_ld, B, R, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cn_plane_dtable(const int* u0, const int* v0, const float* fu,
                               const float* fv, const float* g, int64_t g_ld,
                               float* out, int64_t out_ld, int64_t B, int R,
                               int C, void* stream) {
  return launch<false>(u0, v0, fu, fv, g, g_ld, out, out_ld, B, R, C, stream);
}

// The bf16-operand mode (bf16(U) · bf16(V·g), f32 sums); the same arguments.
extern "C" int cn_plane_dtable_bf16(const int* u0, const int* v0,
                                    const float* fu, const float* fv,
                                    const float* g, int64_t g_ld, float* out,
                                    int64_t out_ld, int64_t B, int R, int C,
                                    void* stream) {
  return launch<true>(u0, v0, fu, fv, g, g_ld, out, out_ld, B, R, C, stream);
}

// The kernel's launches counted on the card since the last reset: out[0]
// the f32 mode's, out[1] the bf16 mode's (host memory).
extern "C" int cn_plane_dtable_launch_counts(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_launches, sizeof(g_launches));
}

extern "C" int cn_plane_dtable_reset_launch_counts() {
  const unsigned long long zero[2] = {0, 0};
  return (int)cudaMemcpyToSymbol(g_launches, zero, sizeof(zero));
}
