// Multiresolution tiled / hash grid encode for Hopper (sm_90a): a level-major
// forward and a backward that adds each corner's gradient with one vector
// atomic.
//
// Replaces no TPU kernel: the JAX package's encoder
// (customnerf_tpu/ops/grid.py::grid_encode) is plain XLA.  It replaces the
// plain PyTorch encode of customnerf_torch/ops/grid.py (kept there as the CPU
// path and the oracle: `_encode_forward`, `_plain_backward`), which held 80 %
// of the reference-grid reconstruction step: ~30 elementwise int64 ops over
// [B, L, 8] corner indices, a `cat` per axis, an `index_select` and an
// `index_add_`.  Design after the reference's gridencoder.cu:88-244 (forward)
// and :248-339 (backward).  Same semantics as the plain path, per point x in
// [0, 1]^3 and level l < n_levels:
//
//   pos = x·scale_l + shift (shift 0.5, or 0 with align_corners), rounded
//   after the product and after the sum (no fused multiply-add: a point on a
//   cell edge lands in the plain path's cell); corner c = floor(pos) + {0,1}
//   per axis; row = (hash_l ? c0 ^ c1·2654435761 ^ c2·805459861
//                           : c0·s0 + c1·s1 + c2·s2) mod 2^32 % size_l
//                   + offset_l,
//   with s_d = 0 on an axis the level's dense sum leaves out; out[b, l·C + c]
//   = Σ_corner ((f0 · f1) · f2) · T[row, c] over the 8 corners (axis 0
//   slowest), f_d = 1 − frac_d or frac_d.  A point outside [0, 1] gives zeros
//   and adds no gradient; levels ≥ n_levels are not launched (the wrapper's
//   output is zero there).
//
// Bound on an H100 SXM (benchmark/lib/counts.py::grid_encode_step): bytes.
// A reference-grid step (16 levels × 2 channels, 23,967,296 rows = 192 MB,
// 1,048,576 coarse + 2,097,152 fine points forward, the fine ones backward)
// needs ~1.1 GB: the table read once, its gradient written once, coordinates,
// features and cotangents; about 0.33 ms at 3.35 TB/s.  The practical limit
// is the L2: 403 M random 8-byte corner reads and 268 M corner atomics a
// step, each its own 32-byte sector.  What the design does about it:
//   * level-major grid (blockIdx.y = level, blockIdx.x = 256 points): blocks
//     run in order of their linear index, so one level's blocks run together
//     and its rows (≤ 2^21 × 8 B = 16.8 MB of the 50 MB L2), and in the
//     backward its gradient rows, stay in the L2 while they are read and
//     added to;
//   * one thread a (point, level): the 8 corner rows are computed in uint32
//     registers and read as one float2 each (C = 2; float / float4 / 2 ×
//     float4 for C = 1, 4, 8), 8 independent loads in flight a thread; no
//     index, weight or value is materialised in memory (the plain path's
//     [B, 16, 8] int64 indices alone are 2.15 GB at 2,097,152 points);
//   * the backward adds w·g to a corner row with one atomicAdd on a float2
//     (Hopper's vector atomics: half the atomic instructions of two scalar
//     adds; float4 for C ≥ 4).  Consecutive samples of a ray share corners
//     (2.1 M fine points land on the 4,920 rows of level 0), so the warp
//     first sums each run of lanes that hit the same row (a segmented
//     reduction by shuffles) and only the run's first lane adds the sum
//     with one atomic, at every level.  On the parity step's own points
//     (H100, PERF.md) merging took the backward from 9.16 to 3.80 ms; it
//     gained 45 % at level 5 (34 % of neighbouring lanes share a corner
//     there) and cost nothing measurable at level 15 (2 % share): a warp
//     with no shared row skips the shuffles after one ballot;
//   * a (point, level) whose cotangent is zero adds nothing and is skipped;
//   * the level constants travel as one by-value argument (no constant
//     tensor, no host-to-device copy), read in place from the parameter bank
//     (__grid_constant__): the launch is capturable in a CUDA graph and
//     replays with the values it was captured with.
// The table, the interpolation, the output and the gradient stay f32.  The
// order of the atomics, and so the last bits of a gradient sum, varies from
// run to run; dx (only when asked for) is summed over the levels with
// atomics too.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_LEVELS = 16;
constexpr unsigned FULL = 0xffffffffu;
constexpr uint32_t PRIME1 = 2654435761u, PRIME2 = 805459861u;
constexpr uint32_t NO_ROW = 0xffffffffu;   // a lane that adds nothing

// Launches counted on the card by the kernels themselves (block (0, 0),
// thread 0): [0] the forward, [1] the backward.  A replayed CUDA graph's
// launches count here too; no host code runs for them.
__device__ unsigned long long g_launches[2];

// One level, as ops/grid.py::kernel_levels packs it: 8 words.
struct Level {
  float scale;
  uint32_t size;        // rows of the level
  uint32_t offset;      // its first row in the table
  uint32_t stride[3];   // dense strides, 0 on an axis the level leaves out
  uint32_t hash;        // 1: the xor-prime hash instead of the dense sum
  uint32_t unused;
};
static_assert(sizeof(Level) == 32, "Level is 8 words");

struct Levels {
  Level l[MAX_LEVELS];
};

// A point's cell at one level: its low corner and the fractions.
struct Cell {
  uint32_t c[3];
  float f[3];
};

__device__ __forceinline__ Cell cell_of(const float (&x)[3], const Level& lv,
                                        float shift) {
  Cell cell;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    // rounded after the product and after the sum, as the plain path
    const float pos = __fadd_rn(__fmul_rn(x[d], lv.scale), shift);
    const float fl = floorf(pos);
    cell.c[d] = (uint32_t)(int)fl;
    cell.f[d] = __fsub_rn(pos, fl);
  }
  return cell;
}

// Corner k's bit along axis d (axis 0 slowest, the plain path's order).
__device__ __forceinline__ uint32_t bit(int k, int d) { return (k >> (2 - d)) & 1; }

__device__ __forceinline__ uint32_t corner_row(const Cell& cell, const Level& lv,
                                               int k) {
  const uint32_t c0 = cell.c[0] + bit(k, 0), c1 = cell.c[1] + bit(k, 1),
                 c2 = cell.c[2] + bit(k, 2);
  const uint32_t idx = lv.hash ? (c0 ^ (c1 * PRIME1) ^ (c2 * PRIME2))
                               : c0 * lv.stride[0] + c1 * lv.stride[1] +
                                     c2 * lv.stride[2];
  return idx % lv.size + lv.offset;
}

__device__ __forceinline__ float factor(const Cell& cell, int k, int d) {
  return bit(k, d) ? cell.f[d] : __fsub_rn(1.f, cell.f[d]);
}

// (f0 · f1) · f2, each product rounded (the plain path's axis order)
__device__ __forceinline__ float weight(const Cell& cell, int k) {
  return __fmul_rn(__fmul_rn(factor(cell, k, 0), factor(cell, k, 1)),
                   factor(cell, k, 2));
}

__device__ __forceinline__ bool outside(const float (&x)[3]) {
  return x[0] < 0.f || x[0] > 1.f || x[1] < 0.f || x[1] > 1.f || x[2] < 0.f ||
         x[2] > 1.f;
}

template <int C>
__device__ __forceinline__ void load_row(const float* p, float (&v)[C]) {
  if constexpr (C == 1) {
    v[0] = __ldg(p);
  } else if constexpr (C == 2) {
    const float2 a = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = a.x;
    v[1] = a.y;
  } else {
#pragma unroll
    for (int q = 0; q < C / 4; ++q) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(p) + q);
      v[4 * q] = a.x;
      v[4 * q + 1] = a.y;
      v[4 * q + 2] = a.z;
      v[4 * q + 3] = a.w;
    }
  }
}

template <int C>
__device__ __forceinline__ void store_row(float* p, const float (&v)[C]) {
  if constexpr (C == 1) {
    p[0] = v[0];
  } else if constexpr (C == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int q = 0; q < C / 4; ++q)
      reinterpret_cast<float4*>(p)[q] =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  }
}

template <int C>
__device__ __forceinline__ void add_row(float* p, const float (&v)[C]) {
  if constexpr (C == 1) {
    atomicAdd(p, v[0]);
  } else if constexpr (C == 2) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
#pragma unroll
    for (int q = 0; q < C / 4; ++q)
      atomicAdd(reinterpret_cast<float4*>(p) + q,
                make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]));
  }
}

// Sums each run of consecutive lanes with the same `row` into the run's
// first lane (a segmented suffix sum by shuffles); true on that lane.  Every
// lane of the warp calls it.
template <int C>
__device__ __forceinline__ bool merge_runs(uint32_t row, float (&v)[C]) {
  const int lane = threadIdx.x & 31;
  const uint32_t prev = __shfl_up_sync(FULL, row, 1);
  const unsigned heads = __ballot_sync(FULL, lane == 0 || row != prev);
  if (heads != FULL) {
    // the run's last lane: the lane before the next head
    const unsigned later = lane == 31 ? 0u : heads & (FULL << (lane + 1));
    const int end = later ? __ffs(later) - 2 : 31;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float t = __shfl_down_sync(FULL, v[c], off);
        if (lane + off <= end) v[c] += t;
      }
    }
  }
  return (heads >> lane) & 1u;
}

template <int C>
__global__ void __launch_bounds__(THREADS)
grid_forward_kernel(const float* __restrict__ x, const float* __restrict__ table,
                    float* __restrict__ out, int64_t out_ld, int64_t B,
                    float shift, const __grid_constant__ Levels levels) {
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0)
    atomicAdd(&g_launches[0], 1ull);
  const int64_t b = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (b >= B) return;
  const int l = blockIdx.y;
  const Level& lv = levels.l[l];
  const float xb[3] = {__ldg(x + 3 * b), __ldg(x + 3 * b + 1),
                       __ldg(x + 3 * b + 2)};
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;
  if (!outside(xb)) {
    const Cell cell = cell_of(xb, lv, shift);
    float vals[8][C];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      load_row<C>(table + (size_t)corner_row(cell, lv, k) * C, vals[k]);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float w = weight(cell, k);
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = __fadd_rn(acc[c], __fmul_rn(vals[k][c], w));
    }
  }
  store_row<C>(out + b * out_ld + l * C, acc);
}

// dtable (may be null) += Σ w·g at each corner row; dx (may be null; table
// is read only then) += Σ_l scale_l Σ_corner (T[row]·g) ∂w/∂frac.
template <int C>
__global__ void __launch_bounds__(THREADS)
grid_backward_kernel(const float* __restrict__ x, const float* __restrict__ table,
                     const float* __restrict__ g, int64_t g_ld,
                     float* __restrict__ dtable, float* __restrict__ dx,
                     int64_t B, float shift, const __grid_constant__ Levels levels) {
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0)
    atomicAdd(&g_launches[1], 1ull);
  // no early return: every lane of a warp takes part in the merge
  const int64_t b = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const int l = blockIdx.y;
  const Level& lv = levels.l[l];
  float xb[3] = {0.f, 0.f, 0.f};
  float gl[C];
#pragma unroll
  for (int c = 0; c < C; ++c) gl[c] = 0.f;
  bool live = false;
  if (b < B) {
#pragma unroll
    for (int d = 0; d < 3; ++d) xb[d] = __ldg(x + 3 * b + d);
    if (!outside(xb)) {
      load_row<C>(g + b * g_ld + l * C, gl);
#pragma unroll
      for (int c = 0; c < C; ++c) live |= gl[c] != 0.f;
    }
  }
  const Cell cell = cell_of(xb, lv, shift);
  float dxs[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint32_t row = live ? corner_row(cell, lv, k) : NO_ROW;
    const float w = weight(cell, k);
    if (dtable != nullptr) {
      float v[C];
#pragma unroll
      for (int c = 0; c < C; ++c) v[c] = __fmul_rn(w, gl[c]);
      if (merge_runs<C>(row, v) && live) add_row<C>(dtable + (size_t)row * C, v);
    }
    if (dx != nullptr && live) {
      float t[C];
      load_row<C>(table + (size_t)row * C, t);
      float gv = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) gv += t[c] * gl[c];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        // ∂w/∂frac_d: the other axes' factors, signed by the corner's side
        float dw = bit(k, d) ? 1.f : -1.f;
#pragma unroll
        for (int e = 0; e < 3; ++e)
          if (e != d) dw *= factor(cell, k, e);
        dxs[d] += gv * dw;
      }
    }
  }
  if (dx != nullptr && live) {
#pragma unroll
    for (int d = 0; d < 3; ++d) atomicAdd(dx + 3 * b + d, dxs[d] * lv.scale);
  }
}

bool valid(int C, int n_levels) {
  return (C == 1 || C == 2 || C == 4 || C == 8) && n_levels >= 1 &&
         n_levels <= MAX_LEVELS;
}

Levels unpack(const void* packed) {
  Levels lv;
  memcpy(&lv, packed, sizeof(lv));
  return lv;
}

}  // namespace

// out [B, out_ld] f32: columns l·C … l·C + C − 1 of each level l < n_levels
// written; x [B, 3], table [rows, C] f32 contiguous; `levels` points to the
// host's 16 × 8 packed words (ops/grid.py::kernel_levels).
extern "C" int cn_grid_encode_forward(const float* x, const float* table,
                                      float* out, int64_t out_ld, int64_t B,
                                      int n_levels, int C, float shift,
                                      const void* levels, void* stream) {
  if (!valid(C, n_levels) || out_ld % C) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  const Levels lv = unpack(levels);
  const dim3 grid((unsigned)((B + THREADS - 1) / THREADS), (unsigned)n_levels);
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
    case 1: grid_forward_kernel<1><<<grid, THREADS, 0, s>>>(x, table, out, out_ld, B, shift, lv); break;
    case 2: grid_forward_kernel<2><<<grid, THREADS, 0, s>>>(x, table, out, out_ld, B, shift, lv); break;
    case 4: grid_forward_kernel<4><<<grid, THREADS, 0, s>>>(x, table, out, out_ld, B, shift, lv); break;
    default: grid_forward_kernel<8><<<grid, THREADS, 0, s>>>(x, table, out, out_ld, B, shift, lv); break;
  }
  return (int)cudaGetLastError();
}

// dtable [rows, C] f32 zeroed by the caller (null: not wanted), dx [B, 3]
// f32 zeroed by the caller (null: not wanted; table is read only for it);
// g [B, g_ld] f32, level l's cotangent at columns l·C … l·C + C − 1.
extern "C" int cn_grid_encode_backward(const float* x, const float* table,
                                       const float* g, int64_t g_ld,
                                       float* dtable, float* dx, int64_t B,
                                       int n_levels, int C, float shift,
                                       const void* levels, void* stream) {
  if (!valid(C, n_levels) || g_ld % C) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  const Levels lv = unpack(levels);
  const dim3 grid((unsigned)((B + THREADS - 1) / THREADS), (unsigned)n_levels);
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
    case 1: grid_backward_kernel<1><<<grid, THREADS, 0, s>>>(x, table, g, g_ld, dtable, dx, B, shift, lv); break;
    case 2: grid_backward_kernel<2><<<grid, THREADS, 0, s>>>(x, table, g, g_ld, dtable, dx, B, shift, lv); break;
    case 4: grid_backward_kernel<4><<<grid, THREADS, 0, s>>>(x, table, g, g_ld, dtable, dx, B, shift, lv); break;
    default: grid_backward_kernel<8><<<grid, THREADS, 0, s>>>(x, table, g, g_ld, dtable, dx, B, shift, lv); break;
  }
  return (int)cudaGetLastError();
}

// The kernels' launches counted on the card since the last reset: out[0] the
// forward's, out[1] the backward's (host memory).
extern "C" int cn_grid_encode_launch_counts(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_launches, sizeof(g_launches));
}

extern "C" int cn_grid_encode_reset_launch_counts() {
  const unsigned long long zero[2] = {0, 0};
  return (int)cudaMemcpyToSymbol(g_launches, zero, sizeof(zero));
}
