// Fused NeRF field MLP forward for Hopper (sm_90a), plain f32 FMA.
//
// Replaces the TPU kernel customnerf_tpu/ops/fused_mlp_pallas.py:59 `_kernel`
// (launched by `_pallas_forward` :76 through `fused_field_mlp` :145).
//
// Computes, per point, with all seven bias-free head weights resident:
//   h   = relu(x_en · w1)          x_en [B, in_dim]      w1  [in_dim, 64]
//   h   = relu(h · w2)                                   w2  [64, 64]
//   fea = h · w3                                         w3  [64, 64]
//   sigma_raw = relu(fea · wd1) · wd2                    wd1 [64, 64], wd2 [64, 1]
//   rgb_raw   = relu([view_en ‖ fea] · wr1) · wr2        wr1 [dir+64, 64], wr2 [64, n_out]
// All matrices are row-major [in, out] (the flax Dense.kernel layout).
//
// Bound on an H100 SXM: 23,040 multiply-adds a point at the flagship widths
// (in_dim 72, dir 27, n_out 4) = 46,080 f32 FLOP against 416 bytes moved
// (396 B read, 20 B written), i.e. ~110 FLOP/B — far above the f32 ridge of
// 67 TFLOP/s / 3.35 TB/s ≈ 20 FLOP/B, so the kernel is bound by the CUDA
// cores' f32 FMA rate (0.16 ms for the 229,376 samples of a train step,
// 2.9 ms for the 4,194,304 queries of an occupancy refresh).
//
// What the design does about it:
//  * every weight (92 KB at the flagship) is staged ONCE per block into
//    dynamic shared memory (above the 48 KB default, hence
//    cudaFuncSetAttribute) and the grid is persistent — at most as many
//    blocks as fit on the card, each walking many tiles — so a 4.2M-point
//    refresh is one launch and weights are read from device memory ~132
//    times in all, not once per tile;
//  * one thread owns one point; its 64-wide activations live in a
//    per-thread column of shared memory ([64][THREADS], conflict-free) and
//    its 64 accumulators in registers, so nothing between layers touches
//    device memory;
//  * weight rows are read as float4 broadcasts (every lane of a warp reads
//    the same address), one 16-byte load per four FMAs;
//  * the rgb head's concatenated input is two partial products over
//    wr1[:dir] and wr1[dir:], no concat;
//  * the tail tile is masked per thread; outputs are written unpadded
//    (sigma_raw [B], rgb_raw [B, n_out]).
// Tensor cores (TF32/bf16 mma or wgmma) are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HID = 64;
constexpr int THREADS = 384;  // points per tile, one per thread
constexpr int MAX_OUT = 8;

__device__ __forceinline__ void fma_row(float (&acc)[HID], float a,
                                        const float* __restrict__ wrow) {
  const float4* w4 = reinterpret_cast<const float4*>(wrow);
#pragma unroll
  for (int q = 0; q < HID / 4; ++q) {
    const float4 w = w4[q];
    acc[4 * q + 0] = fmaf(a, w.x, acc[4 * q + 0]);
    acc[4 * q + 1] = fmaf(a, w.y, acc[4 * q + 1]);
    acc[4 * q + 2] = fmaf(a, w.z, acc[4 * q + 2]);
    acc[4 * q + 3] = fmaf(a, w.w, acc[4 * q + 3]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[HID]) {
#pragma unroll
  for (int j = 0; j < HID; ++j) acc[j] = 0.f;
}

// acc += act(column tid) · W, W [64, 64] in shared memory
__device__ __forceinline__ void layer_from_act(float (&acc)[HID],
                                               const float* __restrict__ act,
                                               const float* __restrict__ W,
                                               int tid) {
#pragma unroll 4
  for (int i = 0; i < HID; ++i) fma_row(acc, act[i * THREADS + tid], W + i * HID);
}

__device__ __forceinline__ void store_act(const float (&acc)[HID],
                                          float* __restrict__ act, int tid,
                                          bool relu) {
#pragma unroll
  for (int j = 0; j < HID; ++j)
    act[j * THREADS + tid] = relu ? fmaxf(acc[j], 0.f) : acc[j];
}

__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src,
                                      int n) {
  // n is a multiple of 4 and both pointers are 16-byte aligned
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float4* d4 = reinterpret_cast<float4*>(dst);
  for (int k = threadIdx.x; k < n / 4; k += blockDim.x) d4[k] = s4[k];
}

__global__ void __launch_bounds__(THREADS)
fused_mlp_kernel(const float* __restrict__ x, const float* __restrict__ view,
                 const float* __restrict__ w1, const float* __restrict__ w2,
                 const float* __restrict__ w3, const float* __restrict__ wd1,
                 const float* __restrict__ wd2, const float* __restrict__ wr1,
                 const float* __restrict__ wr2, float* __restrict__ sigma,
                 float* __restrict__ rgb, int64_t B, int in_dim, int dir_dim,
                 int n_out) {
  extern __shared__ __align__(16) float smem[];
  float* s_w1 = smem;
  float* s_w2 = s_w1 + in_dim * HID;
  float* s_w3 = s_w2 + HID * HID;
  float* s_wd1 = s_w3 + HID * HID;
  float* s_wd2 = s_wd1 + HID * HID;
  float* s_wr1 = s_wd2 + HID;
  float* s_wr2 = s_wr1 + (dir_dim + HID) * HID;
  float* act = s_wr2 + HID * n_out;  // [HID][THREADS]

  stage(s_w1, w1, in_dim * HID);
  stage(s_w2, w2, HID * HID);
  stage(s_w3, w3, HID * HID);
  stage(s_wd1, wd1, HID * HID);
  stage(s_wd2, wd2, HID);
  stage(s_wr1, wr1, (dir_dim + HID) * HID);
  stage(s_wr2, wr2, HID * n_out);
  __syncthreads();

  const int tid = threadIdx.x;
  const int64_t n_tiles = (B + THREADS - 1) / THREADS;
  float acc[HID];

  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t row = tile * THREADS + tid;
    if (row >= B) continue;  // tail tile: no block-wide sync below

    // feature net: 2 hidden ReLU layers + linear out
    zero(acc);
    const float* xr = x + row * in_dim;
#pragma unroll 4
    for (int i = 0; i < in_dim; ++i) fma_row(acc, __ldg(xr + i), s_w1 + i * HID);
    store_act(acc, act, tid, true);
    zero(acc);
    layer_from_act(acc, act, s_w2, tid);
    store_act(acc, act, tid, true);
    zero(acc);
    layer_from_act(acc, act, s_w3, tid);
    store_act(acc, act, tid, false);  // act column = fea

    // density head
    zero(acc);
    layer_from_act(acc, act, s_wd1, tid);
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < HID; ++j) s = fmaf(fmaxf(acc[j], 0.f), s_wd2[j], s);
    sigma[row] = s;

    // rgb head on [view_en ‖ fea]: two partial products, no concat
    zero(acc);
    const float* vr = view + row * dir_dim;
    for (int i = 0; i < dir_dim; ++i) fma_row(acc, __ldg(vr + i), s_wr1 + i * HID);
    layer_from_act(acc, act, s_wr1 + dir_dim * HID, tid);
    float o[MAX_OUT];
#pragma unroll
    for (int k = 0; k < MAX_OUT; ++k) o[k] = 0.f;
#pragma unroll
    for (int j = 0; j < HID; ++j) {
      const float h = fmaxf(acc[j], 0.f);
#pragma unroll
      for (int k = 0; k < MAX_OUT; ++k)
        if (k < n_out) o[k] = fmaf(h, s_wr2[j * n_out + k], o[k]);
    }
#pragma unroll
    for (int k = 0; k < MAX_OUT; ++k)
      if (k < n_out) rgb[row * n_out + k] = o[k];
  }
}

}  // namespace

extern "C" int cn_fused_mlp_forward(const float* x, const float* view,
                                    const float* w1, const float* w2,
                                    const float* w3, const float* wd1,
                                    const float* wd2, const float* wr1,
                                    const float* wr2, float* sigma, float* rgb,
                                    int64_t B, int in_dim, int dir_dim,
                                    int n_out, void* stream) {
  if (B <= 0) return 0;
  if (n_out < 1 || n_out > MAX_OUT || in_dim < 1 || dir_dim < 0)
    return (int)cudaErrorInvalidValue;
  const size_t n_weights = (size_t)in_dim * HID + 3 * HID * HID + HID +
                           (size_t)(dir_dim + HID) * HID + HID * n_out;
  const size_t smem = (n_weights + (size_t)HID * THREADS) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fused_mlp_kernel, THREADS, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int64_t n_tiles = (B + THREADS - 1) / THREADS;
  const int64_t cap = (int64_t)n_sm * per_sm;
  const int grid = (int)(n_tiles < cap ? n_tiles : cap);
  fused_mlp_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      x, view, w1, w2, w3, wd1, wd2, wr1, wr2, sigma, rgb, B, in_dim, dir_dim,
      n_out);
  return (int)cudaGetLastError();
}
