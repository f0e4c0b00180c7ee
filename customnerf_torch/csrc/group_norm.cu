// GroupNorm with an optional fused SiLU for Hopper (sm_90a): bf16 in, f32
// statistics, bf16 out; forward and backward (dx), each two launches.
//
// Replaces no TPU kernel: the JAX package's normalisers
// (customnerf_tpu/guidance/unet.py, vae.py: flax GroupNorm with bf16 params)
// are plain XLA.  It replaces, on the card, the plain chain of
// customnerf_torch/guidance/layers.py::group_norm (kept there as the CPU path,
// the f32 path and the oracle): a bf16 → f32 copy of the input, PyTorch's
// statistics kernel with one block a (n, g) row, the f32 apply, a cast back
// to bf16 and a bf16 SiLU, about 28 bytes of traffic an element; and in
// autograd the SiLU backward, the cast backwards and the f32 GroupNorm
// backward over an f32 copy of the input kept alive for it.  At the SD VAE's
// first level one image gives N·G = 32 rows of 1-4 M elements each: 32
// blocks on 132 SMs.
//
// Semantics, per row r = (n, g) of span = (C/G)·HW contiguous elements
// (NCHW), channel c, in f32 on the bf16 values:
//   mean, M2 = Welford over the span (partials merged by Chan's formula)
//   rstd = rsqrt(max(M2 / span, 0) + eps)
//   a_c = rstd·γ_c, b_c = β_c − a_c·mean               (F.group_norm's)
//   y = bf16(a_c·x + b_c); with SiLU: out = bf16(y / (1 + e^−y))
// the rounding points of the chain: f32 normalisation rounded once to bf16,
// the SiLU of that bf16 value in f32 rounded once.  Backward, with g the
// cotangent the chain's GroupNorm backward sees (dy, or with SiLU
// bf16(dy·σ(y)·(1 + y·(1 − σ(y)))), recomputed from x as the chain's SiLU
// backward rounds it):
//   s1 = Σ γ_c·g·x, s2 = Σ γ_c·g over the row
//   c2 = (s2·mean − s1)·rstd³/span, c3 = −c2·mean − s2·rstd/span
//   dx = bf16(rstd·γ_c·g + c2·x + c3)                  (PyTorch's formula)
// γ and β get no gradient: the SD weights are frozen (the wrapper routes
// anything else to the chain).
//
// Bound on an H100 SXM: bytes.  The forward reads x twice and writes y (6
// bytes an element, 4 counted at the least: x once and y once); the backward
// reads x and dy twice and writes dx (10 bytes; 6 at the least).  What the
// design does about it:
//   * each row is cut into `splits` chunks of `chunk` elements, chosen by the
//     wrapper from the row count and the span (layers.py::kernel_split): ~2048
//     blocks of 256 threads in all, at least 4,096 elements a block, so a
//     1 M-element VAE span and a 2,560-element UNet span at 8² both fill the
//     card's 132 SMs without a knob;
//   * 16-byte loads and stores of 8 bf16 (when HW is a multiple of 8 and the
//     tensors 16-byte aligned; else one element at a time), four in flight a
//     thread forward, two of x and two of dy backward (four of each held the
//     backward to 2 blocks an SM by its ~100 registers: 1.5 against 2.1 TB/s
//     at the VAE's 512² level on an H100); no f32 copy of anything of size
//     N·C·HW is written;
//   * statistics: each thread keeps (count, mean, M2) in f32 and folds in 32
//     loaded elements at a time (their own mean and squared deviations, then
//     Chan's merge); threads merge by a fixed shuffle tree, warps in order, and
//     each block writes one (mean, M2) partial.  The apply launch's blocks
//     each merge their row's partials again in one fixed order (a block's warp
//     0, lane-strided then a shuffle tree), so every block of a row gets the
//     same mean and rstd with no second launch, no float atomics and no
//     ticket: a CUDA graph's replays are bit-identical;
//   * the backward's reduction pass is split the same way (f32 partial sums,
//     a fixed tree), and its apply pass merges them as the forward does.
// The kernels count their own launches (apply launches: [0] forward, [1]
// backward), graph replays included.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;                 // loads in flight a thread: forward
constexpr int BWD_UNROLL = 2;             // backward (x and dy: as many bytes)
constexpr int MAX_GROUP_CHANNELS = 1024;  // shared memory: 3 floats a channel
constexpr int MAX_ROWS = 65535;           // the grid's y extent
constexpr unsigned FULL = 0xffffffffu;

// Launches counted on the card by the kernels themselves (block (0, 0),
// thread 0 of each apply launch): [0] the forward, [1] the backward.  A
// replayed CUDA graph's launches count here too.
__device__ unsigned long long g_launches[2];

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

__device__ __forceinline__ float rnd(float v) {   // round to bf16, as f32
  return __bfloat162float(__float2bfloat16_rn(v));
}

// VEC consecutive bf16 elements as f32 (and back: values already bf16)
template <int VEC>
struct Io;

template <>
struct Io<8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&f)[8]) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&f)[8]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = (__float_as_uint(f[2 * i]) >> 16) |
             (__float_as_uint(f[2 * i + 1]) & 0xffff0000u);
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <>
struct Io<1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&f)[1]) {
    f[0] = __bfloat162float(p[0]);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&f)[1]) {
    p[0] = __float2bfloat16_rn(f[0]);
  }
};

// (na, ma, qa) ← the merge of two (count, mean, M2) states (Chan et al.)
__device__ __forceinline__ void chan(long long& na, float& ma, float& qa,
                                     long long nb, float mb, float qb) {
  if (nb == 0) return;
  if (na == 0) {
    na = nb, ma = mb, qa = qb;
    return;
  }
  const long long n = na + nb;
  const float wb = (float)nb / (float)n;
  const float d = mb - ma;
  ma = fmaf(d, wb, ma);
  qa = qa + qb + d * d * ((float)na * wb);
  na = n;
}

// lane 0 ← the merge of the warp's 32 states (a fixed tree)
__device__ __forceinline__ void warp_chan(long long& n, float& m, float& q) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const long long nb = __shfl_down_sync(FULL, n, off);
    const float mb = __shfl_down_sync(FULL, m, off);
    const float qb = __shfl_down_sync(FULL, q, off);
    chan(n, m, q, nb, mb, qb);
  }
}

// lane 0 ← the warp's sums (a fixed tree)
__device__ __forceinline__ void warp_sum(float& a, float& b) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(FULL, a, off);
    b += __shfl_down_sync(FULL, b, off);
  }
}

struct Shape {
  int groups, cpg, hw, span, chunk, splits;
};

// elements [begin, begin + len) of the row this block takes
__device__ __forceinline__ void chunk_of(const Shape& s, int& begin, int& len) {
  begin = blockIdx.x * s.chunk;
  len = min(s.chunk, s.span - begin);
}

// (mean, rstd) of row `row` from its `splits` partials, in warp 0 (lane 0's
// result is the one used); every block of the row computes the same bits
__device__ void row_stats(const float* partials, long long row, const Shape& s,
                          float eps, float& mean, float& rstd) {
  const int lane = threadIdx.x;
  long long n = 0;
  float m = 0.f, q = 0.f;
  for (int k = lane; k < s.splits; k += 32) {
    const float* p = partials + 2 * (row * s.splits + k);
    chan(n, m, q, min(s.chunk, s.span - k * s.chunk), p[0], p[1]);
  }
  warp_chan(n, m, q);
  mean = m;
  rstd = rsqrtf(fmaxf(q / (float)s.span, 0.f) + eps);
}

// ------------------------------------------------------------ forward
template <int VEC>
__global__ void __launch_bounds__(THREADS)
    gn_stats_kernel(const __nv_bfloat16* __restrict__ x,
                    float* __restrict__ partials, Shape s) {
  __shared__ long long sn[WARPS];
  __shared__ float sm[WARPS], sq[WARPS];
  const long long row = blockIdx.y;
  int begin, len;
  chunk_of(s, begin, len);
  const __nv_bfloat16* p = x + row * s.span + begin;
  const int nv = len / VEC;
  long long n = 0;
  float m = 0.f, q = 0.f;
  for (int j0 = threadIdx.x; j0 < nv; j0 += UNROLL * THREADS) {
    float f[UNROLL][VEC];
    int k = 0;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (j0 + u * THREADS < nv) {
        Io<VEC>::load(p + (size_t)(j0 + u * THREADS) * VEC, f[u]);
        k = u + 1;
      }
    float sum = 0.f;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (u < k)
#pragma unroll
        for (int i = 0; i < VEC; ++i) sum += f[u][i];
    const float bm = k == UNROLL ? sum * (1.f / (UNROLL * VEC))
                                 : sum / (float)(k * VEC);
    float bq = 0.f;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (u < k)
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float d = f[u][i] - bm;
          bq = fmaf(d, d, bq);
        }
    chan(n, m, q, k * VEC, bm, bq);
  }
  warp_chan(n, m, q);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) sn[warp] = n, sm[warp] = m, sq[warp] = q;
  __syncthreads();
  if (threadIdx.x == 0) {
    n = sn[0], m = sm[0], q = sq[0];
    for (int w = 1; w < WARPS; ++w) chan(n, m, q, sn[w], sm[w], sq[w]);
    float* out = partials + 2 * (row * s.splits + blockIdx.x);
    out[0] = m;
    out[1] = q;
  }
}

template <int VEC, bool SILU>
__global__ void __launch_bounds__(THREADS)
    gn_apply_kernel(const __nv_bfloat16* __restrict__ x,
                    __nv_bfloat16* __restrict__ y,
                    const __nv_bfloat16* __restrict__ gamma,
                    const __nv_bfloat16* __restrict__ beta,
                    const float* __restrict__ partials, float* mean_out,
                    float* rstd_out, Shape s, float eps) {
  extern __shared__ float sh[];   // a[cpg], b[cpg]
  __shared__ float stat[2];
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0)
    atomicAdd(&g_launches[0], 1ull);
  const long long row = blockIdx.y;
  if (threadIdx.x < 32) {
    float mean, rstd;
    row_stats(partials, row, s, eps, mean, rstd);
    if (threadIdx.x == 0) {
      stat[0] = mean, stat[1] = rstd;
      if (blockIdx.x == 0) mean_out[row] = mean, rstd_out[row] = rstd;
    }
  }
  __syncthreads();
  const float mean = stat[0], rstd = stat[1];
  const int c0 = (int)(row % s.groups) * s.cpg;
  float* sa = sh;
  float* sb = sh + s.cpg;
  for (int c = threadIdx.x; c < s.cpg; c += THREADS) {
    const float a = rstd * __bfloat162float(gamma[c0 + c]);
    sa[c] = a;
    sb[c] = fmaf(-a, mean, __bfloat162float(beta[c0 + c]));
  }
  __syncthreads();
  int begin, len;
  chunk_of(s, begin, len);
  const __nv_bfloat16* xp = x + row * s.span + begin;
  __nv_bfloat16* yp = y + row * s.span + begin;
  const int nv = len / VEC;
  for (int j0 = threadIdx.x; j0 < nv; j0 += UNROLL * THREADS) {
    float f[UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (j0 + u * THREADS < nv)
        Io<VEC>::load(xp + (size_t)(j0 + u * THREADS) * VEC, f[u]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + u * THREADS;
      if (j < nv) {
        const int c = (unsigned)(begin + j * VEC) / (unsigned)s.hw;
        const float a = sa[c], b = sb[c];
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          float v = rnd(fmaf(a, f[u][i], b));
          if (SILU) v = rnd(v / (1.f + expf(-v)));
          f[u][i] = v;
        }
        Io<VEC>::store(yp + (size_t)j * VEC, f[u]);
      }
    }
  }
}

// ----------------------------------------------------------- backward
// the cotangent the chain's f32 GroupNorm backward sees at one element
template <bool SILU>
__device__ __forceinline__ float cotangent(float dy, float x, float a,
                                           float b) {
  if (!SILU) return dy;
  const float v = rnd(fmaf(a, x, b));
  const float sg = 1.f / (1.f + expf(-v));
  return rnd(dy * sg * (1.f + v * (1.f - sg)));
}

// per channel: [0, cpg) rstd·γ, [cpg, 2·cpg) β − rstd·γ·mean, [2·cpg, 3·cpg) γ
__device__ __forceinline__ void channel_terms(float* sh,
                                              const __nv_bfloat16* gamma,
                                              const __nv_bfloat16* beta,
                                              int c0, int cpg, float mean,
                                              float rstd) {
  for (int c = threadIdx.x; c < cpg; c += THREADS) {
    const float gm = __bfloat162float(gamma[c0 + c]);
    const float a = rstd * gm;
    sh[c] = a;
    sh[cpg + c] = fmaf(-a, mean, __bfloat162float(beta[c0 + c]));
    sh[2 * cpg + c] = gm;
  }
}

template <int VEC, bool SILU>
__global__ void __launch_bounds__(THREADS)
    gn_bwd_reduce_kernel(const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ dy,
                         const __nv_bfloat16* __restrict__ gamma,
                         const __nv_bfloat16* __restrict__ beta,
                         const float* __restrict__ mean_in,
                         const float* __restrict__ rstd_in,
                         float* __restrict__ partials, Shape s) {
  extern __shared__ float sh[];
  __shared__ float s1w[WARPS], s2w[WARPS];
  const long long row = blockIdx.y;
  const int c0 = (int)(row % s.groups) * s.cpg;
  channel_terms(sh, gamma, beta, c0, s.cpg, mean_in[row], rstd_in[row]);
  __syncthreads();
  int begin, len;
  chunk_of(s, begin, len);
  const __nv_bfloat16* xp = x + row * s.span + begin;
  const __nv_bfloat16* gp = dy + row * s.span + begin;
  const int nv = len / VEC;
  float s1 = 0.f, s2 = 0.f;
  for (int j0 = threadIdx.x; j0 < nv; j0 += BWD_UNROLL * THREADS) {
    float f[BWD_UNROLL][VEC], d[BWD_UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < BWD_UNROLL; ++u)
      if (j0 + u * THREADS < nv) {
        Io<VEC>::load(xp + (size_t)(j0 + u * THREADS) * VEC, f[u]);
        Io<VEC>::load(gp + (size_t)(j0 + u * THREADS) * VEC, d[u]);
      }
#pragma unroll
    for (int u = 0; u < BWD_UNROLL; ++u) {
      const int j = j0 + u * THREADS;
      if (j < nv) {
        const int c = (unsigned)(begin + j * VEC) / (unsigned)s.hw;
        const float a = sh[c], b = sh[s.cpg + c], gm = sh[2 * s.cpg + c];
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float gg = gm * cotangent<SILU>(d[u][i], f[u][i], a, b);
          s1 = fmaf(gg, f[u][i], s1);
          s2 += gg;
        }
      }
    }
  }
  warp_sum(s1, s2);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) s1w[warp] = s1, s2w[warp] = s2;
  __syncthreads();
  if (threadIdx.x == 0) {
    s1 = s1w[0], s2 = s2w[0];
    for (int w = 1; w < WARPS; ++w) s1 += s1w[w], s2 += s2w[w];
    float* out = partials + 2 * (row * s.splits + blockIdx.x);
    out[0] = s1;
    out[1] = s2;
  }
}

template <int VEC, bool SILU>
__global__ void __launch_bounds__(THREADS)
    gn_bwd_apply_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ dy,
                        __nv_bfloat16* __restrict__ dx,
                        const __nv_bfloat16* __restrict__ gamma,
                        const __nv_bfloat16* __restrict__ beta,
                        const float* __restrict__ mean_in,
                        const float* __restrict__ rstd_in,
                        const float* __restrict__ partials, Shape s) {
  extern __shared__ float sh[];
  __shared__ float coef[2];
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0)
    atomicAdd(&g_launches[1], 1ull);
  const long long row = blockIdx.y;
  const float mean = mean_in[row], rstd = rstd_in[row];
  if (threadIdx.x < 32) {
    float s1 = 0.f, s2 = 0.f;
    for (int k = threadIdx.x; k < s.splits; k += 32) {
      const float* p = partials + 2 * (row * s.splits + k);
      s1 += p[0];
      s2 += p[1];
    }
    warp_sum(s1, s2);
    if (threadIdx.x == 0) {
      const float inv = 1.f / (float)s.span;
      const float c2 = (s2 * mean - s1) * rstd * rstd * rstd * inv;
      coef[0] = c2;
      coef[1] = -c2 * mean - s2 * rstd * inv;
    }
  }
  const int c0 = (int)(row % s.groups) * s.cpg;
  channel_terms(sh, gamma, beta, c0, s.cpg, mean, rstd);
  __syncthreads();
  const float c2 = coef[0], c3 = coef[1];
  int begin, len;
  chunk_of(s, begin, len);
  const __nv_bfloat16* xp = x + row * s.span + begin;
  const __nv_bfloat16* gp = dy + row * s.span + begin;
  __nv_bfloat16* op = dx + row * s.span + begin;
  const int nv = len / VEC;
  for (int j0 = threadIdx.x; j0 < nv; j0 += BWD_UNROLL * THREADS) {
    float f[BWD_UNROLL][VEC], d[BWD_UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < BWD_UNROLL; ++u)
      if (j0 + u * THREADS < nv) {
        Io<VEC>::load(xp + (size_t)(j0 + u * THREADS) * VEC, f[u]);
        Io<VEC>::load(gp + (size_t)(j0 + u * THREADS) * VEC, d[u]);
      }
#pragma unroll
    for (int u = 0; u < BWD_UNROLL; ++u) {
      const int j = j0 + u * THREADS;
      if (j < nv) {
        const int c = (unsigned)(begin + j * VEC) / (unsigned)s.hw;
        const float a = sh[c], b = sh[s.cpg + c];
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float g = cotangent<SILU>(d[u][i], f[u][i], a, b);
          f[u][i] = rnd(fmaf(c2, f[u][i], a * g) + c3);
        }
        Io<VEC>::store(op + (size_t)j * VEC, f[u]);
      }
    }
  }
}

// the shape checks both launchers share; 0 when the shape is taken
int check_shape(int rows, const Shape& s) {
  if (rows < 1 || rows > MAX_ROWS || s.groups < 1 || rows % s.groups ||
      s.cpg < 1 || s.cpg > MAX_GROUP_CHANNELS || s.hw < 1 || s.chunk < 1 ||
      (long long)s.cpg * s.hw > 0x7fffffffLL ||
      s.splits != ((long long)s.span + s.chunk - 1) / s.chunk)
    return (int)cudaErrorInvalidValue;
  return 0;
}

Shape make_shape(int groups, int cpg, int hw, int chunk, int splits) {
  const long long span = (long long)cpg * hw;
  return Shape{groups, cpg, hw, span > 0x7fffffffLL ? 0 : (int)span, chunk,
               splits};
}

template <int VEC>
int launch_forward(const void* x, const void* gamma, const void* beta,
                   void* y, void* partials, void* mean, void* rstd, int rows,
                   const Shape& s, float eps, int silu, cudaStream_t stream) {
  const dim3 grid(s.splits, rows);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const __nv_bfloat16*>(gamma);
  const auto* bb = static_cast<const __nv_bfloat16*>(beta);
  gn_stats_kernel<VEC><<<grid, THREADS, 0, stream>>>(
      xb, static_cast<float*>(partials), s);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = 2 * sizeof(float) * s.cpg;
  auto kernel = silu ? gn_apply_kernel<VEC, true> : gn_apply_kernel<VEC, false>;
  kernel<<<grid, THREADS, smem, stream>>>(
      xb, static_cast<__nv_bfloat16*>(y), wb, bb,
      static_cast<const float*>(partials), static_cast<float*>(mean),
      static_cast<float*>(rstd), s, eps);
  return (int)cudaGetLastError();
}

template <int VEC>
int launch_backward(const void* x, const void* dy, const void* gamma,
                    const void* beta, const void* mean, const void* rstd,
                    void* dx, void* partials, int rows, const Shape& s,
                    int silu, cudaStream_t stream) {
  const dim3 grid(s.splits, rows);
  const size_t smem = 3 * sizeof(float) * s.cpg;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* gb = static_cast<const __nv_bfloat16*>(dy);
  const auto* wb = static_cast<const __nv_bfloat16*>(gamma);
  const auto* bb = static_cast<const __nv_bfloat16*>(beta);
  const auto* mf = static_cast<const float*>(mean);
  const auto* rf = static_cast<const float*>(rstd);
  auto reduce = silu ? gn_bwd_reduce_kernel<VEC, true>
                     : gn_bwd_reduce_kernel<VEC, false>;
  reduce<<<grid, THREADS, smem, stream>>>(xb, gb, wb, bb, mf, rf,
                                          static_cast<float*>(partials), s);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auto apply = silu ? gn_bwd_apply_kernel<VEC, true>
                    : gn_bwd_apply_kernel<VEC, false>;
  apply<<<grid, THREADS, smem, stream>>>(
      xb, gb, static_cast<__nv_bfloat16*>(dx), wb, bb, mf, rf,
      static_cast<const float*>(partials), s);
  return (int)cudaGetLastError();
}

}  // namespace

// y [N, C, H, W] = GroupNorm(x) (and its SiLU with `silu`), x and y bf16
// contiguous NCHW; rows = N·groups, cpg = C / groups, hw = H·W; each row's
// span of cpg·hw elements (< 2^31) cut into `splits` chunks of `chunk`
// elements (the last one shorter; a multiple of 8 for the 16-byte path);
// γ and β [C] bf16; partials: rows·splits·2 f32 scratch; mean and rstd
// [rows] f32 out (for the backward).
extern "C" int cn_group_norm_forward(const void* x, const void* gamma,
                                     const void* beta, void* y,
                                     void* partials, void* mean, void* rstd,
                                     int rows, int groups, int cpg, int hw,
                                     int chunk, int splits, float eps,
                                     int silu, void* stream) {
  const Shape s = make_shape(groups, cpg, hw, chunk, splits);
  if (int err = check_shape(rows, s)) return err;
  cudaStream_t st = (cudaStream_t)stream;
  if (hw % 8 == 0 && chunk % 8 == 0 && aligned16(x) && aligned16(y))
    return launch_forward<8>(x, gamma, beta, y, partials, mean, rstd, rows, s,
                             eps, silu, st);
  return launch_forward<1>(x, gamma, beta, y, partials, mean, rstd, rows, s,
                           eps, silu, st);
}

// dx = the input's cotangent of the forward above, given dy (its output's
// cotangent, bf16 contiguous NCHW), x, γ, β and the forward's mean and rstd;
// split as the forward; partials: rows·splits·2 f32 scratch.
extern "C" int cn_group_norm_backward(const void* x, const void* dy,
                                      const void* gamma, const void* beta,
                                      const void* mean, const void* rstd,
                                      void* dx,
                                      void* partials, int rows, int groups,
                                      int cpg, int hw, int chunk, int splits,
                                      int silu, void* stream) {
  const Shape s = make_shape(groups, cpg, hw, chunk, splits);
  if (int err = check_shape(rows, s)) return err;
  cudaStream_t st = (cudaStream_t)stream;
  if (hw % 8 == 0 && chunk % 8 == 0 && aligned16(x) && aligned16(dy) &&
      aligned16(dx))
    return launch_backward<8>(x, dy, gamma, beta, mean, rstd, dx, partials,
                              rows, s, silu, st);
  return launch_backward<1>(x, dy, gamma, beta, mean, rstd, dx, partials, rows,
                            s, silu, st);
}

// The kernels' launches counted on the card since the last reset: out[0]
// forwards, out[1] backwards (host memory).
extern "C" int cn_group_norm_launch_counts(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_launches, sizeof(g_launches));
}

extern "C" int cn_group_norm_reset_launch_counts() {
  const unsigned long long zero[2] = {0, 0};
  return (int)cudaMemcpyToSymbol(g_launches, zero, sizeof(zero));
}
