// The Stable Diffusion UNet's attention for Hopper (sm_90a): softmax(q·kᵀ/√d)·v
// in one kernel, with no score tensor in device memory.
//
// Replaces no TPU kernel: the JAX package's attention
// (customnerf_tpu/guidance/unet.py) is plain XLA.  It replaces, on the card,
// the plain chain of customnerf_torch/guidance/unet.py::attention (kept there
// as the CPU path and the oracle): q and k cast to f32, the [b, h, n, m] f32
// logits on the SIMT units, a pass to scale them, the softmax, a pass to
// round the probabilities to bf16, the value product and a transposed copy.
// At SD 1.5's first level (b 2, 8 heads, n = m = 4,096) each call wrote and
// read back a 1.07 GB score tensor, about 7.5 GB of traffic a call.
//
// Semantics, per (batch, head) and query row i, with d the head width:
//   s_ij = fl32(Σ_c q_ic·k_jc) · fl32(1/√d)     (bf16 products, f32 sums)
//   p_ij = bf16(exp(s_ij − max_j s) / Σ_j exp(s_ij − max_j s))
//   o_ic = bf16(Σ_j p_ij · v_jc)                (f32 sums, rounded once)
// exp(s − m) is evaluated as 2^((s − m)·log2 e) on the SFU (ex2.approx,
// 2 ulp) from the same f32 s and m, the subtraction exact near the max: the
// probabilities agree with the plain path's to a few f32 ulps, far below the
// bf16 rounding that follows.  The max is taken over the unscaled sums (the
// scale is positive and rounding is monotone: the same row max).
// The probabilities are rounded after they are normalised, where the plain
// path and the JAX package round them; so the kernel takes two passes over
// the keys.  Pass 1 computes the logits and keeps each row's running max and
// sum (online: the sum rescaled when the max grows).  Pass 2 computes the
// logits again, forms the normalised probabilities, rounds them to bf16 and
// accumulates P·V in f32.  The second Q·Kᵀ is the price of the reference's
// rounding point; nothing of size n·m is ever stored.
//
// Bound on an H100 SXM: operations.  A call reads q, k, v and writes the
// output once (21 MB at SD 1.5's first level) and needs 4·n·m·d FLOPs a
// head (43 GF a level-0 call of SD 1.5: 0.043 ms at 989 TFLOP/s).  The kernel does
// 6·n·m·d at d padded to 16 (two Q·Kᵀ and one P·V; 77 GF there) on the
// tensor cores, and two exponentials a score on the SFU (537 M there,
// ≥ 0.14 ms at 16 a clock an SM).  What the design does about it:
//   * a block takes 128 query rows of one (batch, head), eight warps of 16
//     rows; a warp keeps its q rows as mma A fragments in registers for both
//     passes, the logits of a 64-key tile, and in pass 2 its 16 × d output;
//   * 64-key tiles of k (and in pass 2 of v) are staged in shared memory by
//     cp.async in a ring of three stages: two tiles load while one computes,
//     with one barrier a tile.  Rows are padded by 16 bytes so that ldmatrix
//     reads them without bank conflicts; columns past d up to the next
//     multiple of 16 are zero-filled by the same copies, so any d that is a
//     multiple of 8 up to 160 runs;
//   * products are mma.sync m16n8k16 bf16 with f32 accumulation (K1's); the
//     logits' accumulator fragments become P·V's A fragments in registers;
//     a score costs one SFU instruction and about four FMA-pipe ones a pass;
//   * a key tile past m (cross-attention: m = 77) is masked to −∞ and its v
//     rows zero-filled; query rows past n are computed on zeros and never
//     stored; a warp whose rows all lie past n skips the products;
//   * the output is written straight into [b, n, h·d] bf16 at the head's
//     columns: no transpose, no copy.
// The blocks of one (batch, head) are adjacent in launch order, so its k and
// v stay in the L2 while its row tiles read them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 128;          // query rows a block
constexpr int KEYS = 64;           // keys a tile
constexpr int NT = KEYS / 8;       // n8 tiles of a logit tile
constexpr int STAGES = 3;          // k/v tiles in flight
constexpr int MAX_D = 160;
constexpr int64_t MAX_ROW_STRIDE = 1 << 24;   // k and v rows, in elements
constexpr float LOG2E = 1.4426950408889634f;

constexpr int WARPS = ROWS / 16;   // a warp takes 16 query rows
constexpr int THREADS = 32 * WARPS;

// shared memory of a block at a padded head width DP: q, then STAGES k and
// STAGES v tiles, rows LD = DP + 8 apart (+16 bytes: conflict-free ldmatrix)
constexpr size_t smem_bytes(int DP) {
  return (size_t)(ROWS + 2 * STAGES * KEYS) * (DP + 8) * 2;
}

// Launches counted on the card by the kernel itself (block (0, 0), thread
// 0): [0] with whole key tiles (m a multiple of 64), [1] with a masked last
// key tile.  A replayed CUDA graph's launches count here too.
__device__ unsigned long long g_launches[2];

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared memory; `bytes` = 0 writes zeros
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a · b for one m16n8k16 bf16 product with f32 accumulation (not
// volatile: a pure function of its registers, free to be scheduled)
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the SFU (one instruction; −∞ gives 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// exp(s − m) for s = fl32(acc · scale) and a row max m of such logits: the
// subtraction exact near the max (Sterbenz), then 2^((s − m)·log2 e)
__device__ __forceinline__ float exp_shifted(float acc, float scale, float m) {
  return ex2(__fmul_rn(__fsub_rn(__fmul_rn(acc, scale), m), LOG2E));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* out;
  int64_t q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs;  // in elements
  int heads, n, m, d;
  float scale;
};

// `rows` rows of one head from `src` (row stride `rs`) into shared memory
// (row stride LD), rows ≥ `limit` and columns ≥ d zero-filled up to DP.
template <int DP>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int64_t rs,
                                          int row0, int rows, int limit, int d) {
  constexpr int CH = DP / 8;   // 16-byte chunks a row
  for (int i = threadIdx.x; i < rows * CH; i += THREADS) {
    const int r = i / CH, c = i - r * CH;
    const bool ok = row0 + r < limit && c * 8 < d;
    cp_async16(dst + r * (DP + 8) + c * 8,
               ok ? src + (int64_t)(row0 + r) * rs + c * 8 : src, ok ? 16 : 0);
  }
}

// acc = fl32(q · kᵀ) for the warp's 16 rows against a 64-key tile, keys
// ≥ m masked to −∞ (the scale is applied where the logits are used)
template <int DP>
__device__ __forceinline__ void logits(float (&s)[NT][4],
                                       const uint32_t (&qf)[DP / 16][4],
                                       const __nv_bfloat16* sk, int key0, int m,
                                       int lane) {
  constexpr int LD = DP + 8;
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
#pragma unroll
    for (int jj = 0; jj < NT / 2; ++jj) {
      uint32_t b[4];
      ldmatrix_x4(b, sk + (jj * 16 + (lane >> 4) * 8 + (lane & 7)) * LD +
                         kk * 16 + ((lane >> 3) & 1) * 8);
      mma16(s[2 * jj], qf[kk], b[0], b[1]);
      mma16(s[2 * jj + 1], qf[kk], b[2], b[3]);
    }
  if (key0 + KEYS > m) {   // the ragged last tile only (a uniform branch)
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (key0 + t * 8 + 2 * (lane & 3) + (e & 1) >= m) s[t][e] = -INFINITY;
  }
}

template <int DP>
__global__ void __launch_bounds__(THREADS) attention_kernel(const Args a) {
  constexpr int LD = DP + 8;
  constexpr int KD = DP / 16;  // k16 steps of q·kᵀ
  constexpr int ND = DP / 8;   // n8 tiles of the output
  constexpr int TILE = KEYS * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sk = sq + ROWS * LD;          // STAGES tiles of k
  __nv_bfloat16* sv = sk + STAGES * TILE;      // STAGES tiles of v

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0)
    atomicAdd(&g_launches[a.m % KEYS ? 1 : 0], 1ull);

  const int b = blockIdx.y / a.heads, h = blockIdx.y - b * a.heads;
  const int row0 = blockIdx.x * ROWS;
  const __nv_bfloat16* q = a.q + b * a.q_bs + h * a.d;
  const __nv_bfloat16* k = a.k + b * a.k_bs + h * a.d;
  const __nv_bfloat16* v = a.v + b * a.v_bs + h * a.d;
  const int tiles = (a.m + KEYS - 1) / KEYS;
  const int steps = 2 * tiles;   // pass 1: k tiles; pass 2: k and v tiles
  const bool active = row0 + warp * 16 < a.n;

  // a k/v tile's 16-byte chunks this thread copies, the same in every
  // tile: their rows, shared-memory offsets and offsets in the tile's rows
  // (computed once: issuing the copies took a fifth of the kernel's time)
  constexpr int CH = DP / 8, CHUNKS = KEYS * CH;
  constexpr int SL = (CHUNKS + THREADS - 1) / THREADS;
  int c_row[SL], s_off[SL], k_off[SL], v_off[SL];
#pragma unroll
  for (int j = 0; j < SL; ++j) {
    const int i = threadIdx.x + j * THREADS, r = i / CH, c = i - r * CH;
    c_row[j] = c * 8 < a.d ? r : KEYS * tiles;    // a column past d: zeros
    s_off[j] = r * LD + c * 8;
    k_off[j] = r * (int)a.k_rs + c * 8;
    v_off[j] = r * (int)a.v_rs + c * 8;
  }
  // step j's tiles into stage j % STAGES: pass 1 k only, pass 2 k and v
  auto load_step = [&](int j) {
    const int tile = j % tiles, st = j % STAGES, key0 = tile * KEYS;
    const __nv_bfloat16* kt = k + (int64_t)key0 * a.k_rs;
    const __nv_bfloat16* vt = v + (int64_t)key0 * a.v_rs;
#pragma unroll
    for (int c = 0; c < SL; ++c) {
      if (threadIdx.x + c * THREADS >= CHUNKS) break;
      const bool ok = key0 + c_row[c] < a.m;     // rows past m: zeros
      cp_async16(sk + st * TILE + s_off[c], ok ? kt + k_off[c] : k, ok ? 16 : 0);
      if (j >= tiles)
        cp_async16(sv + st * TILE + s_off[c], ok ? vt + v_off[c] : v, ok ? 16 : 0);
    }
  };
  load_rows<DP>(sq, q, a.q_rs, row0, ROWS, a.n, a.d);
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < steps) load_step(j);
    asm volatile("cp.async.commit_group;\n" ::);
  }

  uint32_t qf[KD][4];
  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  const float sc = a.scale;
  // rows g and g + 8 of the warp's 16 (g = lane / 4): the running max of
  // acc and the sum; after pass 1, the max logit and 1 / sum
  float mx[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int step = 0; step < steps; ++step) {
    // step's group has landed (only the next STAGES − 2 may be in flight)
    // and every warp is past step − 1, whose stage step + STAGES − 1 now
    // loads into
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
    __syncthreads();
    if (step + STAGES - 1 < steps) load_step(step + STAGES - 1);
    asm volatile("cp.async.commit_group;\n" ::);

    if (step == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        ldmatrix_x4(qf[kk], sq + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                                (lane >> 4) * 8);
    }
    if (!active) continue;
    const int st = step % STAGES, tile = step % tiles;
    float s[NT][4];
    logits<DP>(s, qf, sk + st * TILE, tile * KEYS, a.m, lane);
    if (step < tiles) {
      // pass 1: the rows' max over this tile, then the sums rescaled to it
      // (maxima and sums as trees: shorter dependency chains)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float tm[4], part[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          tm[j] = fmaxf(fmaxf(s[j][2 * r], s[j][2 * r + 1]),
                        fmaxf(s[j + 4][2 * r], s[j + 4][2 * r + 1]));
        const float m_new =
            fmaxf(mx[r], quad_max(fmaxf(fmaxf(tm[0], tm[1]), fmaxf(tm[2], tm[3]))));
        const float ms = __fmul_rn(m_new, sc);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          part[j] = (exp_shifted(s[j][2 * r], sc, ms) +
                     exp_shifted(s[j][2 * r + 1], sc, ms)) +
                    (exp_shifted(s[j + 4][2 * r], sc, ms) +
                     exp_shifted(s[j + 4][2 * r + 1], sc, ms));
        l[r] = l[r] * exp_shifted(mx[r], sc, ms) +
               ((part[0] + part[1]) + (part[2] + part[3]));
        mx[r] = m_new;
      }
      if (step == tiles - 1) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = __fmul_rn(mx[r], sc);
          l[r] = 1.f / quad_sum(l[r]);
        }
      }
    } else {
      // pass 2: p = exp(s − max) / sum rounded to bf16, then o += p · v
      const __nv_bfloat16* vb = sv + st * TILE;
#pragma unroll
      for (int kk = 0; kk < KEYS / 16; ++kk) {
        uint32_t p[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float(&e)[4] = s[2 * kk + half];
          p[2 * half] = pack_bf16(exp_shifted(e[0], sc, mx[0]) * l[0],
                                  exp_shifted(e[1], sc, mx[0]) * l[0]);
          p[2 * half + 1] = pack_bf16(exp_shifted(e[2], sc, mx[1]) * l[1],
                                      exp_shifted(e[3], sc, mx[1]) * l[1]);
        }
#pragma unroll
        for (int jd = 0; jd < ND / 2; ++jd) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, vb + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD +
                                    jd * 16 + (lane >> 4) * 8);
          mma16(o[2 * jd], p, bv[0], bv[1]);
          mma16(o[2 * jd + 1], p, bv[2], bv[3]);
        }
      }
    }
  }

  if (!active) return;
  __nv_bfloat16* out = a.out + b * a.o_bs + h * a.d;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + warp * 16 + (lane >> 2) + 8 * r;
    if (row >= a.n) continue;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int col = j * 8 + 2 * (lane & 3);
      if (j * 8 < a.d)
        *reinterpret_cast<uint32_t*>(out + (int64_t)row * a.o_rs + col) =
            pack_bf16(o[j][2 * r], o[j][2 * r + 1]);
    }
  }
}

template <int DP>
int launch(const Args& a, int batch, cudaStream_t stream) {
  const size_t smem = smem_bytes(DP);
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((a.n + ROWS - 1) / ROWS), (unsigned)(batch * a.heads));
  attention_kernel<DP><<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// out [b, n, heads·d] = attention of q [b, n, heads·d] against k, v
// [b, m, heads·d], all bf16 with unit column stride, strides in elements
// (multiples of 8; k's and v's row strides below 2^24), bases 16-byte
// aligned; d a multiple of 8 in [8, 160]; batch · heads ≤ 65535.
extern "C" int cn_attention_forward(const void* q, const void* k,
                                    const void* v, void* out, int64_t q_bs,
                                    int64_t q_rs, int64_t k_bs, int64_t k_rs,
                                    int64_t v_bs, int64_t v_rs, int64_t o_bs,
                                    int64_t o_rs, int batch, int heads, int n,
                                    int m, int d, float scale, void* stream) {
  if (d < 8 || d > MAX_D || d % 8 || heads < 1 || batch < 1 ||
      (int64_t)batch * heads > 65535 || n < 0 || m < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t strides[8] = {q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs};
  for (int64_t s : strides)
    if (s % 8) return (int)cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  if (k_rs >= MAX_ROW_STRIDE || v_rs >= MAX_ROW_STRIDE)   // int32 offsets in a tile
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const Args a{static_cast<const __nv_bfloat16*>(q),
               static_cast<const __nv_bfloat16*>(k),
               static_cast<const __nv_bfloat16*>(v),
               static_cast<__nv_bfloat16*>(out),
               q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs,
               heads, n, m, d, scale};
  cudaStream_t s = (cudaStream_t)stream;
  switch ((d + 15) / 16) {   // the width padded to a multiple of 16
    case 1: return launch<16>(a, batch, s);
    case 2: return launch<32>(a, batch, s);
    case 3: return launch<48>(a, batch, s);
    case 4: return launch<64>(a, batch, s);
    case 5: return launch<80>(a, batch, s);
    case 6: return launch<96>(a, batch, s);
    case 7: return launch<112>(a, batch, s);
    case 8: return launch<128>(a, batch, s);
    case 9: return launch<144>(a, batch, s);
    default: return launch<160>(a, batch, s);
  }
}

// The kernel's launches counted on the card since the last reset: out[0]
// those with whole key tiles, out[1] those with a masked last key tile (host
// memory).
extern "C" int cn_attention_launch_counts(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_launches, sizeof(g_launches));
}

extern "C" int cn_attention_reset_launch_counts() {
  const unsigned long long zero[2] = {0, 0};
  return (int)cudaMemcpyToSymbol(g_launches, zero, sizeof(zero));
}
