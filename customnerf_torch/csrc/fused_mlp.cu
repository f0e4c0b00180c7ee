// Fused NeRF field MLP forward for Hopper (sm_90a) on the tensor cores, in
// two modes: split-TF32 ("3xTF32") to f32 accuracy, and the flax bf16 head
// (see "bf16 mode" below).
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
// All matrices are row-major [in, out] (the flax Dense.kernel layout).  With
// with_rgb = 0 the rgb head is skipped and view_en is never read (the
// occupancy refresh needs sigma alone); sigma is bitwise the same as in a
// full call, since the instructions up to the density head are the same.
//
// Bound on an H100 SXM: 23,040 multiply-adds a point at the flagship widths
// (in_dim 72, dir 27, n_out 4; 16,960 without the rgb head) against 416
// bytes moved (292 without the rgb head).  Every product runs as three TF32
// tensor-core products, so the bound is 3 × 2 × MACs at the dense TF32 rate
// of 495 TFLOP/s: 0.064 ms for the 229,376 samples of a train step, 0.862 ms
// for the 4,194,304 density-only queries of a refresh (bytes: 0.029 and
// 0.366 ms at 3.35 TB/s).
//
// What the design does about it:
//  * mma.sync m16n8k8 TF32 with f32 accumulation.  Each f32 operand x is
//    split as hi = x rounded to TF32 (the bits of cvt.rna.tf32.f32, done
//    with integer ops), lo = x − hi (its low 13 bits cleared), and a
//    product is lo·hi + hi·lo + hi·hi: the dropped lo·lo term is ≤ 2^-22 of
//    it, so the kernel keeps the f32 contract (1e-4 of the largest output
//    against the f32 plain version).  mma.sync reaches about 317 TFLOP/s of
//    TF32 on an H100 (tools/device_probe.py), not the 495 of wgmma.
//  * A warp owns tiles of ROWS points; activations stay in registers from
//    layer to layer.  The accumulator fragment gives lane (g, t) the columns
//    {2t, 2t+1} of each 8-column block, the A fragment wants the k-slots
//    {t, t+4}: every weight is staged with its rows permuted inside each
//    8-row block (slot t ← row 2t, slot t+4 ← row 2t+1; a dot product does
//    not care about the order of k), so ReLU(C) is the next layer's A
//    fragment and no activation crosses shared memory.  x_en and view_en
//    tiles are read with the same permutation.
//  * The weights (94 KB f32 at the flagship) live in shared memory in
//    B-fragment order: each lane reads its two values of a (k8, n8) block as
//    one float2, free of bank conflicts.  A small kernel packs them into
//    that order once a call, and each block copies the packed 94 KB with
//    contiguous cp.async (a gather in every block put its loads, one
//    round-trip after another, before the block's first tile).  They are split into hi/lo as they are read
//    (storing both would not leave room for the input buffers).
//  * Each warp copies its next tile's x_en and view_en rows (one contiguous
//    span each) with 16-byte cp.async into its own buffers while it
//    computes the current tile: the x_en copy is issued once the first
//    layer has read the buffer and overlaps the six layers after it, the
//    view_en copy once the rgb head has read its buffer (so no view_en
//    fragment stays in registers across the other layers).
//  * A warp takes 32 points at a time (two m16 tiles share each split B
//    fragment; 10-12 % faster than 16-point tiles on an H100, PERF.md).  The
//    grid is persistent (one block of 8 warps an SM, ≤ 255 registers),
//    warps walk tiles independently, and the ragged tail is zero-filled by
//    cp.async and masked at the store.  The rgb head's [view_en ‖ fea] input is two
//    partial products; n_out ≤ 8 and the density output (64 → 1) each pad
//    to one n8 block.
//
// bf16 mode (cn_fused_mlp_bf16_forward): the flax bf16 head, the JAX
// package's heads under -O / -O2 with the default --backend xla
// (customnerf_tpu/models/field.py:84-106 with compute_dtype = "bfloat16",
// engine/trainer.py:117; flax Dense outside Pallas there).  x_en and
// view_en rounded to bf16, every weight rounded to bf16, and each layer's
// output rounded to bf16 (to nearest even) after an f32 sum; ReLU on the
// rounded value.  sigma_raw and rgb_raw come out as bf16 values widened to
// f32; the field applies flax's bf16 sigmoid.
//
// Bound of the bf16 mode on an H100 SXM: the same 23,040 multiply-adds a
// point, one bf16 tensor-core product each: 10.6 GFLOP for a train step's
// 229,376 samples, 0.011 ms at the dense bf16 rate of 989 TFLOP/s, under
// the 0.028 ms its 95 MB of f32 inputs and outputs take at 3.35 TB/s.
//
// What its design does, against the f32 kernel:
//  * mma.sync m16n8k16 bf16 with f32 accumulation: one product an element
//    where split-TF32 needs three.  Every K is padded to a multiple of 16
//    with zeros (in_dim 72 → 80; view_en ≤ 32 in two k16 blocks), inert in
//    these bias-free ReLU stacks, as the Pallas kernel pads to 128 lanes;
//  * the m16n8k16 accumulator gives lane (g, t) the columns {2t, 2t+1} of
//    each n8 block, and the A fragment wants the columns {2t, 2t+1} and
//    {2t+8, 2t+9} of a k16 block: n8 blocks 2k and 2k+1 of one layer's
//    output ARE k16 block k of the next layer's input, two bf16 to a
//    register, with no permutation of weights or activations;
//  * the weights (48 KB in bf16 at the flagship) are packed once a call in
//    B-fragment order, a lane's four bf16 of a (k16, n8) block one 8-byte
//    word, and staged by each block with cp.async;
//  * x_en and view_en stay f32 in memory and in the cp.async buffers, and
//    are rounded as the A fragments are built; 32-point tiles, the
//    cp.async double buffering and the persistent grid are the f32
//    kernel's.  wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Launches of each head kernel, counted on the card by the kernel itself
// (block 0, thread 0): [0] the f32 mode, [1] the bf16 mode.  A replayed CUDA
// graph's launches count here too; no host code runs for them.
__device__ unsigned long long g_launches[2];

constexpr int HID = 64;
constexpr int NB = HID / 8;    // n8 blocks of a hidden layer's output
constexpr int KBH = HID / 8;   // k8 blocks of a hidden layer's input
constexpr int MAX_OUT = 8;     // rgb outputs: one n8 block
constexpr int MAX_DIR = 32;    // view_en width: at most four k8 blocks
constexpr int KBV = MAX_DIR / 8;
constexpr int FRAG = 64;       // floats of one (k8, n8) B block: 32 lanes × 2

// Points a warp takes at a time.  Only a study build (tools/kernel_study.py)
// sets another height, 16, with -DCN_MLP_TILE_ROWS=16.
#ifndef CN_MLP_TILE_ROWS
#define CN_MLP_TILE_ROWS 32
#endif
constexpr int MT = CN_MLP_TILE_ROWS / 16;  // m16 tiles a warp
constexpr int ROWS = 16 * MT;
constexpr int WARPS = 16 / MT;             // 8 warps a block (16 at MT = 1)

// hi: x rounded to TF32, to nearest with ties away from zero — the bits of
// cvt.rna.tf32.f32 for every finite x, with two integer ops (the kernel
// measured faster this way than with the cvt; PERF.md)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// d += a · b for one m16n8k8 TF32 product
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[m][n] += a[m] · W[kb-block, n] over the NBL n8 blocks of one k8 block;
// a[m] holds f32 A fragments (a0..a3), wk the block's B fragments.
template <int NBL>
__device__ __forceinline__ void mma_kblock(float (&acc)[MT][NBL][4],
                                           const float (&a)[MT][4],
                                           const float* __restrict__ wk,
                                           int lane) {
  uint32_t ah[MT][4], al[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i) split(a[m][i], ah[m][i], al[m][i]);
#pragma unroll
  for (int n = 0; n < NBL; ++n) {
    const float2 b = reinterpret_cast<const float2*>(wk)[n * 32 + lane];
    uint32_t bh0, bl0, bh1, bl1;
    split(b.x, bh0, bl0);
    split(b.y, bh1, bl1);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      mma(acc[m][n], al[m], bh0, bh1);
      mma(acc[m][n], ah[m], bl0, bl1);
      mma(acc[m][n], ah[m], bh0, bh1);
    }
  }
}

template <int NBL>
__device__ __forceinline__ void zero(float (&acc)[MT][NBL][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NBL; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;
}

// Accumulator fragments (C order: (g,2t) (g,2t+1) (g+8,2t) (g+8,2t+1)) →
// the next layer's A fragments (a0..a3 = (g,t) (g+8,t) (g,t+4) (g+8,t+4)
// under the staged row permutation), with an optional ReLU.
__device__ __forceinline__ void to_act(float (&act)[MT][NB][4],
                                       const float (&acc)[MT][NB][4],
                                       bool relu) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      const float c[4] = {acc[m][n][0], acc[m][n][2], acc[m][n][1],
                          acc[m][n][3]};
#pragma unroll
      for (int i = 0; i < 4; ++i) act[m][n][i] = relu ? fmaxf(c[i], 0.f) : c[i];
    }
}

// acc = act · W for a 64-wide input held in registers
template <int NBL>
__device__ __forceinline__ void layer(float (&acc)[MT][NBL][4],
                                      const float (&act)[MT][NB][4],
                                      const float* __restrict__ w, int lane) {
#pragma unroll
  for (int kb = 0; kb < KBH; ++kb) {
    float a[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < 4; ++i) a[m][i] = act[m][kb][i];
    mma_kblock<NBL>(acc, a, w + kb * NBL * FRAG, lane);
  }
}

// The weights in B-fragment order, the layout of the kernel's shared
// memory: per layer, kb_n × nb_n (k8, n8) blocks of FRAG floats, float
// (pair·32 + lane)·2 + e holding W[row0 + 8kb + 2t + e][8nb + g] for
// lane = 4g + t, zero outside K × N.  Layers in the order w1, w2, w3, wd1,
// wd2, then the rgb head's wr1[:dir], wr1[dir:], wr2.
struct Layer {
  const float* W;
  int ld, row0, K, N, kb_n, nb_n;
};

constexpr int N_LAYERS = 8;
constexpr int N_SIGMA_LAYERS = 5;  // up to the density head

__host__ __device__ inline void weight_layers(
    Layer (&l)[N_LAYERS], const float* w1, const float* w2, const float* w3,
    const float* wd1, const float* wd2, const float* wr1, const float* wr2,
    int in_dim, int dir_dim, int n_out) {
  const int kb1 = (in_dim + 7) / 8;
  l[0] = {w1, HID, 0, in_dim, HID, kb1, NB};
  l[1] = {w2, HID, 0, HID, HID, KBH, NB};
  l[2] = {w3, HID, 0, HID, HID, KBH, NB};
  l[3] = {wd1, HID, 0, HID, HID, KBH, NB};
  l[4] = {wd2, 1, 0, HID, 1, KBH, 1};
  l[5] = {wr1, HID, 0, dir_dim, HID, KBV, NB};
  l[6] = {wr1, HID, dir_dim, HID, HID, KBH, NB};
  l[7] = {wr2, n_out, 0, HID, n_out, KBH, 1};
}

// Floats of the packed weights through layer n_layers − 1.
__host__ __device__ inline int packed_floats(const Layer (&l)[N_LAYERS],
                                             int n_layers) {
  int n = 0;
  for (int i = 0; i < n_layers; ++i) n += l[i].kb_n * l[i].nb_n * FRAG;
  return n;
}

// One thread a packed float.  Run once a call, so that each block of the
// main kernel stages its weights with one contiguous cp.async copy instead
// of gathering them itself.
__global__ void pack_weights(const float* __restrict__ w1,
                             const float* __restrict__ w2,
                             const float* __restrict__ w3,
                             const float* __restrict__ wd1,
                             const float* __restrict__ wd2,
                             const float* __restrict__ wr1,
                             const float* __restrict__ wr2,
                             float* __restrict__ packed, int in_dim,
                             int dir_dim, int n_out, int n_layers) {
  Layer l[N_LAYERS];
  weight_layers(l, w1, w2, w3, wd1, wd2, wr1, wr2, in_dim, dir_dim, n_out);
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  float* dst = packed;
  for (int li = 0; li < n_layers; ++li) {
    const Layer& L = l[li];
    const int size = L.kb_n * L.nb_n * FRAG;
    if (i < size) {
      const int e = i & 1, lane = (i >> 1) & 31, pair = i >> 6;
      const int kb = pair / L.nb_n, nb = pair - kb * L.nb_n;
      const int k = kb * 8 + 2 * (lane & 3) + e, n = nb * 8 + (lane >> 2);
      dst[i] = (k < L.K && n < L.N)
                   ? __ldg(L.W + (int64_t)(L.row0 + k) * L.ld + n) : 0.f;
      return;
    }
    i -= size;
    dst += size;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes));
}

// Copy `valid` bytes of a contiguous span into smem, zero-filling up to
// `total` (both multiples of 4; total a multiple of 16).
__device__ __forceinline__ void copy_span(float* dst, const float* src,
                                          int valid, int total, int lane) {
  const char* s = reinterpret_cast<const char*>(src);
  char* d = reinterpret_cast<char*>(dst);
  for (int off = lane * 16; off < total; off += 32 * 16) {
    const int n = min(16, max(0, valid - off));
    cp_async16(d + off, n ? s + off : s, n);
  }
}

template <bool RGB>
__global__ void __launch_bounds__(WARPS * 32, 1)
fused_mlp_kernel(const float* __restrict__ x, const float* __restrict__ view,
                 const float* __restrict__ packed, int w_floats,
                 float* __restrict__ sigma, float* __restrict__ rgb, int64_t B,
                 int in_dim, int dir_dim, int n_out) {
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(&g_launches[0], 1ull);
  extern __shared__ __align__(16) float smem[];
  const int kb1 = (in_dim + 7) / 8;
  float* s_w1 = smem;
  float* s_w2 = s_w1 + kb1 * NB * FRAG;
  float* s_w3 = s_w2 + KBH * NB * FRAG;
  float* s_wd1 = s_w3 + KBH * NB * FRAG;
  float* s_wd2 = s_wd1 + KBH * NB * FRAG;
  float* s_wrv = s_wd2 + KBH * FRAG;
  float* s_wrf = s_wrv + KBV * NB * FRAG;
  float* s_wr2 = s_wrf + KBH * NB * FRAG;
  float* s_in = smem + w_floats;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int x_floats = ROWS * in_dim;
  const int v_floats = RGB ? (ROWS * dir_dim + 3) / 4 * 4 : 0;
  float* xs = s_in + warp * (x_floats + v_floats);
  float* vs = xs + x_floats;

  const int64_t n_tiles = (B + ROWS - 1) / ROWS;
  const int64_t stride = (int64_t)gridDim.x * WARPS;
  int64_t tile = (int64_t)blockIdx.x * WARPS + warp;

  // x_en and view_en rows of a tile go in two cp.async groups: the x_en
  // buffer is refilled once layer 1 has read it, the view_en buffer once the
  // rgb head has (every call commits a group, empty past the last tile, so
  // that "all but the newest group" is always the one wanted)
  auto load_x = [&](int64_t tl) {
    if (tl < n_tiles) {
      const int64_t r0 = tl * ROWS;
      const int rows = (int)min((int64_t)ROWS, B - r0);
      copy_span(xs, x + r0 * in_dim, rows * in_dim * 4, x_floats * 4, lane);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  auto load_v = [&](int64_t tl) {
    if (tl < n_tiles) {
      const int64_t r0 = tl * ROWS;
      const int rows = (int)min((int64_t)ROWS, B - r0);
      copy_span(vs, view + r0 * dir_dim, rows * dir_dim * 4, v_floats * 4,
                lane);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  // the first tile's rows and the block's weights, all in flight at once
  load_x(tile);
  if (RGB) load_v(tile);
  for (int off = threadIdx.x * 16; off < w_floats * 4; off += WARPS * 32 * 16)
    cp_async16(reinterpret_cast<char*>(smem) + off,
               reinterpret_cast<const char*>(packed) + off, 16);
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  float acc[MT][NB][4], act[MT][NB][4], fea[MT][NB][4];
  for (; tile < n_tiles; tile += stride) {
    if (RGB)  // this tile's x_en; its view_en may still be in flight
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    else
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncwarp();

    // feature net, layer 1 straight from the x_en tile
    zero(acc);
    for (int kb = 0; kb < kb1; ++kb) {
      float a[MT][4];
      const int k = kb * 8 + 2 * t;
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = m * 16 + g + h * 8;
          float2 p = make_float2(0.f, 0.f);
          if (k < in_dim)
            p = *reinterpret_cast<const float2*>(xs + r * in_dim + k);
          a[m][h] = p.x;       // slot t     ← column 2t
          a[m][2 + h] = p.y;   // slot t + 4 ← column 2t + 1
        }
      mma_kblock<NB>(acc, a, s_w1 + kb * NB * FRAG, lane);
    }
    __syncwarp();  // every lane has read the x_en buffer: refill it
    load_x(tile + stride);

    to_act(act, acc, true);
    zero(acc);
    layer<NB>(acc, act, s_w2, lane);
    to_act(act, acc, true);
    zero(acc);
    layer<NB>(acc, act, s_w3, lane);
    to_act(fea, acc, false);

    // density head
    zero(acc);
    layer<NB>(acc, fea, s_wd1, lane);
    to_act(act, acc, true);
    float out[MT][1][4];
    zero(out);
    layer<1>(out, act, s_wd2, lane);
    const int64_t r0 = tile * ROWS;
    if (t == 0) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int64_t row = r0 + m * 16 + g + h * 8;
          if (row < B) sigma[row] = out[m][0][2 * h];
        }
    }

    if (RGB) {
      // rgb head on [view_en ‖ fea]: two partial products, no concat
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      __syncwarp();
      zero(acc);
#pragma unroll
      for (int kb = 0; kb < KBV; ++kb) {
        float a[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = m * 16 + g + (i & 1) * 8;
            const int k = kb * 8 + 2 * t + (i >> 1);
            a[m][i] = k < dir_dim ? vs[r * dir_dim + k] : 0.f;
          }
        mma_kblock<NB>(acc, a, s_wrv + kb * NB * FRAG, lane);
      }
      __syncwarp();  // every lane has read the view_en buffer: refill it
      load_v(tile + stride);
      layer<NB>(acc, fea, s_wrf, lane);
      to_act(act, acc, true);
      zero(out);
      layer<1>(out, act, s_wr2, lane);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int64_t row = r0 + m * 16 + g + h * 8;
          if (row >= B) continue;
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (2 * t + e < n_out) rgb[row * n_out + 2 * t + e] = out[m][0][2 * h + e];
        }
    }
  }
}

// ------------------------------------------------------------ bf16 mode
constexpr int KB16H = HID / 16;      // k16 blocks of a hidden layer's input
constexpr int KBV16 = MAX_DIR / 16;  // k16 blocks of view_en
constexpr int FRAG16 = 128;          // bf16 of one (k16, n8) B block: 32 lanes × 4

// two floats rounded to bf16 (to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// d += a · b for one m16n8k16 bf16 product
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[m][n] += a[m] · W[kb-block, n] over the NBL n8 blocks of one k16
// block; a[m] holds bf16x2 A fragments, wk the block's B fragments.
template <int NBL>
__device__ __forceinline__ void mma16_kblock(float (&acc)[MT][NBL][4],
                                             const uint32_t (&a)[MT][4],
                                             const __nv_bfloat16* __restrict__ wk,
                                             int lane) {
#pragma unroll
  for (int n = 0; n < NBL; ++n) {
    const uint2 b = reinterpret_cast<const uint2*>(wk)[n * 32 + lane];
#pragma unroll
    for (int m = 0; m < MT; ++m) mma16(acc[m][n], a[m], b.x, b.y);
  }
}

// Accumulators of a 64-wide output → the next layer's A fragments, each
// value rounded to bf16 (flax's bf16 Dense output), then an optional ReLU
__device__ __forceinline__ void to_act16(uint32_t (&act)[MT][KB16H][4],
                                         const float (&acc)[MT][NB][4],
                                         bool relu) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int kb = 0; kb < KB16H; ++kb) {
      const float(&lo)[4] = acc[m][2 * kb];
      const float(&hi)[4] = acc[m][2 * kb + 1];
      float v[8] = {lo[0], lo[1], lo[2], lo[3], hi[0], hi[1], hi[2], hi[3]};
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = relu ? fmaxf(v[i], 0.f) : v[i];
#pragma unroll
      for (int i = 0; i < 4; ++i) act[m][kb][i] = pack_bf16(v[2 * i], v[2 * i + 1]);
    }
}

// acc = act · W for a 64-wide bf16 input held in registers
template <int NBL>
__device__ __forceinline__ void layer16(float (&acc)[MT][NBL][4],
                                        const uint32_t (&act)[MT][KB16H][4],
                                        const __nv_bfloat16* __restrict__ w,
                                        int lane) {
#pragma unroll
  for (int kb = 0; kb < KB16H; ++kb) {
    uint32_t a[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < 4; ++i) a[m][i] = act[m][kb][i];
    mma16_kblock<NBL>(acc, a, w + kb * NBL * FRAG16, lane);
  }
}

// The layers of the bf16 layout: k16 blocks, the f32 layout's order
__host__ __device__ inline void weight_layers16(
    Layer (&l)[N_LAYERS], const float* w1, const float* w2, const float* w3,
    const float* wd1, const float* wd2, const float* wr1, const float* wr2,
    int in_dim, int dir_dim, int n_out) {
  const int kb1 = (in_dim + 15) / 16;
  l[0] = {w1, HID, 0, in_dim, HID, kb1, NB};
  l[1] = {w2, HID, 0, HID, HID, KB16H, NB};
  l[2] = {w3, HID, 0, HID, HID, KB16H, NB};
  l[3] = {wd1, HID, 0, HID, HID, KB16H, NB};
  l[4] = {wd2, 1, 0, HID, 1, KB16H, 1};
  l[5] = {wr1, HID, 0, dir_dim, HID, KBV16, NB};
  l[6] = {wr1, HID, dir_dim, HID, HID, KB16H, NB};
  l[7] = {wr2, n_out, 0, HID, n_out, KB16H, 1};
}

__host__ __device__ inline int packed_elems16(const Layer (&l)[N_LAYERS],
                                              int n_layers) {
  int n = 0;
  for (int i = 0; i < n_layers; ++i) n += l[i].kb_n * l[i].nb_n * FRAG16;
  return n;
}

// One thread a packed bf16: element (pair·32 + lane)·4 + e holds
// W[row0 + 16kb + 2t + (e & 1) + 8(e >> 1)][8nb + g] rounded to bf16, for
// lane = 4g + t (b0 = e 0, 1; b1 = e 2, 3), zero outside K × N.
__global__ void pack_weights16(const float* __restrict__ w1,
                               const float* __restrict__ w2,
                               const float* __restrict__ w3,
                               const float* __restrict__ wd1,
                               const float* __restrict__ wd2,
                               const float* __restrict__ wr1,
                               const float* __restrict__ wr2,
                               __nv_bfloat16* __restrict__ packed, int in_dim,
                               int dir_dim, int n_out, int n_layers) {
  Layer l[N_LAYERS];
  weight_layers16(l, w1, w2, w3, wd1, wd2, wr1, wr2, in_dim, dir_dim, n_out);
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  __nv_bfloat16* dst = packed;
  for (int li = 0; li < n_layers; ++li) {
    const Layer& L = l[li];
    const int size = L.kb_n * L.nb_n * FRAG16;
    if (i < size) {
      const int e = i & 3, lane = (i >> 2) & 31, pair = i >> 7;
      const int kb = pair / L.nb_n, nb = pair - kb * L.nb_n;
      const int k = kb * 16 + 2 * (lane & 3) + (e & 1) + 8 * (e >> 1);
      const int n = nb * 8 + (lane >> 2);
      dst[i] = __float2bfloat16_rn(
          (k < L.K && n < L.N) ? __ldg(L.W + (int64_t)(L.row0 + k) * L.ld + n)
                               : 0.f);
      return;
    }
    i -= size;
    dst += size;
  }
}

template <bool RGB>
__global__ void __launch_bounds__(WARPS * 32, 1)
fused_mlp_bf16_kernel(const float* __restrict__ x,
                      const float* __restrict__ view,
                      const __nv_bfloat16* __restrict__ packed, int w_elems,
                      float* __restrict__ sigma, float* __restrict__ rgb,
                      int64_t B, int in_dim, int dir_dim, int n_out) {
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(&g_launches[1], 1ull);
  extern __shared__ __align__(16) unsigned char smem16[];
  const int kb1 = (in_dim + 15) / 16;
  const __nv_bfloat16* s_w1 = reinterpret_cast<const __nv_bfloat16*>(smem16);
  const __nv_bfloat16* s_w2 = s_w1 + kb1 * NB * FRAG16;
  const __nv_bfloat16* s_w3 = s_w2 + KB16H * NB * FRAG16;
  const __nv_bfloat16* s_wd1 = s_w3 + KB16H * NB * FRAG16;
  const __nv_bfloat16* s_wd2 = s_wd1 + KB16H * NB * FRAG16;
  const __nv_bfloat16* s_wrv = s_wd2 + KB16H * FRAG16;
  const __nv_bfloat16* s_wrf = s_wrv + KBV16 * NB * FRAG16;
  const __nv_bfloat16* s_wr2 = s_wrf + KB16H * NB * FRAG16;
  // w_elems is a multiple of FRAG16: the f32 buffers start 16-byte aligned
  float* s_in = reinterpret_cast<float*>(smem16 + (size_t)w_elems * 2);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int x_floats = ROWS * in_dim;
  const int v_floats = RGB ? (ROWS * dir_dim + 3) / 4 * 4 : 0;
  float* xs = s_in + warp * (x_floats + v_floats);
  float* vs = xs + x_floats;

  const int64_t n_tiles = (B + ROWS - 1) / ROWS;
  const int64_t stride = (int64_t)gridDim.x * WARPS;
  int64_t tile = (int64_t)blockIdx.x * WARPS + warp;

  // the f32 kernel's two cp.async groups a tile
  auto load_x = [&](int64_t tl) {
    if (tl < n_tiles) {
      const int64_t r0 = tl * ROWS;
      const int rows = (int)min((int64_t)ROWS, B - r0);
      copy_span(xs, x + r0 * in_dim, rows * in_dim * 4, x_floats * 4, lane);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  auto load_v = [&](int64_t tl) {
    if (tl < n_tiles) {
      const int64_t r0 = tl * ROWS;
      const int rows = (int)min((int64_t)ROWS, B - r0);
      copy_span(vs, view + r0 * dir_dim, rows * dir_dim * 4, v_floats * 4,
                lane);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  load_x(tile);
  if (RGB) load_v(tile);
  for (int off = threadIdx.x * 16; off < w_elems * 2; off += WARPS * 32 * 16)
    cp_async16(smem16 + off, reinterpret_cast<const char*>(packed) + off, 16);
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  float acc[MT][NB][4];
  uint32_t act[MT][KB16H][4], fea[MT][KB16H][4];
  for (; tile < n_tiles; tile += stride) {
    if (RGB)
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    else
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncwarp();

    // feature net, layer 1 straight from the f32 x_en tile, rounded here
    zero(acc);
    for (int kb = 0; kb < kb1; ++kb) {
      uint32_t a[MT][4];
      const int k = kb * 16 + 2 * t;
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float* row = xs + (m * 16 + g + h * 8) * in_dim;
          float2 p0 = make_float2(0.f, 0.f), p1 = make_float2(0.f, 0.f);
          if (k < in_dim) p0 = *reinterpret_cast<const float2*>(row + k);
          if (k + 8 < in_dim) p1 = *reinterpret_cast<const float2*>(row + k + 8);
          a[m][h] = pack_bf16(p0.x, p0.y);      // rows g / g + 8, cols 2t, 2t+1
          a[m][2 + h] = pack_bf16(p1.x, p1.y);  // the same rows, cols + 8
        }
      mma16_kblock<NB>(acc, a, s_w1 + kb * NB * FRAG16, lane);
    }
    __syncwarp();  // every lane has read the x_en buffer: refill it
    load_x(tile + stride);

    to_act16(act, acc, true);
    zero(acc);
    layer16<NB>(acc, act, s_w2, lane);
    to_act16(act, acc, true);
    zero(acc);
    layer16<NB>(acc, act, s_w3, lane);
    to_act16(fea, acc, false);

    // density head
    zero(acc);
    layer16<NB>(acc, fea, s_wd1, lane);
    to_act16(act, acc, true);
    float out[MT][1][4];
    zero(out);
    layer16<1>(out, act, s_wd2, lane);
    const int64_t r0 = tile * ROWS;
    if (t == 0) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int64_t row = r0 + m * 16 + g + h * 8;
          if (row < B) sigma[row] = round_bf16(out[m][0][2 * h]);
        }
    }

    if (RGB) {
      // rgb head on [view_en ‖ fea]: two partial products, no concat
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      __syncwarp();
      zero(acc);
#pragma unroll
      for (int kb = 0; kb < KBV16; ++kb) {
        uint32_t a[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = m * 16 + g + (i & 1) * 8;
            const int k = kb * 16 + 2 * t + (i >> 1) * 8;
            a[m][i] = pack_bf16(k < dir_dim ? vs[r * dir_dim + k] : 0.f,
                                k + 1 < dir_dim ? vs[r * dir_dim + k + 1] : 0.f);
          }
        mma16_kblock<NB>(acc, a, s_wrv + kb * NB * FRAG16, lane);
      }
      __syncwarp();  // every lane has read the view_en buffer: refill it
      load_v(tile + stride);
      layer16<NB>(acc, fea, s_wrf, lane);
      to_act16(act, acc, true);
      zero(out);
      layer16<1>(out, act, s_wr2, lane);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int64_t row = r0 + m * 16 + g + h * 8;
          if (row >= B) continue;
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (2 * t + e < n_out)
              rgb[row * n_out + 2 * t + e] = round_bf16(out[m][0][2 * h + e]);
        }
    }
  }
}

// One persistent launch of a head kernel: as many blocks as the tiles
// need, at most one wave of resident blocks.
template <typename Kernel, typename W>
int launch(Kernel kernel, size_t smem, const float* x, const float* view,
           const W* packed, int w_count, float* sigma, float* rgb, int64_t B,
           int in_dim, int dir_dim, int n_out, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, WARPS * 32, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int64_t n_tiles = (B + ROWS - 1) / ROWS;
  const int64_t wanted = (n_tiles + WARPS - 1) / WARPS;
  const int64_t cap = (int64_t)n_sm * per_sm;
  const int grid = (int)(wanted < cap ? wanted : cap);
  kernel<<<grid, WARPS * 32, smem, stream>>>(x, view, packed, w_count, sigma,
                                             rgb, B, in_dim, dir_dim, n_out);
  return (int)cudaGetLastError();
}

// Shared memory of a head kernel: the packed weights, then each warp's
// x_en and view_en buffers (f32)
size_t head_smem(size_t w_bytes, int in_dim, int dir_dim, bool rgb) {
  const size_t in_floats =
      (size_t)WARPS * (ROWS * in_dim + (rgb ? (ROWS * dir_dim + 3) / 4 * 4 : 0));
  return w_bytes + in_floats * sizeof(float);
}

int check_args(const float* x, const float* view, const void* packed,
               int in_dim, int dir_dim, int n_out, int with_rgb) {
  // cp.async copies 16-byte chunks of the x_en / view_en rows and weights
  if (in_dim < 4 || in_dim % 4 || (uintptr_t)x % 16 || (uintptr_t)packed % 16)
    return (int)cudaErrorInvalidValue;
  if (with_rgb && (n_out < 1 || n_out > MAX_OUT || dir_dim < 1 ||
                   dir_dim > MAX_DIR || (uintptr_t)view % 16))
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// Floats of the scratch buffer cn_fused_mlp_forward packs the weights into.
extern "C" int cn_fused_mlp_packed_floats(int in_dim, int dir_dim, int n_out,
                                          int with_rgb) {
  Layer l[N_LAYERS];
  weight_layers(l, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                nullptr, in_dim, dir_dim, n_out);
  return packed_floats(l, with_rgb ? N_LAYERS : N_SIGMA_LAYERS);
}

// with_rgb = 0 skips the rgb head: view, wr1, wr2 and rgb are then not touched (may be null).
// packed: scratch of cn_fused_mlp_packed_floats(...) floats, 16-byte aligned.
extern "C" int cn_fused_mlp_forward(const float* x, const float* view,
                                    const float* w1, const float* w2,
                                    const float* w3, const float* wd1,
                                    const float* wd2, const float* wr1,
                                    const float* wr2, float* packed,
                                    float* sigma, float* rgb, int64_t B,
                                    int in_dim, int dir_dim, int n_out,
                                    int with_rgb, void* stream) {
  if (B <= 0) return 0;
  if (int err = check_args(x, view, packed, in_dim, dir_dim, n_out, with_rgb))
    return err;
  cudaStream_t s = (cudaStream_t)stream;
  Layer l[N_LAYERS];
  weight_layers(l, w1, w2, w3, wd1, wd2, wr1, wr2, in_dim, dir_dim, n_out);
  const int n_layers = with_rgb ? N_LAYERS : N_SIGMA_LAYERS;
  const int w_floats = packed_floats(l, n_layers);
  pack_weights<<<(w_floats + 255) / 256, 256, 0, s>>>(
      w1, w2, w3, wd1, wd2, wr1, wr2, packed, in_dim, dir_dim, n_out, n_layers);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = head_smem(w_floats * sizeof(float), in_dim, dir_dim, with_rgb);
  return with_rgb ? launch(fused_mlp_kernel<true>, smem, x, view, packed,
                           w_floats, sigma, rgb, B, in_dim, dir_dim, n_out, s)
                  : launch(fused_mlp_kernel<false>, smem, x, view, packed,
                           w_floats, sigma, rgb, B, in_dim, dir_dim, n_out, s);
}

// bf16 elements of the scratch buffer cn_fused_mlp_bf16_forward packs the
// weights into.
extern "C" int cn_fused_mlp_bf16_packed_elems(int in_dim, int dir_dim,
                                              int n_out, int with_rgb) {
  Layer l[N_LAYERS];
  weight_layers16(l, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                  nullptr, in_dim, dir_dim, n_out);
  return packed_elems16(l, with_rgb ? N_LAYERS : N_SIGMA_LAYERS);
}

// The bf16 mode: cn_fused_mlp_forward's arguments, with packed a scratch of
// cn_fused_mlp_bf16_packed_elems(...) bf16, 16-byte aligned.
extern "C" int cn_fused_mlp_bf16_forward(const float* x, const float* view,
                                         const float* w1, const float* w2,
                                         const float* w3, const float* wd1,
                                         const float* wd2, const float* wr1,
                                         const float* wr2, void* packed,
                                         float* sigma, float* rgb, int64_t B,
                                         int in_dim, int dir_dim, int n_out,
                                         int with_rgb, void* stream) {
  if (B <= 0) return 0;
  if (int err = check_args(x, view, packed, in_dim, dir_dim, n_out, with_rgb))
    return err;
  cudaStream_t s = (cudaStream_t)stream;
  Layer l[N_LAYERS];
  weight_layers16(l, w1, w2, w3, wd1, wd2, wr1, wr2, in_dim, dir_dim, n_out);
  const int n_layers = with_rgb ? N_LAYERS : N_SIGMA_LAYERS;
  const int w_elems = packed_elems16(l, n_layers);
  __nv_bfloat16* p = static_cast<__nv_bfloat16*>(packed);
  pack_weights16<<<(w_elems + 255) / 256, 256, 0, s>>>(
      w1, w2, w3, wd1, wd2, wr1, wr2, p, in_dim, dir_dim, n_out, n_layers);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = head_smem(w_elems * 2, in_dim, dir_dim, with_rgb);
  return with_rgb ? launch(fused_mlp_bf16_kernel<true>, smem, x, view,
                           (const __nv_bfloat16*)p, w_elems, sigma, rgb, B,
                           in_dim, dir_dim, n_out, s)
                  : launch(fused_mlp_bf16_kernel<false>, smem, x, view,
                           (const __nv_bfloat16*)p, w_elems, sigma, rgb, B,
                           in_dim, dir_dim, n_out, s);
}

// The head kernels' launches counted on the card since the last reset:
// out[0] the f32 mode's, out[1] the bf16 mode's (host memory).
extern "C" int cn_fused_mlp_launch_counts(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_launches, sizeof(g_launches));
}

extern "C" int cn_fused_mlp_reset_launch_counts() {
  const unsigned long long zero[2] = {0, 0};
  return (int)cudaMemcpyToSymbol(g_launches, zero, sizeof(zero));
}
