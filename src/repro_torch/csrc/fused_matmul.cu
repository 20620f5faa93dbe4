// Fused matmul + block-wise quantize (forward) and dequantize + matmul
// (backward) for the stash of a layer input x (M, D).
//
// Replaces the TPU kernels of src/repro/kernels/fused_matmul.py:
//   _matmul_quant_kernel (+ _quant_epilogue)
//       y = x @ w; the x row tile is quantized and packed with global block
//       offsets, so its words, zero and range are those quant_pack writes
//       for the same x (bit for bit)
//   _dequant_matmul_kernel (+ _tree_sum)
//       dw = dequant(packed)^T @ g, one (D, N) partial per row range,
//       combined by a fixed-order pairwise tree
//
// Forward (matmul_quant_kernel, namespace fwd).  What bounds it on an
// H100: bytes.  It reads x and w once and writes y and the stash: at the
// slice's M = 169,343 rows, 545 MB at 512 -> 256 (0.163 ms at 3.35 TB/s),
// 0.107 ms at 256 -> 256 and 0.119 ms at 512 -> 40.  The product's
// 2 * M * D * N = 44.4 GFLOP at 512 -> 256 take 0.090 ms at the TF32 peak
// of 495 TFLOP/s, the quantizer's ~18 operations an element 0.023 ms at
// 67 TFLOP/s (chip_smoke.check_fused counts all three).  The kernel does
// three TF32 products for the one float32 product (below), 133 GFLOP at
// 512 -> 256, through mma.sync at well under the peak; the quantizer's hash,
// divisions and packing are CUDA-core work of the same order.  Design:
// 1. Tensor cores instead of SIMT FMAs: mma.sync m16n8k8 TF32 with f32
//    accumulators on a hi/lo split of both operands (split_tf32 in
//    tensor_core.cuh: hi = rna(v), lo = rna(v - hi)).  Three products go
//    into the same accumulators, lo.hi, hi.lo, hi.hi; the dropped terms
//    (lo.lo and the two split residuals) miss at most 3 * 2^-22 |x||w| a
//    term, far inside the 2e-4 band the kernel is held to against the
//    float32 product.  One pass (2^-11 a term) or a split of one operand
//    alone breaks that band (tests/test_torch_fused_split.py): w is an
//    arbitrary float32, not RP's exact +-1.  A warp splits each A fragment
//    once a k8 step for all its n-tiles and each B fragment once for all
//    its m-tiles.  Each output is summed by one warp in a fixed order along
//    K; no split-K, no atomics, so repeated calls give the same bits.
// 2. Loads overlap the product: a CTA takes 64 rows and every column of y
//    (n <= 256; wider y in slabs of 256 on neighbouring CTAs), so x leaves
//    device memory once.  x comes by cp.async into a chunk buffer of 64
//    rows x up to 256 columns, the whole chunk at once; w streams through
//    a ring of KW = 16 rows a stage, S - 1 stages ahead of the product.
//    16-byte copies, or 4-byte ones when D or N % 4 != 0 or a base is not
//    16-byte aligned, zero-filled past row M, column N and the chunk's end.
//    Rows are padded (x to 4 mod 16 floats, w to 8 mod 16) so a warp's
//    fragment loads hit 32 distinct banks.
// 3. A column width that fits N: the CTA's columns are a template
//    parameter chosen from N, NT n-tiles of 8 a warp times WN warps: 40
//    (the slice's 40 classes), 64, or 256 (its hidden width).
// 4. The quantize epilogue on every CTA, for its own rows, with the
//    rounding of quant_common.cuh.  A block is G consecutive elements of
//    the row-major x, and a row tile's CTAs take every block whose first
//    element lies in its rows (slabs share them), so each stash word is
//    written once and every layout whose element count is whole blocks
//    runs.  When D % G == 0 and G <= 256 (the slice), a chunk is whole
//    blocks of whole rows: after the chunk's product the CTA quantizes
//    them from the chunk buffer (8 lanes a block find its min and max,
//    then a thread a code word), so x is read from device memory once.
//    Otherwise (G % D == 0 with G > D, or G > 256) the CTA copies its
//    blocks back from device memory (mostly L2) after the product.  A CTA
//    holds 102,400 bytes of shared memory at N = 256 and 73,728 at N = 40,
//    so two or three CTAs share an SM and one's quantizer (CUDA cores) can
//    run beside another's product (tensor cores).
// The rounding differs from the float32 product only in order and in the
// dropped terms.  Where hi is not finite, lo = v - hi is not either, and y
// is NaN where the float32 product may be finite or +-inf: for an infinite
// x or w, and for a finite |v| >= (2 - 2^-11) * 2^127, within a relative
// 2^-12 of FLT_MAX, which rounds to inf in TF32 (as cvt.rna).  The stash is
// quantized from the float32 x and does not see the split.
//
// Backward (dequant_matmul_kernel): what bounds it on an H100 is
// operations: 2 * M * D * N float32 operations on the SIMT cores (no
// tensor cores yet), 0.668 ms at 512 -> 256 against about 0.06 ms of
// bytes (the stash and g).  One 64 x 64 tile of dw per CTA and one of S
// contiguous row ranges per blockIdx.z.  The CTA walks its rows
// 32 at a time; each thread decodes a run of 16 columns of one row straight
// from the words into shared memory (one block lookup and one scale per
// run; no (M, D) float32 reconstruction reaches device memory) beside the
// matching g rows, and the CTA accumulates in row order with __fmaf_rn,
// each thread an 8 x 4 register tile.  Each range writes
// its own (D, N) partial to scratch (S * D * N * 4 bytes, allocated by the
// wrapper; S is a function of the shapes only: 8 MiB at S = 16 for layer
// 1), and tree_sum_kernel adds them in the reference's fixed pairwise
// order, so a result is bit-identical from call to call.  No atomics.
//
// Level tables are copied into shared memory: lanes index them with
// different codes, which a kernel parameter in the constant bank
// serializes.
//
// Bit equality of the stash: built with --fmad=false, the products ask for
// their FMAs (__fmaf_rn, mma) and the quantizer keeps its explicit _rn
// roundings.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "quant_common.cuh"
#include "tensor_core.cuh"

namespace {

using quant::Levels;

constexpr int kThreads = 128;
constexpr int kTM = 64;   // rows of dw per CTA
constexpr int kTN = 64;   // columns of dw per CTA
constexpr int kTK = 32;   // rows of one stash tile
constexpr int kRM = 8;    // rows per thread: 8 * ty .. 8 * ty + 7
// thread t: tx = t & 15 owns columns 4 * tx .. 4 * tx + 3, ty = t >> 4 rows

__device__ __forceinline__ void fma_8x4(float acc[kRM][4], const float* a8,
                                        const float* b4) {
  const float4 a0 = *reinterpret_cast<const float4*>(a8);
  const float4 a1 = *reinterpret_cast<const float4*>(a8 + 4);
  const float4 b = *reinterpret_cast<const float4*>(b4);
  const float a[kRM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    acc[i][0] = __fmaf_rn(a[i], b.x, acc[i][0]);
    acc[i][1] = __fmaf_rn(a[i], b.y, acc[i][1]);
    acc[i][2] = __fmaf_rn(a[i], b.z, acc[i][2]);
    acc[i][3] = __fmaf_rn(a[i], b.w, acc[i][3]);
  }
}

// out[row, col] for the thread's 8 x 4 tile at (r0 + 8 ty, c0 + 4 tx),
// masked to rows < m and columns < n.
__device__ __forceinline__ void store_8x4(float* __restrict__ out,
                                          const float acc[kRM][4],
                                          long long r0, int c0, long long m,
                                          int n, int ty, int tx) {
  const int col = c0 + 4 * tx;
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const long long row = r0 + kRM * ty + i;
    if (row >= m) break;
    float* o = out + row * n + col;
    if ((n & 3) == 0 && col + 3 < n) {
      *reinterpret_cast<float4*>(o) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (col + j < n) o[j] = acc[i][j];
    }
  }
}

constexpr int kRun = kTK * kTM / kThreads;  // columns one thread decodes: 16
constexpr int kLD = kTM + 4;  // padded rows: a step's float4 stores spread
static_assert(kTN == kTM && kRun % 4 == 0 && kThreads * kRun == kTK * kTM,
              "a step's decode and g staging share one thread map");

__global__ void __launch_bounds__(kThreads)
dequant_matmul_kernel(const uint32_t* __restrict__ packed,
                      const float* __restrict__ zero,
                      const float* __restrict__ rng,
                      const float* __restrict__ g, float* __restrict__ part,
                      long long m, int d, int n, long long rows_per_split,
                      int G, int bits, Levels lv) {
  __shared__ __align__(16) float xh[kTK][kLD];  // stash rows x dw rows
  __shared__ __align__(16) float gs[kTK][kLD];  // stash rows x dw columns
  __shared__ float table[quant::kMaxLevels];
  quant::load_levels(lv, table);
  __syncthreads();
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const int d0 = blockIdx.x * kTM, n0 = blockIdx.y * kTN;
  const long long begin = blockIdx.z * rows_per_split;
  const long long end =
      begin + rows_per_split < m ? begin + rows_per_split : m;
  const int W = G / (32 / bits);
  const uint32_t mask = static_cast<uint32_t>((1ull << bits) - 1ull);
  // each step, thread t decodes columns c0 .. c0 + kRun - 1 of stash row
  // mm (and stages the same place of g): one block lookup and one scale
  // per run.  D % G == 0 puts bpr blocks in a row; G % D == 0 puts rpb
  // rows in a block
  const int mm = t / (kTM / kRun), c0 = (t % (kTM / kRun)) * kRun;
  const int col0 = d0 + c0;
  const int bpr = d % G == 0 ? d / G : 0, rpb = bpr ? 0 : G / d;
  const bool gvec = (n & 3) == 0 && (reinterpret_cast<uintptr_t>(g) & 15) == 0;
  float acc[kRM][4];
#pragma unroll
  for (int i = 0; i < kRM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (long long mc = begin; mc < end; mc += kTK) {
    const long long row = mc + mm;
    float v[kRun];
#pragma unroll
    for (int c = 0; c < kRun; ++c) v[c] = 0.0f;
    if (row < end && col0 < d) {
      const uint32_t r = static_cast<uint32_t>(row);
      long long block;
      int e;
      if (bpr) {
        const int cb = col0 / G;
        block = static_cast<long long>(r) * bpr + cb;
        e = col0 - cb * G;
      } else {
        const uint32_t q = r / rpb;
        block = q;
        e = static_cast<int>(r - q * rpb) * d + col0;
      }
      int wi = e % W, sh = (e / W) * bits;
      float scale = quant::dequant_scale(rng[block], bits), z = zero[block];
#pragma unroll
      for (int c = 0; c < kRun; ++c) {
        if (col0 + c < d) {
          const uint32_t code = (__ldg(packed + block * W + wi) >> sh) & mask;
          v[c] = quant::dequant_value(code, scale, z, table, lv.n);
        }
        // the next column: the strided layout's next word, or the next
        // block of the row (only when D % G == 0 and the row goes on)
        if (++wi == W) {
          wi = 0;
          sh += bits;
        }
        if (++e == G && col0 + c + 1 < d) {
          e = wi = sh = 0;
          ++block;
          scale = quant::dequant_scale(rng[block], bits);
          z = zero[block];
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kRun; c += 4)
      *reinterpret_cast<float4*>(&xh[mm][c0 + c]) =
          make_float4(v[c], v[c + 1], v[c + 2], v[c + 3]);
#pragma unroll
    for (int c = 0; c < kRun; c += 4) {
      const int gn = n0 + c0 + c;
      float4 gv = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (row < end) {
        const float* gr = g + row * n + gn;
        if (gvec) {
          if (gn < n) gv = *reinterpret_cast<const float4*>(gr);
        } else {
          gv.x = gn < n ? gr[0] : 0.0f;
          gv.y = gn + 1 < n ? gr[1] : 0.0f;
          gv.z = gn + 2 < n ? gr[2] : 0.0f;
          gv.w = gn + 3 < n ? gr[3] : 0.0f;
        }
      }
      *reinterpret_cast<float4*>(&gs[mm][c0 + c]) = gv;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kTK; ++k)
      fma_8x4(acc, &xh[k][kRM * ty], &gs[k][4 * tx]);
    __syncthreads();
  }
  store_8x4(part + static_cast<long long>(blockIdx.z) * d * n, acc, d0, n0, d,
            n, ty, tx);
}

// dw[i] = the fixed-order pairwise sum of part[0..S)[i]: level by level,
// partial 2k plus partial 2k + 1, an odd tail carried unadded (the
// reference's _tree_sum).  Each thread owns one element of every partial.
__global__ void tree_sum_kernel(float* __restrict__ part,
                                float* __restrict__ dw, long long count,
                                int splits) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float* p = part + i;
  int k = splits;
  while (k > 1) {
    const int half = k >> 1;
    for (int j = 0; j < half; ++j)
      p[j * count] = __fadd_rn(p[(2 * j) * count], p[(2 * j + 1) * count]);
    if (k & 1) p[half * count] = p[(k - 1) * count];
    k = half + (k & 1);
  }
  dw[i] = p[0];
}

// ---------------------------------------------------------------- forward
namespace fwd {

// Measurement builds time the product or the quantizer alone
// (scripts/kernel_times.py fused --parts): -DMATMUL_QUANT_PART=1 skips the
// quantizer, 2 the product; such a build's outputs are not the function's.
#ifndef MATMUL_QUANT_PART
#define MATMUL_QUANT_PART 0
#endif
constexpr bool kProduct = MATMUL_QUANT_PART != 2;
constexpr bool kQuantize = MATMUL_QUANT_PART != 1;

constexpr int kThreads = 256;   // 8 warps
constexpr int kBM = 64;         // rows of x (and y) a CTA
constexpr int kChunkMax = 256;  // columns of x a chunk holds at most
constexpr int kQB = 256;        // blocks a quantize batch at most

struct Params {
  const float* x;
  const float* w;
  float* y;
  uint32_t* packed;
  float* zero;
  float* rng;
  long long m;
  int d, n, G, bits;
  uint32_t seed_hash;
  int cw;          // columns a chunk (a multiple of G in chunk mode)
  int xs;          // row stride of the chunk buffer: 4 mod 16 floats
  int chunk_mode;  // quantize each chunk's blocks from its buffer
  int area;        // floats before the stats: chunk buffer, w ring
  int batch;       // blocks a quantize batch (the stats hold 2 * batch)
  int slabs;       // CTAs a row tile, one for each BN columns of y
  int vec_x;       // 16-byte copies of x
  int vec_w;       // 16-byte copies of w
};

// The min and max of nq blocks staged in shared memory (block q's G
// floats at blk(q)) into stats[q] and stats[p.batch + q]: 8 lanes a block,
// a warp 4 blocks at a time (a quarter-warp's float4 reads are 128
// contiguous bytes).  Every thread of the CTA calls it; the caller
// synchronizes before the stats are read.
template <class Blk>
__device__ __forceinline__ void block_stats(const Params& p, int nq, Blk blk,
                                            float* stats) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int q0 = 4 * warp; q0 < nq; q0 += kThreads / 8) {
    const int q = q0 + (lane >> 3), sub = lane & 7;
    float mn = __int_as_float(0x7F800000), mx = -mn;  // +inf, -inf
    if (q < nq) {
      const float* xb = blk(q);
      if ((p.G & 3) == 0) {
        for (int e = 4 * sub; e < p.G; e += 32) {
          const float4 v = *reinterpret_cast<const float4*>(xb + e);
          mn = fminf(fminf(mn, v.x), fminf(fminf(v.y, v.z), v.w));
          mx = fmaxf(fmaxf(mx, v.x), fmaxf(fmaxf(v.y, v.z), v.w));
        }
      } else {
        for (int e = sub; e < p.G; e += 8) {
          mn = fminf(mn, xb[e]);
          mx = fmaxf(mx, xb[e]);
        }
      }
    }
    for (int o = 4; o > 0; o >>= 1) {
      mn = fminf(mn, __shfl_xor_sync(0xFFFFFFFFu, mn, o));
      mx = fmaxf(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, o));
    }
    if (sub == 0 && q < nq) {
      stats[q] = mn;
      stats[p.batch + q] = mx;
    }
  }
}

// Every code word of nq blocks staged in shared memory (block q at blk(q),
// block gb(q) of the stash, its min and max in stats), with the rounding of
// quant_common.cuh: thread t takes words t, t + kThreads, ..., lanes on
// neighbouring words; word 0 of a block also writes its zero and range.
// Every thread of the CTA calls it.
template <class Blk, class Gb>
__device__ __forceinline__ void quantize_words(const Params& p, int nq,
                                               Blk blk, Gb gb,
                                               const float* stats,
                                               const float* table, int n_lv) {
  const int W = p.G / (32 / p.bits);
  const float B = quant::max_level(p.bits);
  for (int i = threadIdx.x; i < nq * W; i += kThreads) {
    const int q = i / W, j = i - q * W;
    const float mn = stats[q], range = __fsub_rn(stats[p.batch + q], mn);
    const float safe = fmaxf(range, quant::kEps);
    const float* xb = blk(q);
    const long long b = gb(q);
    const uint32_t base = static_cast<uint32_t>(b * p.G);
    p.packed[b * W + j] = quant::pack_word(
        [&](int e) {
          const float u = quant::uniform(p.seed_hash, base + e);
          return quant::sr_code(xb[e], mn, safe, B, u, table, n_lv);
        },
        j, W, p.bits);
    if (j == 0) {
      p.zero[b] = mn;
      p.rng[b] = range;
    }
  }
}

// y (m, n) = x (m, d) @ w (d, n) on the tensor cores, and the stash of x.
// A CTA takes kBM rows of x and BN = 8 * NT * WN columns of y (all of them
// when n <= 256).  Warps 0 .. WM * WN - 1 each own a (16 * MT) x (8 * NT)
// tile of y (WM = 4 / MT warps along M); every warp copies and quantizes.
// x comes in chunks of up to kChunkMax columns, w in a ring of S stages of
// KW rows; MINB CTAs share an SM.
template <int NT, int WN, int MT, int KW, int S, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
matmul_quant_kernel(const Params p, const Levels lv) {
  constexpr int WM = 4 / MT;
  constexpr int BN = 8 * NT * WN;
  constexpr int WS = BN % 16 == 0 ? BN + 8 : BN;  // w row stride: 8 mod 16
  static_assert(16 * MT * WM == kBM && WM * WN <= kThreads / 32 && KW % 8 == 0,
                "the warps tile the CTA's rows");

  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                  // the chunk: kBM rows of p.xs floats
  float* ws = smem + kBM * p.xs;     // w ring: S stages of KW rows of WS
  float* stats = smem + p.area;      // a batch's minima, then its maxima
  __shared__ float table[quant::kMaxLevels];
  quant::load_levels(lv, table);     // read after the first barrier

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const long long m0 = static_cast<long long>(blockIdx.x / p.slabs) * kBM;
  const int slab = static_cast<int>(blockIdx.x % p.slabs);
  const int rows = static_cast<int>(p.m - m0 < kBM ? p.m - m0 : kBM);
  const int nbase = slab * BN;
  const bool mma_warp = warp < WM * WN;
  const int wm = warp % WM, wn = warp / WM;
  const long long row_blocks = p.d / p.G;

  float acc[MT][NT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.0f;

  const int n_chunks = p.d == 0 ? 0 : (p.d + p.cw - 1) / p.cw;
  for (int c = 0; c < n_chunks; ++c) {
    const int cb = c * p.cw;
    const int ce = p.d - cb < p.cw ? p.d : cb + p.cw;
    const int n_steps = (ce - cb + KW - 1) / KW;
    // chunk mode: its blocks, bpr a row, rows * bpr in all (at most
    // p.batch), a contiguous share of them for each slab of the row tile
    const int bpr = p.chunk_mode ? (ce - cb) / p.G : 0;
    const int total = rows * bpr;
    const int lo = static_cast<int>(static_cast<long long>(total) * slab /
                                    p.slabs);
    const int nq = static_cast<int>(static_cast<long long>(total) *
                                    (slab + 1) / p.slabs) - lo;
    auto blk = [&](int q) {
      const int lq = lo + q, r = lq / bpr;
      return xs + r * p.xs + (lq - r * bpr) * p.G;
    };
    auto gb = [&](int q) {
      const int lq = lo + q, r = lq / bpr;
      return (m0 + r) * row_blocks + cb / p.G + (lq - r * bpr);
    };
    // the chunk's x at once (it has a buffer of its own): kBM rows of
    // columns cb .. cb + KW * n_steps - 1, zero-filled past the chunk's end
    // and past row m
    const int cols = n_steps * KW;
    if (p.vec_x) {
      for (int i = tid; i < kBM * cols / 4; i += kThreads) {
        const int r = i / (cols / 4), col = i % (cols / 4) * 4;
        const bool ok = r < rows && cb + col < ce;
        tc::cp_async16(xs + r * p.xs + col,
                       ok ? p.x + (m0 + r) * p.d + cb + col : p.x,
                       ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < kBM * cols; i += kThreads) {
        const int r = i / cols, col = i % cols;
        const bool ok = r < rows && cb + col < ce;
        tc::cp_async4(xs + r * p.xs + col,
                      ok ? p.x + (m0 + r) * p.d + cb + col : p.x,
                      ok ? 4 : 0);
      }
    }
    // w: rows cb + s * KW .. + KW - 1 into ring slot s % S,
    // S - 1 k-steps ahead of the product, zero-filled past the
    // chunk's end and past column n
    auto load_w = [&](int s) {
      const int k0 = cb + s * KW;
      float* wd = ws + (s % S) * KW * WS;
      if (p.vec_w) {
        for (int i = tid; i < KW * BN / 4; i += kThreads) {
          const int kk = i / (BN / 4), col = i % (BN / 4) * 4;
          const bool ok = k0 + kk < ce && nbase + col < p.n;
          tc::cp_async16(
              wd + kk * WS + col,
              ok ? p.w + static_cast<long long>(k0 + kk) * p.n + nbase + col
                 : p.w,
              ok ? 16 : 0);
        }
      } else {
        for (int i = tid; i < KW * BN; i += kThreads) {
          const int kk = i / BN, col = i % BN;
          const bool ok = k0 + kk < ce && nbase + col < p.n;
          tc::cp_async4(
              wd + kk * WS + col,
              ok ? p.w + static_cast<long long>(k0 + kk) * p.n + nbase + col
                 : p.w,
              ok ? 4 : 0);
        }
      }
    };

    tc::cp_async_commit();  // the chunk's x: a group of its own
    if (kProduct) {
#pragma unroll
      for (int s = 0; s < S - 1; ++s) {
        if (s < n_steps) load_w(s);
        tc::cp_async_commit();
      }
      for (int s = 0; s < n_steps; ++s) {
        tc::cp_async_wait<S - 2>();
        __syncthreads();  // step s landed; every warp is done with step s - 1
        if (s + S - 1 < n_steps) load_w(s + S - 1);
        tc::cp_async_commit();
        if (mma_warp) {
          // A fragments: rows wm * 16MT + 16mi + g (+8), columns t4 (+4);
          // B fragments: rows t4 (+4), columns wn * 8NT + 8j + g.  Each is
          // split once and used for all of the warp's n-tiles (A) or m-tiles
          // (B).
#pragma unroll
          for (int kk = 0; kk < KW / 8; ++kk) {
            if (s * KW + kk * 8 >= ce - cb) break;  // zero-filled past it
            const float* xa =
                xs + (wm * 16 * MT + g) * p.xs + s * KW + kk * 8 + t4;
            const float* wb = ws + ((s % S) * KW + kk * 8 + t4) * WS +
                              wn * 8 * NT + g;
            uint32_t ahi[MT][4], alo[MT][4];
#pragma unroll
            for (int mi = 0; mi < MT; ++mi) {
              const float* a = xa + mi * 16 * p.xs;
              tc::split_tf32(a[0], ahi[mi][0], alo[mi][0]);
              tc::split_tf32(a[8 * p.xs], ahi[mi][1], alo[mi][1]);
              tc::split_tf32(a[4], ahi[mi][2], alo[mi][2]);
              tc::split_tf32(a[8 * p.xs + 4], ahi[mi][3], alo[mi][3]);
            }
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              uint32_t bh0, bl0, bh1, bl1;
              tc::split_tf32(wb[8 * j], bh0, bl0);
              tc::split_tf32(wb[4 * WS + 8 * j], bh1, bl1);
#pragma unroll
              for (int mi = 0; mi < MT; ++mi) {
                tc::mma_tf32(acc[mi][j], alo[mi], bh0, bh1);  // lo . hi
                tc::mma_tf32(acc[mi][j], ahi[mi], bl0, bl1);  // hi . lo
                tc::mma_tf32(acc[mi][j], ahi[mi], bh0, bh1);  // hi . hi
              }
            }
          }
        }
      }
    }
    tc::cp_async_wait<0>();
    __syncthreads();  // the chunk is whole; every warp is done with it
    if (!kQuantize || !p.chunk_mode) continue;
    block_stats(p, nq, blk, stats);
    __syncthreads();
    quantize_words(p, nq, blk, gb, stats, table, lv.n);
    __syncthreads();  // the next chunk overwrites the buffer and the stats
  }

  if (mma_warp) {
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = nbase + wn * 8 * NT + 8 * j + 2 * t4;
        if (col >= p.n) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long row = m0 + wm * 16 * MT + mi * 16 + g + 8 * h;
          if (row >= p.m) continue;
          float* o = p.y + row * p.n + col;
          const float v0 = acc[mi][j][2 * h], v1 = acc[mi][j][2 * h + 1];
          if (col + 1 >= p.n) {
            o[0] = v0;
          } else if ((p.n & 1) == 0) {
            *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
          } else {
            o[0] = v0;
            o[1] = v1;
          }
        }
      }
  }
  if (!kQuantize || p.chunk_mode) return;

  // Blocks that a chunk does not hold whole (G % D == 0 with G > D, or
  // G > kChunkMax): the blocks whose first element lies in the row tile,
  // a contiguous share for each slab, copied from device memory (mostly L2:
  // just read) into the free shared memory `batch` blocks at a time.
  const long long q_lo = (m0 * p.d + p.G - 1) / p.G;
  const long long q_hi = ((m0 + rows) * p.d + p.G - 1) / p.G;
  const long long lo = q_lo + (q_hi - q_lo) * slab / p.slabs;
  const long long hi = q_lo + (q_hi - q_lo) * (slab + 1) / p.slabs;
  const bool bvec =
      (p.G & 3) == 0 && (reinterpret_cast<uintptr_t>(p.x) & 15) == 0;
  for (long long b0 = lo; b0 < hi; b0 += p.batch) {
    const int nq = static_cast<int>(hi - b0 < p.batch ? hi - b0 : p.batch);
    const float* src = p.x + b0 * p.G;
    if (bvec) {
      for (int i = 4 * tid; i < nq * p.G; i += 4 * kThreads)
        *reinterpret_cast<float4*>(smem + i) =
            *reinterpret_cast<const float4*>(src + i);
    } else {
      for (int i = tid; i < nq * p.G; i += kThreads) smem[i] = src[i];
    }
    __syncthreads();
    auto staged = [&](int q) { return smem + static_cast<long long>(q) * p.G; };
    block_stats(p, nq, staged, stats);
    __syncthreads();
    quantize_words(p, nq, staged, [&](int q) { return b0 + q; }, stats, table,
                   lv.n);
    __syncthreads();  // the next batch overwrites the staged blocks
  }
}

template <int NT, int WN, int MT, int KW, int S, int MINB>
int launch(Params p, const Levels& lv, cudaStream_t stream) {
  constexpr int BN = 8 * NT * WN;
  constexpr int WS = BN % 16 == 0 ? BN + 8 : BN;
  const auto kern = matmul_quant_kernel<NT, WN, MT, KW, S, MINB>;
  p.xs = (p.cw + KW - 1) / KW * KW + 4;
  // the product's chunk buffer and w ring; the stash path off the chunk
  // stages whole blocks in the same floats, one block at least
  p.area = kBM * p.xs + S * KW * WS;
  p.batch = kQB;
  if (!p.chunk_mode) {
    if (p.area < p.G) p.area = p.G;
    p.batch = p.area / p.G < kQB ? p.area / p.G : kQB;
  }
  p.slabs = (p.n + BN - 1) / BN;
  const size_t smem = sizeof(float) * (static_cast<size_t>(p.area) +
                                       2 * static_cast<size_t>(p.batch));
  static const cudaError_t carveout = cudaFuncSetAttribute(
      kern, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (carveout != cudaSuccess) return static_cast<int>(carveout);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long tiles = (p.m + kBM - 1) / kBM;
  kern<<<static_cast<unsigned>(tiles * p.slabs), kThreads, smem, stream>>>(
      p, lv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fwd

}  // namespace

// y (m, n) = x (m, d) @ w (d, n); packed (m*d/G, G*bits/32), zero and rng
// (m*d/G,) the stash of x, bit-equal to quant_pack on x.reshape(-1, G).
extern "C" int matmul_quant(const float* x, const float* w, float* y,
                            uint32_t* packed, float* zero, float* rng,
                            long long m, int d, int n, int group_size,
                            int bits, unsigned int seed, const float* levels,
                            int n_levels, void* stream) {
  fwd::Params p{};
  p.x = x;
  p.w = w;
  p.y = y;
  p.packed = packed;
  p.zero = zero;
  p.rng = rng;
  p.m = m;
  p.d = d;
  p.n = n;
  p.G = group_size;
  p.bits = bits;
  p.seed_hash = quant::fmix32(seed);
  // a chunk holds whole blocks of whole rows when D % G == 0 and G fits
  p.chunk_mode = d > 0 && d % group_size == 0 && group_size <= fwd::kChunkMax;
  // (in chunk mode at most kQB / kBM blocks a row, so a chunk's blocks fit
  // the stats)
  p.cw = p.chunk_mode
             ? std::min({d, group_size * (fwd::kChunkMax / group_size),
                         group_size * (fwd::kQB / fwd::kBM)})
             : std::min(d, fwd::kChunkMax);
  if (p.cw < 1) p.cw = 1;
  p.vec_x = d % 4 == 0 && p.cw % 4 == 0 &&
            reinterpret_cast<uintptr_t>(x) % 16 == 0;
  p.vec_w = n % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const Levels lv = quant::make_levels(levels, n_levels);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 40) return fwd::launch<5, 1, 1, 16, 2, 3>(p, lv, s);
  if (n <= 64) return fwd::launch<8, 1, 1, 16, 4, 2>(p, lv, s);
  return fwd::launch<8, 4, 2, 16, 2, 2>(p, lv, s);
}

// dw (d, n) = dequant(packed)^T (d, m) @ g (m, n) over `splits` row ranges
// of rows_per_split rows; part holds splits * d * n floats of scratch (it
// may be dw itself when splits == 1).
extern "C" int dequant_matmul(const uint32_t* packed, const float* zero,
                              const float* rng, const float* g, float* part,
                              float* dw, long long m, int d, int n,
                              int splits, long long rows_per_split,
                              int group_size, int bits, const float* levels,
                              int n_levels, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>((d + kTM - 1) / kTM),
                  static_cast<unsigned>((n + kTN - 1) / kTN),
                  static_cast<unsigned>(splits));
  dequant_matmul_kernel<<<grid, kThreads, 0, s>>>(
      packed, zero, rng, g, splits == 1 ? dw : part, m, d, n, rows_per_split,
      group_size, bits, quant::make_levels(levels, n_levels));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long count = static_cast<long long>(d) * n;
  tree_sum_kernel<<<static_cast<unsigned>((count + 255) / 256), 256, 0, s>>>(
      part, dw, count, splits);
  return static_cast<int>(cudaGetLastError());
}
