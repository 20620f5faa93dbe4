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
// Backward (dequant_matmul_kernel, namespace bwd).  What bounds it on an
// H100: bytes.  It reads the stash and g once and writes dw: 198 MB at
// 512 -> 256 (0.0592 ms at 3.35 TB/s), 0.0555 ms at 256 -> 256, 0.0154 ms
// at 512 -> 40; the product's 2 * M * D * N = 44.4 GFLOP at 512 -> 256 take
// 0.0449 ms at the bf16 peak of 989 TFLOP/s, the dequantizer's ~4
// operations an element 0.005 ms (chip_smoke.check_fused counts all three).
// The kernel does three bf16 products for the one float32 product (below)
// through mma.sync, decodes every stash element on the CUDA cores and
// splits both operands.  Design:
// 1. Tensor cores: mma.sync m16n8k16 bf16 with f32 accumulators on hi/lo
//    splits of both operands (split_bf16: hi = rn(v), lo = rn(v - hi),
//    ties to even).  Three products, lo.hi, hi.lo, hi.hi, a k16 step
//    (the accumulator below); the dropped terms (lo.lo and the two split
//    residuals) miss at most 3 * 2^-16 |x_hat||g| a term.  The VM levels
//    are arbitrary float32 values, so x_hat is a general float32 and needs
//    the split as g does: where no rounding error cancels (identical stash rows and
//    identical non-negative g rows) one pass misses the kernel's band of
//    1e-4 * (|x_hat|^T |g|) 59x, a split of x_hat alone 33x, of g alone 26x,
//    and the three products stay at 0.20 of it
//    (tests/test_torch_dequant_split.py).  Three TF32 products would keep
//    2^-22 a term but take twice the tensor-core time and, at k8 against
//    k16, twice the accumulator roundings per row.
//    The accumulator: mma.sync adds its products to C truncating, not
//    rounding to nearest (Fasi et al. 2021, "Numerical behavior of NVIDIA
//    tensor cores", for the generations before Hopper: each product
//    aligned to the largest exponent and cut).  In a chain along a range's
//    rows where nothing cancels the cuts add up in proportion to its
//    length: under that model one chain over the slice's 5,312- and
//    10,592-row ranges misses the band 5-6x and 12x.  So each k16 step's
//    three products go into a fresh accumulator (a chain of three from
//    zero, each cut relative to that step's own sum: about 3 * 2^-23 of
//    16 rows' |x_hat||g|), which is then added to the output's float32 sum
//    rounding to nearest (__fadd_rn: 2^-24 of the sum an addition, at most
//    steps / 2 * 2^-24 = 2.0e-5 over a 10,592-row range's 662 steps where
//    nothing cancels).  The budget, relative to |x_hat|^T |g|: the split's
//    dropped terms 3 * 2^-16 = 4.6e-5 at most (1.65e-5 aligned), the
//    steps' cuts 3.6e-7, the sums 2.0e-5, the tree log2(S) * 2^-24 =
//    3.6e-7, inside 1e-4 by the arithmetic.  It costs four FADDs a thread
//    for every three mma.
// 2. Decode and split each x_hat element once: a CTA takes BD rows of dw
//    and every column (N <= 256; wider dw in slabs of 256 on neighbouring
//    CTAs), so the D tiles partition the stash and each element is decoded
//    once over the grid.  Tiles by N (template parameters): 64 x 256 with
//    stages of 32 stash rows (the slice's hidden width), 128 x 64 and
//    128 x 40 with stages of 64 (the slice's classes).
// 3. Roles: the decode and the splits are CUDA-core work that, done by the
//    same warps as the product, adds to it.  So 8 producer warps stage and
//    8 consumer warps multiply, meeting at named barriers: "full" for a
//    stage buffer the producers have written, "free" for one the consumers
//    are done with (two buffers, so stage s + 1 is staged while stage s is
//    multiplied).  Producers copy g, and the stash's words and block
//    stats, by cp.async into a ring of 4 stages (3 for the 128 x 64 tile;
//    16-byte copies, or 4-byte ones when N % 4 != 0 or g is not 16-byte
//    aligned, zero-filled past the range and column N); then they split
//    each g element once for the CTA and decode each x_hat element in runs
//    of 8 columns of a row (8 consecutive words, one shift, one scale) into
//    bf16 hi and lo buffers laid out [stash row][column], which the
//    consumers read with ldmatrix.trans as the A (x_hat^T) and B (g)
//    fragments.  bf16 rows are padded to an odd multiple of 16 bytes, so
//    every 8 x 8 ldmatrix hits 32 distinct banks.  One CTA an SM: 226,304
//    bytes of shared memory at N = 256.
// 4. Traffic: the stash leaves device memory once; g once per D tile (8
//    times at 512 -> 256), but the D tiles of a row range are neighbouring
//    CTAs (blockIdx.x) and run together, so all but the first read hit L2.
//    That re-read is most of what the staging costs at the 256-wide layers
//    (PERF.md).
// 5. Determinism and memory: S contiguous row ranges (blockIdx.y), a
//    function of the shapes only (kernels/fused_matmul.py splits(): about
//    128 CTAs, at most 64 ranges).  Each range writes its own (D, N)
//    partial to scratch (S * D * N * 4 bytes, allocated by the wrapper:
//    8 MiB at the slice's 256-wide layers and 2.5 MiB at 512 -> 40, no more
//    than the SIMT kernel's), each output summed by one warp in row order,
//    and tree_sum_kernel adds the partials in the reference's fixed
//    pairwise order: a result is bit-identical from call to call.  No
//    atomics.
// 6. Every eligible layout: the ring carries the words when G % BD == 0,
//    a block holds whole runs of 8 words and at most MAXW words (64, or 16
//    at N = 256 for shared memory); otherwise a producer reads a run's
//    words, range and zero from device memory as it decodes it, walking the
//    strided layout word by word and into the next block where D % G == 0
//    (G % D == 0 puts G / D rows in a block).
// The rounding differs from the float32 product in order, in the dropped
// terms and in the tensor cores' truncating steps (design 1).  Where hi is not finite, lo
// is not either, and dw is NaN where the float32 product may be finite or
// +-inf: for an infinite g, and for a finite |g| within a relative 2^-9 of
// FLT_MAX, which rounds to inf in bf16.
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

// ---------------------------------------------------------------- backward
namespace bwd {

// Measurement builds time the backward's parts alone
// (scripts/kernel_times.py fused --parts): -DDEQUANT_MATMUL_PART=1 stages
// every stage but runs no product, 2 stages the first two stages and runs
// the product on their buffers for every stage; such a build's dw is not
// the function's.
#ifndef DEQUANT_MATMUL_PART
#define DEQUANT_MATMUL_PART 0
#endif
constexpr bool kProduct = DEQUANT_MATMUL_PART != 1;
constexpr bool kStage = DEQUANT_MATMUL_PART != 2;

constexpr int kCW = 8;          // consumer warps: the product
constexpr int kNB = 2;          // bf16 stage buffers
constexpr int kRun = 8;         // columns a producer thread decodes at a time

// A row of `cols` bf16 padded to an odd multiple of 16 bytes, so the 8 rows
// of an ldmatrix 8 x 8 matrix hit 32 distinct banks.
__host__ __device__ constexpr int padded(int cols) {
  return cols % 16 == 0 ? cols + 8 : cols;
}

// bf16 elements of a stage buffer of ks stash rows: g hi, g lo (ks x LG),
// x_hat hi, x_hat lo (ks x LX), [stash row][column] each.
__host__ __device__ constexpr int buffer_elems(int ks, int bd, int bn) {
  return 2 * ks * (padded(bn) + padded(bd));
}

struct Params {
  const uint32_t* packed;
  const float* zero;
  const float* rng;
  const float* g;
  float* part;  // S partials of d * n floats (dw itself when S == 1)
  long long m, rows_per_split;
  int d, n, G, bits;
  int W;        // words a block
  int vec_g;    // 16-byte copies of g
  int ring;     // the stage's words and block stats come through the ring
  int slot;     // floats a ring slot: g, then (ring) words and stats
};

// Named barriers (0 is __syncthreads): the producers and the consumers
// meet at "buffer full" and "buffer free" barriers, the producers alone at
// kProducers after a stage's copies land.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
constexpr int kFull = 1, kFree = 1 + kNB, kProducers = 1 + 2 * kNB;

// Any layout: the run's words, range and zero read from device memory
// here.  A run walks the strided layout word by word and crosses into the
// next block where D % G == 0; G % D == 0 puts G / D rows in a block.
__device__ __forceinline__ void decode_any(const Params& p, long long row,
                                           int col, const float* table,
                                           int n_lv, float* v) {
  long long b;
  int e;
  if (p.d % p.G == 0) {
    const int cb = col / p.G;
    e = col - cb * p.G;
    b = row * (p.d / p.G) + cb;
  } else {
    const long long rpb = p.G / p.d, q = row / rpb;
    e = static_cast<int>(row - q * rpb) * p.d + col;
    b = q;
  }
  const uint32_t mask = static_cast<uint32_t>((1ull << p.bits) - 1ull);
  int wi = e % p.W, sh = (e / p.W) * p.bits;
  float scale = quant::dequant_scale(__ldg(p.rng + b), p.bits);
  float z = __ldg(p.zero + b);
#pragma unroll
  for (int c = 0; c < kRun; ++c) {
    if (col + c < p.d)
      v[c] = quant::dequant_value((__ldg(p.packed + b * p.W + wi) >> sh) & mask,
                                  scale, z, table, n_lv);
    if (++wi == p.W) {
      wi = 0;
      sh += p.bits;
    }
    if (++e == p.G && c + 1 < kRun && col + c + 1 < p.d) {
      e = wi = sh = 0;
      ++b;
      scale = quant::dequant_scale(__ldg(p.rng + b), p.bits);
      z = __ldg(p.zero + b);
    }
  }
}

// dw (d, n) = x_hat^T @ g over one row range (blockIdx.y) for a tile of BD
// rows of dw and BN columns (blockIdx.x: D tiles first, then slabs of BN
// columns).  Warps 0 .. kCW - 1 run the product: warp w owns rows
// (w % WD) * 16MT .. + 16MT - 1 and columns (w / WD) * 8NT .. + 8NT - 1 of
// the tile.  The PW warps after them stage: g, the words and the block
// stats of stage s + R - 1 by cp.async into ring slot (s + R - 1) % R,
// then stage s split into bf16 hi and lo in buffer s % kNB.
template <int BD, int BN, int KS, int WD, int MT, int NT, int PW, int R,
          int MAXW>
__global__ void __launch_bounds__(32 * (kCW + PW), 1)
dequant_matmul_kernel(const Params p, const Levels lv) {
  constexpr int kCT = 32 * kCW, kPT = 32 * PW, kT = kCT + kPT;
  constexpr int WN = BN / (8 * NT);
  constexpr int LX = padded(BD), LG = padded(BN);
  constexpr int kRuns = KS * BD / kRun;  // runs of a stage
  static_assert(WD * WN == kCW && 16 * MT * WD == BD && kRuns % kPT == 0 &&
                    BN % 8 == 0 && KS % 16 == 0 && R >= 2,
                "the warps tile the CTA; the runs tile a stage");

  extern __shared__ __align__(16) float smem[];
  uint16_t* bufs = reinterpret_cast<uint16_t*>(smem);   // kNB buffers
  float* ring = smem + kNB * buffer_elems(KS, BD, BN) / 2;  // R slots
  __shared__ float table[quant::kMaxLevels];
  quant::load_levels(lv, table);
  __syncthreads();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int dtiles = (p.d + BD - 1) / BD;
  const int d0 = static_cast<int>(blockIdx.x % dtiles) * BD;
  const int n0 = static_cast<int>(blockIdx.x / dtiles) * BN;
  const long long begin = blockIdx.y * p.rows_per_split;
  const long long end =
      begin + p.rows_per_split < p.m ? begin + p.rows_per_split : p.m;
  const int n_stages = static_cast<int>((end - begin + KS - 1) / KS);
  auto buffer = [&](int b) { return bufs + b * buffer_elems(KS, BD, BN); };

  if (warp >= kCW) {
    // ------------------------------------------------------ producers
    const int pt = tid - kCT;
    // stage s's copies into ring slot s % R, zero-filled past `end` and
    // past column n: g, and on the ring path each row's block of words
    // and its range and zero (G % BD == 0: a row's columns of the tile
    // lie in one block)
    auto load = [&](int s) {
      float* slot = ring + (s % R) * p.slot;
      const long long r0 = begin + static_cast<long long>(s) * KS;
      if (p.vec_g) {
        for (int i = pt; i < KS * BN / 4; i += kPT) {
          const int r = i / (BN / 4), c = i % (BN / 4) * 4;
          const bool ok = r0 + r < end && n0 + c < p.n;
          tc::cp_async16(slot + r * BN + c,
                         ok ? p.g + (r0 + r) * p.n + n0 + c : p.g, ok ? 16 : 0);
        }
      } else {
        for (int i = pt; i < KS * BN; i += kPT) {
          const int r = i / BN, c = i % BN;
          const bool ok = r0 + r < end && n0 + c < p.n;
          tc::cp_async4(slot + r * BN + c,
                        ok ? p.g + (r0 + r) * p.n + n0 + c : p.g, ok ? 4 : 0);
        }
      }
      if (!p.ring) return;
      float* words = slot + KS * BN;
      const long long cb = d0 / p.G, bpr = p.d / p.G;
      float* stats = words + KS * p.W;
      const float* src = reinterpret_cast<const float*>(p.packed);
      for (int i = pt; i < KS * p.W / 4; i += kPT) {
        const int r = i / (p.W / 4), c = i % (p.W / 4) * 4;
        const bool ok = r0 + r < end;
        tc::cp_async16(words + r * p.W + c,
                       ok ? src + ((r0 + r) * bpr + cb) * p.W + c : src,
                       ok ? 16 : 0);
      }
      for (int i = pt; i < 2 * KS; i += kPT) {
        const int r = i >> 1;
        const bool ok = r0 + r < end;
        const float* st = (i & 1) ? p.zero : p.rng;
        tc::cp_async4(stats + i, ok ? st + (r0 + r) * bpr + cb : st,
                      ok ? 4 : 0);
      }
    };
    // run j of a stage for this thread: row u / (BD / kRun), columns
    // (u % (BD / kRun)) * kRun .. + kRun - 1 of the tile, u = pt + j * kPT;
    // its place in the block is the same at every stage
    constexpr int kJ = kRuns / kPT;
    int wofs[kJ], shift[kJ];
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int e = (d0 % p.G) + ((pt + j * kPT) % (BD / kRun)) * kRun;
      wofs[j] = e % p.W;
      shift[j] = (e / p.W) * p.bits;
    }
    const uint32_t mask = static_cast<uint32_t>((1ull << p.bits) - 1ull);
    auto stage = [&](int s, int b) {
      const float* slot = ring + (s % R) * p.slot;
      uint16_t* gh = buffer(b);
      uint16_t* gl = gh + KS * LG;
      uint16_t* xh = gl + KS * LG;
      uint16_t* xl = xh + KS * LX;
      // g: each element split once for the CTA
#pragma unroll 4
      for (int i = pt; i < KS * BN / 4; i += kPT) {
        const int r = i / (BN / 4), c = i % (BN / 4) * 4;
        const float4 v = *reinterpret_cast<const float4*>(slot + r * BN + c);
        uint2 h, l;
        tc::split_bf16(v.x, v.y, h.x, l.x);
        tc::split_bf16(v.z, v.w, h.y, l.y);
        *reinterpret_cast<uint2*>(gh + r * LG + c) = h;
        *reinterpret_cast<uint2*>(gl + r * LG + c) = l;
      }
      // x_hat: decoded once, 0 past row `end` and column d
      const uint32_t* words = reinterpret_cast<const uint32_t*>(slot + KS * BN);
      const float* stats = slot + KS * BN + KS * p.W;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int u = pt + j * kPT;
        const int r = u / (BD / kRun), cc = (u % (BD / kRun)) * kRun;
        const long long row = begin + static_cast<long long>(s) * KS + r;
        float v[kRun];
#pragma unroll
        for (int c = 0; c < kRun; ++c) v[c] = 0.0f;
        if (row < end && d0 + cc < p.d) {
          if (p.ring) {  // 8 consecutive words, one shift, one block
            const uint4* w4 =
                reinterpret_cast<const uint4*>(words + r * p.W + wofs[j]);
            const float scale = quant::dequant_scale(stats[2 * r], p.bits);
            const float z = stats[2 * r + 1];
            const uint4 a = w4[0], c4 = w4[1];
            const uint32_t w[kRun] = {a.x, a.y, a.z, a.w, c4.x, c4.y, c4.z, c4.w};
#pragma unroll
            for (int c = 0; c < kRun; ++c)
              v[c] = quant::dequant_value((w[c] >> shift[j]) & mask, scale, z,
                                          table, lv.n);
          } else {
            decode_any(p, row, d0 + cc, table, lv.n, v);
          }
        }
        uint32_t h[kRun / 2], l[kRun / 2];
#pragma unroll
        for (int c = 0; c < kRun / 2; ++c)
          tc::split_bf16(v[2 * c], v[2 * c + 1], h[c], l[c]);
        *reinterpret_cast<uint4*>(xh + r * LX + cc) =
            make_uint4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<uint4*>(xl + r * LX + cc) =
            make_uint4(l[0], l[1], l[2], l[3]);
      }
    };

    const int staged = kStage ? n_stages : (n_stages < kNB ? n_stages : kNB);
#pragma unroll
    for (int s = 0; s < R - 1; ++s) {
      if (s < staged) load(s);
      tc::cp_async_commit();
    }
    for (int s = 0; s < n_stages; ++s) {
      const int b = s % kNB;
      if (s < staged) {
        tc::cp_async_wait<R - 2>();
        // stage s landed for every producer; all are done with slot s - 1
        bar_sync(kProducers, kPT);
        if (s + R - 1 < staged) load(s + R - 1);
        tc::cp_async_commit();
      }
      if (s >= kNB) bar_sync(kFree + b, kT);  // the product of s - kNB is done
      if (s < staged) stage(s, b);
      bar_arrive(kFull + b, kT);
    }
    tc::cp_async_wait<0>();
    return;
  }

  // -------------------------------------------------------- consumers
  const int g = lane >> 2, t4 = lane & 3;
  const int wd = warp % WD, wn = warp / WD;
  float acc[MT][NT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.0f;

  // One k16 step of one m16n8 tile: lo.hi, hi.lo, hi.hi into a fresh
  // accumulator, which is then added to the tile's sum rounding to nearest.
  // The tensor cores truncate where they add (design 1), so each truncating
  // chain is these three products alone, never a range's whole row sum.
  auto step = [](float* c, const uint32_t* ah, const uint32_t* al,
                 uint32_t bh0, uint32_t bh1, uint32_t bl0, uint32_t bl1) {
    float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    tc::mma_bf16(t, al, bh0, bh1);  // lo . hi
    tc::mma_bf16(t, ah, bl0, bl1);  // hi . lo
    tc::mma_bf16(t, ah, bh0, bh1);  // hi . hi
#pragma unroll
    for (int e = 0; e < 4; ++e) c[e] = __fadd_rn(c[e], t[e]);
  };

  // The product of a stage buffer: per k16 step the warp reads its A
  // fragments (x_hat^T: ldmatrix.trans of the [row][column] tile) and, a
  // pair of n-tiles at a time, its B fragments (g, the same), hi and lo,
  // and runs one step for each of its m16n8 tiles.
  auto product = [&](int b) {
    const uint16_t* gh = buffer(b);
    const uint16_t* gl = gh + KS * LG;
    const uint16_t* xh = gl + KS * LG;
    const uint16_t* xl = xh + KS * LX;
#pragma unroll
    for (int kk = 0; kk < KS; kk += 16) {
      // A: matrix q = lane / 8 holds rows k + 8 (q / 2), columns + 8 (q % 2)
      const int a_off = (kk + (lane & 7) + ((lane >> 4) << 3)) * LX +
                        wd * 16 * MT + (((lane >> 3) & 1) << 3);
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        tc::ldmatrix_x4_trans(ah[mi], xh + a_off + 16 * mi);
        tc::ldmatrix_x4_trans(al[mi], xl + a_off + 16 * mi);
      }
      // B: matrix q holds rows k + 8 (q % 2), columns + 8 (q / 2): b0, b1
      // of n-tiles 2jp and 2jp + 1
      const int b_row = (kk + (lane & 7) + (((lane >> 3) & 1) << 3)) * LG +
                        wn * 8 * NT;
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        uint32_t bh[4], bl[4];
        const int off = b_row + 16 * jp + ((lane >> 4) << 3);
        tc::ldmatrix_x4_trans(bh, gh + off);
        tc::ldmatrix_x4_trans(bl, gl + off);
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int t = 0; t < 2; ++t)
            step(acc[mi][2 * jp + t], ah[mi], al[mi], bh[2 * t],
                 bh[2 * t + 1], bl[2 * t], bl[2 * t + 1]);
      }
      if (NT & 1) {  // the last n-tile alone (lanes 16-31 repeat 0-15)
        uint32_t bh[2], bl[2];
        const int off = b_row + 8 * (NT - 1);
        tc::ldmatrix_x2_trans(bh, gh + off);
        tc::ldmatrix_x2_trans(bl, gl + off);
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
          step(acc[mi][NT - 1], ah[mi], al[mi], bh[0], bh[1], bl[0], bl[1]);
      }
    }
  };

  for (int s = 0; s < n_stages; ++s) {
    const int b = s % kNB;
    bar_sync(kFull + b, kT);
    if (kProduct) product(b);
    if (s + kNB < n_stages) bar_arrive(kFree + b, kT);
  }

  float* out = p.part + static_cast<long long>(blockIdx.y) * p.d * p.n;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = n0 + wn * 8 * NT + 8 * j + 2 * t4;
      if (col >= p.n) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = d0 + wd * 16 * MT + 16 * mi + g + 8 * h;
        if (row >= p.d) continue;
        float* o = out + static_cast<long long>(row) * p.n + col;
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

// The ring path needs a row's columns of the tile in one block, whole
// 32-byte runs of words and at most maxw words a block (shared memory).
inline int ring_path(const Params& p, int bd, int maxw) {
  return p.d % p.G == 0 && p.G % bd == 0 && p.W % kRun == 0 && p.W <= maxw &&
         reinterpret_cast<uintptr_t>(p.packed) % 16 == 0;
}

// Floats a ring slot: g, then on the ring path the words and block stats.
__host__ __device__ constexpr int slot_floats(int ks, int bn, int ring,
                                              int w) {
  return ks * bn + (ring ? ks * w + 2 * ks : 0);
}

// Dynamic shared memory of a launch: kNB stage buffers, then r ring slots.
__host__ __device__ constexpr size_t smem_bytes(int ks, int bd, int bn,
                                                int r, int slot) {
  return sizeof(uint16_t) * kNB * buffer_elems(ks, bd, bn) +
         sizeof(float) * r * static_cast<size_t>(slot);
}

template <int BD, int BN, int KS, int WD, int MT, int NT, int PW, int R,
          int MAXW>
int launch(Params p, const Levels& lv, int splits, cudaStream_t stream) {
  const auto kern = dequant_matmul_kernel<BD, BN, KS, WD, MT, NT, PW, R, MAXW>;
  p.ring = ring_path(p, BD, MAXW);
  p.slot = slot_floats(KS, BN, p.ring, p.W);
  const size_t smem = smem_bytes(KS, BD, BN, R, p.slot);
  constexpr size_t max_smem =
      smem_bytes(KS, BD, BN, R, slot_floats(KS, BN, 1, MAXW));
  static const cudaError_t attr = [&] {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    return cudaFuncSetAttribute(kern,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(max_smem));
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const unsigned tiles =
      static_cast<unsigned>((p.d + BD - 1) / BD * ((p.n + BN - 1) / BN));
  kern<<<dim3(tiles, static_cast<unsigned>(splits)), 32 * (kCW + PW), smem,
         stream>>>(p, lv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bwd

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

// Chunking of x: a chunk holds whole blocks of whole rows when D % G == 0
// and G fits (in chunk mode at most kQB / kBM blocks a row, so a chunk's
// blocks fit the stats).
inline void chunking(Params& p) {
  p.chunk_mode = p.d > 0 && p.d % p.G == 0 && p.G <= kChunkMax;
  p.cw = p.chunk_mode
             ? std::min({p.d, p.G * (kChunkMax / p.G), p.G * (kQB / kBM)})
             : std::min(p.d, kChunkMax);
  if (p.cw < 1) p.cw = 1;
}

// The shared memory layout of a CTA of BN columns (p.xs, p.area, p.batch,
// p.slabs) and its dynamic shared memory in bytes.
template <int BN, int KW, int S>
size_t layout(Params& p) {
  constexpr int WS = BN % 16 == 0 ? BN + 8 : BN;
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
  return sizeof(float) * (static_cast<size_t>(p.area) +
                          2 * static_cast<size_t>(p.batch));
}

template <int NT, int WN, int MT, int KW, int S, int MINB>
int launch(Params p, const Levels& lv, cudaStream_t stream) {
  constexpr int BN = 8 * NT * WN;
  const auto kern = matmul_quant_kernel<NT, WN, MT, KW, S, MINB>;
  const size_t smem = layout<BN, KW, S>(p);
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

// The forward's CTA configurations by the width n of y, <NT, WN, MT, KW, S,
// MINB> of fwd::launch: n <= 40, n <= 64, wider.
constexpr int kFwd[3][6] = {
    {5, 1, 1, 16, 2, 3}, {8, 1, 1, 16, 4, 2}, {8, 4, 2, 16, 2, 2}};
static int fwd_index(int n) { return n <= 40 ? 0 : n <= 64 ? 1 : 2; }

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
  fwd::chunking(p);
  p.vec_x = d % 4 == 0 && p.cw % 4 == 0 &&
            reinterpret_cast<uintptr_t>(x) % 16 == 0;
  p.vec_w = n % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const Levels lv = quant::make_levels(levels, n_levels);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr auto& f = kFwd;
  switch (fwd_index(n)) {
    case 0:
      return fwd::launch<f[0][0], f[0][1], f[0][2], f[0][3], f[0][4],
                         f[0][5]>(p, lv, s);
    case 1:
      return fwd::launch<f[1][0], f[1][1], f[1][2], f[1][3], f[1][4],
                         f[1][5]>(p, lv, s);
    default:
      return fwd::launch<f[2][0], f[2][1], f[2][2], f[2][3], f[2][4],
                         f[2][5]>(p, lv, s);
  }
}

// The dynamic shared memory matmul_quant launches with for x (m, d) in
// G-blocks and y of n columns (kernel_contracts states the same sum).
extern "C" long long matmul_quant_smem(int d, int n, int group_size) {
  fwd::Params p{};
  p.d = d;
  p.n = n;
  p.G = group_size;
  fwd::chunking(p);
  constexpr auto& f = kFwd;
  switch (fwd_index(n)) {
    case 0:
      return static_cast<long long>(
          fwd::layout<8 * f[0][0] * f[0][1], f[0][3], f[0][4]>(p));
    case 1:
      return static_cast<long long>(
          fwd::layout<8 * f[1][0] * f[1][1], f[1][3], f[1][4]>(p));
    default:
      return static_cast<long long>(
          fwd::layout<8 * f[2][0] * f[2][1], f[2][3], f[2][4]>(p));
  }
}

// The backward's tiles, {rows of dw, columns, stash rows a stage}, and the
// one dequant_matmul launches for a gradient of n columns.  The wrapper's
// tile() sizes the row ranges and the scratch from the same table without
// the library (on the CPU too); a gpu test holds the two equal.
constexpr int kTiles[3][3] = {{128, 40, 64}, {128, 64, 64}, {64, 256, 32}};
// Each tile's ring: {slots R, words a block at most MAXW on the ring path}.
constexpr int kRing[3][2] = {{4, 64}, {3, 64}, {4, 16}};
static int tile_index(int n) {
  return n <= kTiles[0][1] ? 0 : n <= kTiles[1][1] ? 1 : 2;
}

extern "C" void dequant_matmul_tile(int n, int* tile) {
  for (int i = 0; i < 3; ++i) tile[i] = kTiles[tile_index(n)][i];
}

// The dynamic shared memory dequant_matmul launches with for a stash of
// d-wide rows in G-blocks of `bits`, packed words 16-byte aligned or not,
// and an n-column gradient (out[0]), and the most its kernel is set up for
// (out[1]); kernel_contracts states the same sums.
extern "C" void dequant_matmul_smem(int d, int n, int group_size, int bits,
                                    int aligned, long long* out) {
  bwd::Params p{};
  p.d = d;
  p.n = n;
  p.G = group_size;
  p.bits = bits;
  p.W = group_size / (32 / bits);
  p.packed = reinterpret_cast<const uint32_t*>(
      static_cast<uintptr_t>(aligned ? 0 : 4));
  const int i = tile_index(n);
  const int bd = kTiles[i][0], bn = kTiles[i][1], ks = kTiles[i][2];
  const int r = kRing[i][0], maxw = kRing[i][1];
  out[0] = static_cast<long long>(bwd::smem_bytes(
      ks, bd, bn, r, bwd::slot_floats(ks, bn, bwd::ring_path(p, bd, maxw),
                                      p.W)));
  out[1] = static_cast<long long>(
      bwd::smem_bytes(ks, bd, bn, r, bwd::slot_floats(ks, bn, 1, maxw)));
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
  bwd::Params p{};
  p.packed = packed;
  p.zero = zero;
  p.rng = rng;
  p.g = g;
  p.part = splits == 1 ? dw : part;
  p.m = m;
  p.rows_per_split = rows_per_split;
  p.d = d;
  p.n = n;
  p.G = group_size;
  p.bits = bits;
  p.W = group_size / (32 / bits);
  p.vec_g = n % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
  const Levels lv = quant::make_levels(levels, n_levels);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the tile by the width of dw: <kTiles row, warps along D, m-tiles and
  // n-tiles a consumer warp, producer warps, ring slots, words a block at
  // most on the ring path>
  constexpr auto& t = kTiles;
  constexpr auto& r = kRing;
  int err;
  switch (tile_index(n)) {
    case 0:
      err = bwd::launch<t[0][0], t[0][1], t[0][2], 8, 1, 5, 8, r[0][0],
                        r[0][1]>(p, lv, splits, s);
      break;
    case 1:
      err = bwd::launch<t[1][0], t[1][1], t[1][2], 4, 2, 4, 8, r[1][0],
                        r[1][1]>(p, lv, splits, s);
      break;
    default:
      err = bwd::launch<t[2][0], t[2][1], t[2][2], 2, 2, 8, 8, r[2][0],
                        r[2][1]>(p, lv, splits, s);
  }
  if (err != cudaSuccess || splits == 1) return err;
  const long long count = static_cast<long long>(d) * n;
  tree_sum_kernel<<<static_cast<unsigned>((count + 255) / 256), 256, 0, s>>>(
      part, dw, count, splits);
  return static_cast<int>(cudaGetLastError());
}
