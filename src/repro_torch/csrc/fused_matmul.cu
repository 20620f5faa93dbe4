// Fused matmul + block-wise quantize (forward) and dequantize + matmul
// (backward) for the stash of a layer input x (M, D).
//
// Replaces the TPU kernels of src/repro/kernels/fused_matmul.py:
//   _matmul_quant_kernel (+ _quant_epilogue)
//       y = x @ w; on the first N-tile the x row tile is quantized and
//       packed with global block offsets, so its words, zero and range are
//       those quant_pack writes for the same x (bit for bit)
//   _dequant_matmul_kernel (+ _tree_sum)
//       dw = dequant(packed)^T @ g, one (D, N) partial per row range,
//       combined by a fixed-order pairwise tree
//
// What bounds them on an H100: operations.  Both do 2 * M * D * N float32
// operations on the SIMT cores (no tensor cores, no TF32: the reference
// computes in float32), at 67 TFLOP/s.  At the slice's shapes (M = 169,343)
// layer 1 (512 -> 256) is 44.4 GFLOP, 0.663 ms, against 0.163 ms of bytes;
// layer 0 (256 -> 256) 0.331 ms; in layer 2 (512 -> 40) the product alone
// is 0.104 ms against 0.119 ms of bytes, and the quantizer's ~18
// operations an element make the forward 0.127 ms of operations
// (chip_smoke.py counts both).  The backward moves only the stash and g
// (about 0.06 ms at layer 1).
//
// Design, forward (matmul_quant_kernel): one 64 x 64 tile of y per CTA of
// 128 threads, each thread an 8 x 4 register tile accumulated with
// __fmaf_rn in k order; a 1-D grid with the N-tiles of a row tile side by
// side, so x is read from device memory once and then from L2.  The K loop
// stages x 256 columns at a time (all D when D < 256), transposed (k-major)
// in shared memory, so each thread reads its 8 rows as two float4; w is
// staged 32 rows at a time as float4.  After the product, the CTAs of the
// first N-tile quantize x.  A block is G consecutive elements of the
// row-major x, and a row tile's CTA takes every block whose first element
// lies in its rows, so each stash word is written by exactly one CTA.  It
// copies their span of x (just read, so mostly from L2) into the shared
// memory the product used, as many blocks at a time as fit; 8 lanes per
// block find its min and max, then every thread rounds the codes of whole
// words straight into registers with the rounding of quant_common.cuh and
// writes the words, zero and range.  Staged apart from the product's
// tiles, a block never has to line up with them, so every layout whose
// element count is whole blocks runs (G >= 1024, or G % D == 0 with G / D
// not dividing 64, included).  The epilogue on one CTA in four at
// N = 256 overlaps the other CTAs' products; spread over every N-tile it
// ran in step with them and was slower.  Ragged M and N edges are masked.
// Shared memory: the larger of (64 * min(D, 256) + 2048) * 4 bytes and one
// block with its stats (72 KiB at D >= 256 and G <= 18,430), so three CTAs
// fit on an SM.
//
// Design, backward (dequant_matmul_kernel): one 64 x 64 tile of dw per CTA
// and one of S contiguous row ranges per blockIdx.z.  The CTA walks its rows
// 32 at a time; each thread decodes a run of 16 columns of one row straight
// from the words into shared memory (one block lookup and one scale per
// run; no (M, D) float32 reconstruction reaches device memory) beside the
// matching g rows, and the CTA accumulates in row order.  Each range writes
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
// their FMAs (__fmaf_rn) and the quantizer keeps its explicit _rn roundings.
#include <cuda_runtime.h>
#include <stdint.h>

#include "quant_common.cuh"

namespace {

using quant::Levels;

constexpr int kThreads = 128;
constexpr int kTM = 64;   // rows of y (forward) or of dw (backward) per CTA
constexpr int kTN = 64;   // columns of y or dw per CTA
constexpr int kTK = 32;   // depth of one staged w tile / rows of one stash tile
constexpr int kRM = 8;    // rows per thread: 8 * ty .. 8 * ty + 7
constexpr int kChunk = 256;  // columns of x one forward K step stages
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

__global__ void __launch_bounds__(kThreads)
matmul_quant_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    float* __restrict__ y, uint32_t* __restrict__ packed,
                    float* __restrict__ zero, float* __restrict__ rng,
                    long long m, int d, int n, int chunk, int batch, int G,
                    int bits, uint32_t seed_hash, Levels lv) {
  // the product's tiles, then the epilogue's staged blocks
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                  // chunk x kTM: element (r, c) at c * kTM + r
  float* ws = smem + chunk * kTM;    // kTK x kTN
  __shared__ float table[quant::kMaxLevels];
  quant::load_levels(lv, table);     // read after the K loop's first barrier
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  // a 1-D grid, N-tiles fastest: the CTAs that share an x row tile run
  // side by side and find it in L2
  const int n_tiles = (n + kTN - 1) / kTN;
  const int tile_n = static_cast<int>(blockIdx.x % n_tiles);
  const long long m0 = static_cast<long long>(blockIdx.x / n_tiles) * kTM;
  const int n0 = tile_n * kTN;
  const int rows = static_cast<int>(m - m0 < kTM ? m - m0 : kTM);
  const bool xvec = (d & 3) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool wvec = (n & 3) == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  float acc[kRM][4];
#pragma unroll
  for (int i = 0; i < kRM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < d; k0 += chunk) {
    const int kx = d - k0 < chunk ? d - k0 : chunk;  // columns in this step
    // stage them, transposed; lanes walk rows so the stores are
    // conflict-free, and each lane's float4 runs along its row
    if (xvec) {
      for (int idx = t; idx < kTM * (kx >> 2); idx += kThreads) {
        const int r = idx & (kTM - 1), c = (idx / kTM) * 4;
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (r < rows)
          v = *reinterpret_cast<const float4*>(x + (m0 + r) * d + k0 + c);
        xs[c * kTM + r] = v.x;
        xs[(c + 1) * kTM + r] = v.y;
        xs[(c + 2) * kTM + r] = v.z;
        xs[(c + 3) * kTM + r] = v.w;
      }
    } else {
      for (int idx = t; idx < kTM * kx; idx += kThreads) {
        const int r = idx & (kTM - 1), c = idx / kTM;
        xs[c * kTM + r] = r < rows ? x[(m0 + r) * d + k0 + c] : 0.0f;
      }
    }
    for (int kk0 = 0; kk0 < kx; kk0 += kTK) {
      const int kc = kx - kk0 < kTK ? kx - kk0 : kTK;
      if (wvec) {
        for (int idx = t; idx < kTK * kTN / 4; idx += kThreads) {
          const int kk = idx / (kTN / 4), c = (idx % (kTN / 4)) * 4;
          float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if (kk < kc && n0 + c < n)
            v = *reinterpret_cast<const float4*>(
                w + static_cast<long long>(k0 + kk0 + kk) * n + n0 + c);
          *reinterpret_cast<float4*>(ws + kk * kTN + c) = v;
        }
      } else {
        for (int idx = t; idx < kTK * kTN; idx += kThreads) {
          const int kk = idx / kTN, gn = n0 + (idx & (kTN - 1));
          ws[idx] = (kk < kc && gn < n)
                        ? w[static_cast<long long>(k0 + kk0 + kk) * n + gn]
                        : 0.0f;
        }
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kc; ++kk)
        fma_8x4(acc, xs + (kk0 + kk) * kTM + kRM * ty, ws + kk * kTN + 4 * tx);
      __syncthreads();
    }
  }
  store_8x4(y, acc, m0, n0, m, n, ty, tx);
  if (tile_n != 0) return;

  // the quantize epilogue, on the first N-tile: the blocks whose first
  // element lies in the row tile go through shared memory `batch` blocks
  // at a time: every thread copies the batch's span of x (contiguous, so
  // coalesced float4 loads), 8 lanes per block find its min and max, and
  // every thread rounds whole words, lanes on neighbouring words.
  const long long q_lo = (m0 * d + G - 1) / G;
  const long long q_hi = ((m0 + rows) * d + G - 1) / G;
  const int warp = t >> 5, lane = t & 31;
  const int W = G / (32 / bits);
  const float B = quant::max_level(bits);
  const bool bvec = (G & 3) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  float* stats = smem + batch * G;  // the batch's minima, then its maxima
  for (long long b0 = q_lo; b0 < q_hi; b0 += batch) {
    const int nq = static_cast<int>(q_hi - b0 < batch ? q_hi - b0 : batch);
    const float* src = x + b0 * G;
    if (bvec) {
      for (int i = 4 * t; i < nq * G; i += 4 * kThreads)
        *reinterpret_cast<float4*>(smem + i) =
            *reinterpret_cast<const float4*>(src + i);
    } else {
      for (int i = t; i < nq * G; i += kThreads) smem[i] = src[i];
    }
    __syncthreads();
    // min and max: 8 lanes per block, so a warp takes 4 blocks at a time
    // (a quarter-warp's float4 reads are 128 contiguous bytes)
    for (int q0 = 4 * warp; q0 < nq; q0 += kThreads / 8) {
      const int q = q0 + (lane >> 3), sub = lane & 7;
      float mn = __int_as_float(0x7F800000), mx = -mn;  // +inf, -inf
      if (q < nq) {
        const float* xb = smem + q * G;
        if ((G & 3) == 0) {
          for (int e = 4 * sub; e < G; e += 32) {
            const float4 v = *reinterpret_cast<const float4*>(xb + e);
            mn = fminf(fminf(mn, v.x), fminf(fminf(v.y, v.z), v.w));
            mx = fmaxf(fmaxf(mx, v.x), fmaxf(fmaxf(v.y, v.z), v.w));
          }
        } else {
          for (int e = sub; e < G; e += 8) {
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
        stats[batch + q] = mx;
      }
    }
    __syncthreads();
    for (int idx = t; idx < nq * W; idx += kThreads) {
      const int q = idx / W, j = idx - q * W;
      const float mn = stats[q], range = __fsub_rn(stats[batch + q], mn);
      const float safe = fmaxf(range, quant::kEps);
      const float* xb = smem + q * G;
      const long long b = b0 + q;
      const uint32_t base = static_cast<uint32_t>(b * G);
      packed[b * W + j] = quant::pack_word(
          [&](int e) {
            const float u = quant::uniform(seed_hash, base + e);
            return quant::sr_code(xb[e], mn, safe, B, u, table, lv.n);
          },
          j, W, bits);
      if (j == 0) {
        zero[b] = mn;
        rng[b] = range;
      }
    }
    __syncthreads();  // the next batch overwrites the staged blocks
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

}  // namespace

// y (m, n) = x (m, d) @ w (d, n); packed (m*d/G, G*bits/32), zero and rng
// (m*d/G,) the stash of x, bit-equal to quant_pack on x.reshape(-1, G).
extern "C" int matmul_quant(const float* x, const float* w, float* y,
                            uint32_t* packed, float* zero, float* rng,
                            long long m, int d, int n, int group_size,
                            int bits, unsigned int seed, const float* levels,
                            int n_levels, void* stream) {
  const int chunk = d < kChunk ? d : kChunk;
  // the epilogue stages `batch` blocks and their two stats in the same
  // shared memory as the product's tiles (one block at least)
  const int tiles = chunk * kTM + kTK * kTN;
  const int floats = tiles > group_size + 2 ? tiles : group_size + 2;
  const int batch = floats / (group_size + 2);
  const size_t smem = static_cast<size_t>(floats) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        matmul_quant_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned grid = static_cast<unsigned>(((m + kTM - 1) / kTM) *
                                             ((n + kTN - 1) / kTN));
  matmul_quant_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      x, w, y, packed, zero, rng, m, d, n, chunk, batch, group_size, bits,
      quant::fmix32(seed), quant::make_levels(levels, n_levels));
  return static_cast<int>(cudaGetLastError());
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
