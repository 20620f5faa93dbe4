// Causal or full online-softmax attention (flash attention): bf16 inputs on
// Hopper's tensor cores, float32 inputs on the SIMT cores.
//
// Replaces the TPU kernel of src/repro/kernels/flash_attention.py:
//   _flash_kernel  per (bh, query tile): running max m, denominator l and
//                  accumulator acc over the key tiles in ascending order;
//                  s = q k^T (scaled), p = exp(s - m_new),
//                  corr = exp(m_old - m_new), l = l corr + sum p,
//                  acc = acc corr + p v; out = acc / max(l, 1e-30).
//                  Key tiles strictly above the causal diagonal are skipped.
// It also computes what repro.models.attention.online_attention computes on
// the prefill path: q_offset (absolute position of query row 0) and kv_len
// (valid keys) mask like the reference's chunk scan.  Ragged Sq and Skv are
// masked here, so nothing is padded outside.  Masked scores are the
// reference's finite NEG_INF = -1e30, so a fully masked tile never makes a
// NaN and the first tile's correction exp(-1e30 - m) is exactly 0.  The
// dtype picks the kernel; both are written by hand and neither falls back
// to the other.
//
// bf16 (the serving prefill): a FlashAttention-2 dataflow on
// mma.sync m16n8k16 bf16 x bf16 -> f32.
// What bounds it on an H100: bytes.  The function is 4 * Dh flops a kept
// (query, key) pair: at the serving prefill shape (80 x 1000 x 128, causal)
// 20.5 GFLOP, 0.0207 ms at 989 TFLOP/s, against 82 MB of q, k, v and out,
// 0.0245 ms at 3.35 TB/s.  The kernel does 6 * Dh a pair on the tensor cores
// (P V twice for the split P, below): 30.7 GFLOP, 0.031 ms; that extra
// P V pass is the kernel's own cost, not the function's.
// - A CTA is 4 warps and owns one (bh, 64-row query tile), heaviest causal
//   tiles launched first; each warp owns 16 query rows.  Q is copied once
//   into shared memory and held in registers as A fragments (ldmatrix).
// - K and V stream through a double-buffered ring of 64-key tiles filled by
//   cp.async (16 bytes a thread; zero-filled past Sq and Skv, the mask
//   handles those rows; plain loads when a pointer is not 16-byte aligned).
//   Rows are padded by 16 bytes, so every ldmatrix hits 32 distinct banks.
//   At Dh = 128: 17 KB of Q and 2 x 34 KB of K and V, two CTAs an SM.
// - S = Q K^T on the tensor cores, bf16 operands, f32 sums: K stored
//   [key][dh] is the .col B operand as it stands.  A bf16 x bf16 product is
//   exact in f32, so only the order of the sum differs from the reference.
//   The scale multiplies the f32 sum after it, for both values of scale_q:
//   with scale_q the reference rounds q * scale in float32 first, so s
//   differs from it by a few float32 ulps.
// - The online softmax stays in registers: a thread holds 2 rows of each
//   m16n8 fragment; the row max goes across the quad by shuffles, each
//   thread keeps its part of l, and the quad sums l once at the end.
// - P V with P split in two bf16 parts, hi = rn(p) and lo = rn(p - hi) (the
//   subtraction is exact), both through the same mma into one f32
//   accumulator, so a term misses at most 2^-16 p (one bf16 P, up to
//   2^-8 p, is what a bf16 attention computes: another function).  The C
//   fragments of two adjacent m16n8 S tiles are the A fragment of one
//   m16n8k16, so P never goes through shared memory; V stored [key][dh] is
//   the B operand through ldmatrix.trans.
// - Each warp stages its 16 x Dh bf16 outputs in its own Q rows and stores
//   16 bytes a thread (out must be 16-byte aligned).  No atomics: repeated
//   calls give the same bits.
//
// float32: SIMT float32 throughout, the reference's arithmetic (no bf16 or
// TF32 products, P stays float32), bound by the card's 67 TFLOP/s float32
// rate.  One CTA of 256 threads per (bh, 64-row query tile).  Q of the tile
// is staged once in shared memory (transposed, padded stride 65: no bank
// conflicts); each 64-row key tile is staged as K^T and V.  Thread
// (rg, cg) = (tid / 16, tid % 16) owns query rows rg + 16 i (i < 4): it
// computes their scores against keys cg + 16 j (j < 4), reduces the row max
// and sum over the 16 threads of its row group with shuffles, writes P into
// the K^T buffer (K is consumed by then), and accumulates acc for columns
// cg + 16 j of its rows (j < Dh / 16) in registers.  With scale_q the scale
// multiplies q in float32 before the product (the reference's
// (q * scale) . k order) instead of the scores after it (the Pallas
// kernel's (q . k) * scale order).
//
// Built with --fmad=false (as every source of the port): the products ask
// for their FMAs (__fmaf_rn), and expf is the accurate one, not __expf.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int kBlockQ = 64;    // query rows per CTA
constexpr int kBlockK = 64;    // keys per staged tile
constexpr float kNegInf = -1e30f;

// Which keys a query tile reads: tiles [0, n_kt) of kBlockK keys.
__device__ __forceinline__ int key_tiles(int q0, int sq, int skv, int causal,
                                         int q_offset, int kv_len) {
  const int kv_end = kv_len < skv ? kv_len : skv;
  int n_kt = (kv_end + kBlockK - 1) / kBlockK;
  if (causal) {
    const int last_row = (q0 + kBlockQ < sq ? q0 + kBlockQ : sq) - 1;
    const int last_k = (q_offset + last_row) / kBlockK + 1;
    n_kt = n_kt < last_k ? n_kt : last_k;
  }
  return n_kt;
}

// ------------------------------------------------------------ float32, SIMT
constexpr int kThreads = 256;  // 16 row groups x 16 column groups
constexpr int kLd = 65;        // padded stride of the transposed tiles

template <int DH>
constexpr size_t smem_bytes() {
  // Q^T [DH][kLd], K^T [DH][kLd] reused as P [kBlockQ][kLd], V [kBlockK][DH]
  return sizeof(float) * (DH * kLd + (DH > kBlockQ ? DH : kBlockQ) * kLd +
                          kBlockK * DH);
}

// Max and sum over the 16 lanes of a row group (lanes xor 8, 4, 2, 1 stay
// inside the half warp).
__device__ __forceinline__ float group_max(float x) {
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xFFFFFFFFu, x, o));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
  for (int o = 8; o > 0; o >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(0xFFFFFFFFu, x, o));
  return x;
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 int sq, int skv, int causal, int q_offset, int kv_len,
                 float scale, int scale_q) {
  constexpr int kCols = DH / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                                // Q^T
  float* kp = qs + DH * kLd;                       // K^T, then P
  float* vs = kp + (DH > kBlockQ ? DH : kBlockQ) * kLd;  // V
  const int tid = threadIdx.x;
  const int rg = tid >> 4, cg = tid & 15;
  const int qt = gridDim.x - 1 - blockIdx.x;      // heaviest tiles first
  const int q0 = qt * kBlockQ;
  const long long bh = blockIdx.y;
  const float* qb = q + (bh * sq + q0) * DH;
  const float* kb = k + bh * skv * DH;
  const float* vb = v + bh * skv * DH;

  for (int e = tid; e < kBlockQ * DH; e += kThreads) {
    const int r = e / DH, d = e % DH;
    float x = q0 + r < sq ? qb[static_cast<long long>(r) * DH + d] : 0.0f;
    if (scale_q) x = __fmul_rn(x, scale);
    qs[d * kLd + r] = x;
  }

  const int kv_end = kv_len < skv ? kv_len : skv;
  const int n_kt = key_tiles(q0, sq, skv, causal, q_offset, kv_len);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.0f;
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // Q staged; the last tile's P and V consumed
    for (int e = tid; e < kBlockK * DH; e += kThreads) {
      const int c = e / DH, d = e % DH;
      const bool in = k0 + c < skv;
      const long long off = static_cast<long long>(k0 + c) * DH + d;
      kp[d * kLd + c] = in ? kb[off] : 0.0f;
      vs[c * DH + d] = in ? vb[off] : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[d * kLd + rg + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = kp[d * kLd + cg + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = __fmaf_rn(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_offset + q0 + rg + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + cg + 16 * j;
        const float x = scale_q ? s[i][j] : __fmul_rn(s[i][j], scale);
        const bool ok = kpos < kv_end && (!causal || kpos <= qpos);
        s[i][j] = ok ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      const float corr = expf(__fsub_rn(m[i], m_new));
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(__fsub_rn(s[i][j], m_new));
        sum = __fadd_rn(sum, s[i][j]);
      }
      l[i] = __fadd_rn(__fmul_rn(l[i], corr), group_sum(sum));
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] = __fmul_rn(acc[i][j], corr);
    }
    __syncthreads();  // every thread is done with K^T: P takes its place
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) kp[(rg + 16 * i) * kLd + cg + 16 * j] = s[i][j];
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBlockK; ++c) {
      float pv[4], vv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = kp[(rg + 16 * i) * kLd + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) vv[j] = vs[c * DH + cg + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          acc[i][j] = __fmaf_rn(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg + 16 * i;
    if (q0 + r >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* o = out + (bh * sq + q0 + r) * DH;
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      o[cg + 16 * j] = __fdiv_rn(acc[i][j], denom);
  }
}

// ------------------------------------------------- bf16, tensor cores
using bf16 = __nv_bfloat16;
constexpr int kTcWarps = 4;              // 16 query rows a warp
constexpr int kTcThreads = 32 * kTcWarps;

template <int DH>
constexpr size_t tc_smem_bytes() {
  // Q, then 2 ring slots of K and V: 64 rows of DH + 8 bf16 each
  return sizeof(bf16) * 5 * kBlockQ * (DH + 8);
}

using tc::cp_async16;
using tc::cp_async_commit;
using tc::cp_async_wait;
using tc::ldmatrix_x4;
using tc::ldmatrix_x4_trans;
using tc::mma_bf16;
using tc::pack_bf16;
using tc::split_bf16;

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xFFFFFFFFu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xFFFFFFFFu, x, 2));
}

// Fragment coordinates (mma.sync m16n8k16, PTX ISA): lane = 4 g + t holds
// S/acc rows g and g + 8 at columns 2t and 2t + 1 of each m16n8 tile.
template <int DH>
__global__ void __launch_bounds__(kTcThreads, 2)
flash_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ out, int sq,
                  int skv, int causal, int q_offset, int kv_len, float scale,
                  int vec_in) {
  constexpr int LD = DH + 8;          // shared row stride: 16 bytes of pad
  constexpr int TILE = kBlockQ * LD;  // one 64-row tile
  constexpr int KS = DH / 16;         // k16 steps of Q K^T
  constexpr int NT = DH / 8;          // n8 tiles of the accumulator
  constexpr int CPR = DH / 8;         // 16-byte chunks a row
  static_assert(kBlockQ == kBlockK && kBlockQ == 16 * kTcWarps, "tiles");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ring = qs + TILE;  // slot s: K at ring + 2 s TILE, V after it
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int q0 = qt * kBlockQ;
  const long long bh = blockIdx.y;
  const bf16* kb = k + bh * skv * DH;
  const bf16* vb = v + bh * skv * DH;

  // Rows [0, 64) of src (rows_left of them real) into a tile; the rest 0.
  auto copy_tile = [&](bf16* dst, const bf16* src, int rows_left) {
    if (vec_in) {
      for (int c = tid; c < kBlockQ * CPR; c += kTcThreads) {
        const int r = c / CPR, col = c % CPR * 8;
        const bool in = r < rows_left;
        cp_async16(dst + r * LD + col, in ? src + r * DH + col : src,
                   in ? 16 : 0);
      }
    } else {
      for (int e = tid; e < kBlockQ * DH; e += kTcThreads) {
        const int r = e / DH, col = e % DH;
        dst[r * LD + col] =
            r < rows_left ? src[r * DH + col] : __float2bfloat16_rn(0.0f);
      }
    }
  };
  auto load_kv = [&](int kt) {
    const int k0 = kt * kBlockK;
    bf16* dst = ring + (kt & 1) * 2 * TILE;
    copy_tile(dst, kb + static_cast<long long>(k0) * DH, skv - k0);
    copy_tile(dst + TILE, vb + static_cast<long long>(k0) * DH, skv - k0);
  };

  const int kv_end = kv_len < skv ? kv_len : skv;
  const int n_kt = key_tiles(q0, sq, skv, causal, q_offset, kv_len);
  const int row_w = q0 + 16 * warp;              // this warp's first row
  const int qpos0 = q_offset + row_w + g, qpos1 = qpos0 + 8;

  copy_tile(qs, q + (bh * sq + q0) * DH, sq - q0);
  load_kv(0);
  cp_async_commit();

  uint32_t qf[KS][4];
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;

  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) load_kv(kt + 1);  // into the slot freed last tile
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile kt (and Q) landed for every thread
    if (kt == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        ldmatrix_x4(qf[ks], qs + (16 * warp + (lane & 15)) * LD + 16 * ks +
                                (lane >> 4) * 8);
    }
    const bf16* ksm = ring + (kt & 1) * 2 * TILE;
    const bf16* vsm = ksm + TILE;

    // S = Q K^T: n-tiles 2np, 2np + 1 (keys 16 np ..) from one ldmatrix
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, ksm + (16 * np + (lane & 7) + (lane >> 4) * 8) * LD +
                           16 * ks + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qf[ks], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qf[ks], b[2], b[3]);
      }
    }

    // scale, mask, online softmax (rows g and g + 8 of this warp)
    const int k0 = kt * kBlockK;
    const bool whole = k0 + kBlockK <= kv_end &&
                       (!causal || k0 + kBlockK - 1 <= q_offset + row_w);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x0 = __fmul_rn(s[j][e], scale);
        float x1 = __fmul_rn(s[j][2 + e], scale);
        if (!whole) {
          const int kpos = k0 + 8 * j + 2 * t + e;
          const bool in = kpos < kv_end;
          if (!in || (causal && kpos > qpos0)) x0 = kNegInf;
          if (!in || (causal && kpos > qpos1)) x1 = kNegInf;
        }
        s[j][e] = x0;
        s[j][2 + e] = x1;
        mx0 = fmaxf(mx0, x0);
        mx1 = fmaxf(mx1, x1);
      }
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float corr0 = expf(__fsub_rn(m0, mn0));
    const float corr1 = expf(__fsub_rn(m1, mn1));
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] = expf(__fsub_rn(s[j][e], mn0));
        s[j][2 + e] = expf(__fsub_rn(s[j][2 + e], mn1));
        sum0 = __fadd_rn(sum0, s[j][e]);
        sum1 = __fadd_rn(sum1, s[j][2 + e]);
      }
    }
    l0 = __fadd_rn(__fmul_rn(l0, corr0), sum0);
    l1 = __fadd_rn(__fmul_rn(l1, corr1), sum1);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      acc[j][0] = __fmul_rn(acc[j][0], corr0);
      acc[j][1] = __fmul_rn(acc[j][1], corr0);
      acc[j][2] = __fmul_rn(acc[j][2], corr1);
      acc[j][3] = __fmul_rn(acc[j][3], corr1);
    }

    // acc += P V, P = hi + lo: keys 16 kk .. 16 kk + 15 a step, dh n-tiles
    // 2dp and 2dp + 1 from one ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < KS; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vsm + (16 * kk + (lane & 7) +
                                    ((lane >> 3) & 1) * 8) * LD +
                                 16 * dp + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], ph, b[0], b[1]);
        mma_bf16(acc[2 * dp], pl, b[0], b[1]);
        mma_bf16(acc[2 * dp + 1], ph, b[2], b[3]);
        mma_bf16(acc[2 * dp + 1], pl, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this slot before its refill
  }
  cp_async_wait<0>();

  // out = acc / max(l, 1e-30): l summed over the quad, the same order in
  // each of its lanes; staged in this warp's Q rows (in registers by now)
  l0 = __fadd_rn(l0, __shfl_xor_sync(0xFFFFFFFFu, l0, 1));
  l0 = __fadd_rn(l0, __shfl_xor_sync(0xFFFFFFFFu, l0, 2));
  l1 = __fadd_rn(l1, __shfl_xor_sync(0xFFFFFFFFu, l1, 1));
  l1 = __fadd_rn(l1, __shfl_xor_sync(0xFFFFFFFFu, l1, 2));
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  bf16* so = qs + 16 * warp * LD;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    *reinterpret_cast<uint32_t*>(so + g * LD + 8 * j + 2 * t) = pack_bf16(
        __fdiv_rn(acc[j][0], d0), __fdiv_rn(acc[j][1], d0));
    *reinterpret_cast<uint32_t*>(so + (g + 8) * LD + 8 * j + 2 * t) =
        pack_bf16(__fdiv_rn(acc[j][2], d1), __fdiv_rn(acc[j][3], d1));
  }
  __syncwarp();
  bf16* ob = out + (bh * sq + row_w) * DH;
  for (int c = lane; c < 16 * CPR; c += 32) {
    const int r = c / CPR, col = c % CPR * 8;
    if (row_w + r < sq)
      *reinterpret_cast<uint4*>(ob + r * DH + col) =
          *reinterpret_cast<const uint4*>(so + r * LD + col);
  }
}

struct Args {
  const void *q, *k, *v;
  void* out;
  int bh, sq, skv, causal, q_offset, kv_len;
  float scale;
  int scale_q;
  cudaStream_t stream;
};

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Lets `kern` take `smem` bytes of dynamic shared memory: set once for each
// kernel instantiation (a function-local static of the caller), its error
// kept for every later launch.
cudaError_t allow_smem(const void* kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int DH>
int launch_f32(const Args& a) {
  constexpr size_t smem = smem_bytes<DH>();
  static const cudaError_t attr_err = allow_smem(
      reinterpret_cast<const void*>(flash_f32_kernel<DH>), smem);
  if (attr_err) return static_cast<int>(attr_err);
  const dim3 grid((a.sq + kBlockQ - 1) / kBlockQ, a.bh);
  flash_f32_kernel<DH><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.out), a.sq, a.skv,
      a.causal, a.q_offset, a.kv_len, a.scale, a.scale_q);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_bf16(const Args& a) {
  constexpr size_t smem = tc_smem_bytes<DH>();
  static const cudaError_t attr_err = allow_smem(
      reinterpret_cast<const void*>(flash_bf16_kernel<DH>), smem);
  if (attr_err) return static_cast<int>(attr_err);
  if (!aligned16(a.out)) return static_cast<int>(cudaErrorMisalignedAddress);
  const dim3 grid((a.sq + kBlockQ - 1) / kBlockQ, a.bh);
  const int vec_in = aligned16(a.q) && aligned16(a.k) && aligned16(a.v);
  flash_bf16_kernel<DH><<<grid, kTcThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.out), a.sq, a.skv,
      a.causal, a.q_offset, a.kv_len, a.scale, vec_in);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch(const Args& a, int is_bf16) {
  return is_bf16 ? launch_bf16<DH>(a) : launch_f32<DH>(a);
}

}  // namespace

// q (bh, sq, dh), k/v (bh, skv, dh), out (bh, sq, dh), all float32
// (is_bf16 = 0) or all bfloat16 (is_bf16 = 1), contiguous; a bf16 out
// 16-byte aligned (the wrapper allocates it).  scale_q picks the float32
// kernel's scale order; the bf16 kernel scales the scores.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int bh, int sq, int skv, int dh,
                               int is_bf16, int causal, int q_offset,
                               int kv_len, float scale, int scale_q,
                               void* stream) {
  const Args a{q, k, v, out, bh, sq, skv, causal, q_offset, kv_len, scale,
               scale_q, static_cast<cudaStream_t>(stream)};
  switch (dh) {
    case 16:
      return launch<16>(a, is_bf16);
    case 32:
      return launch<32>(a, is_bf16);
    case 64:
      return launch<64>(a, is_bf16);
    case 128:
      return launch<128>(a, is_bf16);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
