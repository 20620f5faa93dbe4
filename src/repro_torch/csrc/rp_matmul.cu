// Seeded Rademacher random-projection matmul on Hopper's tensor cores:
// out = (x @ S) * scale, S(k, n) = +-1 from the salted murmur3 hash of a
// counter, never stored in device memory.
//
// Replaces the TPU kernel src/repro/kernels/rp_matmul.py:_rp_kernel
// (rp_project_call, irp_project_call).  R (D x r) has element (d, p) =
// sign(hash(d * r + p)) / sqrt(r), exactly as
// repro_torch.core.random_projection.rp_matrix: RP multiplies by R
// (counter k * r + n), IRP by R^T (counter n * r + k); scale = 1/sqrt(r).
//
// What bounds it on an H100: bytes.  A call moves M * (K + N) * 4 bytes:
// at the main path's M = 169,343 rows that is 390,166,272 B (0.1165 ms at
// 3.35 TB/s) at 512 <-> 64 and 195,083,136 B (0.0582 ms) at 256 <-> 32.
// The product, 2 * M * K * N = 11.1 GFLOP at 512 <-> 64, is done twice in
// TF32 (below): 22.2 GFLOP, about 0.045 ms at 495 TFLOP/s.
//
// Design, against the four limits of a plain float32 SIMT kernel:
// 1. Tensor cores instead of SIMT FMAs: mma.sync m16n8k8 TF32 with f32
//    accumulators.  S is exact as +-1.0 in TF32, and scale is applied once,
//    to the f32 sums.  x is split in two TF32 parts, hi = rna(x) and
//    lo = rna(x - hi) (the subtraction is exact), and both products go into
//    the same accumulators, so a term misses at most 2^-22 |x|.  One TF32
//    pass (2^-11 a term, about 1e-3 over K = 512) would break the 2e-4 band
//    the kernel is held to against the float32 product.
// 2. Loads overlap the product: x streams through a double-buffered ring
//    of tiles of 128 rows x KW columns, filled by cp.async (16 bytes a
//    thread, zero-filled past the ragged row and column edges; 4-byte
//    copies when K % 4 != 0 or x is not 16-byte aligned) while the product
//    runs on the other tile.  KW is 64, or 32 when K <= 32, so a short row
//    does not leave half of each stage empty.  Rows are padded by 4
//    floats, so the fragment loads of a warp hit 32 distinct banks.  When
//    K <= KW a tile holds whole rows and serves every column chunk (IRP).
// 3. Signs hashed once per CTA, not per CTA and K step: each CTA hashes its
//    K x N slice of S into a bit table in shared memory (one bit an
//    element, 4 KB at 512 x 64), laid out in fragment order, so a lane
//    reads one 32-bit word for 16 (or 32) k and builds its B registers as
//    +-1.0f with a shift and a mask.  The grid is persistent (as many CTAs
//    as shared memory lets an SM hold: two at 64-column stages, three at
//    32) and each CTA walks row tiles with a stride of gridDim.x:
//    about 8.6M hashes a call at 512 x 64 instead of 87M.  A slice of more
//    than 4096 words (K > 2048 at 64 columns) is hashed in windows of K,
//    again for each row tile.  The launch sizes shared memory for a full
//    table, so the CTAs an SM holds are found once per kernel variant.
// 4. Coalesced epilogue: each warp scales its 16 x BN slice, stages it in
//    shared memory and stores 16 bytes a thread along the row (scalar
//    stores when N % 4 != 0).
// Each output is summed by one warp in a fixed order along K (hi, then lo,
// each 8 k); there is no split-K and there are no atomics, so repeated
// calls give the same bits.  The rounding differs from the float32
// product only in order and in the dropped 2^-22 |x|.  Where hi is not
// finite, lo = x - hi is not either, and the output is NaN where the
// float32 product may be finite or +-inf: for an infinite x, and for a
// finite |x| >= (2 - 2^-11) * 2^127, within a relative 2^-12 of FLT_MAX,
// which cvt.rna rounds to inf in TF32.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "tensor_core.cuh"

namespace {

using namespace tc;  // cp.async, split_tf32, mma_tf32

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBM = 32 * kWarps;       // rows a CTA tile; 32 a warp
constexpr int kStages = 2;             // ring stages
constexpr int kTableWords = 4096;      // at most 16 KB of sign bits
constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr uint32_t kRademacherSalt = 0x517CC1B7u;
constexpr uint32_t kOne = 0x3F800000u;  // 1.0f

__host__ __device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

struct Params {
  const float* x;
  float* out;
  long long m;
  int k, n, r_dim, transpose;
  uint32_t seed_hash;
  float scale;
  int nk;        // K steps of KW columns (1: the tile holds whole rows)
  int cps;       // column chunks of BN a slab (one slab per blockIdx.y)
  int table_k;   // k rows the sign table holds: a multiple of KW
  int vec_in;    // 16-byte copies of x
  int vec_out;   // 16-byte stores of out
};

// BN output columns a chunk (NT n-tiles of 8).  Fragment order of the sign
// table: the word of lane (g = lane / 4, t = lane % 4) for local chunk c and
// k group q (KQ k each) holds, at bit h * 2NT + 2j + e, the sign of S(k, n)
// with k = q * KQ + 8h + t + 4e and n = c * BN + 8j + g: the B fragment of
// n-tile j at k8 step h of the group (1 = negative, 0 = positive or past
// the edge).  KW: columns of x a ring stage.
template <int BN, int KW>
__global__ void __launch_bounds__(kThreads)
rp_kernel(const Params p) {
  constexpr int NT = BN / 8;          // n-tiles a chunk
  constexpr int KS = 16 / NT;         // k8 steps a table word
  constexpr int KQ = 8 * KS;          // k a table word
  constexpr int XS = KW + 4;          // ring row stride (floats)
  constexpr int OS = BN + 8;          // epilogue row stride (floats)
  static_assert(KW % KQ == 0, "a stage holds whole table words");

  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  float* staged = ring + kStages * kBM * XS;
  uint32_t* table = reinterpret_cast<uint32_t*>(staged + kWarps * 16 * OS);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int n_chunks = (p.n + BN - 1) / BN;
  const int c0 = blockIdx.y * p.cps;
  const int sc = min(p.cps, n_chunks - c0);  // chunks of this slab
  const bool resident = p.nk == 1;
  const int qpw = p.table_k / KQ;            // table words a chunk and lane
  const long long n_tiles = (p.m + kBM - 1) / kBM;

  // A ring item: row tile, column chunk (one chunk per item unless the tile
  // holds whole rows), K step, and ring slot.  Items run tile by tile, each
  // tile's chunks in order, each chunk's K steps in order.
  struct Cursor {
    long long tile;
    int cl, ks, slot;
  };
  auto advance = [&](Cursor& c) {
    c.slot = c.slot + 1 == kStages ? 0 : c.slot + 1;
    if (++c.ks < p.nk) return;
    c.ks = 0;
    if (!resident && ++c.cl < sc) return;
    c.cl = 0;
    c.tile += gridDim.x;
  };

  // Each thread copies the same columns of rows vr0, vr0 + RPI, ... of a
  // tile (sr0, sr0 + kRows, ... with 4-byte copies).
  constexpr int kVecPerRow = KW / 4;
  constexpr int RPI = kThreads / kVecPerRow;
  const int vr0 = tid / kVecPerRow, vcol = tid % kVecPerRow * 4;
  const int sr0 = tid / KW, scol = tid % KW;
  auto load = [&](const Cursor& c) {
    const long long row0 = c.tile * kBM;
    const int k0 = c.ks * KW;
    float* dst = ring + c.slot * kBM * XS;
    if (p.vec_in) {
      const bool k_ok = k0 + vcol < p.k;
      const float* src = p.x + (row0 + vr0) * p.k + k0 + vcol;
#pragma unroll
      for (int it = 0; it < kBM / RPI; ++it) {
        const bool ok = k_ok && row0 + vr0 + it * RPI < p.m;
        cp_async16(dst + (vr0 + it * RPI) * XS + vcol,
                   ok ? src + static_cast<long long>(it * RPI) * p.k : p.x,
                   ok ? 16 : 0);
      }
    } else {
      constexpr int kRows = kThreads / KW;
      const bool k_ok = k0 + scol < p.k;
      const float* src = p.x + (row0 + sr0) * p.k + k0 + scol;
#pragma unroll 4
      for (int it = 0; it < kBM / kRows; ++it) {
        const bool ok = k_ok && row0 + sr0 + it * kRows < p.m;
        cp_async4(dst + (sr0 + it * kRows) * XS + scol,
                  ok ? src + static_cast<long long>(it * kRows) * p.k : p.x,
                  ok ? 4 : 0);
      }
    }
  };

  auto build_table = [&](int window) {
    const int kbase = window * p.table_k;
    for (int idx = tid; idx < sc * qpw * 32; idx += kThreads) {
      const int ln = idx & 31, q = (idx >> 5) % qpw, cl = (idx >> 5) / qpw;
      const int k0 = kbase + q * KQ + (ln & 3);
      const int n0 = (c0 + cl) * BN + (ln >> 2);
      uint32_t word = 0;
#pragma unroll
      for (int h = 0; h < KS; ++h)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kk = k0 + 8 * h + 4 * e, nn = n0 + 8 * j;
            if (kk < p.k && nn < p.n) {
              const uint32_t counter =
                  p.transpose ? static_cast<uint32_t>(nn) * p.r_dim + kk
                              : static_cast<uint32_t>(kk) * p.r_dim + nn;
              word |= (fmix32(counter * kGolden + p.seed_hash) & 1u)
                      << (h * 2 * NT + 2 * j + e);
            }
          }
      table[idx] = word;
    }
  };

  float acc[2][NT][4];

  Cursor pc{blockIdx.x, 0, 0, 0};  // the next item to copy
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (pc.tile < n_tiles) load(pc);
    cp_async_commit();
    advance(pc);
  }
  int window = -1;
  for (Cursor cc{blockIdx.x, 0, 0, 0}; cc.tile < n_tiles; advance(cc)) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // item cc landed; every warp is done with the last one
    if (pc.tile < n_tiles) load(pc);
    cp_async_commit();
    advance(pc);

    const long long tile = cc.tile;
    const int ks = cc.ks;
    const int kbeg = ks * KW;
    const int w = kbeg / p.table_k;
    if (w != window) {  // once per CTA unless K needs windows
      build_table(w);
      window = w;
      __syncthreads();
    }
    const float* xs = ring + cc.slot * kBM * XS + warp * 32 * XS;
    const int cbeg = resident ? 0 : cc.cl;
    const int cend = resident ? sc : cbeg + 1;
    for (int cl = cbeg; cl < cend; ++cl) {
      if (ks == 0) {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.0f;
      }
      const uint32_t* tw =
          table + (cl * qpw + (kbeg - w * p.table_k) / KQ) * 32 + lane;
      uint32_t word = 0;
#pragma unroll
      for (int kk = 0; kk < KW / 8; ++kk) {
        if (kbeg + 8 * kk >= p.k) break;  // zero-filled past K
        if (kk % KS == 0) word = tw[kk / KS * 32];
        const int sh = kk % KS * 2 * NT;
        uint32_t b[NT][2];
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            b[j][e] = kOne | (((word >> (sh + 2 * j + e)) & 1u) << 31);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const float* xr = xs + (mi * 16 + g) * XS + kk * 8 + t4;
          uint32_t hi[4], lo[4];
          split_tf32(xr[0], hi[0], lo[0]);
          split_tf32(xr[8 * XS], hi[1], lo[1]);
          split_tf32(xr[4], hi[2], lo[2]);
          split_tf32(xr[8 * XS + 4], hi[3], lo[3]);
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            mma_tf32(acc[mi][j], hi, b[j][0], b[j][1]);
            mma_tf32(acc[mi][j], lo, b[j][0], b[j][1]);
          }
        }
      }
      if (ks != p.nk - 1) continue;

      // epilogue: this warp's 32 x BN slice, 16 rows at a time
      float* so = staged + warp * 16 * OS;
      const int n0 = (c0 + cl) * BN;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          float* d = so + g * OS + 8 * j + 2 * t4;
          *reinterpret_cast<float2*>(d) =
              make_float2(__fmul_rn(acc[mi][j][0], p.scale),
                          __fmul_rn(acc[mi][j][1], p.scale));
          *reinterpret_cast<float2*>(d + 8 * OS) =
              make_float2(__fmul_rn(acc[mi][j][2], p.scale),
                          __fmul_rn(acc[mi][j][3], p.scale));
        }
        __syncwarp();
        const long long row0 = tile * kBM + warp * 32 + mi * 16;
#pragma unroll
        for (int it = 0; it < 16 * BN / 4 / 32; ++it) {
          const int c = it * 32 + lane;
          const int r = c / (BN / 4), col = c % (BN / 4) * 4;
          const long long gr = row0 + r;
          const int gn = n0 + col;
          if (gr >= p.m || gn >= p.n) continue;
          const float4 v = *reinterpret_cast<const float4*>(so + r * OS + col);
          float* o = p.out + gr * p.n + gn;
          if (p.vec_out) {
            *reinterpret_cast<float4*>(o) = v;
          } else {
            o[0] = v.x;
            if (gn + 1 < p.n) o[1] = v.y;
            if (gn + 2 < p.n) o[2] = v.z;
            if (gn + 3 < p.n) o[3] = v.w;
          }
        }
        __syncwarp();
      }
    }
  }
  cp_async_wait<0>();
}

// The CTAs the card holds at once for one kernel variant, found at its
// first launch on the current device (a process drives one kind of card).
struct Grid {
  cudaError_t err;
  int ctas;
};

template <int BN, int KW>
Grid grid_for(size_t smem) {
  const auto kern = rp_kernel<BN, KW>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (!err) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                         dev);
  if (!err) err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (!err) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kern, kThreads, smem);
  return Grid{err, (per_sm > 0 ? per_sm : 1) * sms};
}

template <int BN, int KW>
int launch(Params p, cudaStream_t stream) {
  constexpr int KQ = 8 * (16 / (BN / 8));
  constexpr size_t kSmem =
      sizeof(float) * (kStages * kBM * (KW + 4) + kWarps * 16 * (BN + 8)) +
      sizeof(uint32_t) * kTableWords;
  static const Grid grid = grid_for<BN, KW>(kSmem);
  if (grid.err) return static_cast<int>(grid.err);
  const int n_chunks = (p.n + BN - 1) / BN;
  p.nk = p.k > KW ? (p.k + KW - 1) / KW : 1;
  // The whole K once a CTA if a chunk's slice fits the table, else windows
  // of K and one chunk a slab.
  p.table_k = std::min(p.nk * KW, kTableWords / 32 * KQ);
  p.cps = std::min(n_chunks, kTableWords / (p.table_k / KQ * 32));
  const int slabs = (n_chunks + p.cps - 1) / p.cps;
  const long long tiles = (p.m + kBM - 1) / kBM;
  long long gx = grid.ctas / slabs;
  if (gx < 1) gx = 1;
  if (gx > tiles) gx = tiles;
  rp_kernel<BN, KW><<<dim3(static_cast<unsigned>(gx), slabs), kThreads,
                       kSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (m, n_dim) = x (m, k_dim) @ S * scale.  transpose = 0: S = sign(R)
// (k_dim = D, n_dim = r_dim); transpose = 1: S = sign(R)^T (k_dim = r_dim,
// n_dim = D).  x and out are contiguous float32 on the device.
extern "C" int rp_project(const float* x, float* out, long long m, int k_dim,
                          int n_dim, int r_dim, int transpose,
                          unsigned int seed, float scale, void* stream) {
  Params p{};
  p.x = x;
  p.out = out;
  p.m = m;
  p.k = k_dim;
  p.n = n_dim;
  p.r_dim = r_dim;
  p.transpose = transpose;
  p.seed_hash = fmix32(seed + kRademacherSalt);
  p.scale = scale;
  p.vec_in = k_dim % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  p.vec_out = n_dim % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_dim <= 32)
    return k_dim <= 32 ? launch<32, 32>(p, s) : launch<32, 64>(p, s);
  return k_dim <= 32 ? launch<64, 32>(p, s) : launch<64, 64>(p, s);
}
