// Block-wise stochastic-rounding quantize+pack and unpack+dequantize.
//
// Replaces the TPU kernels of src/repro/kernels/quant_blockwise.py:
//   _quant_pack_kernel      per block: zero = min, range = max - min,
//                           h = clip((x - zero) / max(range, EPS) * B, 0, B),
//                           stochastic rounding with u = uniform(seed,
//                           row * G + col) onto the uniform or VM levels,
//                           then the strided pack (word j <- codes j, j+W, ...)
//   _dequant_unpack_kernel  unpack, level lookup, v * (range / B) + zero
//
// quant_pack also takes an optional table of seeds, one per run of
// rows_per_seed blocks: the serving KV cache quantizes every token's blocks
// with their own seed and a counter that restarts at 0 for each token (the
// reference's jax.vmap of quantize_blocks in serving/kvcache.py), so block
// row r draws u = uniform(seeds[r / rps], (r % rps) * G + col).  A null
// table is the plain one-seed kernel, with the same bits as before.
// Without a table, BlockOffset places the rows among the global blocks: a
// shard of a larger input (one rank's rows of a sharded activation, its
// columns of a split AdamW moment) draws counter gb(r) * G + col, mod
// 2**32, the unsharded call's noise for its rows, where gb(r) = row0 +
// (r / local) * global + r % local (local rows of `local` blocks lying
// `global` blocks apart; local == global is one contiguous run).
//
// What bounds it on an H100.  Quantize reads 4 bytes an element and writes
// bits/8 (+ 8 a block); dequantize the reverse: 0.0139 ms of bytes at
// 42,336 blocks of 256.  Dequantize issues 9.1 SASS instructions an element
// (13.9 with a VM table; `scripts/kernel_times.py quant --sass` counts the
// persistent loop), far below the bytes: it is bound by them.  Quantize is
// not: its loop issues 41 instructions an element with uniform levels
// (about 12 the murmur3 hash of the SR counter, 4 the division and its
// check, 8 the clip, floor and SR compare, 1 IMAD the pack, the rest the
// tile's min and max, shuffles, loads and stores), 82 with a VM table (the
// level count, two table reads and a second IEEE division an element).
// About 40 % of the uniform loop runs on the half-rate integer pipe, and
// at the card's ~33.5 T lane-instructions a second the uniform loop alone
// takes about as long as its bytes, the VM loop twice as long: the
// quantizer is bound by instruction issue, which the design keeps low.
//
// Design (vector path, G of 64, 128 or 256).  A group of L = G / 16 lanes
// takes one block, four 16-byte chunks a lane (chunk i of lane l is chunk
// c = l + i * L of the block, elements 4c .. 4c+3), so a warp holds 32 / L
// blocks (8 at G = 64, 2 at G = 256) and no lane idles.  The group's min
// and max are xor-shuffles at offsets below L.  In the strided layout the
// four codes of chunk c go to words 4 (c % Q) .. +3 at field c / Q, Q =
// W / 4, so each lane adds its codes, times 2**shift, into partial uint4s
// in registers (one IMAD a code; the fields are disjoint, so the sum is
// the OR); the lanes that share c % Q (offsets Q .. L/2) OR their partial
// words together with xor-shuffles, and lane c % Q of the group stores
// them as one uint4 (two at 16 bits, where Q = 2L).  Dequantize is the
// mirror: a lane loads the uint4s of its chunks' words once, extracts each
// chunk's field and writes one streaming float4 a chunk.  Bits and G are
// template parameters, so codes per word, masks, shifts and shuffle
// offsets are constants, no shuffle sits behind a runtime guard and no
// per-element integer division remains.  The division by the block's
// clamped range computes __fdiv_rn's reciprocal once a block
// (quant::BlockDivisor) and three FFMA an element.  Under a seed table the
// run and row of a block are carried from tile to tile without a division.
// The grid is persistent: as many 256-thread CTAs as the card holds at
// once walk the warp tiles, and each warp issues its next tile's loads
// (words, zero and range, or the x chunks and the seed) into registers
// before it computes the current one, so every resident warp keeps its
// next 16-byte loads in flight.
//
// The vector path needs G of 64, 128 or 256, a block's words in whole
// uint4s (G * bits a multiple of 128), 16-byte aligned x and words
// (quant_lanes_per_block states the rule) and a table of at most 16
// levels.  Everything else takes the scalar path: one warp a block, the min
// and max over the whole warp, each lane building whole words from their
// strided codes (x re-read from L1), one 4-byte store a word; dequantize
// one word a lane, its fields stored to their strided columns.  That path
// takes every config the main path reaches besides: bits 1 at G = 64, a
// misaligned view, ragged words (G not a multiple of the 32 / bits codes a
// word holds, as at G = 125 or 1000 in Table 1's flickr rows: the last
// word's spare fields are zero) and VM tables of up to 256 levels (8-bit
// layers of an autoprec allocation), held in shared memory and searched
// in eight steps.  It is simple, not tuned: at flickr's 89,250 blocks of
// 125 only 8 of a warp's lanes build words.
//
// Bit equality with the plain PyTorch version (and the JAX reference): this
// file is built with --fmad=false and no fast math, and every rounding step
// is an explicit _rn intrinsic, so nothing is contracted into an FMA and
// every division is the IEEE one (__fdiv_rn's own instructions, its
// reciprocal shared by a block).  The rounding itself lives in
// quant_common.cuh, shared with the fused kernels of fused_matmul.cu.
#include <cuda_runtime.h>
#include <stdint.h>

#include "quant_common.cuh"

namespace {

using quant::Levels;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;

// Where local block b lies among the unsharded tensor's blocks (mod 2**32):
// local rows of `local` blocks, `global` blocks apart, the first at `row0`.
struct BlockOffset {
  uint32_t row0, local, global;
  __device__ __forceinline__ uint32_t global_block(uint32_t b) const {
    if (local == global) return row0 + b;      // one contiguous run
    const uint32_t r = b / local;
    return row0 + r * global + (b - r * local);
  }
};

template <int BITS>
struct Code {
  static constexpr int kPerWord = 32 / BITS;
  static constexpr int kLogBits = BITS == 1 ? 0 : BITS == 2 ? 1 : BITS == 4 ? 2
                                  : BITS == 8 ? 3 : 4;
  static constexpr uint32_t kMask = (1u << BITS) - 1u;  // BITS <= 16
  static constexpr float kB = static_cast<float>((1u << BITS) - 1u);
};

// The vector path's geometry for G = 2**LOG_G elements a block, all
// compile-time: L = G / 16 lanes a block, four 16-byte chunks a lane
// (chunk i of lane l is chunk c = l + i * L of the block, elements 4c ..
// 4c+3), and Q = W / 4 uint4s of words a block.  Chunk c's codes go to
// words 4 (c % Q) .. +3 at field c / Q: for lane l that is uint4 (l % Q) +
// slot * L, slot = i % kSlots (a lane holds two uint4s where Q = 2L, at 16
// bits), and field (l >> kLogQ) + field(i).
template <int BITS, int LOG_G>
struct Vec {
  static constexpr int kLogL = LOG_G - 4;
  static constexpr int kL = 1 << kLogL;
  static constexpr int kLogQ = LOG_G + Code<BITS>::kLogBits - 7;
  static constexpr int kQ = 1 << kLogQ;
  static constexpr int kSlots = kQ > kL ? kQ / kL : 1;
  static constexpr int kPerWarp = 32 / kL;  // blocks a warp tile
  __host__ __device__ static constexpr int field(int i) {
    return (i << kLogL) >> kLogQ;
  }
};

// Min and max over the L lanes of a block (every lane gets both).
template <int kLogL>
__device__ __forceinline__ void group_minmax(float& mn, float& mx) {
#pragma unroll
  for (int o = (1 << kLogL) >> 1; o > 0; o >>= 1) {
    mn = fminf(mn, __shfl_xor_sync(kFull, mn, o));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
  }
}

__device__ __forceinline__ float4 zeros4() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

template <int BITS, int LOG_G, bool VM>
__global__ void __launch_bounds__(kThreads)
quant_vec_kernel(const float4* __restrict__ x, uint4* __restrict__ packed,
                 float* __restrict__ zero, float* __restrict__ rng,
                 uint32_t n_blocks, uint32_t seed_hash,
                 const uint32_t* __restrict__ seeds, uint32_t rows_per_seed,
                 BlockOffset off, Levels lv) {
  using V = Vec<BITS, LOG_G>;
  // a VM table of at most 2**BITS levels (the host's dispatch rule)
  constexpr int kLv = VM ? (BITS < 4 ? (1 << BITS) : quant::kMaxLevels) : 0;
  __shared__ float table[quant::kMaxLevels];
  quant::load_levels(lv, table);
  __syncthreads();
  const int n_lv = VM ? lv.n : 0;
  const uint32_t lane = threadIdx.x & 31;
  const uint32_t l = lane & (V::kL - 1), sub = lane >> V::kLogL;
  const uint32_t lane_shift = (l >> V::kLogQ) * BITS;
  const uint32_t n_tiles = (n_blocks + V::kPerWarp - 1) / V::kPerWarp;
  const uint32_t stride = gridDim.x * kWarps;
  uint32_t t = blockIdx.x * kWarps + (threadIdx.x >> 5);

  // Under a seed table, the run (seed index) and the row within it of this
  // lane's block, carried from tile to tile without a division.
  uint32_t run = 0, row = 0, d_run = 0, d_row = 0;
  if (seeds != nullptr) {
    const uint32_t b = t * V::kPerWarp + sub;
    const uint32_t step = stride * V::kPerWarp;
    run = b / rows_per_seed;
    row = b - run * rows_per_seed;
    d_run = step / rows_per_seed;
    d_row = step - d_run * rows_per_seed;
  }
  // a tile's loads: this lane's four chunks of its block, and its seed
  auto fetch = [&](uint32_t tile, uint32_t seed_run, float4 (&v)[4],
                   uint32_t& seed) {
    const uint32_t b = tile * V::kPerWarp + sub;
    if (tile < n_tiles && b < n_blocks) {
      const float4* xb = x + (static_cast<size_t>(b) << (LOG_G - 2)) + l;
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = __ldg(xb + i * V::kL);
      if (seeds != nullptr) seed = __ldg(seeds + seed_run);
    }
  };
  float4 a[4] = {zeros4(), zeros4(), zeros4(), zeros4()};
  uint32_t a_seed = 0;
  fetch(t, run, a, a_seed);
  for (; t < n_tiles; t += stride) {
    uint32_t n_run = run + d_run, n_row = row + d_row;
    if (n_row >= rows_per_seed && seeds != nullptr) {
      n_row -= rows_per_seed;
      ++n_run;
    }
    float4 nx[4] = {zeros4(), zeros4(), zeros4(), zeros4()};
    uint32_t n_seed = 0;
    fetch(t + stride, n_run, nx, n_seed);        // the next tile, in flight

    const uint32_t b = t * V::kPerWarp + sub;
    float mn = a[0].x, mx = a[0].x;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      mn = fminf(fminf(mn, a[i].x), fminf(fminf(a[i].y, a[i].z), a[i].w));
      mx = fmaxf(fmaxf(mx, a[i].x), fmaxf(fmaxf(a[i].y, a[i].z), a[i].w));
    }
    group_minmax<V::kLogL>(mn, mx);
    const float range = __fsub_rn(mx, mn);
    const quant::BlockDivisor div(fmaxf(range, quant::kEps));
    // the SR stream: one seed for all rows (counter = row * G + e), or one
    // per run of rows_per_seed rows (counter restarting at each run)
    uint32_t sh = seed_hash, c0 = off.global_block(b) << LOG_G;
    if (seeds != nullptr) {
      sh = quant::fmix32(a_seed);
      c0 = row << LOG_G;
    }
    uint32_t w[V::kSlots][4] = {};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float num[4] = {__fsub_rn(a[i].x, mn), __fsub_rn(a[i].y, mn),
                            __fsub_rn(a[i].z, mn), __fsub_rn(a[i].w, mn)};
      float q[4];
      div.divide(num, q);
      const uint32_t e0 = c0 + 4 * (l + i * V::kL);
      // the fields are disjoint, so adding code * 2**shift is OR-ing it in:
      // one IMAD on the multiplier's pipe instead of a shift and a LOP3 on
      // the integer pipe, which the hash already keeps busy (the move hides
      // that the multiplier is a power of two, which would turn it back)
      uint32_t field_one;
      asm("mov.b32 %0, %1;" : "=r"(field_one)
          : "r"(1u << (lane_shift + V::field(i) * BITS)));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t code = quant::sr_code_q<kLv>(
            q[e], Code<BITS>::kB, quant::uniform(sh, e0 + e), table, n_lv);
        w[i % V::kSlots][e] += code * field_one;
      }
    }
    // OR the partial words of the lanes that share a uint4 of words
#pragma unroll
    for (int o = V::kQ; o < V::kL; o <<= 1) {
#pragma unroll
      for (int e = 0; e < 4; ++e) w[0][e] |= __shfl_xor_sync(kFull, w[0][e], o);
    }
    if (b < n_blocks) {
      if (l < V::kQ) {
        uint4* pb = packed + (static_cast<size_t>(b) << V::kLogQ) +
                    (l & (V::kQ - 1));
#pragma unroll
        for (int s = 0; s < V::kSlots; ++s)
          pb[s * V::kL] = make_uint4(w[s][0], w[s][1], w[s][2], w[s][3]);
      }
      if (l == 0) {
        zero[b] = mn;
        rng[b] = range;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = nx[i];
    a_seed = n_seed;
    run = n_run;
    row = n_row;
  }
}

template <int BITS, int LOG_G, bool VM>
__global__ void __launch_bounds__(kThreads)
dequant_vec_kernel(const uint4* __restrict__ packed,
                   const float* __restrict__ zero,
                   const float* __restrict__ rng, float4* __restrict__ out,
                   uint32_t n_blocks, Levels lv) {
  using V = Vec<BITS, LOG_G>;
  __shared__ float table[quant::kMaxLevels];
  quant::load_levels(lv, table);
  __syncthreads();
  const int n_lv = VM ? lv.n : 0;
  const uint32_t lane = threadIdx.x & 31;
  const uint32_t l = lane & (V::kL - 1), sub = lane >> V::kLogL;
  const uint32_t lane_shift = (l >> V::kLogQ) * BITS;
  const uint32_t n_tiles = (n_blocks + V::kPerWarp - 1) / V::kPerWarp;
  const uint32_t stride = gridDim.x * kWarps;

  // a tile's loads: the uint4s of this lane's words, zero and range
  auto fetch = [&](uint32_t tile, uint4 (&w)[V::kSlots], float& z,
                   float& r) {
    const uint32_t b = tile * V::kPerWarp + sub;
    if (tile < n_tiles && b < n_blocks) {
      const uint4* pb = packed + (static_cast<size_t>(b) << V::kLogQ) +
                        (l & (V::kQ - 1));
#pragma unroll
      for (int s = 0; s < V::kSlots; ++s) w[s] = __ldg(pb + s * V::kL);
      z = __ldg(zero + b);
      r = __ldg(rng + b);
    }
  };
  uint4 a_w[V::kSlots] = {};
  float a_z = 0.0f, a_r = 0.0f;
  uint32_t t = blockIdx.x * kWarps + (threadIdx.x >> 5);
  fetch(t, a_w, a_z, a_r);
  for (; t < n_tiles; t += stride) {
    uint4 n_w[V::kSlots] = {};
    float n_z = 0.0f, n_r = 0.0f;
    fetch(t + stride, n_w, n_z, n_r);           // the next tile, in flight

    const uint32_t b = t * V::kPerWarp + sub;
    if (b < n_blocks) {
      const float scale = quant::dequant_scale(a_r, BITS);
      float4* ob = out + (static_cast<size_t>(b) << (LOG_G - 2)) + l;
      constexpr uint32_t m = Code<BITS>::kMask;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint4 w = a_w[i % V::kSlots];
        const uint32_t s = lane_shift + V::field(i) * BITS;
        __stcs(ob + i * V::kL, make_float4(
            quant::dequant_value((w.x >> s) & m, scale, a_z, table, n_lv),
            quant::dequant_value((w.y >> s) & m, scale, a_z, table, n_lv),
            quant::dequant_value((w.z >> s) & m, scale, a_z, table, n_lv),
            quant::dequant_value((w.w >> s) & m, scale, a_z, table, n_lv)));
      }
    }
#pragma unroll
    for (int s = 0; s < V::kSlots; ++s) a_w[s] = n_w[s];
    a_z = n_z;
    a_r = n_r;
  }
}

// The scalar path: one warp a block, any G, any alignment, any table.
// Each lane builds words j = lane, lane + 32, ... of the block's W =
// ceil(G * BITS / 32) from their codes j, j + W, j + 2W, ... (x re-read
// from L1 after the min and max); where G is not a multiple of the codes a
// word holds, the last fields of the last words lie past the block and
// stay zero, as the plain pack pads them.  LV is the level table: Levels
// (at most 16 levels, counted) or WideLevels (up to 256, VM at 8 bits,
// searched in eight steps, quant::interior_rank), in shared memory.
template <int BITS, class LV>
__global__ void __launch_bounds__(kThreads)
quant_scalar_kernel(const float* __restrict__ x, uint32_t* __restrict__ packed,
                    float* __restrict__ zero, float* __restrict__ rng,
                    uint32_t n_blocks, int G, uint32_t seed_hash,
                    const uint32_t* __restrict__ seeds,
                    uint32_t rows_per_seed, BlockOffset off, LV lv) {
  constexpr int kSearch = LV::kSize > quant::kMaxLevels ? LV::kSize : 0;
  __shared__ float table[LV::kSize];
  quant::load_levels(lv, table);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int W = (G + Code<BITS>::kPerWord - 1) / Code<BITS>::kPerWord;
  const uint32_t stride = gridDim.x * kWarps;
  for (uint32_t b = blockIdx.x * kWarps + (threadIdx.x >> 5); b < n_blocks;
       b += stride) {
    const float* xb = x + static_cast<size_t>(b) * G;
    float mn = __int_as_float(0x7F800000), mx = -mn;  // +inf, -inf
    for (int e = lane; e < G; e += 32) {
      const float v = xb[e];
      mn = fminf(mn, v);
      mx = fmaxf(mx, v);
    }
    group_minmax<5>(mn, mx);
    const float range = __fsub_rn(mx, mn);
    const float safe = fmaxf(range, quant::kEps);
    uint32_t sh = seed_hash,
             c0 = off.global_block(b) * static_cast<uint32_t>(G);
    if (seeds != nullptr) {
      sh = quant::fmix32(__ldg(seeds + b / rows_per_seed));
      c0 = (b % rows_per_seed) * static_cast<uint32_t>(G);
    }
    for (int j = lane; j < W; j += 32) {
      packed[static_cast<size_t>(b) * W + j] = quant::pack_word(
          [&](int e) {
            return e < G ? quant::sr_code<kSearch>(
                               xb[e], mn, safe, Code<BITS>::kB,
                               quant::uniform(sh, c0 + e), table, lv.n)
                         : 0u;
          },
          j, W, BITS);
    }
    if (lane == 0) {
      zero[b] = mn;
      rng[b] = range;
    }
  }
}

template <int BITS, class LV>
__global__ void __launch_bounds__(kThreads)
dequant_scalar_kernel(const uint32_t* __restrict__ packed,
                      const float* __restrict__ zero,
                      const float* __restrict__ rng, float* __restrict__ out,
                      uint32_t n_blocks, int G, LV lv) {
  __shared__ float table[LV::kSize];
  quant::load_levels(lv, table);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int W = (G + Code<BITS>::kPerWord - 1) / Code<BITS>::kPerWord;
  const uint32_t stride = gridDim.x * kWarps;
  for (uint32_t b = blockIdx.x * kWarps + (threadIdx.x >> 5); b < n_blocks;
       b += stride) {
    const float scale = quant::dequant_scale(__ldg(rng + b), BITS);
    const float z = __ldg(zero + b);
    float* ob = out + static_cast<size_t>(b) * G;
    for (int j = lane; j < W; j += 32) {
      const uint32_t w = __ldg(packed + static_cast<size_t>(b) * W + j);
#pragma unroll 4
      for (int k = 0; k < Code<BITS>::kPerWord; ++k) {
        const int e = j + k * W;
        if (e < G)
          ob[e] = quant::dequant_value((w >> (k * BITS)) & Code<BITS>::kMask,
                                       scale, z, table, lv.n);
      }
    }
  }
}

// log2(G) where the vector path takes G and bits (G of 64, 128 or 256
// whose words fill whole uint4s), else -1.
int vector_log_g(int G, int bits) {
  const int log_g = G == 64 ? 6 : G == 128 ? 7 : G == 256 ? 8 : -1;
  return log_g >= 0 && (G * bits) % 128 == 0 ? log_g : -1;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// CTAs of a persistent launch over `warp_items` warp-sized pieces of work:
// as many as the card holds at once, or fewer when the work is smaller.
template <auto Kernel>
unsigned persistent_grid(long long warp_items) {
  static const long long resident = [] {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel, kThreads, 0);
    return static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  }();
  const long long need = (warp_items + kWarps - 1) / kWarps;
  return static_cast<unsigned>(need < resident ? need : resident);
}

template <auto Kernel, class... Args>
int launch(long long warp_items, cudaStream_t stream, Args... args) {
  Kernel<<<persistent_grid<Kernel>(warp_items), kThreads, 0, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <int BITS, int LOG_G>
int quant_vec(const float* x, uint32_t* packed, float* zero, float* rng,
              uint32_t n, uint32_t seed_hash, const uint32_t* seeds,
              uint32_t rps, BlockOffset off, const Levels& lv, cudaStream_t s) {
  if constexpr (((BITS << LOG_G) & 127) != 0) {
    return cudaErrorInvalidValue;   // not a vector-path width
  } else {
    using V = Vec<BITS, LOG_G>;
    const long long tiles = (static_cast<long long>(n) + V::kPerWarp - 1) /
                            V::kPerWarp;
    const auto* x4 = reinterpret_cast<const float4*>(x);
    auto* p4 = reinterpret_cast<uint4*>(packed);
    if (lv.n)
      return launch<quant_vec_kernel<BITS, LOG_G, true>>(
          tiles, s, x4, p4, zero, rng, n, seed_hash, seeds, rps, off, lv);
    return launch<quant_vec_kernel<BITS, LOG_G, false>>(
        tiles, s, x4, p4, zero, rng, n, seed_hash, seeds, rps, off, lv);
  }
}

template <int BITS, int LOG_G>
int dequant_vec(const uint32_t* packed, const float* zero, const float* rng,
                float* out, uint32_t n, const Levels& lv, cudaStream_t s) {
  if constexpr (((BITS << LOG_G) & 127) != 0) {
    return cudaErrorInvalidValue;   // not a vector-path width
  } else {
    using V = Vec<BITS, LOG_G>;
    const long long tiles = (static_cast<long long>(n) + V::kPerWarp - 1) /
                            V::kPerWarp;
    const auto* p4 = reinterpret_cast<const uint4*>(packed);
    auto* o4 = reinterpret_cast<float4*>(out);
    if (lv.n)
      return launch<dequant_vec_kernel<BITS, LOG_G, true>>(
          tiles, s, p4, zero, rng, o4, n, lv);
    return launch<dequant_vec_kernel<BITS, LOG_G, false>>(
        tiles, s, p4, zero, rng, o4, n, lv);
  }
}

template <int BITS>
int quant_bits(const float* x, uint32_t* packed, float* zero, float* rng,
               uint32_t n, int G, uint32_t seed_hash, const uint32_t* seeds,
               uint32_t rps, BlockOffset off, const float* levels, int n_levels,
               cudaStream_t s) {
  if (n_levels > quant::kMaxLevels) {
    return launch<quant_scalar_kernel<BITS, quant::WideLevels>>(
        n, s, x, packed, zero, rng, n, G, seed_hash, seeds, rps, off,
        quant::make_levels<quant::WideLevels>(levels, n_levels));
  }
  const Levels lv = quant::make_levels(levels, n_levels);
  if (aligned16(x) && lv.n <= (1 << BITS)) {
    switch (vector_log_g(G, BITS)) {
      case 6: return quant_vec<BITS, 6>(x, packed, zero, rng, n, seed_hash, seeds, rps, off, lv, s);
      case 7: return quant_vec<BITS, 7>(x, packed, zero, rng, n, seed_hash, seeds, rps, off, lv, s);
      case 8: return quant_vec<BITS, 8>(x, packed, zero, rng, n, seed_hash, seeds, rps, off, lv, s);
    }
  }
  return launch<quant_scalar_kernel<BITS, Levels>>(n, s, x, packed, zero, rng,
                                                   n, G, seed_hash, seeds,
                                                   rps, off, lv);
}

template <int BITS>
int dequant_bits(const uint32_t* packed, const float* zero, const float* rng,
                 float* out, uint32_t n, int G, const float* levels,
                 int n_levels, cudaStream_t s) {
  if (n_levels > quant::kMaxLevels) {
    return launch<dequant_scalar_kernel<BITS, quant::WideLevels>>(
        n, s, packed, zero, rng, out, n, G,
        quant::make_levels<quant::WideLevels>(levels, n_levels));
  }
  const Levels lv = quant::make_levels(levels, n_levels);
  if (aligned16(packed) && aligned16(out)) {
    switch (vector_log_g(G, BITS)) {
      case 6: return dequant_vec<BITS, 6>(packed, zero, rng, out, n, lv, s);
      case 7: return dequant_vec<BITS, 7>(packed, zero, rng, out, n, lv, s);
      case 8: return dequant_vec<BITS, 8>(packed, zero, rng, out, n, lv, s);
    }
  }
  return launch<dequant_scalar_kernel<BITS, Levels>>(n, s, packed, zero, rng,
                                                     out, n, G, lv);
}

}  // namespace

// Lanes of the vector path a block (G / 16) for this group size and width,
// or 0 where the kernels take the scalar path at any alignment.
extern "C" int quant_lanes_per_block(int group_size, int bits) {
  return vector_log_g(group_size, bits) >= 0 ? group_size / 16 : 0;
}

// x (n_blocks, G) f32 -> packed (n_blocks, ceil(G*bits/32)) u32, zero, rng
// (n_blocks,).  levels: host array of n_levels floats (n_levels = 0:
// uniform levels; at most 256).  seeds: null (every row takes seed), or a
// device array of n_blocks / rows_per_seed seeds, one per run of
// rows_per_seed rows.  row0, blocks_local, blocks_global: the global
// block offset (BlockOffset; 0, 1, 1 with a seed table): local rows of
// blocks_local blocks, blocks_global apart, the first at block row0.
extern "C" int quant_pack(const float* x, uint32_t* packed, float* zero,
                          float* rng, long long n_blocks, int group_size,
                          int bits, unsigned int seed, const uint32_t* seeds,
                          int rows_per_seed, unsigned int row0,
                          unsigned int blocks_local,
                          unsigned int blocks_global, const float* levels,
                          int n_levels, void* stream) {
  if (n_blocks <= 0 || n_blocks >= (1ll << 31) || group_size <= 0 ||
      n_levels < 0 || n_levels > quant::kMaxTableLevels ||
      blocks_local == 0 || blocks_local > blocks_global ||
      n_blocks % blocks_local != 0 ||
      (seeds != nullptr && (row0 != 0 || blocks_local != blocks_global)))
    return cudaErrorInvalidValue;
  const auto n = static_cast<uint32_t>(n_blocks);
  const BlockOffset off{row0, blocks_local, blocks_global};
  const uint32_t sh = quant::fmix32(seed);
  const auto rps = static_cast<uint32_t>(rows_per_seed);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 1: return quant_bits<1>(x, packed, zero, rng, n, group_size, sh, seeds, rps, off, levels, n_levels, s);
    case 2: return quant_bits<2>(x, packed, zero, rng, n, group_size, sh, seeds, rps, off, levels, n_levels, s);
    case 4: return quant_bits<4>(x, packed, zero, rng, n, group_size, sh, seeds, rps, off, levels, n_levels, s);
    case 8: return quant_bits<8>(x, packed, zero, rng, n, group_size, sh, seeds, rps, off, levels, n_levels, s);
    case 16: return quant_bits<16>(x, packed, zero, rng, n, group_size, sh, seeds, rps, off, levels, n_levels, s);
  }
  return cudaErrorInvalidValue;
}

// (packed, zero, rng) -> out (n_blocks, G) f32.
extern "C" int dequant_unpack(const uint32_t* packed, const float* zero,
                              const float* rng, float* out, long long n_blocks,
                              int group_size, int bits, const float* levels,
                              int n_levels, void* stream) {
  if (n_blocks <= 0 || n_blocks >= (1ll << 31) || group_size <= 0 ||
      n_levels < 0 || n_levels > quant::kMaxTableLevels)
    return cudaErrorInvalidValue;
  const auto n = static_cast<uint32_t>(n_blocks);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 1: return dequant_bits<1>(packed, zero, rng, out, n, group_size, levels, n_levels, s);
    case 2: return dequant_bits<2>(packed, zero, rng, out, n, group_size, levels, n_levels, s);
    case 4: return dequant_bits<4>(packed, zero, rng, out, n, group_size, levels, n_levels, s);
    case 8: return dequant_bits<8>(packed, zero, rng, out, n, group_size, levels, n_levels, s);
    case 16: return dequant_bits<16>(packed, zero, rng, out, n, group_size, levels, n_levels, s);
  }
  return cudaErrorInvalidValue;
}
