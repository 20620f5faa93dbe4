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
//
// What bounds it on an H100: bytes.  Quantize reads 4 bytes per element and
// writes bits/8 (+ 8 per block); dequantize the reverse.  The per-element
// work (one murmur3 hash, a few compares and one division) is a few dozen
// operations per 4 bytes, far below the card's operations-per-byte balance.
//
// Design: one warp per block of G elements, eight warps per CTA.  The warp
// loads its block with coalesced float4 loads into shared memory, reduces
// min and max with warp shuffles, computes each code in place, and builds
// every packed word from its strided codes with shifts and ORs, one store
// per word.  Dequantize gives each lane consecutive output elements, so
// stores are coalesced; the few code words of a block are re-read from L1.
//
// Bit equality with the plain PyTorch version (and the JAX reference): this
// file is built with --fmad=false and no fast math, and every rounding step
// is an explicit _rn intrinsic, so nothing is contracted into an FMA and
// every division is the IEEE one.  The rounding itself lives in
// quant_common.cuh, shared with the fused kernels of fused_matmul.cu.
#include <cuda_runtime.h>
#include <stdint.h>

#include "quant_common.cuh"

namespace {

using quant::Levels;

constexpr int kWarpsPerCta = 8;

// Code c of a block in the strided layout: word c % W, shift (c / W) * bits.
__device__ __forceinline__ uint32_t unpack_code(const uint32_t* block_words,
                                                int c, int W, int bits) {
  const uint32_t mask = static_cast<uint32_t>((1ull << bits) - 1ull);
  return (__ldg(block_words + c % W) >> ((c / W) * bits)) & mask;
}

// Min and max over a warp's partial values (every lane gets both).
__device__ __forceinline__ void warp_minmax(float& mn, float& mx) {
  for (int o = 16; o > 0; o >>= 1) {
    mn = fminf(mn, __shfl_xor_sync(0xFFFFFFFFu, mn, o));
    mx = fmaxf(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, o));
  }
}

// One warp quantizes and packs one block of G floats staged in shared
// memory at xs, whose min and max it already holds (on every lane), with the
// level table lv (n_lv entries, shared memory; 0 = uniform).  The codes
// overwrite xs in place; the SR counter of element e is counter0 + e
// (mod 2**32).  block is the block's global index: writes the block's W
// words to packed[block * W ...], and its zero and range.
__device__ __forceinline__ void warp_quantize_staged(
    float* xs, long long block, uint32_t counter0, int G, int bits,
    uint32_t seed_hash,
    float mn, float mx, const float* lv, int n_lv,
    uint32_t* __restrict__ packed,
    float* __restrict__ zero, float* __restrict__ rng, int lane) {
  uint32_t* cs = reinterpret_cast<uint32_t*>(xs);
  const float range = __fsub_rn(mx, mn);
  const float safe = fmaxf(range, quant::kEps);
  const float B = quant::max_level(bits);
  for (int e = lane; e < G; e += 32) {
    const float u = quant::uniform(seed_hash,
                                   counter0 + static_cast<uint32_t>(e));
    cs[e] = quant::sr_code(xs[e], mn, safe, B, u, lv, n_lv);
  }
  __syncwarp();
  const int W = G / (32 / bits);
  for (int j = lane; j < W; j += 32) {
    packed[block * W + j] =
        quant::pack_word([cs](int e) { return cs[e]; }, j, W, bits);
  }
  if (lane == 0) {
    zero[block] = mn;
    rng[block] = range;
  }
}

__global__ void __launch_bounds__(kWarpsPerCta * 32)
quant_pack_kernel(const float* __restrict__ x, uint32_t* __restrict__ packed,
                  float* __restrict__ zero, float* __restrict__ rng,
                  long long n_blocks, int G, int bits, uint32_t seed_hash,
                  const uint32_t* __restrict__ seeds, int rows_per_seed,
                  Levels lv) {
  extern __shared__ float smem[];  // kWarpsPerCta * G floats
  __shared__ float table[quant::kMaxLevels];
  quant::load_levels(lv, table);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarpsPerCta + warp;
  if (row >= n_blocks) return;  // whole warp: row is per warp
  float* xs = smem + static_cast<size_t>(warp) * G;
  const float* xr = x + row * G;

  // pass 1: load the block, min and max
  float mn = __int_as_float(0x7F800000), mx = -mn;  // +inf, -inf
  if ((G & 3) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    for (int e = lane * 4; e < G; e += 128) {
      const float4 v = *reinterpret_cast<const float4*>(xr + e);
      xs[e] = v.x; xs[e + 1] = v.y; xs[e + 2] = v.z; xs[e + 3] = v.w;
      mn = fminf(fminf(mn, v.x), fminf(fminf(v.y, v.z), v.w));
      mx = fmaxf(fmaxf(mx, v.x), fmaxf(fmaxf(v.y, v.z), v.w));
    }
  } else {
    for (int e = lane; e < G; e += 32) {
      const float v = xr[e];
      xs[e] = v;
      mn = fminf(mn, v);
      mx = fmaxf(mx, v);
    }
  }
  warp_minmax(mn, mx);
  __syncwarp();

  // passes 2 and 3: stochastically round each code over its value, then
  // the strided pack (quant_common.cuh)
  // the SR stream: one seed for all rows (counter = row * G + e), or one
  // per run of rows_per_seed rows (counter restarting at each run)
  uint32_t sh = seed_hash;
  uint32_t counter0 = static_cast<uint32_t>(row * G);
  if (seeds != nullptr) {
    sh = quant::fmix32(__ldg(seeds + row / rows_per_seed));
    counter0 = static_cast<uint32_t>((row % rows_per_seed) * G);
  }
  warp_quantize_staged(xs, row, counter0, G, bits, sh, mn, mx, table, lv.n,
                       packed, zero, rng, lane);
}

__global__ void __launch_bounds__(kWarpsPerCta * 32)
dequant_unpack_kernel(const uint32_t* __restrict__ packed,
                      const float* __restrict__ zero,
                      const float* __restrict__ rng, float* __restrict__ out,
                      long long n_blocks, int G, int bits, Levels lv) {
  __shared__ float table[quant::kMaxLevels];
  quant::load_levels(lv, table);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarpsPerCta + warp;
  if (row >= n_blocks) return;
  const int W = G / (32 / bits);
  const float scale = quant::dequant_scale(rng[row], bits);
  const float z = zero[row];
  const uint32_t* pr = packed + row * W;
  float* orow = out + row * G;
  for (int e = lane; e < G; e += 32) {
    orow[e] = quant::dequant_value(unpack_code(pr, e, W, bits), scale,
                                   z, table, lv.n);
  }
}

unsigned grid_for(long long n_blocks) {
  return static_cast<unsigned>((n_blocks + kWarpsPerCta - 1) / kWarpsPerCta);
}

}  // namespace

// x (n_blocks, G) f32 -> packed (n_blocks, G*bits/32) u32, zero, rng (n_blocks,).
// levels: host array of n_levels floats (n_levels = 0: uniform levels).
// seeds: null (every row takes seed), or a device array of
// n_blocks / rows_per_seed seeds, one per run of rows_per_seed rows.
extern "C" int quant_pack(const float* x, uint32_t* packed, float* zero,
                          float* rng, long long n_blocks, int group_size,
                          int bits, unsigned int seed, const uint32_t* seeds,
                          int rows_per_seed, const float* levels,
                          int n_levels, void* stream) {
  const size_t smem = static_cast<size_t>(kWarpsPerCta) * group_size * sizeof(float);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(quant_pack_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  quant_pack_kernel<<<grid_for(n_blocks), kWarpsPerCta * 32, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      x, packed, zero, rng, n_blocks, group_size, bits, quant::fmix32(seed),
      seeds, rows_per_seed, quant::make_levels(levels, n_levels));
  return static_cast<int>(cudaGetLastError());
}

// (packed, zero, rng) -> out (n_blocks, G) f32.
extern "C" int dequant_unpack(const uint32_t* packed, const float* zero,
                              const float* rng, float* out, long long n_blocks,
                              int group_size, int bits, const float* levels,
                              int n_levels, void* stream) {
  dequant_unpack_kernel<<<grid_for(n_blocks), kWarpsPerCta * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      packed, zero, rng, out, n_blocks, group_size, bits,
      quant::make_levels(levels, n_levels));
  return static_cast<int>(cudaGetLastError());
}
