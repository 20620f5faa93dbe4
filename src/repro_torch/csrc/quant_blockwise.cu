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
// every division is the IEEE one.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerCta = 8;
constexpr int kMaxLevels = 16;
constexpr float kEps = 1e-10f;
constexpr uint32_t kGolden = 0x9E3779B9u;

struct Levels {
  float v[kMaxLevels];
  int n;  // 0 = uniform integer levels 0..B
};

__host__ __device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float uniform(uint32_t seed_hash, uint32_t counter) {
  const uint32_t mixed = fmix32(counter * kGolden + seed_hash);
  return __fmul_rn(static_cast<float>(mixed >> 8), 1.0f / 16777216.0f);
}

__host__ __device__ __forceinline__ float max_level(int bits) {
  return static_cast<float>((1ull << bits) - 1ull);
}

__global__ void __launch_bounds__(kWarpsPerCta * 32)
quant_pack_kernel(const float* __restrict__ x, uint32_t* __restrict__ packed,
                  float* __restrict__ zero, float* __restrict__ rng,
                  long long n_blocks, int G, int bits, uint32_t seed_hash,
                  Levels lv) {
  extern __shared__ float smem[];  // kWarpsPerCta * G floats
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarpsPerCta + warp;
  if (row >= n_blocks) return;  // whole warp: row is per warp
  float* xs = smem + static_cast<size_t>(warp) * G;
  uint32_t* cs = reinterpret_cast<uint32_t*>(xs);
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
  for (int o = 16; o > 0; o >>= 1) {
    mn = fminf(mn, __shfl_xor_sync(0xFFFFFFFFu, mn, o));
    mx = fmaxf(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, o));
  }
  __syncwarp();

  // pass 2: normalize and stochastically round, each code over its value
  const float range = __fsub_rn(mx, mn);
  const float safe = fmaxf(range, kEps);
  const float B = max_level(bits);
  for (int e = lane; e < G; e += 32) {
    float h = __fmul_rn(__fdiv_rn(__fsub_rn(xs[e], mn), safe), B);
    h = fminf(fmaxf(h, 0.0f), B);
    const float u = uniform(seed_hash, static_cast<uint32_t>(row * G + e));
    uint32_t code;
    if (lv.n == 0) {
      const float lo = floorf(h);
      code = static_cast<uint32_t>(lo) + (u < __fsub_rn(h, lo) ? 1u : 0u);
    } else {
      // count interior levels <= h: the reference's searchsorted(right) - 1
      uint32_t idx = 0;
      for (int i = 1; i < lv.n - 1; ++i) idx += (h >= lv.v[i]) ? 1u : 0u;
      const float lo = lv.v[idx], hi = lv.v[idx + 1];
      const float p_up = __fdiv_rn(__fsub_rn(h, lo), fmaxf(__fsub_rn(hi, lo), kEps));
      code = idx + (u < p_up ? 1u : 0u);
    }
    cs[e] = code;
  }
  __syncwarp();

  // pass 3: strided pack, word j <- codes j, j + W, j + 2W, ...
  const int vpw = 32 / bits, W = G / vpw;
  for (int j = lane; j < W; j += 32) {
    uint32_t w = 0;
    for (int k = 0; k < vpw; ++k) w |= cs[j + k * W] << (k * bits);
    packed[row * W + j] = w;
  }
  if (lane == 0) {
    zero[row] = mn;
    rng[row] = range;
  }
}

__global__ void __launch_bounds__(kWarpsPerCta * 32)
dequant_unpack_kernel(const uint32_t* __restrict__ packed,
                      const float* __restrict__ zero,
                      const float* __restrict__ rng, float* __restrict__ out,
                      long long n_blocks, int G, int bits, Levels lv) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarpsPerCta + warp;
  if (row >= n_blocks) return;
  const int vpw = 32 / bits, W = G / vpw;
  const uint32_t mask = static_cast<uint32_t>((1ull << bits) - 1ull);
  const float scale = __fdiv_rn(rng[row], max_level(bits));
  const float z = zero[row];
  const uint32_t* pr = packed + row * W;
  float* orow = out + row * G;
  for (int e = lane; e < G; e += 32) {
    const uint32_t code = (__ldg(pr + e % W) >> ((e / W) * bits)) & mask;
    const float v = lv.n ? lv.v[code] : static_cast<float>(code);
    orow[e] = __fadd_rn(__fmul_rn(v, scale), z);
  }
}

Levels make_levels(const float* levels, int n_levels) {
  Levels lv = {};
  lv.n = n_levels;
  for (int i = 0; i < n_levels && i < kMaxLevels; ++i) lv.v[i] = levels[i];
  return lv;
}

unsigned grid_for(long long n_blocks) {
  return static_cast<unsigned>((n_blocks + kWarpsPerCta - 1) / kWarpsPerCta);
}

}  // namespace

// x (n_blocks, G) f32 -> packed (n_blocks, G*bits/32) u32, zero, rng (n_blocks,).
// levels: host array of n_levels floats (n_levels = 0: uniform levels).
extern "C" int quant_pack(const float* x, uint32_t* packed, float* zero,
                          float* rng, long long n_blocks, int group_size,
                          int bits, unsigned int seed, const float* levels,
                          int n_levels, void* stream) {
  const size_t smem = static_cast<size_t>(kWarpsPerCta) * group_size * sizeof(float);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(quant_pack_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  quant_pack_kernel<<<grid_for(n_blocks), kWarpsPerCta * 32, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      x, packed, zero, rng, n_blocks, group_size, bits, fmix32(seed),
      make_levels(levels, n_levels));
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
      make_levels(levels, n_levels));
  return static_cast<int>(cudaGetLastError());
}
