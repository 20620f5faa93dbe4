// Seeded Rademacher random-projection matmul: out = x @ S, with S = R(seed)
// (RP) or R(seed)^T (IRP) regenerated tile by tile and never stored.
//
// Replaces the TPU kernel src/repro/kernels/rp_matmul.py:_rp_kernel
// (rp_project_call, irp_project_call).  R (D x r) has element (d, p) =
// +-1/sqrt(r) from the salted murmur3 hash of the counter d * r + p, in both
// directions, exactly as repro_torch.core.random_projection.rp_matrix.
//
// What bounds it on an H100: at the main path's shapes (M = 169,343 rows,
// 256/512 <-> 32/64 columns) a call moves M * (K + N) * 4 bytes and does
// 2 * M * K * N float32 operations; at the card's 3.35 TB/s and 67 TFLOP/s
// of float32 outside the tensor cores the operations bound it, slightly
// (11.1 GFLOP ~ 0.17 ms against 390 MB ~ 0.12 ms for the 512 -> 64 layers).
// No tensor cores here: the reference computes in float32.
//
// Design: one 64 x TN output tile per CTA of 256 threads, each thread a
// 4 x (TN/16) register tile accumulated with fmaf in a fixed order over K.
// The K loop stages a 64 x 32 tile of x (coalesced, transposed into padded
// shared memory) and regenerates the matching 32 x TN tile of signs in
// shared memory.  Ragged M, K and N edges are masked, so r = 32 and 64 need
// no padding (the TPU's 128 x 128 tile rule does not apply here).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTM = 64;
constexpr int kTK = 32;
constexpr int kThreads = 256;
constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr uint32_t kRademacherSalt = 0x517CC1B7u;

__host__ __device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

template <int TN>
__global__ void __launch_bounds__(kThreads)
rp_kernel(const float* __restrict__ x, float* __restrict__ out, long long m,
          int k_dim, int n_dim, int r_dim, int transpose, uint32_t seed_hash,
          float scale) {
  constexpr int RM = kTM / 16, RN = TN / 16;
  __shared__ float xs[kTK][kTM + 1];
  __shared__ float rs[kTK][TN];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long m0 = static_cast<long long>(blockIdx.x) * kTM;
  const int n0 = blockIdx.y * TN;
  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < k_dim; k0 += kTK) {
    const int c = threadIdx.x & 31;
#pragma unroll
    for (int i = 0; i < kTM / 8; ++i) {
      const int r = (threadIdx.x >> 5) + 8 * i;
      const long long gm = m0 + r;
      const int gk = k0 + c;
      xs[c][r] = (gm < m && gk < k_dim) ? x[gm * k_dim + gk] : 0.0f;
    }
    for (int idx = threadIdx.x; idx < kTK * TN; idx += kThreads) {
      const int kk = idx / TN, nn = idx % TN;
      const int gk = k0 + kk, gn = n0 + nn;
      float s = 0.0f;
      if (gk < k_dim && gn < n_dim) {
        // element (d, p) of R has counter d * r + p
        const uint32_t counter =
            transpose ? static_cast<uint32_t>(gn) * r_dim + gk
                      : static_cast<uint32_t>(gk) * r_dim + gn;
        s = (fmix32(counter * kGolden + seed_hash) & 1u) ? -scale : scale;
      }
      rs[kk][nn] = s;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTK; ++kk) {
      float a[RM], b[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < RN; ++j) b[j] = rs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const long long gm = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gm < m && gn < n_dim) out[gm * n_dim + gn] = acc[i][j];
    }
  }
}

}  // namespace

// out (m, n_dim) = x (m, k_dim) @ S.  transpose = 0: S = R (k_dim = D,
// n_dim = r_dim); transpose = 1: S = R^T (k_dim = r_dim, n_dim = D).
extern "C" int rp_project(const float* x, float* out, long long m, int k_dim,
                          int n_dim, int r_dim, int transpose,
                          unsigned int seed, float scale, void* stream) {
  const uint32_t seed_hash = fmix32(seed + kRademacherSalt);
  const unsigned gx = static_cast<unsigned>((m + kTM - 1) / kTM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_dim <= 32) {
    rp_kernel<32><<<dim3(gx, (n_dim + 31) / 32), kThreads, 0, s>>>(
        x, out, m, k_dim, n_dim, r_dim, transpose, seed_hash, scale);
  } else {
    rp_kernel<64><<<dim3(gx, (n_dim + 63) / 64), kThreads, 0, s>>>(
        x, out, m, k_dim, n_dim, r_dim, transpose, seed_hash, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
