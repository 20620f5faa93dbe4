// Causal or full online-softmax attention (flash attention), SIMT float32.
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
// (valid keys) mask like the reference's chunk scan, and with scale_q the
// scale multiplies q in float32 before the product (the reference's
// (q * scale) . k order) instead of the scores after it (the Pallas kernel's
// (q . k) * scale order).
//
// What bounds it on an H100: operations.  At the serving prefill shape
// (80 heads x 1000 tokens x d_head 128, causal) it does 4 * BH * Dh flops
// per (query, key) pair it keeps, 20.5 GFLOP, against 82 MB of q, k, v and
// out: about 250 flops a byte, far above the float32 balance.  This kernel
// keeps the reference's float32 arithmetic on the SIMT cores (no bf16 or
// TF32 tensor-core products, P stays float32), so its bound is the card's
// 67 TFLOP/s float32 rate.
//
// Design (simple first): one CTA of 256 threads per (bh, 64-row query tile),
// heaviest causal tiles launched first.  Q of the tile is staged once in
// shared memory as float32 (transposed, padded stride 65: no bank
// conflicts); each 64-row key tile is staged as K^T and V in float32.
// Thread (rg, cg) = (tid / 16, tid % 16) owns query rows rg + 16 i (i < 4):
// it computes their scores against keys cg + 16 j (j < 4), reduces the row
// max and sum over the 16 threads of its row group with shuffles, keeps m
// and l for its 4 rows in registers, writes P into the K^T buffer (K is
// consumed by then), and accumulates acc for columns cg + 16 j of its rows
// (j < Dh / 16) in registers.  Ragged Sq and Skv edges are masked here, so
// nothing is padded outside.  Masked scores are the reference's finite
// NEG_INF = -1e30, so a fully masked tile never makes a NaN and the first
// tile's correction exp(-1e30 - m) is exactly 0.
//
// Built with --fmad=false (as every source of the port): the products ask
// for their FMAs (__fmaf_rn), and expf is the accurate one, not __expf.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;    // query rows per CTA
constexpr int kBlockK = 64;    // keys per staged tile
constexpr int kThreads = 256;  // 16 row groups x 16 column groups
constexpr int kLd = 65;        // padded stride of the transposed tiles
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

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

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int sq, int skv,
             int causal, int q_offset, int kv_len, float scale, int scale_q) {
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
  const T* qb = q + (bh * sq + q0) * DH;
  const T* kb = k + bh * skv * DH;
  const T* vb = v + bh * skv * DH;

  for (int e = tid; e < kBlockQ * DH; e += kThreads) {
    const int r = e / DH, d = e % DH;
    float x = q0 + r < sq ? to_f32(qb[static_cast<long long>(r) * DH + d])
                          : 0.0f;
    if (scale_q) x = __fmul_rn(x, scale);
    qs[d * kLd + r] = x;
  }

  const int kv_end = kv_len < skv ? kv_len : skv;
  int n_kt = (kv_end + kBlockK - 1) / kBlockK;
  if (causal) {
    const int last_row = (q0 + kBlockQ < sq ? q0 + kBlockQ : sq) - 1;
    const int last_k = (q_offset + last_row) / kBlockK + 1;
    n_kt = n_kt < last_k ? n_kt : last_k;
  }

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
      kp[d * kLd + c] = in ? to_f32(kb[off]) : 0.0f;
      vs[c * DH + d] = in ? to_f32(vb[off]) : 0.0f;
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
    T* o = out + (bh * sq + q0 + r) * DH;
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      store(o + cg + 16 * j, __fdiv_rn(acc[i][j], denom));
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int sq, int skv, int causal, int q_offset, int kv_len, float scale,
           int scale_q, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(flash_kernel<T, DH>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, bh);
  flash_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, skv, causal,
      q_offset, kv_len, scale, scale_q);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int dh, const void* q, const void* k, const void* v, void* out,
             int bh, int sq, int skv, int causal, int q_offset, int kv_len,
             float scale, int scale_q, cudaStream_t stream) {
  switch (dh) {
    case 16:
      return launch<T, 16>(q, k, v, out, bh, sq, skv, causal, q_offset,
                           kv_len, scale, scale_q, stream);
    case 32:
      return launch<T, 32>(q, k, v, out, bh, sq, skv, causal, q_offset,
                           kv_len, scale, scale_q, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, bh, sq, skv, causal, q_offset,
                           kv_len, scale, scale_q, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, bh, sq, skv, causal, q_offset,
                            kv_len, scale, scale_q, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (bh, sq, dh), k/v (bh, skv, dh), out (bh, sq, dh), all float32
// (is_bf16 = 0) or all bfloat16 (is_bf16 = 1), contiguous.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int bh, int sq, int skv, int dh,
                               int is_bf16, int causal, int q_offset,
                               int kv_len, float scale, int scale_q,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return dispatch<__nv_bfloat16>(dh, q, k, v, out, bh, sq, skv, causal,
                                   q_offset, kv_len, scale, scale_q, s);
  }
  return dispatch<float>(dh, q, k, v, out, bh, sq, skv, causal, q_offset,
                         kv_len, scale, scale_q, s);
}
