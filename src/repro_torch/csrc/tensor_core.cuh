// Tensor-core and async-copy helpers shared by the kernels that run their
// products on Hopper's tensor cores: rp_matmul.cu (rp_project, split TF32),
// fused_matmul.cu (matmul_quant in split TF32, dequant_matmul in split
// bf16) and flash_attention.cu (bf16).
//
// cp.async copies device memory into shared memory without passing through
// registers, 16 bytes (cg: L2 only) or 4 bytes (ca) a thread; a src_bytes
// below the copy size zero-fills the rest, which masks ragged edges.  The
// copies of a thread are grouped by commit and waited for by wait<N>: all
// but the N most recent groups have landed.
//
// split_tf32 and mma_tf32: a float32 value is carried into the tensor cores
// as two TF32 parts (see split_tf32); mma_tf32 is one m16n8k8 product with
// float32 accumulators (A row-major, B column-major fragments as the PTX
// ISA lays them out for .tf32).
//
// pack_bf16, split_bf16, ldmatrix_* and mma_bf16: the same in bf16 (see
// split_bf16); mma_bf16 is one m16n8k16 product with float32 accumulators,
// its fragments read from shared memory by ldmatrix (.trans: the stored
// 8 x 8 matrices transposed, so a [k][m] or [k][n] layout gives A or B).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = hi + lo + e with hi, lo in TF32 and |e| <= 2^-22 |x|.  Each part is
// rounded to nearest, ties away from zero, as cvt.rna.tf32.f32 rounds a
// finite value: half of the 13 dropped bits is added to the magnitude.  hi
// is masked because it is subtracted; the mma ignores the 13 low bits of
// lo.  For a finite |x| >= (2 - 2^-11) * 2^127 hi rounds to inf, and for an
// infinite or NaN x lo is NaN, as with cvt.rna.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(__fsub_rn(v, __uint_as_float(hi))) + 0x1000u;
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as a bf16 pair, x0 in the low half (the lower column),
// each rounded to nearest, ties to even, as cvt.rn.bf16x2.f32 rounds.
__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Two floats as bf16 hi and lo pairs: x = hi + lo + e with |e| <= 2^-16 |x|,
// hi = rn(x), lo = rn(x - hi).  x - hi is exact in float32.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  lo = pack_bf16(__fsub_rn(x0, hf.x), __fsub_rn(x1, hf.y));
  hi = *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s)
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace tc
