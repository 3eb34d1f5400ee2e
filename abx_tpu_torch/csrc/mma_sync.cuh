// Register-level tensor-core helpers: cp.async staging, ldmatrix and
// mma.sync.m16n8k16 (bf16 in, f32 accumulate).
//
// Fragment layouts of mma.m16n8k16 (lane = 4 * g + t):
//   A (16 x 16, row-major): a0 = (g, 2t..2t+1), a1 = (g+8, 2t..2t+1),
//                           a2 = (g, 2t+8..2t+9), a3 = (g+8, 2t+8..2t+9)
//   B (16 x 8, k x n):      b0 = (2t..2t+1, g), b1 = (2t+8..2t+9, g)
//   C (16 x 8, f32):        c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, 2t..2t+1)
// Each bf16x2 register holds the element of lower column (A) or row (B)
// in its low half.  The C layout of two neighbouring n8 tiles is the A
// layout of one k16 step, so a product's result can feed the next product
// from registers.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace abx {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy from device to shared memory; with ok false
// nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices; lanes 8m .. 8m+7 give the row addresses of
// matrix m, and register m of lane 4g + t receives its (g, 2t..2t+1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// As ldmatrix_x4, transposed: register m of lane 4g + t receives
// (2t..2t+1, g) of matrix m.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d += a * b on one m16n8k16 tile.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) rounded to bf16, x0 in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  return bf16x2_bits(__floats2bfloat162_rn(x0, x1));
}

// (x0, x1) = hi + lo in bf16 pairs (the bf16x3 split of common.cuh).
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

}  // namespace abx
