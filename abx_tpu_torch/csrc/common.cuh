// Shared device helpers for the abx_tpu_torch Hopper kernels.
//
// Every in-kernel matrix product runs on the tensor cores through
// nvcuda::wmma bf16 fragments (m16n16k16, f32 accumulation).  A float32
// operand is split into two bf16 halves, v = hi + lo with |lo| <= 2^-8 |hi|,
// and a product is taken as hi*hi + hi*lo + lo*hi ("bf16x3"): the dropped
// lo*lo term is ~2^-16 of the product, so the f32 kernels agree with a plain
// f32 reference to ~1e-5 relative while using the same code path as bf16.
// For bf16 operands lo is identically zero and the split path is not
// compiled.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace abx {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr float kBigNeg = -1e9f;   // additive key-mask value (BIG_NEG)
constexpr int kWarps = 8;          // every kernel runs 8 warps per block
constexpr int kThreads = kWarps * 32;

template <typename T> struct IsF32 { static constexpr bool value = false; };
template <> struct IsF32<float> { static constexpr bool value = true; };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16(v);
}

// Store v into a bf16 tile (and its low half when SPLIT).
template <bool SPLIT>
__device__ __forceinline__ void put(bf16* hi, bf16* lo, int idx, float v) {
  bf16 h = __float2bfloat16(v);
  hi[idx] = h;
  if constexpr (SPLIT) lo[idx] = __float2bfloat16(v - __bfloat162float(h));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragBr = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// acc += A(16x16) * B(16x16) from shared-memory tiles; with SPLIT the low
// halves add the two cross terms.
template <bool SPLIT, typename FragB>
__device__ __forceinline__ void mma16(FragC& acc, const bf16* a_hi,
                                      const bf16* a_lo, int lda,
                                      const bf16* b_hi, const bf16* b_lo,
                                      int ldb) {
  FragA a;
  FragB b;
  wmma::load_matrix_sync(a, a_hi, lda);
  wmma::load_matrix_sync(b, b_hi, ldb);
  wmma::mma_sync(acc, a, b, acc);
  if constexpr (SPLIT) {
    FragA a2;
    FragB b2;
    wmma::load_matrix_sync(b2, b_lo, ldb);
    wmma::mma_sync(acc, a, b2, acc);
    wmma::load_matrix_sync(a2, a_lo, lda);
    wmma::mma_sync(acc, a2, b, acc);
  }
}

// acc[t] += A(16x16) * B_t(16x16) for t < min(n, NT), B_t at b + t*b_step:
// one warp's row of output tiles, with the A fragment loaded once.
template <bool SPLIT, typename FragB, int NT>
__device__ __forceinline__ void mma16_row(FragC* acc, int n, const bf16* a_hi,
                                          const bf16* a_lo, int lda,
                                          const bf16* b_hi, const bf16* b_lo,
                                          int ldb, int b_step) {
  FragA a, a2;
  wmma::load_matrix_sync(a, a_hi, lda);
  if constexpr (SPLIT) wmma::load_matrix_sync(a2, a_lo, lda);
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    if (t >= n) break;
    FragB b;
    wmma::load_matrix_sync(b, b_hi + t * b_step, ldb);
    wmma::mma_sync(acc[t], a, b, acc[t]);
    if constexpr (SPLIT) {
      FragB b2;
      wmma::load_matrix_sync(b2, b_lo + t * b_step, ldb);
      wmma::mma_sync(acc[t], a, b2, acc[t]);
      wmma::mma_sync(acc[t], a2, b, acc[t]);
    }
  }
}

struct Identity {
  __device__ float operator()(int, int, float v) const { return v; }
};

// x[k] = p[k] for the 8 elements of a source row segment at column c (zero
// where the row or column is outside the valid region), with 16-byte loads
// where the segment is aligned and in range.
template <typename T>
__device__ __forceinline__ void load8(const T* p, bool row_ok, int c,
                                      int cols_valid, float* x) {
  if (row_ok && c + 8 <= cols_valid &&
      (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    if constexpr (IsF32<T>::value) {
      const float4 a = reinterpret_cast<const float4*>(p)[0];
      const float4 b = reinterpret_cast<const float4*>(p)[1];
      x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
      x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
    } else {
      const uint4 u = reinterpret_cast<const uint4*>(p)[0];
      const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
      for (int k = 0; k < 8; ++k) x[k] = __bfloat162float(e[k]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      x[k] = (row_ok && c + k < cols_valid) ? to_f32(p[k]) : 0.f;
  }
}

// p[k] = v[k] for 8 elements with 16-byte stores; p must be 16-byte
// aligned.
template <typename T>
__device__ __forceinline__ void store8(T* p, const float* v) {
  if constexpr (IsF32<T>::value) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    alignas(16) bf16 h[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) h[k] = __float2bfloat16(v[k]);
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(h);
  }
}

// Stage a (rows x cols) tile of T from device memory (row stride ld_src,
// valid region rows_valid x cols_valid, zero outside) into bf16 shared
// tiles with row stride ld_dst, applying f(row, col, value) on the way.
// cols and ld_dst are multiples of 8; each thread moves 8 elements with
// 16-byte loads where the source row segment is aligned and in range.
template <typename T, bool SPLIT, typename F = Identity>
__device__ __forceinline__ void stage_tile(const T* __restrict__ src,
                                           size_t ld_src, int rows_valid,
                                           int cols_valid, bf16* hi,
                                           bf16* lo, int ld_dst, int rows,
                                           int cols, F f = F()) {
  const int vpr = cols / 8;
  for (int v = threadIdx.x; v < rows * vpr; v += blockDim.x) {
    const int r = v / vpr, c = (v % vpr) * 8;
    float x[8];
    load8(src + (size_t)r * ld_src + c, r < rows_valid, c, cols_valid, x);
    alignas(16) bf16 h[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const bool in = r < rows_valid && c + k < cols_valid;
      const float y = in ? f(r, c + k, x[k]) : 0.f;
      h[k] = __float2bfloat16(y);
      if constexpr (SPLIT)
        lo[r * ld_dst + c + k] = __float2bfloat16(y - __bfloat162float(h[k]));
    }
    *reinterpret_cast<uint4*>(hi + r * ld_dst + c) =
        *reinterpret_cast<const uint4*>(h);
  }
}

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// 128-byte aligned carve-out of dynamic shared memory.
struct SmemCarver {
  unsigned char* base;
  size_t off;
  __device__ explicit SmemCarver(unsigned char* b) : base(b), off(0) {}
  template <typename T>
  __device__ T* take(size_t n) {
    T* p = reinterpret_cast<T*>(base + off);
    off += (n * sizeof(T) + 127) / 128 * 128;
    return p;
  }
};

__host__ inline size_t carve_bytes(size_t n_bytes) {
  return (n_bytes + 127) / 128 * 128;
}

template <typename Kernel>
__host__ inline cudaError_t set_smem(Kernel k, size_t bytes) {
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace abx
