// Triangle-multiplication contraction in the natural (B, L, L, C) layout:
//   per_row:    out[b, i, j, c] = sum_k left[b, i, k, c] * right[b, j, k, c]
//   per_column: out[b, i, j, c] = sum_k left[b, k, i, c] * right[b, k, j, c]
//
// Replaces the Pallas TPU kernel abx_tpu/ops/triangle.py::
// triangle_multiply_pallas (ABX_PALLAS_TRIANGLE=1).
// Bound on the H100: device-memory bytes at the flagship shape (left, right
// and out, 3 x 85 MB in bf16 at B=4, L=288, C=128, against 24.5 GFLOP).
// Design: one 256-thread block per (32 x 32 tile of (i, j), 16-channel
// block, batch).  K is streamed in 32-wide chunks: each chunk's (32 rows x
// 32 k x 16 channels) slices of left and right are gathered with 16-byte
// loads (16 channels are contiguous in memory) and re-laid channel-major in
// shared memory, so that every channel is a pair of wmma operands; the
// per_column orientation only changes the gather's addresses, so neither
// operand is transposed in device memory.  Warp w owns channels 2w and
// 2w+1, four 16 x 16 f32 accumulator tiles each.  The channel block is
// chosen so those accumulators (64 registers a thread) and the staging
// planes (80 KB in bf16, 160 KB with the f32 bf16x3 split) fit.  Ragged L
// and C are zero-padded while staging.  The result goes through shared
// memory (aliasing the staging planes) so that it is written with c
// innermost, 16 bytes a thread.
#include "common.cuh"

namespace abx {
namespace {

constexpr int kT = 32;                 // i and j tile
constexpr int kTK = 32;                // k chunk
constexpr int kCB = 16;                // channels per block
constexpr int kLDK = kTK + 8;          // bf16 elements
constexpr int kPlane = kT * kLDK;      // one channel's (32 x 32) operand
constexpr int kLDO = kT + 4;           // floats
constexpr int kVec = kCB / 8;          // 16-byte vectors per (row, k)
constexpr int kChPerWarp = kCB / kWarps;

template <typename T>
size_t triangle_smem_bytes() {
  constexpr int parts = IsF32<T>::value ? 2 : 1;
  const size_t stage =
      2 * parts * carve_bytes(sizeof(bf16) * kCB * kPlane);
  const size_t outb = carve_bytes(sizeof(float) * kCB * kT * kLDO);
  return stage > outb ? stage : outb;
}

// Gather the (32 rows x 32 k x 16 channels) slice of one operand into
// channel-major planes: plane c holds [row][k].  Element (r, k, c) is at
// base[((r0 + r) * L + k0 + k) * C + c0 + c] for per_row and at
// base[((k0 + k) * L + r0 + r) * C + c0 + c] for per_column; the index
// that is contiguous in memory runs fastest across threads.
template <typename T, bool SPLIT>
__device__ __forceinline__ void stage_operand(const T* __restrict__ base,
                                              int L, int C, bool per_row,
                                              int r0, int k0, int c0,
                                              bf16* hi, bf16* lo) {
  for (int v = threadIdx.x; v < kT * kTK * kVec; v += kThreads) {
    const int q = v % kVec, rk = v / kVec;
    const int r = per_row ? rk / kTK : rk % kT;
    const int k = per_row ? rk % kTK : rk / kT;
    const int gr = r0 + r, gk = k0 + k, c = c0 + q * 8;
    const size_t cell = per_row ? (size_t)gr * L + gk : (size_t)gk * L + gr;
    float x[8];
    load8(base + cell * C + c, gr < L && gk < L, c, C, x);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      put<SPLIT>(hi, lo, (q * 8 + e) * kPlane + r * kLDK + k, x[e]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    triangle_kernel(const T* __restrict__ left, const T* __restrict__ right,
                    T* __restrict__ out, int L, int C, int per_row) {
  constexpr bool SPLIT = IsF32<T>::value;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  SmemCarver sc(smem_raw);
  bf16* l_hi = sc.take<bf16>(kCB * kPlane);
  bf16* l_lo = SPLIT ? sc.take<bf16>(kCB * kPlane) : l_hi;
  bf16* r_hi = sc.take<bf16>(kCB * kPlane);
  bf16* r_lo = SPLIT ? sc.take<bf16>(kCB * kPlane) : r_hi;
  float* o_s = reinterpret_cast<float*>(smem_raw);  // after the k loop

  const int tiles = (L + kT - 1) / kT;
  const int i0 = (blockIdx.x / tiles) * kT, j0 = (blockIdx.x % tiles) * kT;
  const int c0 = blockIdx.y * kCB;
  const size_t batch = (size_t)blockIdx.z * L * L * C;
  const int warp = threadIdx.x >> 5;

  FragC acc[kChPerWarp][4];
#pragma unroll
  for (int ch = 0; ch < kChPerWarp; ++ch)
#pragma unroll
    for (int t = 0; t < 4; ++t) wmma::fill_fragment(acc[ch][t], 0.f);

  for (int k0 = 0; k0 < L; k0 += kTK) {
    stage_operand<T, SPLIT>(left + batch, L, C, per_row, i0, k0, c0, l_hi,
                            l_lo);
    stage_operand<T, SPLIT>(right + batch, L, C, per_row, j0, k0, c0, r_hi,
                            r_lo);
    __syncthreads();
#pragma unroll
    for (int ch = 0; ch < kChPerWarp; ++ch) {
      const int pl = (warp * kChPerWarp + ch) * kPlane;
#pragma unroll
      for (int kk = 0; kk < kTK; kk += 16) {
        FragA a[2], a_lo[2];
        FragBc bm[2], b_lo[2];
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          wmma::load_matrix_sync(a[t], l_hi + pl + t * 16 * kLDK + kk, kLDK);
          wmma::load_matrix_sync(bm[t], r_hi + pl + t * 16 * kLDK + kk,
                                 kLDK);
          if constexpr (SPLIT) {
            wmma::load_matrix_sync(a_lo[t], l_lo + pl + t * 16 * kLDK + kk,
                                   kLDK);
            wmma::load_matrix_sync(b_lo[t], r_lo + pl + t * 16 * kLDK + kk,
                                   kLDK);
          }
        }
#pragma unroll
        for (int ti = 0; ti < 2; ++ti)
#pragma unroll
          for (int tj = 0; tj < 2; ++tj) {
            FragC& c = acc[ch][ti * 2 + tj];
            wmma::mma_sync(c, a[ti], bm[tj], c);
            if constexpr (SPLIT) {
              wmma::mma_sync(c, a[ti], b_lo[tj], c);
              wmma::mma_sync(c, a_lo[ti], bm[tj], c);
            }
          }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int ch = 0; ch < kChPerWarp; ++ch)
#pragma unroll
    for (int t = 0; t < 4; ++t)
      wmma::store_matrix_sync(
          o_s + (warp * kChPerWarp + ch) * kT * kLDO +
              (t / 2) * 16 * kLDO + (t % 2) * 16,
          acc[ch][t], kLDO, wmma::mem_row_major);
  __syncthreads();

  const bool vec = C % 8 == 0;
  for (int v = threadIdx.x; v < kT * kT * kVec; v += kThreads) {
    const int q = v % kVec, ij = v / kVec;
    const int i = ij / kT, j = ij % kT;
    const int c = c0 + q * 8;
    if (i0 + i >= L || j0 + j >= L || c >= C) continue;
    float x[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = o_s[(q * 8 + e) * kT * kLDO + i * kLDO + j];
    const size_t o = batch + ((size_t)(i0 + i) * L + j0 + j) * C + c;
    if (vec && c + 8 <= C) {
      store8(out + o, x);
    } else {
      for (int e = 0; e < 8 && c + e < C; ++e) out[o + e] = from_f32<T>(x[e]);
    }
  }
}

template <typename T>
cudaError_t launch_triangle(const void* left, const void* right, void* out,
                            int B, int L, int C, int per_row,
                            cudaStream_t stream) {
  const size_t smem = triangle_smem_bytes<T>();
  cudaError_t e = set_smem(triangle_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  const int tiles = (L + kT - 1) / kT;
  const dim3 grid(tiles * tiles, (C + kCB - 1) / kCB, B);
  triangle_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(left), static_cast<const T*>(right),
      static_cast<T*>(out), L, C, per_row);
  return cudaGetLastError();
}

}  // namespace
}  // namespace abx

// dtype: 0 = float32, 1 = bfloat16.  left, right and out (B, L, L, C);
// per_row: 1 for the outgoing (per_row) orientation, 0 for per_column.
// Returns the cudaError_t of the launch.
extern "C" int abx_triangle_multiply(int dtype, const void* left,
                                     const void* right, void* out, int B,
                                     int L, int C, int per_row,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? abx::launch_triangle<float>(left, right, out, B, L, C,
                                                  per_row, s)
                    : abx::launch_triangle<abx::bf16>(left, right, out, B, L,
                                                      C, per_row, s);
}
