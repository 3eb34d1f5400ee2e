// IPA attend-over-pair: out[b, i, h*C + c] = sum_j attn[b, h, i, j] *
// pair[b, i, j, c].
//
// Replaces the Pallas TPU kernel abx_tpu/ops/ipa_attend.py::ipa_pair_attend
// (the non-fused IPA route, ABX_FUSED_IPA_ATTN=0 with ABX_IPA_ATTEND=1).
// Each query row i contracts its own pair row: an (H x J) by (J x C)
// product per (b, i) with H = 12.
// Bound on the H100: device-memory bytes.  The pair track is read once
// (85 MB in bf16 at B=4, L=288, C=128) and the f32 attention once (16 MB);
// the product is ~1 GFLOP.
// Design: one 256-thread block per (query row i, 128-column block of C,
// batch).  The H rows of attn[b, :, i, :] are padded to one 16-row wmma M
// tile and rounded to the pair dtype while they are staged (the JAX
// wrapper's cast of attn to the pair dtype, without a separate pass); the
// pair row P[b, i] streams through shared memory in 64-row J chunks, read
// once for all heads.  Warp w owns output columns 16w .. 16w+15.  Products
// are wmma bf16 (bf16x3 for f32 pairs, see common.cuh); the 12 valid rows
// are written in the concat-ready (B, L, H*C) layout.
#include "common.cuh"

namespace abx {
namespace {

constexpr int kHeads = 16;        // H padded to one wmma M tile
constexpr int kBJ = 64;           // J chunk
constexpr int kBC = kWarps * 16;  // C columns per block
constexpr int kLDA = kBJ + 8;     // bf16 elements
constexpr int kLDB = kBC + 8;     // bf16 elements
constexpr int kLDO = kBC + 4;     // floats

template <typename T>
size_t attend_smem_bytes() {
  constexpr int parts = IsF32<T>::value ? 2 : 1;
  return parts * carve_bytes(sizeof(bf16) * kHeads * kLDA) +
         parts * carve_bytes(sizeof(bf16) * kBJ * kLDB) +
         carve_bytes(sizeof(float) * kHeads * kLDO);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ipa_attend_kernel(const float* __restrict__ attn,
                      const T* __restrict__ pair, T* __restrict__ out, int H,
                      int L, int C) {
  constexpr bool SPLIT = IsF32<T>::value;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  SmemCarver sc(smem_raw);
  bf16* a_hi = sc.take<bf16>(kHeads * kLDA);
  bf16* a_lo = SPLIT ? sc.take<bf16>(kHeads * kLDA) : a_hi;
  bf16* b_hi = sc.take<bf16>(kBJ * kLDB);
  bf16* b_lo = SPLIT ? sc.take<bf16>(kBJ * kLDB) : b_hi;
  float* o_s = sc.take<float>(kHeads * kLDO);

  const int i = blockIdx.x, n0 = blockIdx.y * kBC, b = blockIdx.z;
  const int cols = min(kBC, C - n0);
  const int warp = threadIdx.x >> 5;
  // Row h of the query's attention at a_src + h * L * L.
  const float* a_src = attn + ((size_t)b * H * L + i) * L;
  const T* p_src = pair + ((size_t)b * L + i) * L * C + n0;

  FragC acc;
  wmma::fill_fragment(acc, 0.f);
  for (int j0 = 0; j0 < L; j0 += kBJ) {
    stage_tile<float, SPLIT>(a_src + j0, (size_t)L * L, H, L - j0, a_hi,
                             a_lo, kLDA, kHeads, kBJ);
    stage_tile<T, SPLIT>(p_src + (size_t)j0 * C, C, L - j0, cols, b_hi, b_lo,
                         kLDB, kBJ, kBC);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBJ; kk += 16)
      mma16<SPLIT, FragBr>(acc, a_hi + kk, a_lo + kk, kLDA,
                           b_hi + kk * kLDB + warp * 16,
                           b_lo + kk * kLDB + warp * 16, kLDB);
    __syncthreads();
  }
  wmma::store_matrix_sync(o_s + warp * 16, acc, kLDO, wmma::mem_row_major);
  __syncthreads();

  T* dst = out + ((size_t)b * L + i) * H * C + n0;
  const bool vec = C % 8 == 0;
  for (int idx = threadIdx.x; idx < H * kBC / 8; idx += kThreads) {
    const int h = idx / (kBC / 8), c = (idx % (kBC / 8)) * 8;
    if (c >= cols) continue;
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = o_s[h * kLDO + c + k];
    const size_t o = (size_t)h * C + c;
    if (vec && c + 8 <= cols) {
      store8(dst + o, v);
    } else {
      for (int k = 0; k < 8 && c + k < cols; ++k)
        dst[o + k] = from_f32<T>(v[k]);
    }
  }
}

template <typename T>
cudaError_t launch_attend(const float* attn, const void* pair, void* out,
                          int B, int H, int L, int C, cudaStream_t stream) {
  const size_t smem = attend_smem_bytes<T>();
  cudaError_t e = set_smem(ipa_attend_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(L, (C + kBC - 1) / kBC, B);
  ipa_attend_kernel<T><<<grid, kThreads, smem, stream>>>(
      attn, static_cast<const T*>(pair), static_cast<T*>(out), H, L, C);
  return cudaGetLastError();
}

}  // namespace
}  // namespace abx

// dtype (of pair and out): 0 = float32, 1 = bfloat16.  attn (B, H, L, L)
// f32 with H <= 16; pair (B, L, L, C); out (B, L, H*C).  Returns the
// cudaError_t of the launch.
extern "C" int abx_ipa_pair_attend(int dtype, const float* attn,
                                   const void* pair, void* out, int B, int H,
                                   int L, int C, void* stream) {
  if (H > abx::kHeads) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? abx::launch_attend<float>(attn, pair, out, B, H, L, C, s)
             : abx::launch_attend<abx::bf16>(attn, pair, out, B, H, L, C, s);
}
