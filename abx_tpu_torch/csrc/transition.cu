// Fused pair transition: out = x + ReLU(LN(x) W1^T + b1) W2^T + b2.
//
// Replaces abx_tpu/ops/transition.py::fused_transition (Pallas TPU) for f32
// inputs and for C above 192 or not a multiple of 8; bf16 launches with
// C <= 192 run the Hopper kernel of transition_sm90.cu.
// Bound on the H100: tensor-core operations.  At the flagship shape
// (x: 4*288*288 rows of C=192, hidden N=4C=768) a call is ~196 GFLOP
// against ~255 MB of bf16 input and output, ~770 flop/byte, above the
// H100's ~295 flop/byte ridge.  Without fusion the (M, 4C) intermediate
// (~510 MB in bf16) would be written and read back.
// Design: a block owns BM rows.  It LayerNorms them into shared memory
// once, then walks the hidden dimension in 64-wide chunks: chunk h =
// ReLU(LN(x) W1[chunk]^T + b1) stays in shared memory and is immediately
// contracted with W2[:, chunk] into f32 accumulator fragments held in
// registers across the chunks (C <= 256).  The 4C intermediate never
// reaches device memory.  Tiles are staged with 16-byte loads.
// Products are wmma bf16 (bf16x3 for f32 inputs, see common.cuh).
#include "common.cuh"

namespace abx {

constexpr int kNB = 64;    // hidden-dimension chunk
constexpr int kMaxYT = 8;  // output accumulator tiles per warp (C <= 256)

template <typename T>
struct TransitionTile {
  static constexpr bool SPLIT = IsF32<T>::value;
  static constexpr int BM = SPLIT ? 32 : 64;
};

struct TransitionLayout {
  int cp, ldx, ldw2, ldh, ldhb, ldy;
  __host__ __device__ explicit TransitionLayout(int c) {
    cp = round_up(c, 16);
    ldx = cp + 8;      // bf16: LN(x) tile and W1 chunk, [row][k]
    ldw2 = kNB + 8;    // bf16: W2 chunk stored [c][k]
    ldh = kNB + 4;     // f32 hidden chunk
    ldhb = kNB + 8;    // bf16 hidden chunk
    ldy = cp + 4;      // f32 output tile (aliases the weight chunks)
  }
};

template <typename T>
size_t transition_smem_bytes(int c) {
  constexpr int BM = TransitionTile<T>::BM;
  constexpr int parts = TransitionTile<T>::SPLIT ? 2 : 1;
  const TransitionLayout q(c);
  return parts * carve_bytes(sizeof(bf16) * BM * q.ldx) +
         parts * carve_bytes(sizeof(bf16) * kNB * q.ldx) +
         parts * carve_bytes(sizeof(bf16) * q.cp * q.ldw2) +
         carve_bytes(sizeof(float) * BM * q.ldh) +
         parts * carve_bytes(sizeof(bf16) * BM * q.ldhb) +
         2 * carve_bytes(sizeof(float) * BM);
}

struct RowLnXform {  // LayerNorm of the staged rows
  const float* mean;
  const float* rstd;
  const float* scale;
  const float* bias;
  __device__ float operator()(int r, int c, float v) const {
    return (v - mean[r]) * rstd[r] * scale[c] + bias[c];
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    transition_kernel(const T* __restrict__ x, int M, int C,
                      const float* __restrict__ ln_s,
                      const float* __restrict__ ln_b,
                      const T* __restrict__ w1, const float* __restrict__ b1,
                      const T* __restrict__ w2, const float* __restrict__ b2,
                      T* __restrict__ out, int N) {
  constexpr bool SPLIT = TransitionTile<T>::SPLIT;
  constexpr int BM = TransitionTile<T>::BM;
  const TransitionLayout q(C);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  SmemCarver sc(smem_raw);
  bf16* xn_hi = sc.take<bf16>(BM * q.ldx);
  bf16* xn_lo = SPLIT ? sc.take<bf16>(BM * q.ldx) : xn_hi;
  bf16* w1_hi = sc.take<bf16>(kNB * q.ldx);
  bf16* w1_lo = SPLIT ? sc.take<bf16>(kNB * q.ldx) : w1_hi;
  bf16* w2_hi = sc.take<bf16>(q.cp * q.ldw2);
  bf16* w2_lo = SPLIT ? sc.take<bf16>(q.cp * q.ldw2) : w2_hi;
  float* h_s = sc.take<float>(BM * q.ldh);
  bf16* hb_hi = sc.take<bf16>(BM * q.ldhb);
  bf16* hb_lo = SPLIT ? sc.take<bf16>(BM * q.ldhb) : hb_hi;
  float* mean_s = sc.take<float>(BM);
  float* rstd_s = sc.take<float>(BM);
  // The f32 output tile is written once, after the last chunk, over the
  // (then dead) W1/W2 chunk buffers, which are at least as large.
  float* y_s = reinterpret_cast<float*>(w1_hi);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * BM;
  const int rows = min(BM, M - m0);

  for (int i = warp; i < BM; i += kWarps) {
    float s = 0.f, s2 = 0.f;
    if (i < rows) {
      for (int k = lane; k < C; k += 32) {
        const float v = to_f32(x[(size_t)(m0 + i) * C + k]);
        s += v;
        s2 += v * v;
      }
    }
    s = warp_sum(s);
    s2 = warp_sum(s2);
    if (lane == 0) {
      const float mu = s / C;
      mean_s[i] = mu;
      rstd_s[i] = rsqrtf(fmaxf(s2 / C - mu * mu, 0.f) + 1e-5f);
    }
  }
  __syncthreads();
  stage_tile<T, SPLIT>(x + (size_t)m0 * C, C, rows, C, xn_hi, xn_lo, q.ldx,
                       BM, q.cp, RowLnXform{mean_s, rstd_s, ln_s, ln_b});

  // Warp w owns output row tile tm = w % nrow and a run of column tiles,
  // so each A fragment is loaded once per k-step (mma16_row).
  constexpr int nrow = BM / 16, wpr = kWarps / nrow;
  constexpr int per1 = (kNB / 16) / wpr;          // GEMM1 tiles per warp
  const int tm = warp % nrow;
  const int tn1 = (warp / nrow) * per1;
  const int per2 = (q.cp / 16 + wpr - 1) / wpr;   // GEMM2 tiles per warp
  const int tn2 = (warp / nrow) * per2;
  const int n2 = max(0, min(per2, q.cp / 16 - tn2));
  FragC yacc[kMaxYT];
#pragma unroll
  for (int k = 0; k < kMaxYT; ++k) wmma::fill_fragment(yacc[k], 0.f);
  for (int n0 = 0; n0 < N; n0 += kNB) {
    __syncthreads();  // previous chunk's GEMM2 done with w2/hb
    stage_tile<T, SPLIT>(w1 + (size_t)n0 * C, C, min(kNB, N - n0), C, w1_hi,
                         w1_lo, q.ldx, kNB, q.cp);
    stage_tile<T, SPLIT>(w2 + n0, N, C, min(kNB, N - n0), w2_hi, w2_lo,
                         q.ldw2, q.cp, kNB);
    __syncthreads();
    {
      FragC acc[per1];
#pragma unroll
      for (int t = 0; t < per1; ++t) wmma::fill_fragment(acc[t], 0.f);
      for (int kk = 0; kk < q.cp; kk += 16)
        mma16_row<SPLIT, FragBc, per1>(
            acc, per1, xn_hi + tm * 16 * q.ldx + kk,
            xn_lo + tm * 16 * q.ldx + kk, q.ldx,
            w1_hi + tn1 * 16 * q.ldx + kk, w1_lo + tn1 * 16 * q.ldx + kk,
            q.ldx, 16 * q.ldx);
#pragma unroll
      for (int t = 0; t < per1; ++t)
        wmma::store_matrix_sync(h_s + tm * 16 * q.ldh + (tn1 + t) * 16,
                                acc[t], q.ldh, wmma::mem_row_major);
    }
    __syncthreads();
    for (int idx = tid; idx < BM * kNB; idx += kThreads) {
      const int i = idx / kNB, j = idx % kNB, n = n0 + j;
      const float v = n < N ? fmaxf(h_s[i * q.ldh + j] + b1[n], 0.f) : 0.f;
      put<SPLIT>(hb_hi, hb_lo, i * q.ldhb + j, v);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kNB; kk += 16)
      mma16_row<SPLIT, FragBc, kMaxYT>(
          yacc, n2, hb_hi + tm * 16 * q.ldhb + kk,
          hb_lo + tm * 16 * q.ldhb + kk, q.ldhb,
          w2_hi + tn2 * 16 * q.ldw2 + kk, w2_lo + tn2 * 16 * q.ldw2 + kk,
          q.ldw2, 16 * q.ldw2);
  }
  __syncthreads();  // all warps done with the weight chunks y_s overlays
#pragma unroll
  for (int k = 0; k < kMaxYT; ++k) {
    if (k >= n2) break;
    wmma::store_matrix_sync(y_s + tm * 16 * q.ldy + (tn2 + k) * 16, yacc[k],
                            q.ldy, wmma::mem_row_major);
  }
  __syncthreads();
  for (int idx = tid; idx < BM * C; idx += kThreads) {
    const int i = idx / C, c = idx % C;
    if (i >= rows) continue;
    const size_t m = (size_t)(m0 + i) * C + c;
    out[m] = from_f32<T>(y_s[i * q.ldy + c] + b2[c] + to_f32(x[m]));
  }
}

template <typename T>
cudaError_t launch_transition(const void* x, int M, int C, const float* ln_s,
                              const float* ln_b, const void* w1,
                              const float* b1, const void* w2,
                              const float* b2, void* out, int N,
                              cudaStream_t stream) {
  const size_t smem = transition_smem_bytes<T>(C);
  cudaError_t e = set_smem(transition_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  constexpr int BM = TransitionTile<T>::BM;
  const dim3 grid((M + BM - 1) / BM);
  transition_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), M, C, ln_s, ln_b, static_cast<const T*>(w1),
      b1, static_cast<const T*>(w2), b2, static_cast<T*>(out), N);
  return cudaGetLastError();
}

}  // namespace abx

extern "C" int abx_fused_transition(int dtype, const void* x, int M, int C,
                                    const float* ln_s, const float* ln_b,
                                    const void* w1, const float* b1,
                                    const void* w2, const float* b2,
                                    void* out, int N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? abx::launch_transition<float>(x, M, C, ln_s, ln_b, w1, b1, w2,
                                             b2, out, N, s)
             : abx::launch_transition<abx::bf16>(x, M, C, ln_s, ln_b, w1, b1,
                                                 w2, b2, out, N, s);
}
