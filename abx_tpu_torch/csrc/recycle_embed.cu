// Fused pair-track recycling assembly:
//   out = concat(static_pair, t_vec) + LayerNorm(prev_pair) + table[bins].
//
// Replaces abx_tpu/ops/recycle_embed.py::recycle_embed (Pallas TPU).
// Bound on the H100: device-memory bytes.  Per pair element it reads C0
// static channels and C prev_pair channels and writes C, with ~10 flops per
// channel; at B=4, L=288, C=192 that is ~230 MB in bf16 per trunk pass.
// Design: one warp per pair element (row), 8 rows per 256-thread block.
// Each lane moves 8 channels at a time with 16-byte loads and stores; the
// LayerNorm statistics are one-pass moments (max(var, 0) clamp, eps 1e-5)
// reduced with warp shuffles, and the second pass re-reads the row (an L1
// hit) to normalise it and add the static part, the per-batch time vector
// on channels C0..C-1 and the distogram-bin row of the f32 table.  An
// out-of-range bin adds zero, as the TPU kernel's one-hot product does.
#include "common.cuh"

namespace abx {

struct RecycleArgs {
  const void* static_pair;  // (M, C0), dtype T
  const float* t_vec;       // (B, C - C0)
  const void* prev_pair;    // (M, C), dtype T
  const float* ln_scale;    // (C,)
  const float* ln_bias;     // (C,)
  const float* table;       // (n_bins, C)
  const int64_t* bins;      // (M,)
  void* out;                // (M, C), dtype T
  int M, C0, C, rows_per_batch, n_bins;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) recycle_kernel(RecycleArgs p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m = blockIdx.x * kWarps + warp;
  if (m >= p.M) return;
  const T* pp = static_cast<const T*>(p.prev_pair) + (size_t)m * p.C;
  float s = 0.f, s2 = 0.f;
  for (int c = lane * 8; c < p.C; c += 32 * 8) {
    float v[8];
    load8(pp + c, true, c, p.C, v);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      s += v[k];
      s2 += v[k] * v[k];
    }
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  const float mu = s / p.C;
  const float rstd = rsqrtf(fmaxf(s2 / p.C - mu * mu, 0.f) + 1e-5f);

  const int64_t bin = p.bins[m];
  const bool bin_ok = bin >= 0 && bin < p.n_bins;
  const float* emb = p.table + (bin_ok ? bin : 0) * p.C;
  const T* sp = static_cast<const T*>(p.static_pair) + (size_t)m * p.C0;
  const float* tv = p.t_vec + (size_t)(m / p.rows_per_batch) * (p.C - p.C0);
  T* out = static_cast<T*>(p.out) + (size_t)m * p.C;
  const bool vec = p.C % 8 == 0;  // out rows start 16-byte aligned
  for (int c = lane * 8; c < p.C; c += 32 * 8) {
    float v[8], base[8];
    load8(pp + c, true, c, p.C, v);
    load8(sp + c, true, c, p.C0, base);  // zero from C0 on
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int cc = c + k;
      if (cc >= p.C) break;
      const float ln = (v[k] - mu) * rstd * p.ln_scale[cc] + p.ln_bias[cc];
      const float b = cc < p.C0 ? base[k] : tv[cc - p.C0];
      v[k] = b + ln + (bin_ok ? emb[cc] : 0.f);
    }
    if (vec && c + 8 <= p.C) {
      store8(out + c, v);
    } else {
      for (int k = 0; k < 8 && c + k < p.C; ++k) out[c + k] = from_f32<T>(v[k]);
    }
  }
}

template <typename T>
cudaError_t launch_recycle(const RecycleArgs& p, cudaStream_t stream) {
  const int grid = (p.M + kWarps - 1) / kWarps;
  recycle_kernel<T><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace abx

// dtype: 0 = float32, 1 = bfloat16 (static_pair, prev_pair and out).  Rows
// m = b * rows_per_batch + (i * L + j).  Returns the cudaError_t of the
// launch.
extern "C" int abx_recycle_embed(int dtype, const void* static_pair,
                                 const float* t_vec, const void* prev_pair,
                                 const float* ln_scale, const float* ln_bias,
                                 const float* table, const int64_t* bins,
                                 void* out, int M, int C0, int C,
                                 int rows_per_batch, int n_bins,
                                 void* stream) {
  abx::RecycleArgs p{static_pair, t_vec, prev_pair, ln_scale,
                     ln_bias,     table, bins,      out,
                     M,           C0,    C,         rows_per_batch,
                     n_bins};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? abx::launch_recycle<float>(p, s)
                    : abx::launch_recycle<abx::bf16>(p, s);
}
