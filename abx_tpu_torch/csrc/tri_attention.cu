// Attention core of the packed triangle / seq attention.
//
// Replaces the softmax-attend body of
// abx_tpu/ops/tri_attention.py::triangle_attention_packed (Pallas TPU).
// The wrapper (abx_tpu_torch/ops/tri_attention.py) runs it as three
// launches of this repository's kernels: row_linear.cu for LN + the fused
// [q|k|v|gate] projection, this kernel, and row_linear.cu again for the
// out-proj + bias + residual epilogue.
// Bound on the H100: at the flagship tri-attention shape (B=4, R=L=288,
// H=4, D=48) the logits are 4*288*4*288*288 f32 = 1.5 GB if materialised;
// here they live only in shared memory.  The products are a small part of
// the time; the softmax (exp, row max/sum shuffles) and the block's
// barrier phases bound it.
// Design: one block per (query block of 64 rows, head, batch*row).  Keys
// stream in blocks of 64 with an f32 online softmax (running max and sum
// per query row, f32 exp; the TPU kernel's bf16 exp trick is not used).
// The bias arrives in the input dtype and the additive key mask (BIG_NEG)
// as a separate f32 row; both are summed in f32 while the bias tile is
// staged into the logits tile with 16-byte loads, and that tile seeds the
// QK^T accumulators.  Each warp runs its eight rows' softmax reductions
// interleaved.  The query scale D^-1/2 is folded into wq by the wrapper.
// Head dim D need not be a multiple of 16: it is zero-padded to Dp inside
// shared memory (seq attention has D = 17).
#include "common.cuh"

namespace abx {

constexpr int kQB = 64;  // query rows per block
constexpr int kKB = 64;  // keys per block

struct MaskAdd {  // adds the key-mask bias of the tile's key columns
  const float* mb;
  __device__ float operator()(int, int c, float v) const { return v + mb[c]; }
};

struct AttnLayout {
  int dp, ldq, lds, ldp, ldo;
  __host__ __device__ explicit AttnLayout(int d) {
    dp = round_up(d, 16);
    ldq = dp + 8;    // bf16 Q / K / V tiles
    lds = kKB + 4;   // f32 logits
    ldp = kKB + 8;   // bf16 probabilities
    ldo = dp + 4;    // f32 output / P.V
  }
};

template <typename T>
size_t attention_smem_bytes(int d) {
  constexpr int parts = IsF32<T>::value ? 2 : 1;
  const AttnLayout q(d);
  return parts * carve_bytes(sizeof(bf16) * kQB * q.ldq) * 3 +
         carve_bytes(sizeof(float) * kQB * q.lds) +
         parts * carve_bytes(sizeof(bf16) * kQB * q.ldp) +
         2 * carve_bytes(sizeof(float) * kQB * q.ldo) +
         3 * carve_bytes(sizeof(float) * kQB);
}

// y: (B*R*L, ldy) rows [q (H*D) | k (H*D) | v (H*D) | gate (H*D)?];
// bias: (B, H, L, L) in T; maskbias: (B, L) f32 additive; out: (B*R*L, H*D).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    attention_kernel(const T* __restrict__ y, int ldy, int R, int L, int H,
                     int D, const T* __restrict__ bias,
                     const float* __restrict__ maskbias, int has_gate,
                     T* __restrict__ out) {
  constexpr bool SPLIT = IsF32<T>::value;
  const AttnLayout q(D);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  SmemCarver sc(smem_raw);
  bf16* q_hi = sc.take<bf16>(kQB * q.ldq);
  bf16* q_lo = SPLIT ? sc.take<bf16>(kQB * q.ldq) : q_hi;
  bf16* k_hi = sc.take<bf16>(kKB * q.ldq);
  bf16* k_lo = SPLIT ? sc.take<bf16>(kKB * q.ldq) : k_hi;
  bf16* v_hi = sc.take<bf16>(kKB * q.ldq);
  bf16* v_lo = SPLIT ? sc.take<bf16>(kKB * q.ldq) : v_hi;
  float* s_s = sc.take<float>(kQB * q.lds);
  bf16* p_hi = sc.take<bf16>(kQB * q.ldp);
  bf16* p_lo = SPLIT ? sc.take<bf16>(kQB * q.ldp) : p_hi;
  float* pv_s = sc.take<float>(kQB * q.ldo);
  float* o_s = sc.take<float>(kQB * q.ldo);
  float* m_s = sc.take<float>(kQB);
  float* l_s = sc.take<float>(kQB);
  float* a_s = sc.take<float>(kQB);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * kQB, h = blockIdx.y, br = blockIdx.z;
  const int b = br / R;
  const int hd = H * D;
  const size_t row0 = (size_t)br * L;  // first row of this (b, r) in y/out
  const T* bias_bh = bias + ((size_t)b * H + h) * L * L;
  const float* mb = maskbias + (size_t)b * L;

  stage_tile<T, SPLIT>(y + (row0 + q0) * ldy + h * D, ldy, L - q0, D, q_hi,
                       q_lo, q.ldq, kQB, q.dp);
  for (int idx = tid; idx < kQB * q.ldo; idx += kThreads) o_s[idx] = 0.f;
  if (tid < kQB) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  const int o_tiles = (kQB / 16) * (q.dp / 16);
  for (int k0 = 0; k0 < L; k0 += kKB) {
    __syncthreads();  // previous block's P.V is done with k/v/p
    const T* kv = y + (row0 + k0) * ldy + h * D;
    stage_tile<T, SPLIT>(kv + hd, ldy, L - k0, D, k_hi, k_lo, q.ldq, kKB,
                         q.dp);
    stage_tile<T, SPLIT>(kv + 2 * hd, ldy, L - k0, D, v_hi, v_lo, q.ldq, kKB,
                         q.dp);
    // bias + key-mask bias, staged with 16-byte loads into the logits tile,
    // which then seeds the QK^T accumulators.
    stage_tile_f32<T>(bias_bh + (size_t)q0 * L + k0, L, L - q0, L - k0, s_s,
                      q.lds, kQB, kKB, MaskAdd{mb + k0});
    __syncthreads();
    {  // warp w: row tile w % 4, column tiles 2 * (w / 4) + {0, 1}
      const int tm = warp % (kQB / 16), tn = 2 * (warp / (kQB / 16));
      FragC acc[2];
#pragma unroll
      for (int t = 0; t < 2; ++t)
        wmma::load_matrix_sync(acc[t], s_s + tm * 16 * q.lds + (tn + t) * 16,
                               q.lds, wmma::mem_row_major);
      for (int kk = 0; kk < q.dp; kk += 16)
        mma16_row<SPLIT, FragBc, 2>(acc, 2, q_hi + tm * 16 * q.ldq + kk,
                                    q_lo + tm * 16 * q.ldq + kk, q.ldq,
                                    k_hi + tn * 16 * q.ldq + kk,
                                    k_lo + tn * 16 * q.ldq + kk, q.ldq,
                                    16 * q.ldq);
#pragma unroll
      for (int t = 0; t < 2; ++t)
        wmma::store_matrix_sync(s_s + tm * 16 * q.lds + (tn + t) * 16,
                                acc[t], q.lds, wmma::mem_row_major);
    }
    __syncthreads();
    // Online softmax: warp w owns rows w*8 .. w*8+7, two keys per lane;
    // the eight rows' reductions are independent and run interleaved.
    {
      constexpr int kRows = kQB / kWarps;
      const int i0 = warp * kRows;
      float s[kRows][2], m_old[kRows], m_new[kRows], psum[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int j = lane + 32 * u;
          s[r][u] = k0 + j < L ? s_s[(i0 + r) * q.lds + j] : -INFINITY;
        }
        m_old[r] = m_s[i0 + r];
        m_new[r] = fmaxf(s[r][0], s[r][1]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        m_new[r] = fmaxf(m_old[r], warp_max(m_new[r]));
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        psum[r] = 0.f;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float pv = expf(s[r][u] - m_new[r]);
          psum[r] += pv;
          put<SPLIT>(p_hi, p_lo, (i0 + r) * q.ldp + lane + 32 * u, pv);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) psum[r] = warp_sum(psum[r]);
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float alpha = expf(m_old[r] - m_new[r]);
          a_s[i0 + r] = alpha;
          l_s[i0 + r] = l_s[i0 + r] * alpha + psum[r];
          m_s[i0 + r] = m_new[r];
        }
      }
    }
    __syncthreads();
    for (int tile = warp; tile < o_tiles; tile += kWarps) {
      const int tm = tile / (q.dp / 16), tn = tile % (q.dp / 16);
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < kKB; kk += 16)
        mma16<SPLIT, FragBr>(acc, p_hi + tm * 16 * q.ldp + kk,
                             p_lo + tm * 16 * q.ldp + kk, q.ldp,
                             v_hi + kk * q.ldq + tn * 16,
                             v_lo + kk * q.ldq + tn * 16, q.ldq);
      wmma::store_matrix_sync(pv_s + tm * 16 * q.ldo + tn * 16, acc, q.ldo,
                              wmma::mem_row_major);
    }
    __syncthreads();
    for (int idx = tid; idx < kQB * q.dp; idx += kThreads) {
      const int i = idx / q.dp, d = idx % q.dp;
      o_s[i * q.ldo + d] = o_s[i * q.ldo + d] * a_s[i] + pv_s[i * q.ldo + d];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < kQB * D; idx += kThreads) {
    const int i = idx / D, d = idx % D, l = q0 + i;
    if (l >= L) continue;
    float v = o_s[i * q.ldo + d] / l_s[i];
    if (has_gate) {
      const float g = to_f32(y[(row0 + l) * ldy + 3 * hd + h * D + d]);
      v *= 1.f / (1.f + expf(-g));
    }
    out[(row0 + l) * hd + h * D + d] = from_f32<T>(v);
  }
}

template <typename T>
cudaError_t launch_attention(const void* y, int ldy, int B, int R, int L,
                             int H, int D, const void* bias,
                             const float* maskbias, int has_gate, void* out,
                             cudaStream_t stream) {
  const size_t smem = attention_smem_bytes<T>(D);
  cudaError_t e = set_smem(attention_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((L + kQB - 1) / kQB, H, B * R);
  attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(y), ldy, R, L, H, D, static_cast<const T*>(bias),
      maskbias, has_gate, static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace abx

extern "C" int abx_tri_attention_core(int dtype, const void* y, int ldy,
                                      int B, int R, int L, int H, int D,
                                      const void* bias, const float* maskbias,
                                      int has_gate, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? abx::launch_attention<float>(y, ldy, B, R, L, H, D, bias,
                                            maskbias, has_gate, out, s)
             : abx::launch_attention<abx::bf16>(y, ldy, B, R, L, H, D, bias,
                                                maskbias, has_gate, out, s);
}
