// Masked multi-head attention core shared by the packed triangle / seq
// attention and its column variant, the head-major triangle attention
// (tri_attention.cu) and the ESM2 self-attention (esm_attention.cu).
//
// out[b, r, l, h, :] = softmax_j(qscale * q_l . k_j + bias[b, h, l, j]
//                                + mb[b, j]) . v[j]
//                      (x sigmoid(gate[l]) when a gate is given)
// for every batch element b, row r < R, query l < L and head h < H, with
// head dim D.  Operands are read through strides (batch, row, position,
// head; unit stride along D), so callers hand in slices of a fused
// projection, head-major views or the columns of a natural pair tensor
// without copies.  The logits live only in shared memory.
//
// Design: one block per (query block of 64 rows, head, batch*row).  Keys
// stream in blocks of 64 with an f32 online softmax (running max and sum
// per query row).  The bias arrives in the input dtype or in f32 (or is
// absent) and the additive key mask (BIG_NEG) as a separate f32 row; both
// are summed in f32 while the bias tile is staged into the logits tile,
// which is added to the f32 QK^T accumulators after the query scale.  Each
// warp runs its eight rows' softmax reductions interleaved.  Head dim D
// need not be a multiple of 16: it is zero-padded to Dp inside shared
// memory (seq attention has D = 17), and a ragged last query or key block
// (L = 306 in ESM) is zero-padded and its keys masked to -inf.
// Rounding: products are bf16 with f32 accumulation (bf16x3 for f32
// operands), and the probabilities are rounded to bf16 for the PV product
// in the bf16 kernel.  With bf16_exp (bf16 inputs only) the exponent is
// taken as the TPU's packed kernel takes it, exp(bf16(s - m)) rounded to
// bf16 and summed in f32, with m the running maximum of the row (the TPU
// kernel's m is the row's final maximum; the two agree once the block
// holding the maximum has been seen).
#pragma once

#include "common.cuh"

namespace abx {
// Internal linkage: tri_attention.cu and esm_attention.cu each compile
// their own copy of the kernel and its launchers.
namespace {

constexpr int kQB = 64;  // query rows per block
constexpr int kKB = 64;  // keys per block

struct MaskAdd {  // adds the key-mask bias of the tile's key columns
  const float* mb;
  __device__ float operator()(int, int c, float v) const { return v + mb[c]; }
};

// Element (b, r, l, h, d) of an operand lies at
// base + b * s.b + r * s.r + l * s.l + h * s.h + d.
struct Strides {
  long long b, r, l, h;
};

struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* gate;       // optional: out *= sigmoid(gate), strides gs
  const void* bias;       // optional: (B, H, L, L), input dtype or f32
  int bias_f32;           // the bias is f32
  const float* maskbias;  // (B, L) f32 additive key mask
  void* out;
  Strides qs, ks, vs, gs, os;
  int R, L, H, D;
  float qscale;           // applied to q . k in f32
  int bf16_exp;           // exponent rounded through bf16 (bf16 only)
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    attention_kernel(const AttnArgs a) {
  constexpr bool SPLIT = IsF32<T>::value;
  const int R = a.R, L = a.L, H = a.H, D = a.D;
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
  const int b = br / R, row = br % R;
  auto at = [&](const Strides& st) {
    return b * st.b + row * st.r + h * st.h;
  };
  const T* qp = static_cast<const T*>(a.q) + at(a.qs);
  const T* kp = static_cast<const T*>(a.k) + at(a.ks);
  const T* vp = static_cast<const T*>(a.v) + at(a.vs);
  const size_t bias_bh = ((size_t)b * H + h) * L * L;
  const float* mb = a.maskbias + (size_t)b * L;
  const bool bf16_exp = !SPLIT && a.bf16_exp;

  stage_tile<T, SPLIT>(qp + q0 * a.qs.l, a.qs.l, L - q0, D, q_hi, q_lo,
                       q.ldq, kQB, q.dp);
  for (int idx = tid; idx < kQB * q.ldo; idx += kThreads) o_s[idx] = 0.f;
  if (tid < kQB) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  const int o_tiles = (kQB / 16) * (q.dp / 16);
  for (int k0 = 0; k0 < L; k0 += kKB) {
    __syncthreads();  // previous block's P.V is done with k/v/p
    stage_tile<T, SPLIT>(kp + k0 * a.ks.l, a.ks.l, L - k0, D, k_hi, k_lo,
                         q.ldq, kKB, q.dp);
    stage_tile<T, SPLIT>(vp + k0 * a.vs.l, a.vs.l, L - k0, D, v_hi, v_lo,
                         q.ldq, kKB, q.dp);
    // bias + key-mask bias (or the key-mask bias alone), staged into the
    // logits tile, which then seeds the QK^T accumulators.
    const size_t tile0 = bias_bh + (size_t)q0 * L + k0;
    if (a.bias && a.bias_f32) {
      stage_tile_f32<float>(static_cast<const float*>(a.bias) + tile0, L,
                            L - q0, L - k0, s_s, q.lds, kQB, kKB,
                            MaskAdd{mb + k0});
    } else if (a.bias) {
      stage_tile_f32<T>(static_cast<const T*>(a.bias) + tile0, L, L - q0,
                        L - k0, s_s, q.lds, kQB, kKB, MaskAdd{mb + k0});
    } else {
      for (int idx = tid; idx < kQB * kKB; idx += kThreads) {
        const int i = idx / kKB, j = idx % kKB;
        s_s[i * q.lds + j] = k0 + j < L ? mb[k0 + j] : 0.f;
      }
    }
    __syncthreads();
    {  // warp w: row tile w % 4, column tiles 2 * (w / 4) + {0, 1}
      const int tm = warp % (kQB / 16), tn = 2 * (warp / (kQB / 16));
      FragC acc[2];
#pragma unroll
      for (int t = 0; t < 2; ++t) wmma::fill_fragment(acc[t], 0.f);
      for (int kk = 0; kk < q.dp; kk += 16)
        mma16_row<SPLIT, FragBc, 2>(acc, 2, q_hi + tm * 16 * q.ldq + kk,
                                    q_lo + tm * 16 * q.ldq + kk, q.ldq,
                                    k_hi + tn * 16 * q.ldq + kk,
                                    k_lo + tn * 16 * q.ldq + kk, q.ldq,
                                    16 * q.ldq);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        // s = qscale * (q . k) + (bias + key-mask bias): two accumulator
        // fragments of one shape map their elements alike.
        float* tile = s_s + tm * 16 * q.lds + (tn + t) * 16;
        FragC seed;
        wmma::load_matrix_sync(seed, tile, q.lds, wmma::mem_row_major);
#pragma unroll
        for (int e = 0; e < acc[t].num_elements; ++e)
          acc[t].x[e] = acc[t].x[e] * a.qscale + seed.x[e];
        wmma::store_matrix_sync(tile, acc[t], q.lds, wmma::mem_row_major);
      }
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
          const float pv =
              bf16_exp ? __bfloat162float(__float2bfloat16(expf(
                             __bfloat162float(__float2bfloat16(
                                 s[r][u] - m_new[r])))))
                       : expf(s[r][u] - m_new[r]);
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
  const T* gp = a.gate ? static_cast<const T*>(a.gate) + at(a.gs) : nullptr;
  T* op = static_cast<T*>(a.out) + at(a.os);
  for (int idx = tid; idx < kQB * D; idx += kThreads) {
    const int i = idx / D, d = idx % D, l = q0 + i;
    if (l >= L) continue;
    float v = o_s[i * q.ldo + d] / l_s[i];
    if (gp) {
      const float g = to_f32(gp[l * a.gs.l + d]);
      v *= 1.f / (1.f + expf(-g));
    }
    op[l * a.os.l + d] = from_f32<T>(v);
  }
}

// Launch over B * R batch rows; dtype 0 = float32, 1 = bfloat16.
template <typename T>
cudaError_t launch_attention_t(const AttnArgs& a, int B,
                               cudaStream_t stream) {
  const size_t smem = attention_smem_bytes<T>(a.D);
  cudaError_t e = set_smem(attention_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.L + kQB - 1) / kQB, a.H, B * a.R);
  attention_kernel<T><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

inline cudaError_t launch_attention(int dtype, const AttnArgs& a, int B,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_attention_t<float>(a, B, s)
                    : launch_attention_t<bf16>(a, B, s);
}

}  // namespace
}  // namespace abx
