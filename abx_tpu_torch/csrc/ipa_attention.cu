// Fused IPA attention: logits + softmax + scalar, point and pair attends.
//
// Replaces abx_tpu/ops/ipa_attention.py::ipa_attention (Pallas TPU).
// Per (batch, query row i, head h):
//   logit_j = qs_i.ks_j + pw_h (|qp_i|^2 + |kp_j|^2 - 2 qp_i.kp_j)
//             + bias[h, i, j] + maskbias_j            (keys masked only)
//   p = softmax_j(logit)   (f32)
//   out_s = sum_j p_j vs_j,  out_p = sum_j p_j vp_j (f32),
//   out_2d[i, h, :] = sum_j p_j pair[i, j, :].
// The wrapper folds pw into qp and into the squared norms, so the point
// term arrives as q2 + k2 - 2 qp.kp.  The point terms are
// cancellation-sensitive and stay exact f32 FMA (centred points, f32
// attend), as the TPU kernel keeps them in f32.
// Bound on the H100: device-memory bytes of the pair track (B*L*L*C read
// once per layer, 85 MB in bf16 at B=4, L=288, C=128) and the f32 bias
// (16 MB); the pair attend (H*C flops per pair element and row, ~65% of
// the call's flops) runs on the tensor cores via wmma bf16 (bf16x3 for
// f32 inputs), with the (B, H, L, L) logits/probabilities kept in shared
// memory.  The logits and the scalar/point attends (O(L^2 H (Ds + P*3)))
// are f32 FMA loops.
// Design: one block per (batch, 4 query rows) holds all heads'
// probabilities for its rows in shared memory, so every row's pair slice
// pair[b, i] (L x C) is read from device memory exactly once.  The keys'
// scalar/point data stream through shared memory in 16-key chunks with
// coalesced loads; the pair chunks are staged with 16-byte loads.
#include "common.cuh"

namespace abx {

constexpr int kJB = 32;  // keys per staged pair chunk (tensor-core attend)
constexpr int kKJ = 16;  // keys per staged chunk of k/v scalars and points
constexpr int kIB = 4;   // query rows per block

struct IpaArgs {
  const void* qs;       // (B, L, H, Ds) T, pre-scaled
  const void* ks;       // (B, L, H, Ds) T
  const void* vs;       // (B, L, H, Ds) T
  const float* qp;      // (B, L, H, P3q), pw-folded
  const float* kp;      // (B, L, H, P3q)
  const float* vp;      // (B, L, H, P3v)
  const float* q2;      // (B, L, H), pw-folded
  const float* k2;      // (B, L, H), pw-folded
  const float* bias;    // (B, H, L, L)
  const float* maskbias;  // (B, L)
  const void* pair;     // (B, L, L, C) T
  void* out_s;          // (B, L, H*Ds) T
  float* out_p;         // (B, L, H*P3v)
  void* out_2d;         // (B, L, H*C) T
  int L, H, Ds, P3q, P3v, C;
};

// Shared-memory plan.  Phase-local buffers (the k chunk, the v chunk, the
// pair-attend staging) share one region.
struct IpaLayout {
  int ldp, lda, ldb, ldo, qw, ev;
  size_t p_bytes, q_bytes, acc_bytes, ks_bytes, kp_bytes, k2_bytes,
      vs_bytes, vp_bytes, a_bytes, b_bytes, o_bytes, region_bytes;
  __host__ __device__ IpaLayout(int L, int H, int Ds, int P3q, int P3v,
                                int C, int parts) {
    ldp = round_up(L, 4);  // f32 probabilities [H][kIB][L]
    lda = kJB + 8;         // bf16 staged probabilities [16][kJB]
    ldb = C + 8;           // bf16 staged pair chunk [kJB][C]
    ldo = C + 4;           // f32 pair-attend output [16][C]
    qw = Ds + P3q + 1;     // staged query row: scalar | point | q2
    ev = Ds + P3v;         // attend outputs per (row, head)
    p_bytes = cb(sizeof(float) * H * kIB * ldp);
    q_bytes = cb(sizeof(float) * kIB * H * qw);
    acc_bytes = cb(sizeof(float) * kIB * H * ev);
    // Staged key rows are padded by one float (odd strides: threads
    // walking heads or keys hit distinct banks).
    ks_bytes = cb(sizeof(float) * kKJ * H * (Ds + 1));
    kp_bytes = cb(sizeof(float) * kKJ * H * (P3q + 1));
    k2_bytes = cb(sizeof(float) * kKJ * H);
    vs_bytes = cb(sizeof(float) * kKJ * H * (Ds + 1));
    vp_bytes = cb(sizeof(float) * kKJ * H * (P3v + 1));
    a_bytes = cb(sizeof(bf16) * 16 * lda) * parts;
    b_bytes = cb(sizeof(bf16) * kJB * ldb) * parts;
    o_bytes = cb(sizeof(float) * 16 * ldo);
    const size_t k = ks_bytes + kp_bytes + k2_bytes, v = vs_bytes + vp_bytes,
                 pa = a_bytes + b_bytes + o_bytes;
    region_bytes = k > v ? (k > pa ? k : pa) : (v > pa ? v : pa);
  }
  __host__ __device__ static size_t cb(size_t n) {
    return (n + 127) / 128 * 128;
  }
  __host__ __device__ size_t total() const {
    return p_bytes + q_bytes + acc_bytes + region_bytes;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads) ipa_kernel(IpaArgs a) {
  constexpr bool SPLIT = IsF32<T>::value;
  const int L = a.L, H = a.H, Ds = a.Ds, P3q = a.P3q, P3v = a.P3v, C = a.C;
  const IpaLayout q(L, H, Ds, P3q, P3v, C, SPLIT ? 2 : 1);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* p_s = reinterpret_cast<float*>(smem_raw);
  float* q_s = reinterpret_cast<float*>(smem_raw + q.p_bytes);
  float* acc_s = reinterpret_cast<float*>(smem_raw + q.p_bytes + q.q_bytes);
  unsigned char* region = smem_raw + q.p_bytes + q.q_bytes + q.acc_bytes;
  float* ks_c = reinterpret_cast<float*>(region);
  float* kp_c = reinterpret_cast<float*>(region + q.ks_bytes);
  float* k2_c = reinterpret_cast<float*>(region + q.ks_bytes + q.kp_bytes);
  float* vs_c = reinterpret_cast<float*>(region);
  float* vp_c = reinterpret_cast<float*>(region + q.vs_bytes);
  bf16* a_hi = reinterpret_cast<bf16*>(region);
  bf16* a_lo = a_hi + (SPLIT ? 16 * q.lda : 0);
  bf16* b_hi = reinterpret_cast<bf16*>(region + q.a_bytes);
  bf16* b_lo = b_hi + (SPLIT ? kJB * q.ldb : 0);
  float* o_s = reinterpret_cast<float*>(region + q.a_bytes + q.b_bytes);

  const T* qs = static_cast<const T*>(a.qs);
  const T* ks = static_cast<const T*>(a.ks);
  const T* vs = static_cast<const T*>(a.vs);
  const T* pair = static_cast<const T*>(a.pair);
  T* out_s = static_cast<T*>(a.out_s);
  T* out_2d = static_cast<T*>(a.out_2d);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int i0 = blockIdx.x * kIB, b = blockIdx.y;
  const int rows = min(kIB, L - i0);
  const size_t bl = (size_t)b * L;  // row offset of batch b

  // Query rows of this block: [scalar (Ds) | point (P3q) | q2] per head.
  for (int idx = tid; idx < kIB * H * q.qw; idx += kThreads) {
    const int e = idx % q.qw, ih = idx / q.qw, h = ih % H, i = ih / H;
    float v = 0.f;
    if (i < rows) {
      const size_t row = (bl + i0 + i) * H + h;
      v = e < Ds ? to_f32(qs[row * Ds + e])
          : e < Ds + P3q ? a.qp[row * P3q + e - Ds] : a.q2[row];
    }
    q_s[idx] = v;
  }
  for (int idx = tid; idx < kIB * H * q.ev; idx += kThreads) acc_s[idx] = 0.f;

  // Logits without bias (f32 FMA) over key chunks staged in shared
  // memory; threads walk heads fastest.
  for (int j0 = 0; j0 < L; j0 += kKJ) {
    const int nj = min(kKJ, L - j0);
    __syncthreads();
    for (int idx = tid; idx < nj * H * Ds; idx += kThreads)
      ks_c[idx / Ds * (Ds + 1) + idx % Ds] =
          to_f32(ks[(bl + j0) * H * Ds + idx]);
    for (int idx = tid; idx < nj * H * P3q; idx += kThreads)
      kp_c[idx / P3q * (P3q + 1) + idx % P3q] =
          a.kp[(bl + j0) * H * P3q + idx];
    for (int idx = tid; idx < nj * H; idx += kThreads)
      k2_c[idx] = a.k2[(bl + j0) * H + idx];
    __syncthreads();
    for (int idx = tid; idx < H * nj * kIB; idx += kThreads) {
      const int h = idx % H, rest = idx / H, jj = rest % nj, i = rest / nj;
      const float* qr = q_s + (i * H + h) * q.qw;
      const float* kr = ks_c + (jj * H + h) * (Ds + 1);
      const float* pr = kp_c + (jj * H + h) * (P3q + 1);
      float s = 0.f, cross = 0.f;
      for (int d = 0; d < Ds; ++d) s += qr[d] * kr[d];
      for (int e = 0; e < P3q; ++e) cross += qr[Ds + e] * pr[e];
      p_s[(h * kIB + i) * q.ldp + j0 + jj] =
          s + qr[Ds + P3q] + k2_c[jj * H + h] - 2.f * cross;
    }
  }
  __syncthreads();
  // Pair bias + key mask, then the softmax over keys; one warp per
  // (head, row), reading the bias row contiguously.
  for (int row = warp; row < H * kIB; row += kWarps) {
    float* pr = p_s + row * q.ldp;
    const int h = row / kIB, i = row % kIB;
    const float* br =
        a.bias + (((size_t)b * H + h) * L + min(i0 + i, L - 1)) * L;
    float mx = -INFINITY;
    for (int j = lane; j < L; j += 32) {
      const float v = pr[j] + br[j] + a.maskbias[bl + j];
      pr[j] = v;
      mx = fmaxf(mx, v);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float e = expf(pr[j] - mx);
      pr[j] = e;
      sum += e;
    }
    const float inv = 1.f / warp_sum(sum);
    for (int j = lane; j < L; j += 32) pr[j] *= inv;
  }
  // Scalar and point attends (f32 FMA) over value chunks.
  for (int j0 = 0; j0 < L; j0 += kKJ) {
    const int nj = min(kKJ, L - j0);
    __syncthreads();
    for (int idx = tid; idx < nj * H * Ds; idx += kThreads)
      vs_c[idx / Ds * (Ds + 1) + idx % Ds] =
          to_f32(vs[(bl + j0) * H * Ds + idx]);
    for (int idx = tid; idx < nj * H * P3v; idx += kThreads)
      vp_c[idx / P3v * (P3v + 1) + idx % P3v] =
          a.vp[(bl + j0) * H * P3v + idx];
    __syncthreads();
    for (int idx = tid; idx < kIB * H * q.ev; idx += kThreads) {
      const int e = idx % q.ev, ih = idx / q.ev, h = ih % H, i = ih / H;
      const float* pr = p_s + (h * kIB + i) * q.ldp + j0;
      float acc = acc_s[idx];
      if (e < Ds) {
        for (int jj = 0; jj < nj; ++jj)
          acc += pr[jj] * vs_c[(jj * H + h) * (Ds + 1) + e];
      } else {
        for (int jj = 0; jj < nj; ++jj)
          acc += pr[jj] * vp_c[(jj * H + h) * (P3v + 1) + e - Ds];
      }
      acc_s[idx] = acc;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < kIB * H * q.ev; idx += kThreads) {
    const int e = idx % q.ev, ih = idx / q.ev, h = ih % H, i = ih / H;
    if (i >= rows) continue;
    const size_t row = (bl + i0 + i) * H + h;
    if (e < Ds)
      out_s[row * Ds + e] = from_f32<T>(acc_s[idx]);
    else
      a.out_p[row * P3v + e - Ds] = acc_s[idx];
  }
  // Pair attend on the tensor cores: per row i, (16 x L) x (L x C) with
  // the heads as the (zero-padded) M dimension.
  const int c_tiles = C / 16;
  for (int i = 0; i < rows; ++i) {
    FragC acc[2];
    wmma::fill_fragment(acc[0], 0.f);
    wmma::fill_fragment(acc[1], 0.f);
    const T* prow = pair + (bl + i0 + i) * (size_t)L * C;
    for (int j0 = 0; j0 < L; j0 += kJB) {
      __syncthreads();
      for (int idx = tid; idx < 16 * kJB; idx += kThreads) {
        const int hh = idx / kJB, jj = idx % kJB, j = j0 + jj;
        const float v =
            (hh < H && j < L) ? p_s[(hh * kIB + i) * q.ldp + j] : 0.f;
        put<SPLIT>(a_hi, a_lo, hh * q.lda + jj, v);
      }
      stage_tile<T, SPLIT>(prow + (size_t)j0 * C, C, L - j0, C, b_hi, b_lo,
                           q.ldb, kJB, C);
      __syncthreads();
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int tn = warp + t * kWarps;
        if (tn >= c_tiles) continue;
#pragma unroll
        for (int kk = 0; kk < kJB; kk += 16)
          mma16<SPLIT, FragBr>(acc[t], a_hi + kk, a_lo + kk, q.lda,
                               b_hi + kk * q.ldb + tn * 16,
                               b_lo + kk * q.ldb + tn * 16, q.ldb);
      }
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int tn = warp + t * kWarps;
      if (tn < c_tiles)
        wmma::store_matrix_sync(o_s + tn * 16, acc[t], q.ldo,
                                wmma::mem_row_major);
    }
    __syncthreads();
    for (int idx = tid; idx < H * C; idx += kThreads) {
      const int hh = idx / C, c = idx % C;
      out_2d[(bl + i0 + i) * H * C + hh * C + c] =
          from_f32<T>(o_s[hh * q.ldo + c]);
    }
  }
}

template <typename T>
cudaError_t launch_ipa(IpaArgs a, int B, cudaStream_t stream) {
  const IpaLayout q(a.L, a.H, a.Ds, a.P3q, a.P3v, a.C,
                    IsF32<T>::value ? 2 : 1);
  const size_t smem = q.total();
  cudaError_t e = set_smem(ipa_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.L + kIB - 1) / kIB, B);
  ipa_kernel<T><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace abx

// C must be a multiple of 16 and at most 256 (the wrapper checks).
extern "C" int abx_ipa_attention(int dtype, const void* qs, const void* ks,
                                 const void* vs, const float* qp,
                                 const float* kp, const float* vp,
                                 const float* q2, const float* k2,
                                 const float* bias, const float* maskbias,
                                 const void* pair, void* out_s, float* out_p,
                                 void* out_2d, int B, int L, int H, int Ds,
                                 int P3q, int P3v, int C, void* stream) {
  abx::IpaArgs a{qs,   ks,     vs,    qp,     kp, vp, q2, k2,  bias, maskbias,
                 pair, out_s, out_p, out_2d, L,  H,  Ds, P3q, P3v,  C};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? abx::launch_ipa<float>(a, B, s)
                    : abx::launch_ipa<abx::bf16>(a, B, s);
}
