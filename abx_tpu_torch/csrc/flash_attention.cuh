// Register-resident flash attention core (FlashAttention-2 style) on
// mma.sync.m16n8k16, used by the ESM2 self-attention (esm_attention.cu),
// which replaces the Pallas TPU kernel abx_tpu/ops/esm_attention.py:47.
// Bound on the H100: bytes (q, k, v read and the output written once; at
// the ESM2-3B shape 25 MB against 3.8 GFLOP).  The design keeps the
// logits, probabilities and output out of shared and device memory, reads
// each K / V tile once per block with asynchronous 16-byte copies, and
// runs one barrier per 64-key tile.
//
// out[b, l, h, :] = softmax_j(q_l . k_j + keybias[b, j]) . v[j]
// for batch b, query l < L and head h < H, head dim D <= 128 (a multiple
// of 8), keybias = BIG_NEG where the bool key-pad mask is set, else 0.
// Operands are read and written through (batch, position, head) element
// strides with unit stride along D, so head-major views of a (B, L, H, D)
// projection need no copy.
//
// Design: one block of 4 warps per (64 queries, head, batch); warp w owns
// query rows 16w .. 16w+15.  Q is staged once and held in registers as
// A fragments (ldmatrix).  K and V stream through a two-stage cp.async ring
// of 64-key tiles (16-byte copies straight from the strided views, rows
// padded by 16 bytes so ldmatrix is conflict-free), one barrier per key
// tile.  S = Q K^T stays in registers (8 n8 tiles x 4 f32 a thread); the
// key-pad bias comes from a (B, L) bool row staged once per block as f32
// (keys past L are -inf); the online softmax's row max and sum take two
// quad shuffles, with an f32 exponent (exp2 of the scaled difference).  P
// is rounded to bf16 in registers and reused as the A fragment of P V (the
// C layout of two n8 tiles is the A layout of one k16 step); V arrives
// through ldmatrix.trans.  O stays in
// registers (16 x D a warp) and is divided by the row sum once at the end,
// staged through the warp's own Q rows and written with 16-byte stores.
// D is a compile-time 16, 32, 64 or 128 (zero-padded above D).  A float32
// instance runs the same loop on f32 tiles with every product as bf16x3
// (hi*hi + hi*lo + lo*hi, as common.cuh describes), P split alike.
// Rounding: the bf16 kernel rounds the unnormalised P to bf16 before P V
// and divides at the end; the TPU kernel (abx_tpu/ops/esm_attention.py)
// rounds the normalised probabilities.
#pragma once

#include "common.cuh"
#include "mma_sync.cuh"

namespace abx {
namespace {

namespace flash {

constexpr int kQB = 64;           // queries per block
constexpr int kKB = 64;           // keys per pipeline stage
constexpr int kWarpsF = kQB / 16;
constexpr int kThreadsF = kWarpsF * 32;
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

// Element (b, l, h, d) of an operand lies at base + b*s.b + l*s.l + h*s.h + d.
struct Strides {
  long long b, l, h;
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const unsigned char* key_pad;  // (B, L) bool, nonzero = padded key
  void* out;
  Strides qs, ks, vs, os;
  int L, H, D;
};

template <typename T, int DP>
struct Layout {
  static constexpr int kLd = DP + 8;          // padded row (elements)
  static constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte copy
  static constexpr int kChunks = DP / kVec;    // 16-byte copies per row
  static constexpr size_t kTile = sizeof(T) * kQB * kLd;
  static size_t smem_bytes(int L) {
    return kTile * (1 + 2 * kStages) +
           sizeof(float) * static_cast<size_t>(round_up(L, kKB));
  }
};

// Fragment registers: bf16 holds the high halves only.
template <bool SPLIT>
struct FragA {
  uint32_t hi[4], lo[SPLIT ? 4 : 1];
};
template <bool SPLIT>
struct FragB {
  uint32_t hi[2], lo[SPLIT ? 2 : 1];
};

template <bool SPLIT>
__device__ __forceinline__ void mma3(float (&d)[4], const FragA<SPLIT>& a,
                                     const FragB<SPLIT>& b) {
  mma_bf16(d, a.hi, b.hi[0], b.hi[1]);
  if constexpr (SPLIT) {
    mma_bf16(d, a.hi, b.lo[0], b.lo[1]);
    mma_bf16(d, a.lo, b.hi[0], b.hi[1]);
  }
}

// A fragment of rows r0.. r0+15, columns c0 .. c0+15 of a row-major tile.
template <typename T, int LD>
__device__ __forceinline__ void load_a(FragA<IsF32<T>::value>& f,
                                       const T* tile, int r0, int c0,
                                       int lane) {
  if constexpr (IsF32<T>::value) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = *reinterpret_cast<const float2*>(
          tile + (r0 + g + 8 * (i & 1)) * LD + c0 + 2 * t + 8 * (i >> 1));
      split_bf16(x.x, x.y, f.hi[i], f.lo[i]);
    }
  } else {
    ldmatrix_x4(f.hi, tile + (r0 + (lane & 15)) * LD + c0 + 8 * (lane >> 4));
  }
}

// B fragments of two n8 tiles, B(k, n) = tile[n0 + n][c0 + k] (K as the B
// operand of Q K^T: rows are keys, columns the head dim).
template <typename T, int LD>
__device__ __forceinline__ void load_b_rows(FragB<IsF32<T>::value> (&f)[2],
                                            const T* tile, int n0, int c0,
                                            int lane) {
  if constexpr (IsF32<T>::value) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float2 x = *reinterpret_cast<const float2*>(
            tile + (n0 + 8 * j + g) * LD + c0 + 2 * t + 8 * i);
        split_bf16(x.x, x.y, f[j].hi[i], f[j].lo[i]);
      }
  } else {
    uint32_t r[4];
    const int m = lane >> 3;
    ldmatrix_x4(r, tile + (n0 + (lane & 7) + 8 * (m >> 1)) * LD + c0 +
                       8 * (m & 1));
    f[0].hi[0] = r[0];
    f[0].hi[1] = r[1];
    f[1].hi[0] = r[2];
    f[1].hi[1] = r[3];
  }
}

// B fragments of two n8 tiles, B(k, n) = tile[k0 + k][n0 + n] (V as the B
// operand of P V: rows are keys, columns the head dim).
template <typename T, int LD>
__device__ __forceinline__ void load_b_cols(FragB<IsF32<T>::value> (&f)[2],
                                            const T* tile, int k0, int n0,
                                            int lane) {
  if constexpr (IsF32<T>::value) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const T* p = tile + (k0 + 2 * t + 8 * i) * LD + n0 + 8 * j + g;
        split_bf16(p[0], p[LD], f[j].hi[i], f[j].lo[i]);
      }
  } else {
    uint32_t r[4];
    const int m = lane >> 3;
    ldmatrix_x4_trans(r, tile + (k0 + (lane & 7) + 8 * (m & 1)) * LD + n0 +
                             8 * (m >> 1));
    f[0].hi[0] = r[0];
    f[0].hi[1] = r[1];
    f[1].hi[0] = r[2];
    f[1].hi[1] = r[3];
  }
}

// Blocks an SM should hold: four at the ESM2-3B shape (bf16, D = 64), so
// its 800 blocks take two waves of the 132 SMs (caps registers at 128).
template <typename T, int DP>
constexpr int min_blocks() {
  return (!IsF32<T>::value && DP <= 64) ? 4 : 1;
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreadsF, (min_blocks<T, DP>()))
    flash_kernel(const Args a) {
  using Lay = Layout<T, DP>;
  constexpr bool SPLIT = IsF32<T>::value;
  constexpr int LD = Lay::kLd, VEC = Lay::kVec, CH = Lay::kChunks;
  constexpr int KT = DP / 16;  // k16 steps of Q K^T
  constexpr int NT = DP / 8;   // n8 tiles of O
  constexpr int NS = kKB / 8;  // n8 tiles of S
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* k_s = q_s + kQB * LD;
  T* v_s = k_s + kStages * kKB * LD;
  float* kbias = reinterpret_cast<float*>(v_s + kStages * kKB * LD);

  const int L = a.L, D = a.D;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t = lane & 3;
  const int q0 = blockIdx.x * kQB, h = blockIdx.y, b = blockIdx.z;
  const T* qp = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
  const T* kp = static_cast<const T*>(a.k) + b * a.ks.b + h * a.ks.h;
  const T* vp = static_cast<const T*>(a.v) + b * a.vs.b + h * a.vs.h;

  // Rows p0 .. p0+63 of an operand into a padded tile; rows past L and
  // columns past D are zero-filled.
  auto stage = [&](T* dst, const T* src, long long sl, int p0) {
    for (int c = tid; c < kKB * CH; c += kThreadsF) {
      const int r = c / CH, col = (c % CH) * VEC;
      const bool ok = p0 + r < L && col < D;
      cp_async16(dst + r * LD + col, ok ? src + (p0 + r) * sl + col : src,
                 ok);
    }
  };
  const int nkb = (L + kKB - 1) / kKB;
  stage(q_s, qp, a.qs.l, q0);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nkb) {
      stage(k_s + s * kKB * LD, kp, a.ks.l, s * kKB);
      stage(v_s + s * kKB * LD, vp, a.vs.l, s * kKB);
    }
    cp_async_commit();
  }
  const unsigned char* pad = a.key_pad + static_cast<size_t>(b) * L;
  for (int j = tid; j < nkb * kKB; j += kThreadsF)
    kbias[j] = j < L ? (pad[j] ? kBigNeg : 0.f) : -INFINITY;

  FragA<SPLIT> qf[KT];
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int kb = 0; kb < nkb; ++kb) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kb visible; every warp is done with kb - 1
    {
      const int nb = kb + kStages - 1;
      if (nb < nkb) {
        stage(k_s + (nb % kStages) * kKB * LD, kp, a.ks.l, nb * kKB);
        stage(v_s + (nb % kStages) * kKB * LD, vp, a.vs.l, nb * kKB);
      }
      cp_async_commit();
    }
    if (kb == 0) {
#pragma unroll
      for (int kt = 0; kt < KT; ++kt)
        load_a<T, LD>(qf[kt], q_s, warp * 16, kt * 16, lane);
    }
    const T* kt_s = k_s + (kb % kStages) * kKB * LD;
    const T* vt_s = v_s + (kb % kStages) * kKB * LD;

    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt)
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        FragB<SPLIT> kf[2];
        load_b_rows<T, LD>(kf, kt_s, np * 16, kt * 16, lane);
        mma3<SPLIT>(s[2 * np], qf[kt], kf[0]);
        mma3<SPLIT>(s[2 * np + 1], qf[kt], kf[1]);
      }

    // Key bias, then the online softmax of rows g (e = 0, 1) and g + 8
    // (e = 2, 3); a row's 64 keys lie in the 4 lanes of one quad.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const float2 kbv =
          *reinterpret_cast<const float2*>(kbias + kb * kKB + n * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] += (e & 1) ? kbv.y : kbv.x;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = exp2f((m_run[r] - m_new) * kLog2e);
      m_run[r] = m_new;
    }
    // exp(x) = 2^(x log2 e), the difference taken first: exact where s is
    // the row max (a fully padded row's logits all round to BIG_NEG).
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f((s[n][e] - m_run[e >> 1]) * kLog2e);
        sum[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + sum[r];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];

    // O += P V, P from the S registers.
#pragma unroll
    for (int kc = 0; kc < kKB / 16; ++kc) {
      FragA<SPLIT> pf;
      const float* p0 = s[2 * kc];
      const float* p1 = s[2 * kc + 1];
      if constexpr (SPLIT) {
        split_bf16(p0[0], p0[1], pf.hi[0], pf.lo[0]);
        split_bf16(p0[2], p0[3], pf.hi[1], pf.lo[1]);
        split_bf16(p1[0], p1[1], pf.hi[2], pf.lo[2]);
        split_bf16(p1[2], p1[3], pf.hi[3], pf.lo[3]);
      } else {
        pf.hi[0] = pack_bf16(p0[0], p0[1]);
        pf.hi[1] = pack_bf16(p0[2], p0[3]);
        pf.hi[2] = pack_bf16(p1[0], p1[1]);
        pf.hi[3] = pack_bf16(p1[2], p1[3]);
      }
#pragma unroll
      for (int dp = 0; dp < NT / 2; ++dp) {
        FragB<SPLIT> vf[2];
        load_b_cols<T, LD>(vf, vt_s, kc * 16, dp * 16, lane);
        mma3<SPLIT>(o[2 * dp], pf, vf[0]);
        mma3<SPLIT>(o[2 * dp + 1], pf, vf[1]);
      }
    }
  }
  cp_async_wait<0>();

  // Row sums over the quad, one division, then this warp's 16 rows go
  // through its own rows of the Q tile to 16-byte stores.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  T* o_s = q_s + warp * 16 * LD;
  const int g = lane >> 2;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      T* p = o_s + (g + 8 * r) * LD + n * 8 + 2 * t;
      p[0] = from_f32<T>(o[n][2 * r] / l_run[r]);
      p[1] = from_f32<T>(o[n][2 * r + 1] / l_run[r]);
    }
  __syncwarp();
  T* op = static_cast<T*>(a.out) + b * a.os.b + h * a.os.h;
  for (int c = lane; c < 16 * CH; c += 32) {
    const int r = c / CH, col = (c % CH) * VEC, l = q0 + warp * 16 + r;
    if (l < L && col < D)
      *reinterpret_cast<uint4*>(op + l * a.os.l + col) =
          *reinterpret_cast<const uint4*>(o_s + r * LD + col);
  }
}

template <typename T, int DP>
cudaError_t launch_t(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = Layout<T, DP>::smem_bytes(a.L);
  cudaError_t e = set_smem(flash_kernel<T, DP>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.L + kQB - 1) / kQB, a.H, B);
  flash_kernel<T, DP><<<grid, kThreadsF, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const Args& a, int B, cudaStream_t stream) {
  if (a.D % 8 != 0 || a.D < 8) return cudaErrorInvalidValue;
  if (a.D <= 16) return launch_t<T, 16>(a, B, stream);
  if (a.D <= 32) return launch_t<T, 32>(a, B, stream);
  if (a.D <= 64) return launch_t<T, 64>(a, B, stream);
  if (a.D <= 128) return launch_t<T, 128>(a, B, stream);
  return cudaErrorInvalidValue;
}

// dtype 0 = float32, 1 = bfloat16.
inline cudaError_t launch(int dtype, const Args& a, int B, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_d<float>(a, B, s) : launch_d<bf16>(a, B, s);
}

}  // namespace flash
}  // namespace
}  // namespace abx
