// Register-resident flash attention core (FlashAttention-2 style) on
// mma.sync.m16n8k16, shared by the ESM2 self-attention (esm_attention.cu),
// the f32 instance of its flash route (esm_flash_sm90.cu) and the triangle
// / seq attentions (tri_attention.cu).
//
// out[b, r, l, h, :] = softmax_j(qscale * q_l . k_j + bias[b, h, l, j]
//                                + keybias[b, j]) . v[j]
//                      (x sigmoid(gate[l, h, :]) when a gate is given)
// for batch b, row r < R, query l < L and head h < H, head dim D <= 128.
// The bias (BIAS instances only) is a (B, H, L, L) tensor shared by the R
// rows, in the input dtype or in f32; keybias comes from a (B, L) bool
// key-pad row (BIG_NEG where set, ESM) or a (B, L) f32 key mask m (the
// triangle attentions: (1 - m) * BIG_NEG, the reference's expression, so
// the wrappers launch nothing to build it); keys past L are -inf.  The
// logits are summed in the reference's order: (qscale * q.k + bias) +
// keybias.
// Segment mode (SEG instances: only the f32 instance of ESM's flash route;
// its bf16 launches run the Hopper kernel of esm_flash_sm90.cu, which
// takes kSegMask, kSegKB and the quad reductions from here): the function
// of the stock TPU flash kernel with segment ids 1 - pad.  Key j is visible to
// query l iff both are valid or both are padded, and the keys past L up to
// the next multiple of 128 (the stock kernel's zero-padded tail) are
// padded keys with zero k and v; a masked logit is s + kSegMask, the stock
// kernel's mask value.  The key tiles are 128 keys, the stock kernel's
// block: its running max is updated once a 128-key block and P is rounded
// to bf16 against it, as there; where L <= 128 (one block) P is normalised
// before it is rounded, as the stock kernel's one-step path does.  Two
// key-bias rows in shared memory, one for each query segment; a thread
// reads its two rows' segments once.
// Operands are read and written through (batch, row, position, head)
// element strides with unit stride along D, so head-major views, column
// blocks of a fused projection and the columns of a natural pair tensor
// need no copy.
//
// Design: one block of RB row groups x QW warps per (QB = 16 QW queries,
// head, batch, RB rows); warp w of a row group owns query rows 16w ..
// 16w+15 of its row.  Q is staged once and held in registers as A
// fragments (ldmatrix).  K and V of each row group stream through a
// two-stage cp.async ring of 64-key tiles (rows padded by 16 bytes so
// ldmatrix is conflict-free), one barrier per key tile; each row group
// stages its own row, a fixed number of 16-byte copies a thread.  The QB x
// 64 bias tile of the (b, h) the row groups share rides in the same ring,
// staged once for all RB rows, so the bias is read from L2 once per RB
// rows.  S = Q K^T stays in registers (8 n8 tiles x 4 f32 a thread), bias
// and key bias are added there; a row's 64 keys lie in the 4 lanes of one
// quad, so its max and sum take two quad shuffles.  P is rounded to bf16
// in registers and reused as the A fragment of P V (the C layout of two n8
// tiles is the A layout of one k16 step); V arrives through
// ldmatrix.trans.  O stays in registers (16 x D a warp), is divided by the
// row sum once at the end, multiplied by sigmoid(gate) (the gate tile is
// staged with Q at the start), staged through the warp's own Q rows and
// written with 16-byte stores.  QW and RBMAX (the most rows a block) are
// compile-time: ESM runs 4 warps and one row, the triangle attentions the
// pick of tri_attention.cu.
// What bounds it (the triangle attention at its flagship shape, bf16, on
// the H100): neither the products nor the bytes.  Ablations that took out
// the P V products, the exponent, Q K^T, the bias or the in-loop loads one
// at a time each left most of the time in place, and a third ring stage,
// two row tiles a warp and more rows a block, each of which costs
// occupancy (registers or shared memory), made it slower.  Each step is a
// chain of dependent latencies between two barriers with 12-16 warps an SM
// to hide them, so the instruction count of a step (the staging's address
// arithmetic included) and the warps an SM holds set the time.
// Exponent: the online instances (FINAL false) keep a running max and
// rescale, with an f32 exponent (exp2 of the scaled difference).  The FINAL
// instances (bf16, the TPU kernels' ABX_TRI_ATTN_BF16_EXP) take
// p = bf16(exp(bf16(s - m))) against the row's final max m, as the TPU
// kernel does, in two passes over the key tiles: pass 1 computes S and
// keeps only the row max (no exponent, no V), pass 2 recomputes S with the
// same instructions, so s - m is 0 at the max, and takes the exponent, the
// f32 row sum and P V without rescaling.  The cost is one more Q K^T and
// one more read of K and the bias tile per key tile (at D = 48 Q K^T is
// half the products); keeping S resident instead would need 16 x L f32 a
// warp and cap L near 320.
// Head dim: a compile-time DP of 16, 32, 48, 64 or 128, zero-padded above
// D.  Operands whose rows are 16-byte aligned with D a multiple of 16
// bytes take cp.async and 16-byte stores; others (D = 17 of the seq
// attention, a 34-byte row) take plain element loads into the zero-padded
// tiles and element stores.  A float32 instance runs the same loop on f32
// tiles with every product as bf16x3 (hi*hi + hi*lo + lo*hi, as
// common.cuh describes), P split alike.
// Rounding: the bf16 kernel rounds the unnormalised P to bf16 before P V
// (exact under the FINAL exponent, whose p is bf16 already) and divides
// by the f32 row sum at the end; the TPU kernels round the normalised
// probabilities to bf16 instead.
#pragma once

#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "mma_sync.cuh"

namespace abx {
namespace {

namespace flash {

constexpr int kKB = 64;     // keys per pipeline stage
constexpr int kStages = 2;
constexpr int kLdBias = kKB + 8;  // bias tile row (elements): conflict-free
constexpr size_t kMaxSmem = 232448;
constexpr float kLog2e = 1.4426950408889634f;
// The stock TPU flash kernel's mask value, -0.7 * FLT_MAX: s + kSegMask is
// kSegMask itself at any logit the model makes, so a block with no visible
// key gives p = 1 everywhere, which the next block's exp(m_prev - m_next)
// = 0 wipes, as in the stock kernel.
constexpr float kSegMask = -0.7f * 3.402823466e38f;
constexpr int kSegKB = 128;  // keys a pipeline stage in segment mode

// Element (b, r, l, h, d) of an operand lies at
// base + b*s.b + r*s.r + l*s.l + h*s.h + d.
struct Strides {
  long long b, r, l, h;
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* gate;              // optional, BIAS instances: out *=
                                 // sigmoid(gate), strides gs
  const void* bias;              // (B, H, L, L), BIAS instances only
  int bias_f32;                  // the bias is f32 (else the input dtype)
  const unsigned char* key_pad;  // (B, L) bool, nonzero = padded key, or
  const float* mask;             // (B, L) f32 key mask, 1 = valid
  void* out;
  Strides qs, ks, vs, gs, os;
  int R, L, H, D;
  float qscale;  // applied to q . k in f32 (BIAS instances only)
  // Set by the launcher:
  int rb;           // rows per block
  int vec;          // q, k, v, gate, out rows take 16-byte copies
  int bias_vec;     // bias rows take 16-byte copies
};

// Byte offsets of the shared-memory regions of one block.
template <typename T, int DP, int QW, bool SEG = false>
struct Layout {
  static constexpr int kQB = 16 * QW;
  static constexpr int KB = SEG ? kSegKB : kKB;  // keys a stage
  static constexpr int kLd = DP + 8;  // padded operand row (elements)
  static constexpr size_t kQTile = sizeof(T) * kQB * kLd;  // Q or gate
  static constexpr size_t kKTile = sizeof(T) * KB * kLd;  // K or V
  size_t gate, k, v, bias, kbias, total;
  __host__ __device__ Layout(int rb, bool has_gate, int bias_es, int L) {
    gate = rb * kQTile;
    k = gate + (has_gate ? rb * kQTile : 0);
    v = k + kStages * rb * kKTile;
    bias = v + kStages * rb * kKTile;
    kbias = bias + static_cast<size_t>(kStages) * kQB * kLdBias * bias_es;
    total = kbias + (SEG ? 2 : 1) * sizeof(float) *
                        static_cast<size_t>(round_up(L, KB));
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

// Two neighbouring bias elements as f32.
__device__ __forceinline__ float2 bias_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 bias_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Blocks an SM should hold: registers capped at 128 for bf16 with DP <= 64
// and 4-warp row groups, four groups an SM (the ESM2-3B shape: 800 blocks
// of 4 warps take two waves of the 132 SMs), else at what one block
// allows.
// Segment mode (now only its f32 instance, with DP <= 64): shared memory
// (2 stages of 128-key f32 K and V tiles) sets the blocks an SM, and
// registers are not capped.
template <typename T, int DP, int QW, int RBMAX, bool SEG>
constexpr int min_blocks() {
  return (!SEG && !IsF32<T>::value && DP <= 64 && QW == 4 && RBMAX <= 4)
             ? 4 / RBMAX
             : 1;
}

// s = qscale * s + bias over a thread's S fragment, the bias read from a
// QB x 64 tile at this thread's first element (row g, column 2t).
template <int NS, typename BT>
__device__ __forceinline__ void add_bias(float (&s)[NS][4], const BT* bt,
                                         float qscale) {
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float2 bv = bias_pair(bt + 8 * r * kLdBias + n * 8);
      s[n][2 * r] = s[n][2 * r] * qscale + bv.x;
      s[n][2 * r + 1] = s[n][2 * r + 1] * qscale + bv.y;
    }
}

// Over the 4 lanes of a quad, which hold one row's 64 keys.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// RBMAX: the most rows a block (row groups of QW warps).
template <typename T, int DP, int QW, int RBMAX, bool BIAS, bool FINAL,
          bool SEG>
__global__ void __launch_bounds__(RBMAX * QW * 32,
                                  (min_blocks<T, DP, QW, RBMAX, SEG>()))
    flash_kernel(const Args a) {
  constexpr bool SPLIT = IsF32<T>::value;
  static_assert(!(FINAL && SPLIT), "the bf16 exponent is for bf16 inputs");
  static_assert(!(SEG && (BIAS || FINAL || RBMAX != 1)),
                "segment mode is ESM's: no bias, online exponent, one row");
  using Lay = Layout<T, DP, QW, SEG>;
  constexpr int QB = Lay::kQB, LD = Lay::kLd, KB = Lay::KB;
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte copy
  constexpr int CH = DP / VEC;         // 16-byte copies per row
  constexpr int KT = DP / 16;          // k16 steps of Q K^T
  constexpr int NT = DP / 8;           // n8 tiles of O
  constexpr int NS = KB / 8;           // n8 tiles of S
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // One row a block and no gate are compile-time where the instance says
  // so (ESM): its layout and indices then fold to constants.
  const int L = a.L, D = a.D, R = a.R, rb = RBMAX == 1 ? 1 : a.rb;
  const bool has_gate = BIAS && a.gate != nullptr;
  const int bias_es = !BIAS ? 0 : (a.bias_f32 ? 4 : sizeof(T));
  const Lay lay(rb, has_gate, bias_es, L);
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* g_s = reinterpret_cast<T*>(smem_raw + lay.gate);
  T* k_s = reinterpret_cast<T*>(smem_raw + lay.k);
  T* v_s = reinterpret_cast<T*>(smem_raw + lay.v);
  unsigned char* b_s = smem_raw + lay.bias;
  float* kbias = reinterpret_cast<float*>(smem_raw + lay.kbias);

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // Row group and warp in it.
  const int grp = RBMAX == 1 ? 0 : warp / QW, wq = warp % QW;
  const int nrb = (R + rb - 1) / rb;
  const int q0 = blockIdx.x * QB, h = blockIdx.y;
  const int b = blockIdx.z / nrb, r0 = (blockIdx.z % nrb) * rb;
  // A ragged last block's spare row groups recompute row R - 1 and store
  // nothing.
  const int row = min(r0 + grp, R - 1);
  const T* qp = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
  // Position 0 of this row group's row of K and V.
  const T* k_row = static_cast<const T*>(a.k) + b * a.ks.b + h * a.ks.h +
                   row * a.ks.r;
  const T* v_row = static_cast<const T*>(a.v) + b * a.vs.b + h * a.vs.h +
                   row * a.vs.r;

  // Positions p0 .. p0+N-1 of this row group's row of an operand (row: its
  // position 0) into N padded rows at dst; positions past L and columns
  // past D are zero.  Each row group stages its own row: GT threads, a
  // fixed number of copies each.
  constexpr int GT = QW * 32;
  const int lt = tid - grp * GT;
  auto stage = [&](auto n_rows, T* dst, const T* src, long long sl, int p0) {
    constexpr int N = decltype(n_rows)::value, NC = N * CH;
    if (a.vec) {
      if constexpr (GT % CH == 0) {  // every copy of a thread in one column
        constexpr int DR = GT / CH;    // rows between a thread's copies
        const int r = lt / CH, col = (lt % CH) * VEC;
        const T* p = src + (p0 + r) * sl + col;
#pragma unroll
        for (int i = 0; i < (NC + GT - 1) / GT; ++i) {
          if (NC % GT == 0 || r + i * DR < N) {
            const bool ok = p0 + r + i * DR < L && col < D;
            cp_async16(dst + (r + i * DR) * LD + col,
                       ok ? p + i * DR * sl : src, ok);
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < (NC + GT - 1) / GT; ++i) {
          const int c = lt + i * GT, r = c / CH, col = (c % CH) * VEC;
          if (NC % GT == 0 || c < NC) {
            const bool ok = p0 + r < L && col < D;
            cp_async16(dst + r * LD + col,
                       ok ? src + (p0 + r) * sl + col : src, ok);
          }
        }
      }
    } else {  // element loads, U of a thread's in flight before the stores
      constexpr int U = 8, NE = N * DP;
#pragma unroll 1
      for (int c0 = lt; c0 < NE; c0 += U * GT) {
        T x[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int c = c0 + u * GT, r = c / DP, col = c % DP;
          x[u] = c < NE && p0 + r < L && col < D
                     ? __ldg(src + (p0 + r) * sl + col)
                     : from_f32<T>(0.f);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int c = c0 + u * GT;
          if (c < NE) dst[(c / DP) * LD + c % DP] = x[u];
        }
      }
    }
  };
  using QRows = std::integral_constant<int, QB>;
  using KRows = std::integral_constant<int, KB>;

  // The QB x 64 bias tile at (q0, k0) of this block's (b, h).
  auto stage_bias = [&](auto elem, unsigned char* dst, int k0) {
    using BT = decltype(elem);
    constexpr int BV = 16 / sizeof(BT), BCH = kKB / BV;
    BT* d = reinterpret_cast<BT*>(dst);
    const BT* src = static_cast<const BT*>(a.bias) +
                    ((static_cast<size_t>(b) * a.H + h) * L + q0) * L + k0;
    if (a.bias_vec) {
      for (int c = tid; c < QB * BCH; c += nthr) {
        const int r = c / BCH, j = (c % BCH) * BV;
        const bool ok = q0 + r < L && k0 + j < L;
        cp_async16(d + r * kLdBias + j, ok ? src + r * L + j : src, ok);
      }
    } else {
      for (int c = tid; c < QB * kKB; c += nthr) {
        const int r = c / kKB, j = c % kKB;
        const bool ok = q0 + r < L && k0 + j < L;
        d[r * kLdBias + j] = ok ? src[r * L + j] : from_f32<BT>(0.f);
      }
    }
  };

  const int nkb = (L + KB - 1) / KB;
  const int steps = FINAL ? 2 * nkb : nkb;
  // Step st loads key tile st % nkb into stage st % kStages: K and the bias
  // tile, and V unless it is a FINAL kernel's first pass.
  auto stage_step = [&](int st) {
    const int kb = st % nkb, buf = st % kStages;
    const int tile = (buf * rb + grp) * KB * LD;
    stage(KRows{}, k_s + tile, k_row, a.ks.l, kb * KB);
    if (!FINAL || st >= nkb)
      stage(KRows{}, v_s + tile, v_row, a.vs.l, kb * KB);
    if constexpr (BIAS) {
      unsigned char* dst = b_s + buf * QB * kLdBias * bias_es;
      if (SPLIT || a.bias_f32)
        stage_bias(float(0), dst, kb * kKB);
      else
        stage_bias(__float2bfloat16(0.f), dst, kb * kKB);
    }
  };

  stage(QRows{}, q_s + grp * QB * LD, qp + row * a.qs.r, a.qs.l, q0);
  if (has_gate)
    stage(QRows{}, g_s + grp * QB * LD,
          static_cast<const T*>(a.gate) + b * a.gs.b + h * a.gs.h +
              row * a.gs.r,
          a.gs.l, q0);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < steps) stage_step(i);
    cp_async_commit();
  }
  for (int j = tid; j < nkb * KB; j += nthr) {
    if constexpr (SEG) {
      // Row 0 for padded queries, row 1 for valid ones; key j is valid iff
      // j < L and not padded (the tail past L is the padded segment).
      const bool valid = j < L && !a.key_pad[static_cast<size_t>(b) * L + j];
      kbias[j] = valid ? kSegMask : 0.f;
      kbias[nkb * KB + j] = valid ? 0.f : kSegMask;
    } else {
      float kv = -INFINITY;
      if (j < L)
        kv = a.key_pad
                 ? (a.key_pad[static_cast<size_t>(b) * L + j] ? kBigNeg : 0.f)
                 : (1.f - a.mask[static_cast<size_t>(b) * L + j]) * kBigNeg;
      kbias[j] = kv;
    }
  }
  // Segment mode: the key-bias row of each of this thread's two query rows
  // (rows past L are in the padded segment; they are not stored).
  const float* kb_row[2] = {kbias, kbias};
  if constexpr (SEG) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int l = q0 + wq * 16 + g + 8 * r;
      const bool valid =
          l < L && !a.key_pad[static_cast<size_t>(b) * L + l];
      kb_row[r] = kbias + (valid ? nkb * KB : 0);
    }
  }

  FragA<SPLIT> qf[KT];
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int st = 0; st < steps; ++st) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // step st visible; every warp is done with st - 1
    if (st + kStages - 1 < steps) stage_step(st + kStages - 1);
    cp_async_commit();
    if (st == 0) {
#pragma unroll
      for (int kt = 0; kt < KT; ++kt)
        load_a<T, LD>(qf[kt], q_s + grp * QB * LD, wq * 16, kt * 16, lane);
    }
    const int kb = st % nkb, buf = st % kStages;
    const T* kt_s = k_s + (buf * rb + grp) * KB * LD;
    const T* vt_s = v_s + (buf * rb + grp) * KB * LD;

    // s = (qscale * q . k + bias) + keybias.
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
    if constexpr (BIAS) {
      const unsigned char* bt = b_s + buf * QB * kLdBias * bias_es;
      const int i0 = (wq * 16 + g) * kLdBias + 2 * t;
      if (SPLIT || a.bias_f32)
        add_bias(s, reinterpret_cast<const float*>(bt) + i0, a.qscale);
      else
        add_bias(s, reinterpret_cast<const bf16*>(bt) + i0, a.qscale);
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      if constexpr (SEG) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 kbv = *reinterpret_cast<const float2*>(
              kb_row[r] + kb * KB + n * 8 + 2 * t);
          s[n][2 * r] += kbv.x;
          s[n][2 * r + 1] += kbv.y;
        }
      } else {
        const float2 kbv = *reinterpret_cast<const float2*>(
            kbias + kb * kKB + n * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] += (e & 1) ? kbv.y : kbv.x;
      }
    }

    // Rows g (r = 0: e = 0, 1) and g + 8 (r = 1: e = 2, 3) of the warp's 16.
    if constexpr (FINAL) {
      if (st < nkb) {  // pass 1: the row max only
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            m_run[e >> 1] = fmaxf(m_run[e >> 1], s[n][e]);
        continue;
      }
      if (st == nkb) {
#pragma unroll
        for (int r = 0; r < 2; ++r) m_run[r] = quad_max(m_run[r]);
      }
      // p = bf16(exp(bf16(s - m))), m the row's final max (exact in bf16,
      // so P V sees it unrounded).
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 x = __bfloat1622float2(__floats2bfloat162_rn(
              s[n][2 * r] - m_run[r], s[n][2 * r + 1] - m_run[r]));
          const float2 p = __bfloat1622float2(
              __floats2bfloat162_rn(expf(x.x), expf(x.y)));
          s[n][2 * r] = p.x;
          s[n][2 * r + 1] = p.y;
          l_run[r] += p.x + p.y;
        }
    } else {
      float mx[2] = {-INFINITY, -INFINITY}, alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m_run[r], quad_max(mx[r]));
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
      if constexpr (SEG) {
        // The stock kernel's one-block path (L <= 128): P is normalised
        // before it is rounded for P V, and the output not divided again.
        if (nkb == 1) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float l = quad_sum(sum[r]);
#pragma unroll
            for (int n = 0; n < NS; ++n) {
              s[n][2 * r] /= l;
              s[n][2 * r + 1] /= l;
            }
          }
        }
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];
    }

    // O += P V, P from the S registers.
#pragma unroll
    for (int kc = 0; kc < KB / 16; ++kc) {
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

  // Row sums over the quad, one division, the gate, then this warp's 16
  // rows go through its own rows of the Q tile to the stores.
  const int w0 = (grp * QB + wq * 16) * LD;
  T* o_s = q_s + w0;
  const T* gt = g_s + w0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = SEG && nkb == 1 ? 1.f : quad_sum(l_run[r]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int i = (g + 8 * r) * LD + n * 8 + 2 * t;
      float v0 = o[n][2 * r] / l, v1 = o[n][2 * r + 1] / l;
      if (has_gate) {
        v0 *= 1.f / (1.f + expf(-to_f32(gt[i])));
        v1 *= 1.f / (1.f + expf(-to_f32(gt[i + 1])));
      }
      o_s[i] = from_f32<T>(v0);
      o_s[i + 1] = from_f32<T>(v1);
    }
  }
  __syncwarp();
  if (r0 + grp >= R) return;
  T* op = static_cast<T*>(a.out) + b * a.os.b + (r0 + grp) * a.os.r +
          h * a.os.h;
  const int l0 = q0 + wq * 16;
  if (a.vec) {
    for (int c = lane; c < 16 * CH; c += 32) {
      const int r = c / CH, col = (c % CH) * VEC;
      if (l0 + r < L && col < D)
        *reinterpret_cast<uint4*>(op + (l0 + r) * a.os.l + col) =
            *reinterpret_cast<const uint4*>(o_s + r * LD + col);
    }
  } else {
    for (int c = lane; c < 16 * DP; c += 32) {
      const int r = c / DP, col = c % DP;
      if (l0 + r < L && col < D) op[(l0 + r) * a.os.l + col] =
          o_s[r * LD + col];
    }
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

inline bool strides16(const Strides& s, size_t es) {
  return (s.b * es) % 16 == 0 && (s.r * es) % 16 == 0 &&
         (s.l * es) % 16 == 0 && (s.h * es) % 16 == 0;
}

// rb: at most RBMAX rows a block, fewer where shared memory runs out.
template <typename T, int DP, int QW, int RBMAX, bool BIAS, bool FINAL,
          bool SEG>
cudaError_t launch_t(Args a, int B, cudaStream_t stream) {
  using Lay = Layout<T, DP, QW, SEG>;
  const size_t es = sizeof(T);
  const int bias_es = !BIAS ? 0 : (a.bias_f32 ? 4 : static_cast<int>(es));
  const bool has_gate = BIAS && a.gate != nullptr;
  a.vec = a.D % (16 / es) == 0 && aligned16(a.q) && aligned16(a.k) &&
          aligned16(a.v) && aligned16(a.out) &&
          (!has_gate || (aligned16(a.gate) && strides16(a.gs, es))) &&
          strides16(a.qs, es) && strides16(a.ks, es) &&
          strides16(a.vs, es) && strides16(a.os, es);
  a.bias_vec = BIAS && aligned16(a.bias) && (a.L * bias_es) % 16 == 0;
  a.rb = std::min(RBMAX, a.R);
  while (a.rb > 1 &&
         Lay(a.rb, has_gate, bias_es, a.L).total > kMaxSmem)
    --a.rb;
  const size_t smem = Lay(a.rb, has_gate, bias_es, a.L).total;
  if (smem > kMaxSmem) return cudaErrorInvalidConfiguration;
  cudaError_t e =
      set_smem(flash_kernel<T, DP, QW, RBMAX, BIAS, FINAL, SEG>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.L + Lay::kQB - 1) / Lay::kQB, a.H,
                  B * ((a.R + a.rb - 1) / a.rb));
  flash_kernel<T, DP, QW, RBMAX, BIAS, FINAL, SEG>
      <<<grid, a.rb * QW * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

// Segment mode in f32 stops at D = 64: two stages of 128-key f32 K and V
// tiles of D = 128 would take 278 KB of shared memory.
template <typename T, int QW, int RBMAX, bool BIAS, bool FINAL,
          bool SEG = false>
cudaError_t launch_d(const Args& a, int B, cudaStream_t s) {
  if (a.D < 1 || a.L < 1 || a.R < 1) return cudaErrorInvalidValue;
  if (a.D <= 16) return launch_t<T, 16, QW, RBMAX, BIAS, FINAL, SEG>(a, B, s);
  if (a.D <= 32) return launch_t<T, 32, QW, RBMAX, BIAS, FINAL, SEG>(a, B, s);
  if (a.D <= 48) return launch_t<T, 48, QW, RBMAX, BIAS, FINAL, SEG>(a, B, s);
  if (a.D <= 64) return launch_t<T, 64, QW, RBMAX, BIAS, FINAL, SEG>(a, B, s);
  if constexpr (!(SEG && IsF32<T>::value)) {
    if (a.D <= 128)
      return launch_t<T, 128, QW, RBMAX, BIAS, FINAL, SEG>(a, B, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace flash
}  // namespace
}  // namespace abx
