// Row-wise fused linear: Y = [LayerNorm(X)] W^T + bias [x sigmoid(gate)]
// [+ residual].
//
// Replaces these Pallas TPU kernels, or their projection halves:
//   * abx_tpu/ops/pair_bias.py::pair_bias_proj (LN -> C->H, written in the
//     (B, H, R, L) attention-bias layout: out_mode 1; its bf16 launches run
//     pair_bias.cu);
//   * the in-kernel LN + q/k/v/gate projection and the out-proj + residual
//     epilogue of abx_tpu/ops/tri_attention.py::triangle_attention_packed
//     (out_mode 0);
//   * abx_tpu/ops/tri_mult.py::tri_mult_post (LN over C_int -> C_int->C ->
//     x sigmoid(final gate) -> + residual: out_mode 0 with a gate);
//   * abx_tpu/ops/tri_mult.py::tri_mult_pre (LN -> the fused [left | right
//     | left gate | right gate | final gate] projection -> left * sigmoid(
//     left gate) * pair mask, the same for right, and the final gate
//     pre-sigmoid: out_mode 2, entry abx_tri_mult_pre; without the final
//     gate columns for emit_fgate=False; left and right written channel-
//     major, (B, nc, R, L), for c_major=True);
//   * abx_tpu/ops/tri_mult.py::tri_mult_post with y_c_major=True (its input
//     read channel-major, (B, nc, R, L): entry abx_tri_mult_post_c_major);
//   * abx_tpu/ops/gate_proj.py::gate_proj_residual ((sigmoid(gate) * y) W^T
//     + bias + residual: the gate is applied while a tile of y is staged,
//     entry abx_gate_proj);
//   * abx_tpu/ops/tri_mult.py::tri_mult_post_gatefold (LN(y) W^T + b, times
//     sigmoid(LN_x(res) Wg^T + bg) with the final gate recomputed from the
//     residual and kept in f32, + res: two LN-staged products per output
//     tile in one block, entry abx_tri_mult_post_gatefold; its bf16
//     launches with nc <= 128 and C <= 192 run gatefold_sm90.cu).
// Two kernels.  bf16 launches of out_mode 0 and 2 with K <= 192 (K a
// multiple of 8) run the Hopper core of row_linear_sm90.cuh (persistent
// blocks, TMA, wgmma; its note says what bounds it): tri_mult_pre in all
// three variants, tri_mult_post on the natural input, gate_proj_residual,
// and the triangle attention's fused projection and out-proj.  The tile
// kernel below keeps the rest: f32 inputs (bf16x3), the pair-bias
// projection (out_mode 1) where pair_bias.cu does not take it (f32, K above
// 192 or not a multiple of 8, N > 64), the channel-major input of
// tri_mult_post, the gate-fold post in f32 (and shapes gatefold_sm90.cu
// does not take), and K > 192 (the seq attention's
// projection and out-proj, K = 544, M = 1,152).
// Bound on the H100 (tile kernel): the C->H bias projection does 2*H flops per byte of
// the (B, L, L, C) pair track and is bound by device-memory bytes; the
// wider projections are bound by the block's non-MMA phases (LayerNorm
// statistics, staging, the epilogue), not by the tensor cores.
// Design: one 64 x BN output tile per 256-thread block (BN = 64 for the
// narrow bias projections, 128 otherwise), K streamed in 64-wide chunks
// with 16-byte loads.  The LayerNorm statistics are taken per row in a
// first pass (16-byte loads, a warp's rows interleaved) and the
// normalisation (or the sigmoid gate) is applied while a chunk is staged in
// shared memory, so the normalised or gated tensor never reaches device
// memory.  The N tiles of one M tile are consecutive blocks, so the row
// re-reads hit L2.  The epilogue writes 8 columns per thread.  Products are
// wmma bf16 (bf16x3 for f32 inputs, see common.cuh).
// Channel-major operands: a 64-row M tile is 64 consecutive positions m =
// (b*R + r)*L + l, which may straddle two batch elements when R*L is not a
// multiple of 64, so every row finds its own batch element.  pre's c_major
// store stages the gated 64 x 64 tile transposed in shared memory, so that
// each channel writes a run of consecutive positions; post's channel-major
// input is read with consecutive threads on consecutive positions (the
// LayerNorm statistics with four threads per row, each over a quarter of
// the channels) and transposed into the [row][k] staging tile.
#include "common.cuh"
#include "row_linear_sm90.cuh"

namespace abx {

struct LinearArgs {
  const void* x;
  int M, K, ldx;
  const float* ln_scale;  // nullable: no LayerNorm
  const float* ln_bias;
  const void* w;          // (N, K) row-major, same dtype as x
  const float* bias;      // (N,) nullable
  const void* residual;   // (M, N) nullable, same dtype as x
  const void* gate;       // (M, N) pre-sigmoid gate, nullable, dtype of x
  const void* xgate;      // (M, K) pre-sigmoid gate on x (row stride ldx),
                          // nullable, dtype of x; exclusive with ln_scale
  void* out;
  int N;
  int out_mode;           // 0: (M, N); 1: (B, N, R, Lc), m = (b*R + r)*Lc + l;
                          // 2: gated pairs, see abx_tri_mult_pre
  int R, Lc;
  const float* seq_mask;  // out_mode 2: (B, Lc), pair mask m[b,r] * m[b,l]
  void* out2;             // out_mode 2: (M, N - gated columns) ungated part
  int gated;              // out_mode 2: value channels per side (nc)
  int lr_c_major;         // out_mode 2: gated sides as (B, nc, R, Lc)
};

constexpr int kHalf = 64;  // out_mode 2: [64 values | 64 gates] per N tile

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

constexpr int kBM = 64, kBK = 64;
constexpr int kLDA = kBK + 8;  // bf16 elements

// BN: 64 for narrow outputs (the pair-bias heads), 128 otherwise.
template <int BN>
struct LinearTile {
  static constexpr int LDC = BN + 4;                   // floats
  static constexpr int TILES = (kBM / 16) * (BN / 16);
  static constexpr int PER_WARP = TILES / kWarps;      // 2 or 4
};

template <typename T, int BN>
size_t linear_smem_bytes() {
  constexpr int parts = IsF32<T>::value ? 2 : 1;
  return parts * carve_bytes(sizeof(bf16) * kBM * kLDA) +
         parts * carve_bytes(sizeof(bf16) * BN * kLDA) +
         carve_bytes(sizeof(float) * kBM * LinearTile<BN>::LDC) +
         2 * carve_bytes(sizeof(float) * kBM);
}

// Transforms applied to X while a K chunk is staged; k0 is the chunk's first
// column, set by accumulate().
struct NoXform {
  int k0;
  __device__ float operator()(int, int, float v) const { return v; }
};

struct LnXform {  // LayerNorm
  const float* mean;
  const float* rstd;
  const float* scale;
  const float* bias;
  int k0;
  __device__ float operator()(int r, int c, float v) const {
    return (v - mean[r]) * rstd[r] * scale[k0 + c] + bias[k0 + c];
  }
};

template <typename T>
struct GateXform {  // y * sigmoid(gate), gate at the same place as y
  const T* gate;    // row m0 of the gate
  int ld;
  int k0;
  __device__ float operator()(int r, int c, float v) const {
    return v * sigmoid(to_f32(gate[(size_t)r * ld + k0 + c]));
  }
};

// LayerNorm moments of rows [0, rows) of x (row stride ldx, K columns):
// one-pass moments, max(var, 0) clamp, eps 1e-5.  Warp w takes rows
// w*R .. w*R+R-1, 8 columns per lane per step (16-byte loads), the R rows'
// loads and reductions interleaved.
template <typename T>
__device__ __forceinline__ void row_moments(const T* x, int ldx, int K,
                                            int rows, float* mean_s,
                                            float* rstd_s) {
  constexpr int R = kBM / kWarps;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float s[R], s2[R];
#pragma unroll
  for (int r = 0; r < R; ++r) s[r] = s2[r] = 0.f;
  for (int c = lane * 8; c < K; c += 32 * 8) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = warp * R + r;
      float v[8];
      load8(x + (size_t)i * ldx + c, i < rows, c, K, v);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        s[r] += v[k];
        s2[r] += v[k] * v[k];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    s[r] = warp_sum(s[r]);
    s2[r] = warp_sum(s2[r]);
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float mu = s[r] / K;
      mean_s[warp * R + r] = mu;
      rstd_s[warp * R + r] = rsqrtf(fmaxf(s2[r] / K - mu * mu, 0.f) + 1e-5f);
    }
  }
}

// row_moments for a channel-major x (B, K, R*Lc = rl): element (m, k) at
// x[(b*K + k)*rl + m % rl], b = m / rl, for the tile's rows m0 + [0, rows).
// Four threads per row, each over every fourth channel; consecutive
// threads take consecutive rows.  part: 2 * kThreads floats of scratch.
template <typename T>
__device__ __forceinline__ void row_moments_cmajor(const T* x, int K, int m0,
                                                   int rows, int rl,
                                                   float* part, float* mean_s,
                                                   float* rstd_s) {
  constexpr int kParts = kThreads / kBM;
  const int i = threadIdx.x % kBM, q = threadIdx.x / kBM;
  float s = 0.f, s2 = 0.f;
  if (i < rows) {
    const int m = m0 + i;
    const T* xr = x + (size_t)(m / rl) * K * rl + m % rl;
    for (int k = q; k < K; k += kParts) {
      const float v = to_f32(xr[(size_t)k * rl]);
      s += v;
      s2 += v * v;
    }
  }
  part[threadIdx.x] = s;
  part[kThreads + threadIdx.x] = s2;
  __syncthreads();
  if (threadIdx.x < kBM) {
    s = s2 = 0.f;
#pragma unroll
    for (int p = 0; p < kParts; ++p) {
      s += part[p * kBM + i];
      s2 += part[kThreads + p * kBM + i];
    }
    const float mu = s / K;
    mean_s[i] = mu;
    rstd_s[i] = rsqrtf(fmaxf(s2 / K - mu * mu, 0.f) + 1e-5f);
  }
}

// stage_tile for the K chunk k0 of a channel-major x (layout as above):
// the (kBM x kBK) tile lands in [row][k] order, f applied on the way.
template <typename T, bool SPLIT, typename F>
__device__ __forceinline__ void stage_cmajor(const T* x, int K, int m0,
                                             int rows, int rl, int k0,
                                             bf16* hi, bf16* lo, F f) {
  for (int idx = threadIdx.x; idx < kBM * kBK; idx += kThreads) {
    const int i = idx % kBM, k = idx / kBM;
    float v = 0.f;
    if (i < rows && k0 + k < K) {
      const int m = m0 + i;
      v = f(i, k, to_f32(x[((size_t)(m / rl) * K + k0 + k) * rl + m % rl]));
    }
    put<SPLIT>(hi, lo, i * kLDA + k, v);
  }
}

// acc = f(X) W^T for one 64 x BN output tile: x at the tile's first row
// (row stride ldx), w at its first output column (row stride K).  With XCM,
// x is the whole channel-major tensor (see stage_cmajor), the tile's rows
// m0 + [0, rows) of rl positions per batch element.  Ends with a barrier,
// so the staging tiles may be reused.
template <typename T, int BN, bool SPLIT, bool XCM = false, typename F>
__device__ __forceinline__ void accumulate(FragC* acc, const T* x, int ldx,
                                           int K, int rows, const T* w,
                                           int cols, bf16* a_hi, bf16* a_lo,
                                           bf16* b_hi, bf16* b_lo, F f,
                                           int m0 = 0, int rl = 0) {
  using Tile = LinearTile<BN>;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int t = 0; t < Tile::PER_WARP; ++t) wmma::fill_fragment(acc[t], 0.f);
  for (int k0 = 0; k0 < K; k0 += kBK) {
    f.k0 = k0;
    if constexpr (XCM)
      stage_cmajor<T, SPLIT>(x, K, m0, rows, rl, k0, a_hi, a_lo, f);
    else
      stage_tile<T, SPLIT>(x + k0, ldx, rows, K - k0, a_hi, a_lo, kLDA, kBM,
                           kBK, f);
    stage_tile<T, SPLIT>(w + k0, K, cols, K - k0, b_hi, b_lo, kLDA, BN,
                         kBK);
    __syncthreads();
    {  // the warp's PER_WARP tiles share one row tm: A loaded once
      const int tile = warp * Tile::PER_WARP;
      const int tm = tile / (BN / 16), tn = tile % (BN / 16);
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16)
        mma16_row<SPLIT, FragBc, Tile::PER_WARP>(
            acc, Tile::PER_WARP, a_hi + tm * 16 * kLDA + kk,
            a_lo + tm * 16 * kLDA + kk, kLDA, b_hi + tn * 16 * kLDA + kk,
            b_lo + tn * 16 * kLDA + kk, kLDA, 16 * kLDA);
    }
    __syncthreads();
  }
}

template <int BN>
__device__ __forceinline__ void store_acc(float* c_s, const FragC* acc) {
  using Tile = LinearTile<BN>;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int t = 0; t < Tile::PER_WARP; ++t) {
    const int tile = warp * Tile::PER_WARP + t;
    const int tm = tile / (BN / 16), tn = tile % (BN / 16);
    wmma::store_matrix_sync(c_s + tm * 16 * Tile::LDC + tn * 16, acc[t],
                            Tile::LDC, wmma::mem_row_major);
  }
}

template <typename T, int BN, bool XCM>
__global__ void __launch_bounds__(kThreads) linear_kernel(LinearArgs p) {
  constexpr bool SPLIT = IsF32<T>::value;
  using Tile = LinearTile<BN>;
  constexpr int LDC = Tile::LDC;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  SmemCarver sc(smem_raw);
  bf16* a_hi = sc.take<bf16>(kBM * kLDA);
  bf16* a_lo = SPLIT ? sc.take<bf16>(kBM * kLDA) : a_hi;
  bf16* b_hi = sc.take<bf16>(BN * kLDA);
  bf16* b_lo = SPLIT ? sc.take<bf16>(BN * kLDA) : b_hi;
  float* c_s = sc.take<float>(kBM * LDC);
  float* mean_s = sc.take<float>(kBM);
  float* rstd_s = sc.take<float>(kBM);

  const T* x = static_cast<const T*>(p.x);
  const T* w = static_cast<const T*>(p.w);
  const int tid = threadIdx.x;
  // N tiles of one M tile are consecutive blocks, so the blocks that read
  // the same rows of X run together and share them through L2.
  const int n_tiles = (p.N + BN - 1) / BN;
  const int m0 = (blockIdx.x / n_tiles) * kBM;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int rows = min(kBM, p.M - m0), cols = min(BN, p.N - n0);
  const T* xa = x + (size_t)m0 * p.ldx;
  const T* wn = w + (size_t)n0 * p.K;

  FragC acc[Tile::PER_WARP];
  if constexpr (XCM) {  // with the LayerNorm (abx_tri_mult_post_c_major)
    const int rl = p.R * p.Lc;
    row_moments_cmajor(x, p.K, m0, rows, rl, c_s, mean_s, rstd_s);
    __syncthreads();
    accumulate<T, BN, SPLIT, true>(
        acc, x, p.ldx, p.K, rows, wn, cols, a_hi, a_lo, b_hi, b_lo,
        LnXform{mean_s, rstd_s, p.ln_scale, p.ln_bias, 0}, m0, rl);
  } else if (p.ln_scale != nullptr) {
    row_moments(xa, p.ldx, p.K, rows, mean_s, rstd_s);
    __syncthreads();
    accumulate<T, BN, SPLIT>(acc, xa, p.ldx, p.K, rows, wn, cols, a_hi, a_lo,
                             b_hi, b_lo,
                             LnXform{mean_s, rstd_s, p.ln_scale, p.ln_bias,
                                     0});
  } else if (p.xgate != nullptr) {
    accumulate<T, BN, SPLIT>(
        acc, xa, p.ldx, p.K, rows, wn, cols, a_hi, a_lo, b_hi, b_lo,
        GateXform<T>{static_cast<const T*>(p.xgate) + (size_t)m0 * p.ldx,
                     p.ldx, 0});
  } else {
    accumulate<T, BN, SPLIT>(acc, xa, p.ldx, p.K, rows, wn, cols, a_hi, a_lo,
                             b_hi, b_lo, NoXform{0});
  }
  store_acc<BN>(c_s, acc);
  __syncthreads();

  const T* res = static_cast<const T*>(p.residual);
  T* out = static_cast<T*>(p.out);
  if (p.out_mode == 0) {
    // 8 consecutive columns per thread: 16-byte residual loads and output
    // stores where the row is a multiple of 8 long (out is a fresh,
    // aligned allocation), element by element otherwise.
    const bool vec = p.N % 8 == 0;
    for (int idx = tid; idx < kBM * BN / 8; idx += kThreads) {
      const int i = idx / (BN / 8), j = (idx % (BN / 8)) * 8;
      if (i >= rows || j >= cols) continue;
      const size_t o = (size_t)(m0 + i) * p.N + n0 + j;
      float v[8], r[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        v[k] = c_s[i * LDC + j + k];
        if (p.bias && j + k < cols) v[k] += p.bias[n0 + j + k];
      }
      if (p.gate) {
        load8(static_cast<const T*>(p.gate) + o, true, j, cols, r);
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] *= sigmoid(r[k]);
      }
      if (res) {
        load8(res + o, true, j, cols, r);
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] += r[k];
      }
      if (vec && j + 8 <= cols) {
        store8(out + o, v);
      } else {
        for (int k = 0; k < 8 && j + k < cols; ++k)
          out[o + k] = from_f32<T>(v[k]);
      }
    }
  } else if (BN == 2 * kHalf && p.out_mode == 2) {
    // N tiles 0 .. 2*T-1 hold [64 values | their 64 gates] of the left
    // (first T tiles) and right sides, T = ceil(nc / 64); the tiles after
    // them hold the ungated final-gate columns.  (Launched with BN = 128
    // only.)
    const int per_side = (p.gated + kHalf - 1) / kHalf;
    const int tile = n0 / BN;
    if (tile < 2 * per_side) {
      const int c0 = (tile % per_side) * kHalf;
      T* dst = out + (size_t)(tile / per_side) * p.M * p.gated;
      const int rl = p.R * p.Lc;
      // The gated 64 x 64 tile, 8 consecutive channels of one row per
      // thread and step, kept in registers.
      constexpr int kSteps = kBM * kHalf / 8 / kThreads;
      float v[kSteps][8];
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        const int idx = tid + st * kThreads;
        const int i = idx / (kHalf / 8), j = (idx % (kHalf / 8)) * 8;
        const int m = m0 + i;
        const int b = m / rl;
        const float pm = i < rows ? p.seq_mask[b * p.Lc + (m / p.Lc) % p.R] *
                                        p.seq_mask[b * p.Lc + m % p.Lc]
                                  : 0.f;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int n = n0 + j + k;  // gated N tiles are whole
          const float g = c_s[i * LDC + kHalf + j + k] + p.bias[n + kHalf];
          v[st][k] = (c_s[i * LDC + j + k] + p.bias[n]) * sigmoid(g) * pm;
        }
      }
      if (!p.lr_c_major) {
        const bool vec = p.gated % 8 == 0;
#pragma unroll
        for (int st = 0; st < kSteps; ++st) {
          const int idx = tid + st * kThreads;
          const int i = idx / (kHalf / 8), j = (idx % (kHalf / 8)) * 8;
          if (i >= rows || c0 + j >= p.gated) continue;
          const size_t o = (size_t)(m0 + i) * p.gated + c0 + j;
          if (vec && c0 + j + 8 <= p.gated) {
            store8(dst + o, v[st]);
          } else {
            for (int k = 0; k < 8 && c0 + j + k < p.gated; ++k)
              dst[o + k] = from_f32<T>(v[st][k]);
          }
        }
      } else {
        // (B, nc, R, Lc): the tile goes through shared memory transposed,
        // [channel][row], so that a warp writes 32 consecutive positions of
        // one channel.
        constexpr int kLDT = kBM + 1;
        __syncthreads();  // every thread has read its part of c_s
#pragma unroll
        for (int st = 0; st < kSteps; ++st) {
          const int idx = tid + st * kThreads;
          const int i = idx / (kHalf / 8), j = (idx % (kHalf / 8)) * 8;
#pragma unroll
          for (int k = 0; k < 8; ++k) c_s[(j + k) * kLDT + i] = v[st][k];
        }
        __syncthreads();
        for (int idx = tid; idx < kHalf * kBM; idx += kThreads) {
          const int c = idx / kBM, i = idx % kBM;
          if (i >= rows || c0 + c >= p.gated) continue;
          const int m = m0 + i;
          dst[((size_t)(m / rl) * p.gated + c0 + c) * rl + m % rl] =
              from_f32<T>(c_s[c * kLDT + i]);
        }
      }
    } else {
      const int n_free = p.N - 2 * per_side * BN;
      const int f0 = n0 - 2 * per_side * BN;
      T* dst = static_cast<T*>(p.out2);
      const bool vec = n_free % 8 == 0;
      for (int idx = tid; idx < kBM * BN / 8; idx += kThreads) {
        const int i = idx / (BN / 8), j = (idx % (BN / 8)) * 8;
        if (i >= rows || j >= cols) continue;
        float v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
          v[k] = c_s[i * LDC + j + k] + (j + k < cols ? p.bias[n0 + j + k] : 0.f);
        const size_t o = (size_t)(m0 + i) * n_free + f0 + j;
        if (vec && j + 8 <= cols) {
          store8(dst + o, v);
        } else {
          for (int k = 0; k < 8 && j + k < cols; ++k)
            dst[o + k] = from_f32<T>(v[k]);
        }
      }
    }
  } else {
    const int rl = p.R * p.Lc;
    for (int idx = tid; idx < kBM * BN; idx += kThreads) {
      const int j = idx / kBM, i = idx % kBM, m = m0 + i, n = n0 + j;
      if (i >= rows || j >= cols) continue;
      float v = c_s[i * LDC + j];
      if (p.bias) v += p.bias[n];
      const int b = m / rl, rem = m % rl;
      out[((size_t)b * p.N + n) * rl + rem] = from_f32<T>(v);
    }
  }
}

template <typename T, int BN, bool XCM = false>
cudaError_t launch_linear_bn(const LinearArgs& p, cudaStream_t stream) {
  const size_t smem = linear_smem_bytes<T, BN>();
  cudaError_t e = set_smem(linear_kernel<T, BN, XCM>, smem);
  if (e != cudaSuccess) return e;
  const int grid = ((p.M + kBM - 1) / kBM) * ((p.N + BN - 1) / BN);
  linear_kernel<T, BN, XCM><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_linear(const LinearArgs& p, cudaStream_t stream) {
  return p.N <= 64 ? launch_linear_bn<T, 64>(p, stream)
                   : launch_linear_bn<T, 128>(p, stream);
}

// bf16 launches the Hopper core takes (sm90::instance) run there
// (row_linear_sm90.cuh); the others on the tile kernel above.
cudaError_t launch_linear_bf16(const LinearArgs& p, cudaStream_t stream) {
  const sm90::Args a{p.M,
                     p.K,
                     p.N,
                     p.ln_scale,
                     p.ln_bias,
                     static_cast<const bf16*>(p.xgate),
                     p.bias,
                     static_cast<const bf16*>(p.residual),
                     static_cast<const bf16*>(p.gate),
                     static_cast<bf16*>(p.out),
                     p.out_mode,
                     p.R,
                     p.Lc,
                     p.seq_mask,
                     static_cast<bf16*>(p.out2),
                     p.gated,
                     p.lr_c_major};
  const int code = sm90::instance(a, p.ldx, p.x, p.w);
  if (code >= 0) return sm90::launch(code, a, p.x, p.w, stream);
  return p.out_mode == 2 ? launch_linear_bn<bf16, 128>(p, stream)
                         : launch_linear<bf16>(p, stream);
}

// tri_mult_post_gatefold: per 64 x 128 output tile, o = LN(y) W^T and
// fg = LN_x(res) Wg^T, each accumulated over its own K (nc, then C) through
// the same staging tiles; the epilogue forms (o + b) * sigmoid(fg + bg) +
// res with fg in f32.
struct GatefoldArgs {
  const void* y;          // (M, NC)
  const void* res;        // (M, C)
  int M, NC, C;
  const float* y_scale;   // (NC,) LayerNorm of y
  const float* y_bias;
  const void* w;          // (C, NC), dtype of y
  const float* wb;        // (C,)
  const float* x_scale;   // (C,) the pre block's LayerNorm, applied to res
  const float* x_bias;
  const void* wg;         // (C, C) final-gate projection, dtype of y
  const float* wgb;       // (C,)
  void* out;              // (M, C)
};

template <typename T>
size_t gatefold_smem_bytes() {
  constexpr int parts = IsF32<T>::value ? 2 : 1;
  return parts * carve_bytes(sizeof(bf16) * kBM * kLDA) +
         parts * carve_bytes(sizeof(bf16) * 128 * kLDA) +
         2 * carve_bytes(sizeof(float) * kBM * LinearTile<128>::LDC) +
         4 * carve_bytes(sizeof(float) * kBM);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) gatefold_kernel(GatefoldArgs p) {
  constexpr bool SPLIT = IsF32<T>::value;
  constexpr int BN = 128;
  using Tile = LinearTile<BN>;
  constexpr int LDC = Tile::LDC;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  SmemCarver sc(smem_raw);
  bf16* a_hi = sc.take<bf16>(kBM * kLDA);
  bf16* a_lo = SPLIT ? sc.take<bf16>(kBM * kLDA) : a_hi;
  bf16* b_hi = sc.take<bf16>(BN * kLDA);
  bf16* b_lo = SPLIT ? sc.take<bf16>(BN * kLDA) : b_hi;
  float* o_s = sc.take<float>(kBM * LDC);
  float* g_s = sc.take<float>(kBM * LDC);
  float* mean_y = sc.take<float>(kBM);
  float* rstd_y = sc.take<float>(kBM);
  float* mean_x = sc.take<float>(kBM);
  float* rstd_x = sc.take<float>(kBM);

  const int n_tiles = (p.C + BN - 1) / BN;
  const int m0 = (blockIdx.x / n_tiles) * kBM;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int rows = min(kBM, p.M - m0), cols = min(BN, p.C - n0);
  const T* y = static_cast<const T*>(p.y) + (size_t)m0 * p.NC;
  const T* res = static_cast<const T*>(p.res) + (size_t)m0 * p.C;
  row_moments(y, p.NC, p.NC, rows, mean_y, rstd_y);
  row_moments(res, p.C, p.C, rows, mean_x, rstd_x);
  __syncthreads();

  FragC acc[Tile::PER_WARP];
  accumulate<T, BN, SPLIT>(
      acc, y, p.NC, p.NC, rows, static_cast<const T*>(p.w) + (size_t)n0 * p.NC,
      cols, a_hi, a_lo, b_hi, b_lo,
      LnXform{mean_y, rstd_y, p.y_scale, p.y_bias, 0});
  store_acc<BN>(o_s, acc);
  accumulate<T, BN, SPLIT>(
      acc, res, p.C, p.C, rows, static_cast<const T*>(p.wg) + (size_t)n0 * p.C,
      cols, a_hi, a_lo, b_hi, b_lo,
      LnXform{mean_x, rstd_x, p.x_scale, p.x_bias, 0});
  store_acc<BN>(g_s, acc);
  __syncthreads();

  T* out = static_cast<T*>(p.out);
  const bool vec = p.C % 8 == 0;
  for (int idx = threadIdx.x; idx < kBM * BN / 8; idx += kThreads) {
    const int i = idx / (BN / 8), j = (idx % (BN / 8)) * 8;
    if (i >= rows || j >= cols) continue;
    float r[8], v[8];
    load8(res + (size_t)i * p.C + n0 + j, true, j, cols, r);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int n = min(n0 + j + k, p.C - 1);
      const float fg = g_s[i * LDC + j + k] + p.wgb[n];
      v[k] = (o_s[i * LDC + j + k] + p.wb[n]) * sigmoid(fg) + r[k];
    }
    const size_t o = (size_t)(m0 + i) * p.C + n0 + j;
    if (vec && j + 8 <= cols) {
      store8(out + o, v);
    } else {
      for (int k = 0; k < 8 && j + k < cols; ++k)
        out[o + k] = from_f32<T>(v[k]);
    }
  }
}

template <typename T>
cudaError_t launch_gatefold(const GatefoldArgs& p, cudaStream_t stream) {
  const size_t smem = gatefold_smem_bytes<T>();
  cudaError_t e = set_smem(gatefold_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  const int grid = ((p.M + kBM - 1) / kBM) * ((p.C + 127) / 128);
  gatefold_kernel<T><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace abx

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch.
extern "C" int abx_row_linear(int dtype, const void* x, int M, int K, int ldx,
                              const float* ln_scale, const float* ln_bias,
                              const void* w, const float* bias,
                              const void* residual, const void* gate,
                              void* out, int N, int out_mode, int R, int Lc,
                              void* stream) {
  abx::LinearArgs p{x,        M,    K,        ldx,     ln_scale, ln_bias,
                    w,        bias, residual, gate,    nullptr,  out,
                    N,        out_mode, R,    Lc,      nullptr,  nullptr,
                    0,        0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? abx::launch_linear<float>(p, s)
                    : abx::launch_linear_bf16(p, s);
}

// tri_mult_pre: LayerNorm(x) -> packed projection -> gating.  w (N, K) and
// bias (N,) are packed by the caller: for each side (left, right) and each
// 64-channel chunk of its nc value channels, 64 value rows then their 64
// gate rows (zero rows pad the last chunk), then the ungated final-gate
// rows.  out_lr is (2, M, nc): left * sigmoid(left gate) * pair mask, then
// right -- or (2, B, nc, R, Lc) with c_major; out_fg is (M, N - 4 * 64 *
// ceil(nc / 64)), the final gate pre-sigmoid (null, and no final-gate rows
// in w, for emit_fgate=False).
// Rows are m = (b*R + r)*Lc + l; seq_mask is (B, Lc).
extern "C" int abx_tri_mult_pre(int dtype, const void* x, int M, int K,
                                const float* ln_scale, const float* ln_bias,
                                const void* w, const float* bias, int N,
                                const float* seq_mask, int R, int Lc, int nc,
                                int c_major, void* out_lr, void* out_fg,
                                void* stream) {
  abx::LinearArgs p{x,       M,    K,       K,       ln_scale, ln_bias,
                    w,       bias, nullptr, nullptr, nullptr,  out_lr,
                    N,       2,    R,       Lc,      seq_mask, out_fg,
                    nc,      c_major};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? abx::launch_linear_bn<float, 128>(p, s)
                    : abx::launch_linear_bf16(p, s);
}

// tri_mult_post with a channel-major input: out = (LN(y) W^T + bias) *
// sigmoid(gate) + residual, y (B, K, R, Lc) with M = B*R*Lc positions; w (N,
// K); bias (N,); gate, residual and out (M, N) in the natural order.
extern "C" int abx_tri_mult_post_c_major(int dtype, const void* y, int M,
                                         int K, const float* ln_scale,
                                         const float* ln_bias, const void* w,
                                         const float* bias, const void* gate,
                                         const void* residual, void* out,
                                         int N, int R, int Lc, void* stream) {
  abx::LinearArgs p{y,       M,    K,        K,       ln_scale, ln_bias,
                    w,       bias, residual, gate,    nullptr,  out,
                    N,       0,    R,        Lc,      nullptr,  nullptr,
                    0,       0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? abx::launch_linear_bn<float, 128, true>(p, s)
                    : abx::launch_linear_bn<abx::bf16, 128, true>(p, s);
}

// gate_proj_residual: out = (y * sigmoid(gate)) W^T + bias + residual, the
// product z = y * sigmoid(gate) rounded to the dtype of y as it is staged.
// y and gate (M, K); w (N, K); bias (N,); residual and out (M, N).
extern "C" int abx_gate_proj(int dtype, const void* y, const void* gate,
                             int M, int K, const void* w, const float* bias,
                             const void* residual, void* out, int N,
                             void* stream) {
  abx::LinearArgs p{y,       M,    K,        K,       nullptr, nullptr,
                    w,       bias, residual, nullptr, gate,    out,
                    N,       0,    0,        0,       nullptr, nullptr,
                    0,       0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? abx::launch_linear<float>(p, s)
                    : abx::launch_linear_bf16(p, s);
}

// tri_mult_post_gatefold: out = (LN(y) W^T + wb) * sigmoid(LN_x(res) Wg^T +
// wgb) + res.  y (M, NC); res and out (M, C); w (C, NC); wg (C, C); the
// LayerNorm params and biases f32.
extern "C" int abx_tri_mult_post_gatefold(
    int dtype, const void* y, const void* res, int M, int NC, int C,
    const float* y_scale, const float* y_bias, const void* w, const float* wb,
    const float* x_scale, const float* x_bias, const void* wg,
    const float* wgb, void* out, void* stream) {
  abx::GatefoldArgs p{y,  res,     M,       NC, C,   y_scale, y_bias,
                      w,  wb,      x_scale, x_bias, wg, wgb,  out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? abx::launch_gatefold<float>(p, s)
                    : abx::launch_gatefold<abx::bf16>(p, s);
}
