// Hopper row-linear core: Y = f(X) W^T + bias, with the epilogues of
// row_linear.cu's out_modes 0 (optional sigmoid gate and residual) and 2
// (tri_mult_pre's gated pairs, natural or channel-major), for bf16 X with
// K <= 192, K a multiple of 8 (16-byte TMA strides).  f(X) is X's
// LayerNorm (f32 statistics, rounded to bf16 before the product, as the
// TPU kernels round LN(x) to the input dtype), X * sigmoid(gate) rounded
// to bf16 (gate_proj_residual), or X itself.
//
// Replaces, for those launches, the tile kernel of row_linear.cu, and
// with it the projection halves of the Pallas TPU kernels
// abx_tpu/ops/tri_mult.py::tri_mult_pre and ::tri_mult_post,
// abx_tpu/ops/tri_attention.py::triangle_attention_packed (its LN + q/k/v/
// gate projection and its out-proj + residual) and
// ::triangle_attention_packed_cols (its projection), and
// abx_tpu/ops/gate_proj.py::gate_proj_residual.
// Bound on the H100: at tri_mult_pre's flagship shape (M = 4*288*288,
// K = 192, N = 704) 90 GFLOP against 425 MB, i.e. device-memory bytes
// (0.127 ms) over the tensor cores' 0.091 ms: the kernel has to stream X
// in and the gated pairs out at the memory's rate while the products run.
// What holds that tile kernel back: one 64 x 128 output tile a block (31k
// blocks), the LayerNorm statistics and the normalisation redone for each
// of a row tile's N tiles, synchronous staging, wmma 16x16x16 and an f32
// round trip of every accumulator through shared memory.
// Design:
// - A persistent grid, one block per SM (about 210 KB of shared memory at
//   K = 192), walks 128-row M tiles; a block computes all N columns of a
//   tile, so X is read and normalised once per row.
// - One producer thread (a third warpgroup, its registers given to the
//   consumers with setmaxnreg) loads the raw X tile by TMA in 64-column
//   boxes with the 128-byte swizzle, and streams W in 128-row chunks
//   through a two-stage ring (full / empty mbarriers).  The next tile's X
//   is requested as soon as the consumers have normalised the current
//   one, so it lands during the current tile's N loop.
// - Two consumer warpgroups take 64 rows each: eight lanes a row, the
//   moments in f32 from registers (two passes), the normalised row
//   written as bf16 into the A tile in wgmma's 128-byte-swizzled K-major
//   layout (the same layout the TMA gave X), then a proxy fence.
// - Per 128-column chunk: K / 16 wgmma.m64n128k16 (A and B from shared
//   memory, f32 accumulators in registers); out_mode 0's gate and
//   residual are loaded at the lane's own cells while the products run.
//   The epilogue works from the registers: bias, the sigmoid gate, the
//   residual, the pair mask; out_mode 2's chunks hold [64 values | their
//   64 gates], so a thread holds column n and its gate n + 64 and forms
//   value * sigmoid(gate) * mask in registers.  Each 64-column half is
//   rounded once to bf16 into the warp's own 16-row staging tile and
//   written out as 16-byte pieces, a quarter-warp per 128-byte row; the
//   channel-major store goes through the warpgroup's tile transposed, so
//   that a lane writes 8 consecutive positions of one channel.
// - What bounds it, measured by cutting parts out (tri_mult_pre, bf16,
//   flagship shape, one H100): the epilogue's instruction count, with
//   two consumer warps a scheduler to hide its latencies; the products
//   and the loads take a fifth of the time.  The sigmoid takes the SFU's
//   exponent and reciprocal (__expf, __fdividef) for that reason.
// Ragged M, N and K are zero-filled by TMA and masked on the way out.
#pragma once

#include "common.cuh"
#include "mma_sync.cuh"
#include "tma.cuh"

namespace abx {
namespace sm90 {

constexpr int kBM = 128;         // rows of an M tile: two warpgroups x 64
constexpr int kBN = 128;         // columns of a W chunk
constexpr int kMaxK = 192;       // at most three 64-column swizzle atoms
constexpr int kStages = 2;       // W ring
constexpr int kConsumerWarps = 8;
constexpr int kThreads = 32 * kConsumerWarps + 128;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
// Staging rows (bf16), 64 columns (or, channel-major, 64 positions) and 8
// of padding: the staging tiles of the 8 consumer warps (16 rows each) or
// of the 2 warpgroups (64 channels each) fill the same region.
constexpr int kLdW = 64 + 8;
constexpr int kHalf = 64;          // out_mode 2: [64 values | 64 gates]

struct Args {
  int M, K, N;
  const float* ln_scale;  // (K,) nullable: no LayerNorm
  const float* ln_bias;
  const bf16* xgate;      // (M, K) pre-sigmoid gate on X, nullable
  const float* bias;      // (N,) nullable
  const bf16* residual;   // out_mode 0: (M, N), nullable
  const bf16* gate;       // out_mode 0: (M, N) pre-sigmoid gate, nullable
  bf16* out;              // out_mode 0: (M, N); 2: the gated sides
  int out_mode;           // 0 or 2 (see row_linear.cu)
  int R, Lc;              // out_mode 2: rows m = (b*R + r)*Lc + l
  const float* seq_mask;  // out_mode 2: (B, Lc)
  bf16* out2;             // out_mode 2: (M, N - gated columns), nullable
  int gated;              // out_mode 2: value channels per side (nc)
  int lr_c_major;         // out_mode 2: sides as (B, nc, R, Lc)
};

template <int KA>
struct Plan {
  static constexpr int kTile = KA * kBM * 128;  // X or A tile, bytes
  static constexpr int kW = KA * kBN * 128;     // one W stage, bytes
  static constexpr int kA = kTile;              // offsets from the base
  static constexpr int kW0 = 2 * kTile;
  static constexpr int kT = kW0 + kStages * kW;
  static constexpr int kBar = kT + kBM * kLdW * 2;
  // 1024 bytes of slack to align the base for the 128-byte swizzle.
  static constexpr size_t kSmem = 1024 + kBar + 64;
};

// Byte offset of the 16-byte piece j (0..7) of row r in a 64-column atom
// of 128-byte rows, 128-byte swizzle (the TMA's and wgmma's layout).
__device__ __forceinline__ int swz(int r, int j) {
  return r * 128 + ((j ^ (r & 7)) << 4);
}

// wgmma descriptor of a K-major, 128-byte-swizzled operand at shared
// address addr: rows 128 bytes apart, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// wgmma descriptor of an MN-major, 128-byte-swizzled operand at shared
// address addr: 64 MN elements a 128-byte row, one row a K index, 8-row K
// groups 1024 bytes apart (the stride byte offset).  The callers' MN
// extent is one swizzle atom (64 rows of an M tile, 64 columns of N), so
// the leading byte offset (the stride between MN atoms) is never used; it
// is set to 1024 as well.
__device__ __forceinline__ uint64_t desc_mn_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d = A(64 x 16) B(16 x 128)^T + (scale_d ? d : 0), both operands from
// shared memory.
__device__ __forceinline__ void wgmma_128(float (&d)[64], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d = A(64 x 16) B(16 x 64)^T + (scale_d ? d : 0), both operands from
// shared memory.
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// sigmoid with the SFU's exponent and reciprocal: the epilogue is bound
// by its instruction count, and bf16 outputs do not see the last f32 bits.
__device__ __forceinline__ float sigm(float v) {
  return __fdividef(1.f, 1.f + __expf(-v));
}

__device__ __forceinline__ void load8_bf16(const bf16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int k = 0; k < 8; ++k) x[k] = __bfloat162float(e[k]);
}

__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  uint4 u;
  u.x = pack_bf16(v[0], v[1]);
  u.y = pack_bf16(v[2], v[3]);
  u.z = pack_bf16(v[4], v[5]);
  u.w = pack_bf16(v[6], v[7]);
  return u;
}

// The accumulator of one warpgroup (64 rows x 128 columns): element
// d[4 n + 2 h + x] is row 16 w + g + 8 h, column 8 n + 2 t + x (w the
// warp in the warpgroup, lane = 4 g + t).  The epilogue works on 64-column
// halves: a half's 8 n8 tiles as v[nt][h][x] in f32, rounded once to bf16
// into the warp's 16 x 64 staging tile (rows kLdW apart: the lanes of a
// store hit distinct banks), from which each lane writes 16-byte pieces,
// a quarter-warp per 128-byte row.

__device__ __forceinline__ void stage_half(bf16* wst, const float (&v)[8][2][2],
                                           int g, int t) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(wst + (g + 8 * h) * kLdW + 8 * nt +
                                   2 * t) = pack_bf16(v[nt][h][0],
                                                      v[nt][h][1]);
}

// Rows m_w + [0, 16) and columns col0 + [0, 64) of a (M, ld) bf16 output
// whose first ncols columns exist (ld and ncols multiples of 8, dst
// 16-byte aligned), from the warp's staging tile.
__device__ __forceinline__ void flush_half(const bf16* wst, bf16* dst,
                                           int ld, int m_w, int M, int col0,
                                           int ncols, int lane) {
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * 8; i += 32) {
    const int r = i >> 3, pc = (i & 7) * 8;
    const int m = m_w + r, c = col0 + pc;
    if (m < M && c < ncols)
      *reinterpret_cast<uint4*>(dst + static_cast<size_t>(m) * ld + c) =
          *reinterpret_cast<const uint4*>(wst + r * kLdW + pc);
  }
  __syncwarp();
}

// The (M, ld) bf16 pair of columns (n, n + 1) of row m as one word (zero
// past M rows and ld columns; ld even, p 4-byte aligned).
__device__ __forceinline__ uint32_t load_pair(const bf16* p, int ld, int m,
                                              int M, int n) {
  if (m >= M || n >= ld) return 0u;
  return *reinterpret_cast<const uint32_t*>(p + static_cast<size_t>(m) * ld +
                                            n);
}

__device__ __forceinline__ float lo_f(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_f(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// What f(X) is (XF) and which epilogue runs (EPI): compile-time, so that
// each instance holds only its own code (the instruction cache is what a
// generic epilogue ran out of).
enum Xf { kXNone = 0, kXLn = 1, kXGate = 2 };
enum Epi { kPlain = 0, kRes = 1, kGateRes = 2, kPairs = 3, kPairsCm = 4 };

template <int KA, int XF, int EPI>
__global__ void __launch_bounds__(kThreads, 1)
    linear_sm90_kernel(const __grid_constant__ CUtensorMap map_x,
                       const __grid_constant__ CUtensorMap map_w, Args p) {
  using P = Plan<KA>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t bar = base + P::kBar;
  const uint32_t x_full = bar, x_empty = bar + 8;
  const uint32_t w_full = bar + 16, w_empty = bar + 16 + 8 * kStages;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_mt = (p.M + kBM - 1) / kBM;
  const int nb_n = (p.N + kBN - 1) / kBN;

  if (threadIdx.x == 0) {
    mbar_init(x_full, 1);
    mbar_init(x_empty, 2);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(w_full + 8 * s, 1);
      mbar_init(w_empty + 8 * s, kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == kConsumerWarps && lane == 0) {
      int u = 0;
      auto load_w = [&](int nb) {
        const int s = u % kStages;
        if (u >= kStages) mbar_wait(w_empty + 8 * s, ((u / kStages) + 1) & 1);
        mbar_expect_tx(w_full + 8 * s, P::kW);
        const uint32_t dst = base + P::kW0 + s * P::kW;
        for (int a = 0; a < KA; ++a)
          tma_load_2d(dst + a * kBN * 128, &map_w, w_full + 8 * s, 64 * a,
                      nb * kBN);
        ++u;
      };
      auto load_x = [&](int tile) {
        mbar_expect_tx(x_full, P::kTile);
        for (int a = 0; a < KA; ++a)
          tma_load_2d(base + a * kBM * 128, &map_x, x_full, 64 * a,
                      tile * kBM);
      };
      int it = 0;
      if (blockIdx.x < n_mt) load_x(blockIdx.x);
      for (int tile = blockIdx.x; tile < n_mt; tile += gridDim.x, ++it) {
        load_w(0);
        // The consumers free the raw X tile once it is normalised: the
        // next tile's X then lands during this tile's N loop.
        if (tile + gridDim.x < n_mt) {
          mbar_wait(x_empty, it & 1);
          load_x(tile + gridDim.x);
        }
        for (int nb = 1; nb < nb_n; ++nb) load_w(nb);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wg = warp >> 2, wi = warp & 3;
    const int g = lane >> 2, t = lane & 3;
    const int K = p.K;
    const float* seq_mask = p.seq_mask;
    int u = 0, it = 0;
    for (int tile = blockIdx.x; tile < n_mt; tile += gridDim.x, ++it) {
      const int m0 = tile * kBM;
      mbar_wait(x_full, it & 1);
      // f(X) into the A tile: eight lanes a row (lane j takes the 16-byte
      // pieces j of each atom), four rows a pass, 16 rows a warp.
      {
        const int rs = lane >> 3, j = lane & 7;
        for (int pass = 0; pass < 4; ++pass) {
          const int r = 64 * wg + 16 * wi + 4 * pass + rs;
          float v[KA][8];
          float s = 0.f;
#pragma unroll
          for (int a = 0; a < KA; ++a) {
            const int k = 64 * a + 8 * j;
            if (k < K) {
              load8_bf16(reinterpret_cast<const bf16*>(
                             gbase + a * kBM * 128 + swz(r, j)), v[a]);
            } else {
#pragma unroll
              for (int e = 0; e < 8; ++e) v[a][e] = 0.f;
            }
#pragma unroll
            for (int e = 0; e < 8; ++e) s += v[a][e];
          }
          if constexpr (XF == kXLn) {
#pragma unroll
            for (int o = 1; o < 8; o <<= 1)
              s += __shfl_xor_sync(0xffffffffu, s, o);
            const float mu = s / K;
            float s2 = 0.f;
#pragma unroll
            for (int a = 0; a < KA; ++a)
              if (64 * a + 8 * j < K) {
#pragma unroll
                for (int e = 0; e < 8; ++e) {
                  const float c = v[a][e] - mu;
                  s2 += c * c;
                }
              }
#pragma unroll
            for (int o = 1; o < 8; o <<= 1)
              s2 += __shfl_xor_sync(0xffffffffu, s2, o);
            const float rstd = rsqrtf(s2 / K + 1e-5f);
#pragma unroll
            for (int a = 0; a < KA; ++a) {
              const int k = 64 * a + 8 * j;
              if (k < K) {
#pragma unroll
                for (int e = 0; e < 8; ++e)
                  v[a][e] = (v[a][e] - mu) * rstd * p.ln_scale[k + e] +
                            p.ln_bias[k + e];
              }
            }
          } else if constexpr (XF == kXGate) {
            const int m = m0 + r;
#pragma unroll
            for (int a = 0; a < KA; ++a) {
              const int k = 64 * a + 8 * j;
              if (k < K && m < p.M) {
                float gt[8];
                load8_bf16(p.xgate + static_cast<size_t>(m) * K + k, gt);
#pragma unroll
                for (int e = 0; e < 8; ++e) v[a][e] *= sigm(gt[e]);
              }
            }
          }
#pragma unroll
          for (int a = 0; a < KA; ++a)
            *reinterpret_cast<uint4*>(gbase + P::kA + a * kBM * 128 +
                                      swz(r, j)) = pack8(v[a]);
        }
      }
      // The A tile's generic-proxy writes, visible to wgmma's async proxy;
      // the warpgroup's 64 rows complete; the raw X tile free.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_sync(1 + wg, 128);
      if (wi == 0 && lane == 0) mbar_arrive(x_empty);

      const int m_r0 = m0 + 64 * wg + 16 * wi + g;  // row of d[.. h = 0]
      float pm[2] = {0.f, 0.f};
      if constexpr (EPI >= kPairs) {
        const int rl = p.R * p.Lc;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m_r0 + 8 * h;
          if (m < p.M) {
            const int b = m / rl;
            pm[h] = seq_mask[b * p.Lc + (m / p.Lc) % p.R] *
                    seq_mask[b * p.Lc + m % p.Lc];
          }
        }
      }
      bf16* wst = reinterpret_cast<bf16*>(gbase + P::kT) + warp * 16 * kLdW;
      const int m_w = m0 + 64 * wg + 16 * wi;  // the warp's first row
      const int per_side = (p.gated + kHalf - 1) / kHalf;
      constexpr bool mode0 = EPI < kPairs;
      for (int nb = 0; nb < nb_n; ++nb, ++u) {
        const int s = u % kStages;
        mbar_wait(w_full + 8 * s, (u / kStages) & 1);
        float d[64];
        wgmma_fence();
        const uint32_t a_base = base + P::kA + 64 * wg * 128;
        const uint32_t w_base = base + P::kW0 + s * P::kW;
#pragma unroll
        for (int a = 0; a < KA; ++a)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_128(d, desc_sw128(a_base + a * kBM * 128 + 32 * kk),
                      desc_sw128(w_base + a * kBN * 128 + 32 * kk),
                      a + kk > 0);
        wgmma_commit();
        const int n0 = nb * kBN;
        // out_mode 0's gate and residual at the lane's own cells, loaded
        // while the products run.
        uint32_t gw[16][2], rw[16][2];
        if constexpr (EPI == kRes || EPI == kGateRes) {
#pragma unroll
          for (int nt = 0; nt < 16; ++nt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int m = m_r0 + 8 * h, n = n0 + 8 * nt + 2 * t;
              if constexpr (EPI == kGateRes)
                gw[nt][h] = load_pair(p.gate, p.N, m, p.M, n);
              rw[nt][h] = load_pair(p.residual, p.N, m, p.M, n);
            }
        }
        wgmma_wait0();
        __syncwarp();
        if (lane == 0) mbar_arrive(w_empty + 8 * s);

        if (mode0 || nb >= 2 * per_side) {
          // Plain columns: out_mode 0, or out_mode 2's final gate
          // (pre-sigmoid, into out2).
          const int col0 = mode0 ? n0 : n0 - 2 * per_side * kBN;
          const int ncols = mode0 ? p.N : p.N - 2 * per_side * kBN;
          bf16* dst = mode0 ? p.out : p.out2;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            float v[8][2][2];
#pragma unroll
            for (int nt = 0; nt < 8; ++nt)
#pragma unroll
              for (int x = 0; x < 2; ++x) {
                const int j = 8 * (8 * hf + nt) + 2 * t + x;
                const float bv =
                    (p.bias != nullptr && col0 + j < ncols) ? p.bias[n0 + j]
                                                            : 0.f;
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  float o = d[4 * (8 * hf + nt) + 2 * h + x] + bv;
                  if constexpr (EPI == kGateRes) {
                    const uint32_t gq = gw[8 * hf + nt][h];
                    o *= sigm(x ? hi_f(gq) : lo_f(gq));
                  }
                  if constexpr (EPI == kRes || EPI == kGateRes) {
                    const uint32_t rq = rw[8 * hf + nt][h];
                    o += x ? hi_f(rq) : lo_f(rq);
                  }
                  v[nt][h][x] = o;
                }
              }
            stage_half(wst, v, g, t);
            flush_half(wst, dst, ncols, m_w, p.M, col0 + 64 * hf, ncols,
                       lane);
          }
          continue;
        }
        const int side = nb / per_side, c0 = (nb % per_side) * kHalf;
        const int nc = p.gated;
        bf16* dst = p.out + static_cast<size_t>(side) * p.M * nc;
        // value * sigmoid(gate) * pair mask: column n of the chunk and its
        // gate, column n + 64, lie in the same lane (tiles n8 and n8 + 8).
        float gv[8][2][2];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int n = n0 + 8 * nt + 2 * t + x;
            const float bv = p.bias[n], bg = p.bias[n + kHalf];
#pragma unroll
            for (int h = 0; h < 2; ++h)
              gv[nt][h][x] = (d[4 * nt + 2 * h + x] + bv) *
                             sigm(d[4 * (nt + 8) + 2 * h + x] + bg) * pm[h];
          }
        if constexpr (EPI == kPairs) {
          stage_half(wst, gv, g, t);
          flush_half(wst, dst, nc, m_w, p.M, c0, nc, lane);
        } else {
          // (B, nc, R, Lc): the warpgroup's 64 x 64 tile goes through
          // shared memory as [channel][row], so that a lane writes 8
          // consecutive positions of one channel.
          bf16* st = reinterpret_cast<bf16*>(gbase + P::kT) +
                     wg * kHalf * kLdW;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int x = 0; x < 2; ++x)
                st[(8 * nt + 2 * t + x) * kLdW + 16 * wi + g + 8 * h] =
                    __float2bfloat16(gv[nt][h][x]);
          named_sync(1 + wg, 128);
          const int rl = p.R * p.Lc;
          const bool vec = rl % 8 == 0;
          const int tw = threadIdx.x & 127;
          const int mw = m0 + 64 * wg;
          for (int idx = tw; idx < kHalf * 8; idx += 128) {
            const int c = idx >> 3, r8 = (idx & 7) * 8;
            if (c0 + c >= nc) continue;
            const int m = mw + r8;
            if (m >= p.M) continue;
            const bf16* srow = st + c * kLdW + r8;
            if (vec) {
              bf16* o = dst + (static_cast<size_t>(m / rl) * nc + c0 + c) *
                                  rl + m % rl;
              uint4 w;
              uint32_t* wv = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
              for (int e = 0; e < 4; ++e)
                wv[e] = *reinterpret_cast<const uint32_t*>(srow + 2 * e);
              *reinterpret_cast<uint4*>(o) = w;
            } else {
              for (int e = 0; e < 8 && m + e < p.M; ++e) {
                const int me = m + e;
                dst[(static_cast<size_t>(me / rl) * nc + c0 + c) * rl +
                    me % rl] = srow[e];
              }
            }
          }
          named_sync(1 + wg, 128);  // the staging tile is free again
        }
      }
    }
  }
}

// A (rows, K) bf16 row-major operand (row stride K) as a 2-d tensor map,
// 64-column x 128-row boxes, 128-byte swizzle.
inline bool encode_rows(CUtensorMap* map, const void* base, int rows, int K) {
  return encode_bf16_sw128(map, base, rows, K, 128);
}

inline bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// The (XF, EPI) instance, as XF * 8 + EPI, that a launch takes, or -1
// where the tile kernel of row_linear.cu keeps it: bf16 with K a
// multiple of 8 and at most kMaxK, X rows contiguous, 16-byte aligned X, W
// and outputs, output rows a multiple of 8 columns, and one of the
// combinations the port launches.
inline int instance(const Args& p, int ldx, const void* x, const void* w) {
  if (p.K % 8 != 0 || p.K <= 0 || p.K > kMaxK || ldx != p.K ||
      !aligned(x, 16) || !aligned(w, 16) || !aligned(p.out, 16))
    return -1;
  const int xf = p.ln_scale != nullptr ? (p.xgate ? -1 : kXLn)
                                       : (p.xgate ? kXGate : kXNone);
  if (p.out_mode == 2) {
    const int n_free = p.N - 2 * kBN * ((p.gated + kHalf - 1) / kHalf);
    if (xf != kXLn || p.gated % 8 != 0 || n_free % 8 != 0 ||
        (n_free > 0 && !aligned(p.out2, 16)))
      return -1;
    return xf * 8 + (p.lr_c_major ? kPairsCm : kPairs);
  }
  if (p.out_mode != 0 || p.N % 8 != 0 || !aligned(p.gate, 4) ||
      !aligned(p.residual, 4))
    return -1;
  const int epi = p.gate ? (p.residual ? kGateRes : -1)
                         : (p.residual ? kRes : kPlain);
  const int code = xf * 8 + epi;
  switch (code) {
    case kXLn * 8 + kPlain:
    case kXNone * 8 + kPlain:
    case kXNone * 8 + kRes:
    case kXLn * 8 + kGateRes:
    case kXGate * 8 + kRes:
      return epi < 0 ? -1 : code;
    default:
      return -1;
  }
}

inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

template <int KA, int XF, int EPI>
cudaError_t launch_ka(const Args& p, const void* x, const void* w,
                      cudaStream_t stream) {
  CUtensorMap map_x, map_w;
  if (!encode_rows(&map_x, x, p.M, p.K) || !encode_rows(&map_w, w, p.N, p.K))
    return cudaErrorInvalidValue;
  const size_t smem = Plan<KA>::kSmem;
  cudaError_t e = set_smem(linear_sm90_kernel<KA, XF, EPI>, smem);
  if (e != cudaSuccess) return e;
  const int n_mt = (p.M + kBM - 1) / kBM;
  const int grid = n_mt < sm_count() ? n_mt : sm_count();
  linear_sm90_kernel<KA, XF, EPI>
      <<<grid, kThreads, smem, stream>>>(map_x, map_w, p);
  return cudaGetLastError();
}

template <int KA>
cudaError_t launch_inst(int code, const Args& p, const void* x,
                        const void* w, cudaStream_t s) {
  switch (code) {
    case kXLn * 8 + kPlain: return launch_ka<KA, kXLn, kPlain>(p, x, w, s);
    case kXNone * 8 + kPlain:
      return launch_ka<KA, kXNone, kPlain>(p, x, w, s);
    case kXNone * 8 + kRes: return launch_ka<KA, kXNone, kRes>(p, x, w, s);
    case kXLn * 8 + kGateRes:
      return launch_ka<KA, kXLn, kGateRes>(p, x, w, s);
    case kXGate * 8 + kRes: return launch_ka<KA, kXGate, kRes>(p, x, w, s);
    case kXLn * 8 + kPairs: return launch_ka<KA, kXLn, kPairs>(p, x, w, s);
    case kXLn * 8 + kPairsCm:
      return launch_ka<KA, kXLn, kPairsCm>(p, x, w, s);
    default: return cudaErrorInvalidValue;
  }
}

// Launch instance `code` (from instance()).
inline cudaError_t launch(int code, const Args& p, const void* x,
                          const void* w, cudaStream_t stream) {
  if (p.M <= 0) return cudaSuccess;
  switch ((p.K + 63) / 64) {
    case 1: return launch_inst<1>(code, p, x, w, stream);
    case 2: return launch_inst<2>(code, p, x, w, stream);
    default: return launch_inst<3>(code, p, x, w, stream);
  }
}

}  // namespace sm90
}  // namespace abx
