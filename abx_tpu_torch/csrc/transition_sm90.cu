// Hopper pair transition: out = x + ReLU(LN(x) W1^T + b1) W2^T + b2, for
// bf16 x of C <= 192 channels (C a multiple of 8), hidden N = 4C.
//
// Replaces, for those launches, the kernel of transition.cu (which
// keeps f32 inputs and other C), and with it the Pallas TPU kernel
// abx_tpu/ops/transition.py::fused_transition.  Rounding points as the TPU
// kernel: LN statistics in f32 (one-pass moments, max(var, 0), eps 1e-5),
// LN(x) rounded to bf16 before W1; h = ReLU(acc + b1) in f32, rounded to
// bf16 before W2; y + b2 + x in f32 with x the raw input, rounded once.
// Bound on the H100: tensor-core operations.  At the flagship shape (M =
// 4*288*288 rows, C = 192, N = 768) 195.7 GFLOP against 255 MB of input
// and output: 0.198 ms at 989 TFLOP/s.
// What held that kernel back (2.95 ms): every 64-row block re-staged
// both weight matrices (590 KB) with synchronous 16-byte loads, each hidden
// chunk made an f32 round trip through shared memory, wmma 16x16x16.
// Design:
// - A persistent grid, one block per SM, walks 128-row M tiles.  One
//   producer thread (a third warpgroup, its registers given away with
//   setmaxnreg) loads the raw X tile by TMA (128-byte swizzle) and streams
//   the weights in 64-wide hidden chunks through a two-stage ring (full /
//   empty mbarriers): per chunk the W1 rows (64 x C) and the W2 columns
//   (C x 64), 48 KB at C = 192.  So the weights cross from L2 once per
//   128-row tile.  The next tile's X is requested once the current one is
//   normalised, and lands during the chunk loop.
// - Two consumer warpgroups take 64 rows each.  LN(x) goes into the A tile
//   in wgmma's 128-byte-swizzled K-major layout (eight lanes a row).
// - Per chunk: GEMM1 = C / 16 wgmma.m64n64k16 (A and W1 from shared
//   memory) into 32 f32 registers; + b1, ReLU and the bf16 rounding in
//   registers, whose accumulator layout is the register-A layout of the
//   next product; GEMM2 = 4 wgmma.m64n{64 KA}k16 with A from registers and
//   W2 from shared memory, adding into the (64 x C) f32 Y accumulator held
//   across all chunks (96 registers a thread at C = 192).  The hidden
//   activations never touch shared memory.
// - The two warpgroups issue their products in turns (named barriers), so
//   that one's bias and ReLU run while the other's product does.
// - Epilogue: Y + b2 per 64-column atom into the warp's f32 staging tile
//   (XOR-swizzled rows), then 16-byte pieces: the raw x, loaded while the
//   last chunk's GEMM2 runs (it was read ~10 us earlier, so mostly from
//   L2), added in f32, rounded and written, a quarter-warp per 128-byte
//   output row.
// What bounds it, by cutting parts out (tools/ablate_transition.py,
// PERF.md): not the weight stream (without it the kernel is ~1% faster, so a
// cluster multicast of the chunks would not pay yet), nor one product
// alone (each accounts for ~0.08 ms of ~0.41): the chain of each
// warpgroup's products, their waits and the bias between them, with two
// warpgroups to overlap.  Without the products the weight stream alone
// takes ~0.29 ms (L2 to the SMs at ~5 TB/s): the next limit.  Keeping GEMM1
// of the next chunk in flight during this chunk's bias (two accumulators)
// made ptxas serialize the wgmma and ran slower.
// Ragged M, N and C are zero-filled by TMA and masked on the way out.
#include "common.cuh"
#include "mma_sync.cuh"
#include "row_linear_sm90.cuh"
#include "tma.cuh"

namespace abx {
namespace tr90 {

using sm90::desc_sw128;
using sm90::load8_bf16;
using sm90::named_sync;
using sm90::swz;
using sm90::wgmma_commit;
using sm90::wgmma_ss64;
using sm90::wgmma_fence;
using sm90::wgmma_wait0;

constexpr int kBM = 128;          // rows of an M tile: two warpgroups x 64
constexpr int kNB = 64;           // hidden columns of a weight chunk
constexpr int kMaxC = 192;        // three 64-column swizzle atoms
constexpr int kStages = 2;        // weight ring
constexpr int kConsumerWarps = 8;
constexpr int kThreads = 32 * kConsumerWarps + 128;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

// Shared memory of a C <= 64 KA launch, byte offsets from the 1024-aligned
// base: raw X tile, LN(x) A tile, the weight stages ([W1 chunk | W2 chunk]),
// the consumer warps' f32 staging tiles (16 x 64 each), the barriers.
template <int KA>
struct Plan {
  static constexpr int kTile = KA * kBM * 128;
  static constexpr int kW1 = KA * kNB * 128;  // 64 hidden rows, K = C
  static constexpr int kW2 = 64 * KA * 128;   // 64 KA channel rows, K = 64
  static constexpr int kStage = kW1 + kW2;
  static constexpr int kA = kTile;
  static constexpr int kW0 = 2 * kTile;
  static constexpr int kT = kW0 + kStages * kStage;
  static constexpr int kBar = kT + kConsumerWarps * 16 * 64 * 4;
  static constexpr size_t kSmem = 1024 + kBar + 64;
};

// GEMM2's wgmma shapes, B as in row_linear_sm90.cuh (K-major, 128-byte
// swizzle) and A from registers, four bf16x2 words a thread in mma.sync's
// A-fragment order (GEMM1 is sm90::wgmma_ss64).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[96],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, {%96, %97, %98, %99}, %100, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

struct Args {
  int M, C, N;
  const float* ln_scale;  // (C,)
  const float* ln_bias;
  const float* b1;        // (N,)
  const float* b2;        // (C,)
  const bf16* x;          // (M, C): the residual, re-read in the epilogue
  bf16* out;              // (M, C)
};

template <int KA>
__global__ void __launch_bounds__(kThreads, 1)
    transition_sm90_kernel(const __grid_constant__ CUtensorMap map_x,
                           const __grid_constant__ CUtensorMap map_w1,
                           const __grid_constant__ CUtensorMap map_w2,
                           Args p) {
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
  const int n_ch = (p.N + kNB - 1) / kNB;

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
      auto load_w = [&](int j) {
        const int s = u % kStages;
        if (u >= kStages) mbar_wait(w_empty + 8 * s, ((u / kStages) + 1) & 1);
        mbar_expect_tx(w_full + 8 * s, P::kStage);
        const uint32_t dst = base + P::kW0 + s * P::kStage;
        for (int a = 0; a < KA; ++a)
          tma_load_2d(dst + a * kNB * 128, &map_w1, w_full + 8 * s, 64 * a,
                      j * kNB);
        tma_load_2d(dst + P::kW1, &map_w2, w_full + 8 * s, j * kNB, 0);
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
        if (tile + gridDim.x < n_mt) {
          mbar_wait(x_empty, it & 1);
          load_x(tile + gridDim.x);
        }
        for (int j = 1; j < n_ch; ++j) load_w(j);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wg = warp >> 2, wi = warp & 3;
    const int g = lane >> 2, t = lane & 3;
    const int C = p.C;
    float* wst = reinterpret_cast<float*>(gbase + P::kT) + warp * 16 * 64;
    // The two warpgroups issue their products in turns (named barriers 3
    // and 4: a warpgroup waits on its own, then lets the other go), so
    // that the tensor cores run G1(wg 0), G1(wg 1), G2(wg 0), G2(wg 1)
    // and each warpgroup's bias and ReLU run while the other's product
    // does.  Warpgroup 0 goes first.
    auto my_turn = [&]() { named_sync(3 + wg, 256); };
    auto pass_turn = [&]() {
      asm volatile("bar.arrive %0, %1;\n" ::"r"(3 + (wg ^ 1)), "r"(256)
                   : "memory");
    };
    if (wg == 1) pass_turn();
    int u = 0, it = 0;
    for (int tile = blockIdx.x; tile < n_mt; tile += gridDim.x, ++it) {
      const int m0 = tile * kBM;
      mbar_wait(x_full, it & 1);
      // LN(x) into the A tile: eight lanes a row (lane j takes the 16-byte
      // pieces j of each atom), four rows a pass, 16 rows a warp.
      {
        const int rs = lane >> 3, j = lane & 7;
        for (int pass = 0; pass < 4; ++pass) {
          const int r = 64 * wg + 16 * wi + 4 * pass + rs;
          float v[KA][8];
          float s = 0.f, s2 = 0.f;
#pragma unroll
          for (int a = 0; a < KA; ++a) {
            load8_bf16(reinterpret_cast<const bf16*>(gbase + a * kBM * 128 +
                                                     swz(r, j)),
                       v[a]);
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              s += v[a][e];
              s2 += v[a][e] * v[a][e];
            }
          }
#pragma unroll
          for (int o = 1; o < 8; o <<= 1) {
            s += __shfl_xor_sync(0xffffffffu, s, o);
            s2 += __shfl_xor_sync(0xffffffffu, s2, o);
          }
          const float mu = s / C;
          const float rstd = rsqrtf(fmaxf(s2 / C - mu * mu, 0.f) + 1e-5f);
#pragma unroll
          for (int a = 0; a < KA; ++a) {
            const int k = 64 * a + 8 * j;
            if (k < C) {
#pragma unroll
              for (int e = 0; e < 8; ++e)
                v[a][e] = (v[a][e] - mu) * rstd * p.ln_scale[k + e] +
                          p.ln_bias[k + e];
            } else {
#pragma unroll
              for (int e = 0; e < 8; ++e) v[a][e] = 0.f;
            }
            *reinterpret_cast<uint4*>(gbase + P::kA + a * kBM * 128 +
                                      swz(r, j)) = sm90::pack8(v[a]);
          }
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_sync(1 + wg, 128);
      if (wi == 0 && lane == 0) mbar_arrive(x_empty);

      const uint32_t a_base = base + P::kA + 64 * wg * 128;
      const int m_w = m0 + 64 * wg + 16 * wi;  // the warp's first row
      float y[32 * KA];
      // The residual x of the lane's epilogue pieces (row m_w + lane / 8 +
      // 4 q, columns 64 a + 8 (lane % 8)), loaded while the last chunk's
      // GEMM2 runs.
      uint4 xr[KA][4];
      for (int jc = 0; jc < n_ch; ++jc, ++u) {
        const int s = u % kStages;
        mbar_wait(w_full + 8 * s, (u / kStages) & 1);
        const uint32_t w1s = base + P::kW0 + s * P::kStage;
        const uint32_t w2s = w1s + P::kW1;
        float acc[32];
        my_turn();
        wgmma_fence();
#pragma unroll
        for (int a = 0; a < KA; ++a)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss64(acc, desc_sw128(a_base + a * kBM * 128 + 32 * kk),
                       desc_sw128(w1s + a * kNB * 128 + 32 * kk), a + kk > 0);
        wgmma_commit();
        pass_turn();
        wgmma_wait0();
        // h = ReLU(acc + b1) rounded to bf16: the accumulator's n8 tiles
        // 2kk and 2kk + 1 are the register-A fragment of GEMM2's k-step kk.
        const int n0 = jc * kNB;
        uint32_t hf[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float hv[8];
#pragma unroll
          for (int q = 0; q < 2; ++q)
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              const int n = n0 + 16 * kk + 8 * q + 2 * t + x;
              const float bv = n < p.N ? p.b1[n] : 0.f;
#pragma unroll
              for (int h = 0; h < 2; ++h)
                hv[4 * q + 2 * h + x] =
                    fmaxf(acc[8 * kk + 4 * q + 2 * h + x] + bv, 0.f);
            }
          hf[kk][0] = pack_bf16(hv[0], hv[1]);  // row g,     k 2t
          hf[kk][1] = pack_bf16(hv[2], hv[3]);  // row g + 8, k 2t
          hf[kk][2] = pack_bf16(hv[4], hv[5]);  // row g,     k 2t + 8
          hf[kk][3] = pack_bf16(hv[6], hv[7]);  // row g + 8, k 2t + 8
        }
        my_turn();
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs(y, hf[kk], desc_sw128(w2s + 32 * kk), jc + kk > 0);
        wgmma_commit();
        // Warpgroup 1's last product of the kernel passes no turn: nothing
        // waits for it.
        if (wg == 0 || jc + 1 < n_ch || tile + gridDim.x < n_mt) pass_turn();
        if (jc == n_ch - 1) {
#pragma unroll
          for (int a = 0; a < KA; ++a)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int m = m_w + (lane >> 3) + 4 * q;
              const int c = 64 * a + 8 * (lane & 7);
              xr[a][q] = (m < p.M && c < C)
                             ? *reinterpret_cast<const uint4*>(
                                   p.x + static_cast<size_t>(m) * C + c)
                             : make_uint4(0u, 0u, 0u, 0u);
            }
        }
        wgmma_wait0();
        __syncwarp();
        if (lane == 0) mbar_arrive(w_empty + 8 * s);
      }

      // Epilogue, one 64-column atom at a time: Y + b2 into the warp's
      // staging tile (column blocks of 8 XOR-swizzled by the row), then
      // 16-byte pieces + x, rounded once.
#pragma unroll
      for (int a = 0; a < KA; ++a) {
#pragma unroll
        for (int nl = 0; nl < 8; ++nl)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = g + 8 * h, col = 8 * nl + 2 * t;
            const int c = 64 * a + col;
            const float b0 = c < C ? p.b2[c] : 0.f;
            const float b1v = c + 1 < C ? p.b2[c + 1] : 0.f;
            const int nt = 8 * a + nl;
            *reinterpret_cast<float2*>(wst + r * 64 + (col ^ (8 * (r & 7)))) =
                make_float2(y[4 * nt + 2 * h] + b0, y[4 * nt + 2 * h + 1] + b1v);
          }
        __syncwarp();
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = (lane >> 3) + 4 * q, pc = (lane & 7) * 8;
          const int m = m_w + r, c = 64 * a + pc;
          if (m < p.M && c < C) {
            const size_t o = static_cast<size_t>(m) * C + c;
            const bf16* xe = reinterpret_cast<const bf16*>(&xr[a][q]);
            float xv[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) xv[e] = __bfloat162float(xe[e]);
            const float* src = wst + r * 64 + (pc ^ (8 * (r & 7)));
            const float4 lo = *reinterpret_cast<const float4*>(src);
            const float4 hi = *reinterpret_cast<const float4*>(src + 4);
            float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
            for (int e = 0; e < 8; ++e) v[e] += xv[e];
            *reinterpret_cast<uint4*>(p.out + o) = sm90::pack8(v);
          }
        }
        __syncwarp();
      }
    }
  }
}

template <int KA>
cudaError_t launch_ka(const Args& p, const void* w1, const void* w2,
                      cudaStream_t stream) {
  CUtensorMap map_x, map_w1, map_w2;
  if (!encode_bf16_sw128(&map_x, p.x, p.M, p.C, kBM) ||
      !encode_bf16_sw128(&map_w1, w1, p.N, p.C, kNB) ||
      !encode_bf16_sw128(&map_w2, w2, p.C, p.N, 64 * KA))
    return cudaErrorInvalidValue;
  const size_t smem = Plan<KA>::kSmem;
  cudaError_t e = set_smem(transition_sm90_kernel<KA>, smem);
  if (e != cudaSuccess) return e;
  const int n_mt = (p.M + kBM - 1) / kBM;
  const int grid = n_mt < sm90::sm_count() ? n_mt : sm90::sm_count();
  transition_sm90_kernel<KA>
      <<<grid, kThreads, smem, stream>>>(map_x, map_w1, map_w2, p);
  return cudaGetLastError();
}

}  // namespace tr90
}  // namespace abx

// bf16 fused transition on the Hopper kernel: x and out (M, C), w1 (N, C),
// w2 (C, N) bf16; ln_s, ln_b, b2 (C,) and b1 (N,) f32.  C a multiple of 8
// and at most 192, N a multiple of 8, every pointer 16-byte aligned;
// cudaErrorInvalidValue otherwise (the caller routes other launches to
// abx_fused_transition).
extern "C" int abx_fused_transition_sm90(const void* x, int M, int C,
                                         const float* ln_s, const float* ln_b,
                                         const void* w1, const float* b1,
                                         const void* w2, const float* b2,
                                         void* out, int N, void* stream) {
  using abx::sm90::aligned;
  if (C <= 0 || C % 8 != 0 || C > abx::tr90::kMaxC || N <= 0 || N % 8 != 0 ||
      !aligned(x, 16) || !aligned(w1, 16) || !aligned(w2, 16) ||
      !aligned(out, 16))
    return cudaErrorInvalidValue;
  if (M <= 0) return cudaSuccess;
  const abx::tr90::Args p{M,  C, N, ln_s, ln_b, b1, b2,
                          static_cast<const abx::bf16*>(x),
                          static_cast<abx::bf16*>(out)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((C + 63) / 64) {
    case 1: return abx::tr90::launch_ka<1>(p, w1, w2, s);
    case 2: return abx::tr90::launch_ka<2>(p, w1, w2, s);
    default: return abx::tr90::launch_ka<3>(p, w1, w2, s);
  }
}
