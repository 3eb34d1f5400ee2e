// Hopper gate-fold post block of the triangle multiplication:
//   out = (LN(y) W^T + wb) * sigmoid(LN_x(res) Wg^T + wgb) + res,
// for bf16 y of NC <= 128 channels and res of C <= 192 channels (both
// multiples of 8), W (C, NC) and Wg (C, C).
//
// Replaces, for those launches, the tile kernel of row_linear.cu (which
// keeps f32 and other shapes), and with it the Pallas TPU kernel
// abx_tpu/ops/tri_mult.py::tri_mult_post_gatefold.  Rounding points as the
// TPU kernel: LN statistics in f32 (one-pass moments, max(var, 0), eps
// 1e-5), LN(y) and LN_x(res) rounded to bf16 before their products; both
// products summed in f32; the final gate kept in f32; + bias, * sigmoid,
// + res in f32, rounded once.
// Bound on the H100: device-memory bytes.  At the optimize path's shape
// (M = 4*288*288 rows, NC = 128, C = 192) 340 MB of y, res and out against
// 40.8 GFLOP: 0.1015 ms at 3.35 TB/s over the tensor cores' 0.041 ms.
// What held the tile kernel back (1.50 ms): one 64 x 128 output tile a
// block, so C = 192 split as 128 + 64 with a third of the second tile's
// products and staging padding; both LayerNorms' moments and the
// normalisation redone for each N tile; y, then res, staged synchronously
// through the same tiles; wmma 16x16x16; both f32 accumulators through
// shared memory (> 64 KB a block, one or two blocks an SM).
// Design:
// - A persistent grid, one block per SM.  Both weights stay in shared
//   memory for the block's life (W 48 KB, Wg 72 KB at C = 192, 128-byte
//   swizzled, loaded once by TMA), so no weight byte crosses from L2
//   again.  That leaves room for one 64-row tile of y and res (40 KB) per
//   consumer warpgroup and nothing more, so each tile is normalised in
//   place.
// - Two consumer warpgroups work on their own 64-row tiles, each fed by
//   its own producer thread (a third warpgroup, its registers given to the
//   consumers with setmaxnreg) through a one-slot full / empty mbarrier
//   pair: while one warpgroup's next tile loads, the other computes.
// - A warpgroup takes the raw residual at its accumulator cells into
//   registers (48 words a thread at C = 192; the swizzled layout makes the
//   reads conflict-free), then normalises y and res in place (eight lanes
//   a row, f32 moments over three shuffles), rounded to bf16, and fences
//   the writes for the async proxy.  Cutting parts out
//   (tools/ablate_kernels.py) shows the LN sets the pace: without it the
//   kernel is ~40% faster, without both products ~15%, without the stores
//   ~5%; its scalar param reads alone cost ~10%, hence the float4 reads.
// - Per 64-column output chunk: NC / 16 wgmma.m64n64k16 into the o
//   accumulator and C / 16 into the gate accumulator (32 f32 registers a
//   thread each), one commit; after the last chunk's products the tile's
//   slot goes back to its producer, so the next tile loads during the
//   last epilogue.  The epilogue works from registers: + wb, the f32
//   sigmoid gate (+ wgb), + the residual words, one rounding into the
//   warp's 16 x 64 staging tile (128-byte swizzled rows), written out as
//   16-byte pieces, a quarter-warp per 128-byte row.
// - The biases and LN params sit in shared memory, staged once a block.
// f32 launches and other shapes stay on the tile kernel of row_linear.cu.
// Ragged M, NC and C are zero-filled by TMA and masked on the way out.
#include "common.cuh"
#include "mma_sync.cuh"
#include "row_linear_sm90.cuh"
#include "tma.cuh"

namespace abx {
namespace gf90 {

using sm90::desc_sw128;
using sm90::load8_bf16;
using sm90::named_sync;
using sm90::sigm;
using sm90::swz;
using sm90::wgmma_commit;
using sm90::wgmma_fence;
using sm90::wgmma_ss64;
using sm90::wgmma_wait0;

constexpr int kRows = 64;         // rows of a warpgroup's tile
constexpr int kAtom = kRows * 128;  // one 64-column atom of a tile, bytes
constexpr int kMaxNC = 128, kMaxC = 192;
constexpr int kConsumerWarps = 8;
constexpr int kThreads = 32 * kConsumerWarps + 128;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

// Shared memory of a launch with NC <= 64 KY and C <= 64 KR, byte offsets
// from the 1024-aligned base: W (KY atoms of 64 KR rows), Wg (KR atoms),
// the two warpgroups' tiles ([y atoms | res atoms] each), the consumer
// warps' bf16 staging tiles (16 x 64 each), the f32 params, the barriers.
template <int KY, int KR>
struct Plan {
  static constexpr int kNR = 64 * KR;          // weight rows (out channels)
  static constexpr int kWAtom = kNR * 128;
  static constexpr int kW = 0;
  static constexpr int kWg = KY * kWAtom;
  static constexpr int kWBytes = (KY + KR) * kWAtom;
  static constexpr int kTile = (KY + KR) * kAtom;
  static constexpr int kTiles = kWBytes;
  static constexpr int kStage = kTiles + 2 * kTile;
  static constexpr int kParams = kStage + kConsumerWarps * 16 * 128;
  // wb, wgb, x_scale, x_bias (kNR each), y_scale, y_bias (64 KY each)
  static constexpr int kNParams = 4 * kNR + 2 * 64 * KY;
  static constexpr int kBar = kParams + kNParams * 4;
  static constexpr size_t kSmem = 1024 + kBar + 64;
};

struct Args {
  int M, NC, C;
  const float* y_scale;  // (NC,) LayerNorm of y
  const float* y_bias;
  const float* wb;       // (C,)
  const float* x_scale;  // (C,) the pre block's LayerNorm, applied to res
  const float* x_bias;
  const float* wgb;      // (C,)
  bf16* out;             // (M, C)
};

// LayerNorm in place over the 16 rows of warp wi in a tile of KA atoms
// (K channels, zero past K): eight lanes a row (lane j takes the 16-byte
// pieces j of each atom), four rows a pass, the four passes unrolled (their
// load, sum and shuffle chains overlap); the params (zero past K, padded
// to 64 KA) read as float4 pairs.  The LN is the kernel's largest part
// (tools/ablate_kernels.py), bound by its instruction count and latency
// with four warps a warpgroup.
template <int KA>
__device__ __forceinline__ void ln_in_place(unsigned char* tile, int K,
                                            const float* sc, const float* bi,
                                            int wi, int lane) {
  const int rs = lane >> 3, j = lane & 7;
#pragma unroll
  for (int pass = 0; pass < 4; ++pass) {
    const int r = 16 * wi + 4 * pass + rs;
    float v[KA][8];
    float s = 0.f, s2 = 0.f;
#pragma unroll
    for (int a = 0; a < KA; ++a) {
      load8_bf16(reinterpret_cast<const bf16*>(tile + a * kAtom + swz(r, j)),
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
    const float mu = s / K;
    const float rstd = rsqrtf(fmaxf(s2 / K - mu * mu, 0.f) + 1e-5f);
#pragma unroll
    for (int a = 0; a < KA; ++a) {
      const int k = 64 * a + 8 * j;
      float sv[8], bv[8];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 s4 = reinterpret_cast<const float4*>(sc + k)[h];
        const float4 b4 = reinterpret_cast<const float4*>(bi + k)[h];
        sv[4 * h] = s4.x, sv[4 * h + 1] = s4.y, sv[4 * h + 2] = s4.z,
        sv[4 * h + 3] = s4.w;
        bv[4 * h] = b4.x, bv[4 * h + 1] = b4.y, bv[4 * h + 2] = b4.z,
        bv[4 * h + 3] = b4.w;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[a][e] = k < K ? (v[a][e] - mu) * rstd * sv[e] + bv[e] : 0.f;
      *reinterpret_cast<uint4*>(tile + a * kAtom + swz(r, j)) =
          sm90::pack8(v[a]);
    }
  }
}

template <int KY, int KR>
__global__ void __launch_bounds__(kThreads, 1)
    gatefold_sm90_kernel(const __grid_constant__ CUtensorMap map_y,
                         const __grid_constant__ CUtensorMap map_res,
                         const __grid_constant__ CUtensorMap map_w,
                         const __grid_constant__ CUtensorMap map_wg, Args p) {
  using P = Plan<KY, KR>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t bar = base + P::kBar;
  const uint32_t w_full = bar;
  auto full = [&](int w) { return bar + 8 + 8 * w; };
  auto empty = [&](int w) { return bar + 24 + 8 * w; };
  float* prm = reinterpret_cast<float*>(gbase + P::kParams);
  float* s_wb = prm;
  float* s_wgb = prm + P::kNR;
  float* s_xsc = prm + 2 * P::kNR;
  float* s_xb = prm + 3 * P::kNR;
  float* s_ysc = prm + 4 * P::kNR;
  float* s_yb = s_ysc + 64 * KY;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_tiles = (p.M + kRows - 1) / kRows;

  if (threadIdx.x == 0) {
    mbar_init(w_full, 1);
    for (int w = 0; w < 2; ++w) {
      mbar_init(full(w), 1);
      mbar_init(empty(w), 4);
    }
    mbar_fence_init();
  }
  for (int i = threadIdx.x; i < P::kNR; i += blockDim.x) {
    const bool in = i < p.C;
    s_wb[i] = in ? p.wb[i] : 0.f;
    s_wgb[i] = in ? p.wgb[i] : 0.f;
    s_xsc[i] = in ? p.x_scale[i] : 0.f;
    s_xb[i] = in ? p.x_bias[i] : 0.f;
  }
  for (int i = threadIdx.x; i < 64 * KY; i += blockDim.x) {
    s_ysc[i] = i < p.NC ? p.y_scale[i] : 0.f;
    s_yb[i] = i < p.NC ? p.y_bias[i] : 0.f;
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int pw = warp - kConsumerWarps;  // the warpgroup it feeds
    if (pw < 2 && lane == 0) {
      if (pw == 0) {
        mbar_expect_tx(w_full, P::kWBytes);
        for (int a = 0; a < KY; ++a)
          tma_load_2d(base + P::kW + a * P::kWAtom, &map_w, w_full, 64 * a,
                      0);
        for (int a = 0; a < KR; ++a)
          tma_load_2d(base + P::kWg + a * P::kWAtom, &map_wg, w_full, 64 * a,
                      0);
      }
      const uint32_t dst = base + P::kTiles + pw * P::kTile;
      int k = 0;
      for (int tile = 2 * blockIdx.x + pw; tile < n_tiles;
           tile += 2 * gridDim.x, ++k) {
        if (k > 0) mbar_wait(empty(pw), (k - 1) & 1);
        mbar_expect_tx(full(pw), P::kTile);
        for (int a = 0; a < KY; ++a)
          tma_load_2d(dst + a * kAtom, &map_y, full(pw), 64 * a,
                      tile * kRows);
        for (int a = 0; a < KR; ++a)
          tma_load_2d(dst + (KY + a) * kAtom, &map_res, full(pw), 64 * a,
                      tile * kRows);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wg = warp >> 2, wi = warp & 3;
    const int g = lane >> 2, t = lane & 3;
    unsigned char* tile_p = gbase + P::kTiles + wg * P::kTile;
    unsigned char* res_p = tile_p + KY * kAtom;
    const uint32_t a_y = base + P::kTiles + wg * P::kTile;
    const uint32_t a_r = a_y + KY * kAtom;
    unsigned char* wst = gbase + P::kStage + warp * 16 * 128;
    mbar_wait(w_full, 0);
    int k = 0;
    for (int tile = 2 * blockIdx.x + wg; tile < n_tiles;
         tile += 2 * gridDim.x, ++k) {
      mbar_wait(full(wg), k & 1);
      // The raw residual at the lane's accumulator cells (rows 16 wi + g +
      // 8 h, columns 64 a + 8 nt + 2 t, + 1), before it is normalised.
      uint32_t rr[KR][8][2];
#pragma unroll
      for (int a = 0; a < KR; ++a)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            rr[a][nt][h] = *reinterpret_cast<const uint32_t*>(
                res_p + a * kAtom + swz(16 * wi + g + 8 * h, nt) + 4 * t);
      __syncwarp();
      ln_in_place<KY>(tile_p, p.NC, s_ysc, s_yb, wi, lane);
      ln_in_place<KR>(res_p, p.C, s_xsc, s_xb, wi, lane);
      // The normalised tiles' generic-proxy writes, visible to wgmma's
      // async proxy; the warpgroup's 64 rows complete.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_sync(1 + wg, 128);

      const int m_w = tile * kRows + 16 * wi;  // the warp's first row
      // Unrolled: j indexes the residual registers.
#pragma unroll
      for (int j = 0; j < KR; ++j) {
        float o[32], gt[32];
        const uint32_t wj = base + P::kW + j * 64 * 128;
        const uint32_t wgj = base + P::kWg + j * 64 * 128;
        wgmma_fence();
#pragma unroll
        for (int a = 0; a < KY; ++a)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss64(o, desc_sw128(a_y + a * kAtom + 32 * kk),
                       desc_sw128(wj + a * P::kWAtom + 32 * kk), a + kk > 0);
#pragma unroll
        for (int a = 0; a < KR; ++a)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss64(gt, desc_sw128(a_r + a * kAtom + 32 * kk),
                       desc_sw128(wgj + a * P::kWAtom + 32 * kk), a + kk > 0);
        wgmma_commit();
        wgmma_wait0();
        if (j == KR - 1) {
          // The tile is consumed: its slot goes back to the producer.
          __syncwarp();
          if (lane == 0) mbar_arrive(empty(wg));
        }
        // Epilogue: (o + wb) * sigmoid(gate + wgb) + res, rounded once into
        // the warp's staging tile, then 16-byte pieces out.
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int n = 64 * j + 8 * nt + 2 * t;
            const uint32_t rq = rr[j][nt][h];
            float v[2];
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              const int i = 4 * nt + 2 * h + x;
              v[x] = (o[i] + s_wb[n + x]) * sigm(gt[i] + s_wgb[n + x]) +
                     (x ? sm90::hi_f(rq) : sm90::lo_f(rq));
            }
            *reinterpret_cast<uint32_t*>(wst + swz(g + 8 * h, nt) + 4 * t) =
                pack_bf16(v[0], v[1]);
          }
        __syncwarp();
#pragma unroll
        for (int i = lane; i < 16 * 8; i += 32) {
          const int r = i >> 3, pc = i & 7;
          const int m = m_w + r, c = 64 * j + 8 * pc;
          if (m < p.M && c < p.C)
            *reinterpret_cast<uint4*>(p.out + static_cast<size_t>(m) * p.C +
                                      c) =
                *reinterpret_cast<const uint4*>(wst + swz(r, pc));
        }
        __syncwarp();
      }
    }
  }
}

template <int KY, int KR>
cudaError_t launch_k(const Args& p, const void* y, const void* res,
                     const void* w, const void* wg, cudaStream_t stream) {
  using P = Plan<KY, KR>;
  CUtensorMap map_y, map_res, map_w, map_wg;
  if (!encode_bf16_sw128(&map_y, y, p.M, p.NC, kRows) ||
      !encode_bf16_sw128(&map_res, res, p.M, p.C, kRows) ||
      !encode_bf16_sw128(&map_w, w, p.C, p.NC, P::kNR) ||
      !encode_bf16_sw128(&map_wg, wg, p.C, p.C, P::kNR))
    return cudaErrorInvalidValue;
  cudaError_t e = set_smem(gatefold_sm90_kernel<KY, KR>, P::kSmem);
  if (e != cudaSuccess) return e;
  const int pairs = ((p.M + kRows - 1) / kRows + 1) / 2;
  const int grid = pairs < sm90::sm_count() ? pairs : sm90::sm_count();
  gatefold_sm90_kernel<KY, KR><<<grid, kThreads, P::kSmem, stream>>>(
      map_y, map_res, map_w, map_wg, p);
  return cudaGetLastError();
}

template <int KY>
cudaError_t launch_ky(const Args& p, const void* y, const void* res,
                      const void* w, const void* wg, cudaStream_t s) {
  switch ((p.C + 63) / 64) {
    case 1: return launch_k<KY, 1>(p, y, res, w, wg, s);
    case 2: return launch_k<KY, 2>(p, y, res, w, wg, s);
    default: return launch_k<KY, 3>(p, y, res, w, wg, s);
  }
}

}  // namespace gf90
}  // namespace abx

// bf16 tri_mult_post_gatefold on the Hopper kernel: y (M, NC), res and out
// (M, C), w (C, NC), wg (C, C) bf16; y_scale, y_bias (NC,), wb, x_scale,
// x_bias, wgb (C,) f32.  NC and C multiples of 8, NC <= 128, C <= 192,
// y, res, w, wg and out 16-byte aligned; cudaErrorInvalidValue otherwise
// (the caller routes other launches to abx_tri_mult_post_gatefold).
extern "C" int abx_tri_mult_post_gatefold_sm90(
    const void* y, const void* res, int M, int NC, int C,
    const float* y_scale, const float* y_bias, const void* w, const float* wb,
    const float* x_scale, const float* x_bias, const void* wg,
    const float* wgb, void* out, void* stream) {
  using abx::sm90::aligned;
  namespace gf = abx::gf90;
  if (NC <= 0 || NC % 8 != 0 || NC > gf::kMaxNC || C <= 0 || C % 8 != 0 ||
      C > gf::kMaxC || !aligned(y, 16) || !aligned(res, 16) ||
      !aligned(w, 16) || !aligned(wg, 16) || !aligned(out, 16))
    return cudaErrorInvalidValue;
  if (M <= 0) return cudaSuccess;
  const gf::Args p{M,      NC,      C,     y_scale, y_bias, wb,
                   x_scale, x_bias, wgb,   static_cast<abx::bf16*>(out)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return NC <= 64 ? gf::launch_ky<1>(p, y, res, w, wg, s)
                  : gf::launch_ky<2>(p, y, res, w, wg, s);
}
