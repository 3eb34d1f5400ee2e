// Hopper tri_mult_post with a channel-major input:
//   out = (bf16(LN(y^T)) W^T + wb) * sigmoid(fg) + res,
// for bf16 y (B, NC, P) of NC <= 128 channels over P = R*L positions (P a
// multiple of 8), fg, res and out (B*P, C) in the natural layout with
// C <= 192 (NC and C multiples of 8), W (C, NC).
//
// Replaces, for those launches, the tile kernel of row_linear.cu (entry
// abx_tri_mult_post_c_major, which keeps f32 and other shapes), and with it
// the Pallas TPU kernel abx_tpu/ops/tri_mult.py::tri_mult_post with
// y_c_major=True.  Rounding points as the TPU kernel: LN statistics in f32
// (one-pass moments, max(var, 0), eps 1e-5), LN(y) rounded to bf16 before
// the product; the product summed in f32; + wb, * sigmoid(fg), + res in
// f32, rounded once.
// Bound on the H100: device-memory bytes.  At the c-major design's shape
// (B = 4, P = 288*288, NC = 128, C = 192) 467 MB of y, fg, res and out
// against 16.3 GFLOP: 0.1395 ms at 3.35 TB/s over the tensor cores'
// 0.016 ms.
// What held the tile kernel back (0.797 ms): y read three times in 2-byte
// pieces (the LN statistics, then once for each of the two N tiles of C =
// 192), each element transposed through scalar stores, wmma 16x16 with
// half of the second N tile padding, and 10,368 blocks of one 64 x 128
// output tile each.
// Design:
// - A persistent grid, one block per SM; W stays in shared memory for the
//   block's life (48 KB at NC = 128, C = 192, 128-byte swizzled, loaded
//   once by TMA).  Two consumer warpgroups each walk their own 64-position
//   tiles, each fed by its own producer thread (a third warpgroup, its
//   registers given to the consumers with setmaxnreg) through one slot:
//   the y tile on one barrier, the fg and res tiles on a second, so the LN
//   and the products run while fg and res still land.
// - Tiles are cut per batch element: y is a 3-d TMA tensor (P, NC, B), so
//   no tile straddles two batch elements; the last tile of an element is
//   zero-filled past P by TMA and its stores are masked.
// - The y tile lands channel-major, [channel][64 positions] in 128-byte
//   swizzled rows: the MN-major layout wgmma reads for a transposed A
//   operand.  The LN statistics run down the channels: a thread takes 8
//   positions (one 16-byte piece) of 4 KY channels, the moments summed over
//   shuffles and the four warps' partials; the tile is normalised in
//   place, rounded to bf16, and fed to wgmma as it lies (no transposed
//   copy).
// - Per 64-column output chunk: NC / 16 wgmma.m64n64k16 with A transposed
//   into 32 f32 registers a thread; the epilogue reads fg and res at the
//   accumulator's cells from the slot (the swizzled layout makes the reads
//   conflict-free), forms (o + wb) * sigmoid(fg) + res, rounds it once into
//   the res tile in place (each thread writes only the cells it read), and
//   the warp writes its 16 rows out as 16-byte pieces, a quarter-warp per
//   128-byte row.  The slot goes back to its producer after the last
//   chunk's stores.
// Ragged NC and C are zero-filled by TMA and masked on the way out.
#include "common.cuh"
#include "mma_sync.cuh"
#include "row_linear_sm90.cuh"
#include "tma.cuh"

namespace abx {
namespace pcm90 {

using sm90::desc_mn_sw128;
using sm90::desc_sw128;
using sm90::load8_bf16;
using sm90::named_sync;
using sm90::sigm;
using sm90::swz;
using sm90::wgmma_commit;
using sm90::wgmma_fence;
using sm90::wgmma_wait0;

constexpr int kRows = 64;           // positions of a tile
constexpr int kAtom = kRows * 128;  // 64 rows of 128 bytes
constexpr int kMaxNC = 128, kMaxC = 192;
constexpr int kConsumerWarps = 8;
constexpr int kThreads = 32 * kConsumerWarps + 128;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

// Shared memory of a launch with NC <= 64 KY and C <= 64 KR, byte offsets
// from the 1024-aligned base: W (KY atoms of 64 KR rows), the two
// warpgroups' slots ([y: 64 KY channel rows | fg: KR atoms | res: KR
// atoms] each), the LN partials (2 warpgroups x 4 warps x {sum, sum of
// squares} x 64 positions), the f32 params, the barriers.
template <int KY, int KR>
struct Plan {
  static constexpr int kNR = 64 * KR;         // W rows (out channels)
  static constexpr int kWAtom = kNR * 128;
  static constexpr int kW = 0;
  static constexpr int kWBytes = KY * kWAtom;
  static constexpr int kY = KY * kAtom;
  static constexpr int kFR = 2 * KR * kAtom;
  static constexpr int kSlot = kY + kFR;
  static constexpr int kSlots = kWBytes;
  static constexpr int kPart = kSlots + 2 * kSlot;
  static constexpr int kParams = kPart + 2 * 4 * 2 * 64 * 4;
  // wb (kNR), scale and bias (64 KY each)
  static constexpr int kNParams = kNR + 2 * 64 * KY;
  static constexpr int kBar = kParams + kNParams * 4;
  static constexpr size_t kSmem = 1024 + kBar + 64;
};

struct Args {
  int B, NC, P, C;
  const float* scale;  // (NC,) LayerNorm of y
  const float* bias;
  const float* wb;     // (C,)
  bf16* out;           // (B*P, C)
};

// d = A(64 x 16) B(16 x 64)^T + (scale_d ? d : 0), A MN-major (transposed)
// and B K-major, both from shared memory.
__device__ __forceinline__ void wgmma_ta64(float (&d)[32], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// LayerNorm in place down the channels of a channel-major tile (64 KY
// channel rows of 64 positions, zero past K channels): lane (q, j) of warp
// wi takes positions 8 j .. 8 j + 7 (the 16-byte piece j of a row) of the
// channels 16 KY wi + 4 i + q, so a quarter-warp reads one whole 128-byte
// row (conflict-free); the moments are summed over the lanes of a piece
// (two shuffles) and the four warps (partials in `part`, one barrier of
// the warpgroup `bar_id`); the params are zero past K.
template <int KY>
__device__ __forceinline__ void ln_cmajor(unsigned char* tile, int K,
                                          const float* sc, const float* bi,
                                          float* part, int bar_id, int wi,
                                          int lane) {
  constexpr int NI = 4 * KY;
  const int j = lane & 7, q = lane >> 3;
  float v[NI][8];
  float s[8], s2[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) s[e] = s2[e] = 0.f;
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int k = 16 * KY * wi + 4 * i + q;
    load8_bf16(reinterpret_cast<const bf16*>(tile + swz(k, j)), v[i]);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      s[e] += v[i][e];
      s2[e] += v[i][e] * v[i][e];
    }
  }
#pragma unroll
  for (int e = 0; e < 8; ++e)
#pragma unroll
    for (int o = 8; o < 32; o <<= 1) {
      s[e] += __shfl_xor_sync(0xffffffffu, s[e], o);
      s2[e] += __shfl_xor_sync(0xffffffffu, s2[e], o);
    }
  if (q == 0) {
    float4* ps = reinterpret_cast<float4*>(part + wi * 64 + 8 * j);
    float4* ps2 = reinterpret_cast<float4*>(part + 256 + wi * 64 + 8 * j);
    ps[0] = make_float4(s[0], s[1], s[2], s[3]);
    ps[1] = make_float4(s[4], s[5], s[6], s[7]);
    ps2[0] = make_float4(s2[0], s2[1], s2[2], s2[3]);
    ps2[1] = make_float4(s2[4], s2[5], s2[6], s2[7]);
  }
  named_sync(bar_id, 128);
  float mu[8], rstd[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) s[e] = s2[e] = 0.f;
#pragma unroll
  for (int w = 0; w < 4; ++w)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float4 a =
          reinterpret_cast<const float4*>(part + w * 64 + 8 * j)[hh];
      const float4 b =
          reinterpret_cast<const float4*>(part + 256 + w * 64 + 8 * j)[hh];
      s[4 * hh] += a.x, s[4 * hh + 1] += a.y, s[4 * hh + 2] += a.z,
          s[4 * hh + 3] += a.w;
      s2[4 * hh] += b.x, s2[4 * hh + 1] += b.y, s2[4 * hh + 2] += b.z,
          s2[4 * hh + 3] += b.w;
    }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    mu[e] = s[e] / K;
    rstd[e] = rsqrtf(fmaxf(s2[e] / K - mu[e] * mu[e], 0.f) + 1e-5f);
  }
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int k = 16 * KY * wi + 4 * i + q;
    const float a = sc[k], c = bi[k];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[i][e] = (v[i][e] - mu[e]) * rstd[e] * a + c;
    *reinterpret_cast<uint4*>(tile + swz(k, j)) = sm90::pack8(v[i]);
  }
}

template <int KY, int KR>
__global__ void __launch_bounds__(kThreads, 1)
    post_cmajor_sm90_kernel(const __grid_constant__ CUtensorMap map_y,
                            const __grid_constant__ CUtensorMap map_fg,
                            const __grid_constant__ CUtensorMap map_res,
                            const __grid_constant__ CUtensorMap map_w,
                            Args p) {
  using P = Plan<KY, KR>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t bar = base + P::kBar;
  const uint32_t w_full = bar;
  auto y_full = [&](int w) { return bar + 8 + 8 * w; };
  auto fr_full = [&](int w) { return bar + 24 + 8 * w; };
  auto empty = [&](int w) { return bar + 40 + 8 * w; };
  float* s_wb = reinterpret_cast<float*>(gbase + P::kParams);
  float* s_sc = s_wb + P::kNR;
  float* s_bi = s_sc + 64 * KY;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tpb = (p.P + kRows - 1) / kRows;  // tiles a batch element
  const int n_tiles = p.B * tpb;

  if (threadIdx.x == 0) {
    mbar_init(w_full, 1);
    for (int w = 0; w < 2; ++w) {
      mbar_init(y_full(w), 1);
      mbar_init(fr_full(w), 1);
      mbar_init(empty(w), 4);
    }
    mbar_fence_init();
  }
  for (int i = threadIdx.x; i < P::kNR; i += blockDim.x)
    s_wb[i] = i < p.C ? p.wb[i] : 0.f;
  for (int i = threadIdx.x; i < 64 * KY; i += blockDim.x) {
    s_sc[i] = i < p.NC ? p.scale[i] : 0.f;
    s_bi[i] = i < p.NC ? p.bias[i] : 0.f;
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
      }
      const uint32_t dst = base + P::kSlots + pw * P::kSlot;
      int k = 0;
      for (int tile = 2 * blockIdx.x + pw; tile < n_tiles;
           tile += 2 * gridDim.x, ++k) {
        const int b = tile / tpb, p0 = (tile - b * tpb) * kRows;
        const int m0 = b * p.P + p0;
        if (k > 0) mbar_wait(empty(pw), (k - 1) & 1);
        mbar_expect_tx(y_full(pw), P::kY);
        tma_load_3d(dst, &map_y, y_full(pw), p0, 0, b);
        mbar_expect_tx(fr_full(pw), P::kFR);
        for (int a = 0; a < KR; ++a)
          tma_load_2d(dst + P::kY + a * kAtom, &map_fg, fr_full(pw), 64 * a,
                      m0);
        for (int a = 0; a < KR; ++a)
          tma_load_2d(dst + P::kY + (KR + a) * kAtom, &map_res, fr_full(pw),
                      64 * a, m0);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wg = warp >> 2, wi = warp & 3;
    const int g = lane >> 2, t = lane & 3;
    unsigned char* y_p = gbase + P::kSlots + wg * P::kSlot;
    const unsigned char* fg_p = y_p + P::kY;
    unsigned char* res_p = y_p + P::kY + KR * kAtom;
    const uint32_t a_y = base + P::kSlots + wg * P::kSlot;
    float* part = reinterpret_cast<float*>(gbase + P::kPart) + wg * 512;
    mbar_wait(w_full, 0);
    int k = 0;
    for (int tile = 2 * blockIdx.x + wg; tile < n_tiles;
         tile += 2 * gridDim.x, ++k) {
      const int b = tile / tpb, p0 = (tile - b * tpb) * kRows;
      const size_t m0 = static_cast<size_t>(b) * p.P + p0;
      const int valid = min(kRows, p.P - p0);  // positions of this tile
      mbar_wait(y_full(wg), k & 1);
      ln_cmajor<KY>(y_p, p.NC, s_sc, s_bi, part, 1 + wg, wi, lane);
      // The normalised tile's generic-proxy writes, visible to wgmma's
      // async proxy; the warpgroup's 64 KY rows complete.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_sync(1 + wg, 128);
#pragma unroll
      for (int j = 0; j < KR; ++j) {
        float o[32];
        const uint32_t wj = base + P::kW + j * 64 * 128;
        wgmma_fence();
#pragma unroll
        for (int a = 0; a < KY; ++a)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ta64(o, desc_mn_sw128(a_y + (64 * a + 16 * kk) * 128),
                       desc_sw128(wj + a * P::kWAtom + 32 * kk), a + kk > 0);
        wgmma_commit();
        wgmma_wait0();
        if (j == 0) mbar_wait(fr_full(wg), k & 1);
        // Epilogue: (o + wb) * sigmoid(fg) + res at the lane's cells (rows
        // 16 wi + g + 8 h, columns 64 j + 8 nt + 2 t, + 1), rounded once
        // into the res tile in place, then 16-byte pieces out.
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int off = j * kAtom + swz(16 * wi + g + 8 * h, nt) + 4 * t;
            const uint32_t fq = *reinterpret_cast<const uint32_t*>(fg_p + off);
            uint32_t* rq = reinterpret_cast<uint32_t*>(res_p + off);
            const uint32_t rv = *rq;
            const int n = 64 * j + 8 * nt + 2 * t;
            const int i = 4 * nt + 2 * h;
            const float v0 = (o[i] + s_wb[n]) * sigm(sm90::lo_f(fq)) +
                             sm90::lo_f(rv);
            const float v1 = (o[i + 1] + s_wb[n + 1]) * sigm(sm90::hi_f(fq)) +
                             sm90::hi_f(rv);
            *rq = pack_bf16(v0, v1);
          }
        __syncwarp();
#pragma unroll
        for (int i = lane; i < 16 * 8; i += 32) {
          const int r = 16 * wi + (i >> 3), pc = i & 7;
          const int c = 64 * j + 8 * pc;
          if (r < valid && c < p.C)
            *reinterpret_cast<uint4*>(p.out + (m0 + r) * p.C + c) =
                *reinterpret_cast<const uint4*>(res_p + j * kAtom +
                                                swz(r, pc));
        }
        __syncwarp();
      }
      // The slot is consumed: back to the producer, the in-place writes
      // ordered before the next TMA load into it.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      if (lane == 0) mbar_arrive(empty(wg));
    }
  }
}

template <int KY, int KR>
cudaError_t launch_k(const Args& p, const void* y, const void* fg,
                     const void* res, const void* w, cudaStream_t stream) {
  using P = Plan<KY, KR>;
  const int M = p.B * p.P;
  CUtensorMap map_y, map_fg, map_res, map_w;
  if (!encode_bf16_cmajor_sw128(&map_y, y, p.B, p.NC, p.P, 64 * KY) ||
      !encode_bf16_sw128(&map_fg, fg, M, p.C, kRows) ||
      !encode_bf16_sw128(&map_res, res, M, p.C, kRows) ||
      !encode_bf16_sw128(&map_w, w, p.C, p.NC, P::kNR))
    return cudaErrorInvalidValue;
  cudaError_t e = set_smem(post_cmajor_sm90_kernel<KY, KR>, P::kSmem);
  if (e != cudaSuccess) return e;
  const int n_tiles = p.B * ((p.P + kRows - 1) / kRows);
  const int pairs = (n_tiles + 1) / 2;
  const int grid = pairs < sm90::sm_count() ? pairs : sm90::sm_count();
  post_cmajor_sm90_kernel<KY, KR><<<grid, kThreads, P::kSmem, stream>>>(
      map_y, map_fg, map_res, map_w, p);
  return cudaGetLastError();
}

template <int KY>
cudaError_t launch_ky(const Args& p, const void* y, const void* fg,
                      const void* res, const void* w, cudaStream_t s) {
  switch ((p.C + 63) / 64) {
    case 1: return launch_k<KY, 1>(p, y, fg, res, w, s);
    case 2: return launch_k<KY, 2>(p, y, fg, res, w, s);
    default: return launch_k<KY, 3>(p, y, fg, res, w, s);
  }
}

}  // namespace pcm90
}  // namespace abx

// bf16 tri_mult_post with a channel-major input on the Hopper kernel: y
// (B, NC, P) with P = R*L positions; fg, res and out (B*P, C); w (C, NC)
// bf16; scale, bias (NC,), wb (C,) f32.  NC and C multiples of 8, NC <=
// 128, C <= 192, P a multiple of 8, y, fg, res, w and out 16-byte aligned;
// cudaErrorInvalidValue otherwise (the caller routes other launches to
// abx_tri_mult_post_c_major).
extern "C" int abx_tri_mult_post_c_major_sm90(
    const void* y, int B, int NC, int P, int C, const float* scale,
    const float* bias, const void* w, const float* wb, const void* fg,
    const void* res, void* out, void* stream) {
  using abx::sm90::aligned;
  namespace pc = abx::pcm90;
  if (NC <= 0 || NC % 8 != 0 || NC > pc::kMaxNC || C <= 0 || C % 8 != 0 ||
      C > pc::kMaxC || P % 8 != 0 || !aligned(y, 16) || !aligned(fg, 16) ||
      !aligned(res, 16) || !aligned(w, 16) || !aligned(out, 16))
    return cudaErrorInvalidValue;
  if (B <= 0 || P <= 0) return cudaSuccess;
  const pc::Args p{B, NC, P, C, scale, bias, wb,
                   static_cast<abx::bf16*>(out)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return NC <= 64 ? pc::launch_ky<1>(p, y, fg, res, w, s)
                  : pc::launch_ky<2>(p, y, fg, res, w, s);
}
