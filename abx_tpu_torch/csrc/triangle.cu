// Triangle-multiplication contraction in the natural (B, L, L, C) layout:
//   per_row:    out[b, i, j, c] = sum_k left[b, i, k, c] * right[b, j, k, c]
//   per_column: out[b, i, j, c] = sum_k left[b, k, i, c] * right[b, k, j, c]
//
// Replaces the Pallas TPU kernel abx_tpu/ops/triangle.py:81
// triangle_multiply_pallas (ABX_PALLAS_TRIANGLE=1).
// Bound on the H100: device-memory bytes at the flagship shape (left, right
// and out, 3 x 85 MB in bf16 at B=4, L=288, C=128, against 24.5 GFLOP: 96
// FLOP a byte, under the card's ~295).  What limits a kernel that keeps
// the natural layout is the flow from L2 into the SMs: every cell is a
// channel vector, so a block holding a 32 x 32 x 32-channel tile of f32
// accumulators (all the registers allow) re-reads each operand row L / 32
// times, in pieces of 64 contiguous bytes, and the SMs take in such pieces
// at ~3.8 TB/s, 32-byte ones at ~2.4 (tools/l2_pieces.py on an H100 SXM at
// 700 W): the channels a block holds are chosen for the piece size.
//
// Design, with no transpose in device or shared memory:
// - One block per (32 i x 32 j tile, 32 channels (16 for f32), batch):
//   eight consumer warps (four for f32; warp w owns rows 16(w % 2) .. +15,
//   all 32 columns and channels 8(w / 2) .. +7: 4 n8 tiles x 8 channels x
//   4 f32 accumulators) and one producer warpgroup, whose registers go to
//   the consumers (setmaxnreg).
// - One producer thread streams K in 16-wide steps with TMA through a
//   3-stage ring guarded by mbarriers (full: bytes landed; empty: every
//   consumer warp is done with the slot).  A box is the tile's 64 bytes of
//   channels x 16 k x 32 rows, [row][k][64 bytes] in shared memory;
//   per_column only changes the tensor map's strides.
// - The A fragment of mma.m16n8k16 wants, in a lane (g, t), the elements
//   (g, 2t), (g, 2t+1), (g+8, 2t), ... of one channel's matrix; the
//   16-byte vectors at those cells hold them for 8 channels at once, so 8
//   vector reads and a byte permute (prmt) per register give the A
//   fragments of 8 channel matrices, and 4 reads the B fragments of one n8
//   tile.  The boxes land with the TMA's 64-byte swizzle (16-byte quarter
//   q of cell (r, k) at quarter q ^ (k >> 1 & 3)), and lanes of odd g read
//   the odd k of each pair first: the reads of a quarter-warp then hit 8
//   distinct bank groups.
// - The C fragment puts cells (g, 2t) and (g, 2t+1) in one lane for every
//   channel, so a lane holds all 8 channels of a cell and writes them as
//   one 16-byte store (two for f32), with no shared-memory round trip.
// Ragged L and C are zero-filled by TMA and masked on the way out; C need
// only be a multiple of the 16-byte vector (the wrapper pads the input
// channels otherwise) and the output keeps the true C.  The f32 instance
// splits every operand into bf16 hi + lo and sums hi*hi + hi*lo + lo*hi.
#include "common.cuh"
#include "mma_sync.cuh"
#include "tma.cuh"

namespace abx {
namespace {

constexpr int kTI = 32;               // i rows of a block
constexpr int kTJ = 32;               // j columns of a block
constexpr int kTK = 16;               // k per pipeline stage
constexpr int kStagesT = 3;
constexpr int kNT = kTJ / 8;          // n8 tiles of a consumer warp
constexpr int kCellB = 64;            // bytes of a block's channels a cell
constexpr int kRowB = kTK * kCellB;   // bytes of a tile row
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

template <typename T>
struct Tri {
  static constexpr bool SPLIT = IsF32<T>::value;
  static constexpr int kVec = 16 / sizeof(T);           // channels in 16 B
  static constexpr int kChannels = kCellB / sizeof(T);  // of a block
  static constexpr int kGroups = kChannels / 8;         // 8-channel groups
  static constexpr int kConsumers = (kTI / 16) * kGroups;  // warps
  static constexpr int kThreads = 32 * kConsumers + 128;
  static constexpr int kTileA = kTI * kRowB;
  static constexpr int kStage = (kTI + kTJ) * kRowB;
  static constexpr size_t kSmem =
      static_cast<size_t>(kStagesT) * kStage + 2 * kStagesT * sizeof(uint64_t);
};

// --- the consumers' k16 step ------------------------------------------------

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ uint4 lds128(const unsigned char* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// bf16: a and b point at the 16-byte quarter of the lane's channel group
// in its A row (16(w % 2) + g) and B row (g); the lane's first-read cell
// of a k pair is at byte k0, the other at k1, and sel_lo / sel_hi permute
// two such words into the (even k, odd k) pairs of their low and high
// channels.  k0, k1 and the swizzle of the quarter stay fixed for the
// lane: the offsets below move k by 8 and rows by 8, which keeps
// k >> 1 & 3.
__device__ __forceinline__ void step_bf16(float (&acc)[kNT][8][4],
                                          const unsigned char* a,
                                          const unsigned char* b, int k0,
                                          int k1, uint32_t sel_lo,
                                          uint32_t sel_hi) {
  uint32_t fa[8][4];
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    const unsigned char* p = a + 8 * kRowB * (f & 1) + 8 * kCellB * (f >> 1);
    const uint4 x = lds128(p + k0), y = lds128(p + k1);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      fa[e][f] = __byte_perm(word(x, e >> 1), word(y, e >> 1),
                             (e & 1) ? sel_hi : sel_lo);
  }
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    const unsigned char* p = b + 8 * kRowB * n;
    const uint4 x0 = lds128(p + k0), x1 = lds128(p + k1);
    const uint4 y0 = lds128(p + 8 * kCellB + k0);
    const uint4 y1 = lds128(p + 8 * kCellB + k1);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const uint32_t s = (e & 1) ? sel_hi : sel_lo;
      mma_bf16(acc[n][e], fa[e],
               __byte_perm(word(x0, e >> 1), word(x1, e >> 1), s),
               __byte_perm(word(y0, e >> 1), word(y1, e >> 1), s));
    }
  }
}

// f32: the lane's 8 channels of a cell are two 16-byte quarters, at bytes
// q0 (channels 0-3) and q1 (4-7) after the swizzle; cells k (byte k0) and
// k + 1 (byte k0 + 64) of each pair; products bf16x3.
__device__ __forceinline__ void cell8(const unsigned char* p, int q0, int q1,
                                      float (&v)[8]) {
  const float4 u = *reinterpret_cast<const float4*>(p + q0);
  const float4 w = *reinterpret_cast<const float4*>(p + q1);
  v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
  v[4] = w.x; v[5] = w.y; v[6] = w.z; v[7] = w.w;
}

__device__ __forceinline__ void step_f32(float (&acc)[kNT][8][4],
                                         const unsigned char* a,
                                         const unsigned char* b, int k0,
                                         int q0, int q1) {
  uint32_t fa[8][4], fa_lo[8][4];
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    const unsigned char* p = a + 8 * kRowB * (f & 1) + 8 * kCellB * (f >> 1);
    float x[8], y[8];
    cell8(p + k0, q0, q1, x);
    cell8(p + k0 + kCellB, q0, q1, y);
#pragma unroll
    for (int e = 0; e < 8; ++e) split_bf16(x[e], y[e], fa[e][f], fa_lo[e][f]);
  }
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    const unsigned char* p = b + 8 * kRowB * n;
    float x0[8], x1[8], y0[8], y1[8];
    cell8(p + k0, q0, q1, x0);
    cell8(p + k0 + kCellB, q0, q1, x1);
    cell8(p + 8 * kCellB + k0, q0, q1, y0);
    cell8(p + 8 * kCellB + k0 + kCellB, q0, q1, y1);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      uint32_t b0, b0_lo, b1, b1_lo;
      split_bf16(x0[e], x1[e], b0, b0_lo);
      split_bf16(y0[e], y1[e], b1, b1_lo);
      mma_bf16(acc[n][e], fa[e], b0, b1);
      mma_bf16(acc[n][e], fa[e], b0_lo, b1_lo);
      mma_bf16(acc[n][e], fa_lo[e], b0, b1);
    }
  }
}

// --- the kernel -------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(Tri<T>::kThreads, 1)
    triangle_kernel(const __grid_constant__ CUtensorMap map_l,
                    const __grid_constant__ CUtensorMap map_r,
                    T* __restrict__ out, int L, int C, int cblocks) {
  using Lay = Tri<T>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t smem = smem_u32(smem_raw);
  const uint32_t full = smem + kStagesT * Lay::kStage;  // kStagesT mbarriers
  const uint32_t empty = full + 8 * kStagesT;           // and kStagesT more

  const int tiles_j = (L + kTJ - 1) / kTJ;
  const int i0 = (blockIdx.x / tiles_j) * kTI;
  const int j0 = (blockIdx.x % tiles_j) * kTJ;
  const int b = blockIdx.y / cblocks;
  const int c0 = (blockIdx.y % cblocks) * Lay::kChannels;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nk = (L + kTK - 1) / kTK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStagesT; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, Lay::kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= Lay::kConsumers) {
    // Producer warpgroup: one thread issues every copy.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == Lay::kConsumers && lane == 0) {
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % kStagesT;
        if (kb >= kStagesT) mbar_wait(empty + 8 * s, (kb / kStagesT + 1) & 1);
        mbar_expect_tx(full + 8 * s, Lay::kStage);
        const uint32_t st = smem + s * Lay::kStage;
        tma_load(st, &map_l, full + 8 * s, c0, kb * kTK, i0, b);
        tma_load(st + Lay::kTileA, &map_r, full + 8 * s, c0, kb * kTK, j0, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int g = lane >> 2, t = lane & 3;
    const int grp = warp / (kTI / 16), mr = 16 * (warp % (kTI / 16));
    // The lane's cells k = 2t + (0, 1) (+ 8) have k >> 1 & 3 = t: quarter
    // q of each sits at quarter q ^ t.
    const int a_row = (mr + g) * kRowB, b_row = Lay::kTileA + g * kRowB;
    // Odd-g lanes take the odd k of a pair first (bank groups, see above).
    const int d = g & 1;
    const int k0 = kCellB * (2 * t + d), k1 = kCellB * (2 * t + 1 - d);
    const uint32_t sel_lo = d ? 0x1054 : 0x5410, sel_hi = d ? 0x3276 : 0x7632;

    float acc[kNT][8][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 8; ++e)
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[n][e][x] = 0.f;

    for (int kb = 0; kb < nk; ++kb) {
      const int s = kb % kStagesT;
      mbar_wait(full + 8 * s, (kb / kStagesT) & 1);
      const unsigned char* st = smem_raw + s * Lay::kStage;
      if constexpr (Lay::SPLIT) {
        step_f32(acc, st + a_row, st + b_row, kCellB * 2 * t,
                 16 * ((2 * grp) ^ t), 16 * ((2 * grp + 1) ^ t));
      } else {
        const int q = 16 * (grp ^ t);
        step_bf16(acc, st + a_row + q, st + b_row + q, k0, k1, sel_lo,
                  sel_hi);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }

    // Lane (g, t) holds cells (g + 8h, 2t + x) of each n8 tile, 8 channels
    // each: one 16-byte store per cell (two for f32) where C allows.
    const int cg = c0 + 8 * grp;
    if (cg < C) {
      constexpr int VEC = Lay::kVec;
      const bool vec = C % VEC == 0;
      const size_t batch = static_cast<size_t>(b) * L * L;
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int i = i0 + mr + g + 8 * (x >> 1);
          const int j = j0 + 8 * n + 2 * t + (x & 1);
          if (i >= L || j >= L) continue;
          T* o = out + (batch + static_cast<size_t>(i) * L + j) * C + cg;
          float v[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = acc[n][e][x];
          if (vec && cg + 8 <= C) {
            store8(o, v);
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e)
              if (cg + e < C) o[e] = from_f32<T>(v[e]);
          }
        }
    }
  }
}

// --- host side --------------------------------------------------------------

// The (B, L, L, Cs) operand as a 4-d tensor (channel, k, row, batch): for
// per_row row r's k-th cell is [r][k], for per_column [k][r]; boxes of 64
// bytes of channels x 16 k x 32 rows, swizzled in 64-byte spans.
template <typename T>
bool encode_operand(CUtensorMap* map, const void* base, int B, int L, int Cs,
                    int per_row) {
  auto encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t cell = static_cast<cuuint64_t>(Cs) * sizeof(T);
  const cuuint64_t line = cell * L;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(Cs),
                              static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {per_row ? cell : line, per_row ? line : cell,
                                 line * L};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(Tri<T>::kChannels),
                             kTK, kTI, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  return encode(map,
                IsF32<T>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                4, const_cast<void*>(base), dims, strides, box, estride,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
cudaError_t launch_triangle(const void* left, const void* right, void* out,
                            int B, int L, int C, int Cs, int per_row,
                            cudaStream_t stream) {
  using Lay = Tri<T>;
  static_assert(kTI == kTJ, "one box shape for both operands");
  if (Cs % Lay::kVec != 0 || Cs < C) return cudaErrorInvalidValue;
  CUtensorMap map_l, map_r;
  if (!encode_operand<T>(&map_l, left, B, L, Cs, per_row) ||
      !encode_operand<T>(&map_r, right, B, L, Cs, per_row))
    return cudaErrorInvalidValue;
  cudaError_t e = set_smem(triangle_kernel<T>, Lay::kSmem);
  if (e != cudaSuccess) return e;
  const int cblocks = (C + Lay::kChannels - 1) / Lay::kChannels;
  const int tiles = ((L + kTI - 1) / kTI) * ((L + kTJ - 1) / kTJ);
  triangle_kernel<T><<<dim3(tiles, B * cblocks), Lay::kThreads, Lay::kSmem,
                       stream>>>(map_l, map_r, static_cast<T*>(out), L, C,
                                 cblocks);
  return cudaGetLastError();
}

}  // namespace
}  // namespace abx

// dtype: 0 = float32, 1 = bfloat16.  left, right (B, L, L, Cs) with Cs a
// multiple of 16 bytes of channels (zero beyond C), 16-byte aligned; out
// (B, L, L, C); per_row: 1 for the outgoing (per_row) orientation, 0 for
// per_column.  Returns the cudaError_t of the launch.
extern "C" int abx_triangle_multiply(int dtype, const void* left,
                                     const void* right, void* out, int B,
                                     int L, int C, int Cs, int per_row,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? abx::launch_triangle<float>(left, right, out, B, L, C,
                                                  Cs, per_row, s)
                    : abx::launch_triangle<abx::bf16>(left, right, out, B, L,
                                                      C, Cs, per_row, s);
}
