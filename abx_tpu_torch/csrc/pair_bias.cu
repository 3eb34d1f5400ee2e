// Hopper pair-bias projection: out[b, h, r, l] = bf16(bf16(LN(pair[b, r,
// l])) . w[h]), for bf16 pair of C <= 192 channels (C a multiple of 8) and
// H <= 64 heads.
//
// Replaces, for those launches, the tile kernel's out_mode 1 of
// row_linear.cu (which keeps f32 inputs and other shapes), and with it the
// Pallas TPU kernel abx_tpu/ops/pair_bias.py::pair_bias_proj in its
// transpose_out form.  Rounding points as the TPU kernel: LN statistics in
// f32 (one-pass moments, max(var, 0), eps 1e-5), LN(x) rounded to bf16
// before the product, f32 accumulation, one rounding of the output.
// Bound on the H100: device-memory bytes.  At the flagship shape (M =
// 4*288*288 rows of C = 192) a call reads 127 MB and writes 2.7 MB (H = 4)
// or 21 MB (H = 32): 0.039 / 0.044 ms at 3.35 TB/s, against 0.5 / 4.1
// GFLOP.  What held the tile kernel back (0.22 / 0.27 ms): one 64 x 64
// output tile a block with N = 4 padded to 64 columns, a separate
// statistics pass, wmma, and scalar 2-byte stores into the transposed
// layout.
// Design: a persistent grid of 256-thread blocks walks 128-row tiles, a
// warp 16 rows.  Each lane loads its 16-byte pieces of two rows (g and
// g + 8) straight into registers, the next tile's while it computes this
// one, so a block keeps ~48 KB of the pair track in flight.  The pieces a
// lane holds are its k-slots of mma.sync.m16n8k16: since the product sums
// over k, any k order serves if A and B use the same one, so lane t takes
// columns 32 p + 8 t .. + 8 of piece p (a quarter-warp reads 64 contiguous
// bytes of a row) and the B fragment is read from W, resident in shared
// memory, at the same columns.  The LayerNorm moments come from the four
// lanes of a row by two shuffles; LN(x) is rounded to bf16 into the A
// fragments in registers.  The (rows x H) result is staged transposed in
// shared memory, and each head's run of 128 consecutive positions written
// out in 16-byte pieces (scalar where R*L or the tail is not a multiple of
// 8): position m = (b R + r) L + l is element m mod RL of out[b, h].
// What bounds it (PERF.md): it reads at ~2 TB/s, not the card's 3.35;
// a version that streamed the tiles through a four-stage bulk-copy ring in
// shared memory, four times the bytes in flight, ran no faster, so the
// limit is the block's own work a tile (unpacking, the moments, LN, the
// dependent mma chain, two barriers) with eight warps an SM to hide its
// latencies.
#include "common.cuh"
#include "mma_sync.cuh"

namespace abx {
namespace pb {

constexpr int kMaxC = 192;
constexpr int kPieces = kMaxC / 32;   // 16-byte pieces of a row per lane
constexpr int kRows = 16 * kWarps;    // rows of a tile
constexpr int kLdW = kMaxC + 32;      // W rows 448 bytes apart (no conflicts)
constexpr int kLdS = kRows + 8;       // staging rows (bf16), 16-byte aligned

template <int NT>
constexpr size_t smem_bytes() {
  return sizeof(bf16) * 8 * NT * kLdW + sizeof(float) * 2 * kMaxC +
         sizeof(bf16) * 8 * NT * kLdS;
}

__device__ __forceinline__ uint4 ldg_stream(const bf16* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ void unpack8(const uint4& u, float (&v)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// NT n8 tiles of heads (H <= 8 NT).
template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
    pair_bias_kernel(const bf16* __restrict__ x, int M, int C,
                     const float* __restrict__ ln_s,
                     const float* __restrict__ ln_b,
                     const bf16* __restrict__ w, int H, int RL,
                     bf16* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* w_s = reinterpret_cast<bf16*>(smem_raw);
  float* sc_s = reinterpret_cast<float*>(w_s + 8 * NT * kLdW);
  float* bi_s = sc_s + kMaxC;
  bf16* st = reinterpret_cast<bf16*>(bi_s + kMaxC);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // W (zero past H heads and C columns), the LayerNorm params (zero past
  // C, so that LN(x) is 0 there).
  for (int i = tid; i < 8 * NT * kLdW; i += kThreads) {
    const int h = i / kLdW, k = i % kLdW;
    w_s[i] = (h < H && k < C) ? w[static_cast<size_t>(h) * C + k]
                              : __float2bfloat16(0.f);
  }
  for (int k = tid; k < kMaxC; k += kThreads) {
    sc_s[k] = k < C ? ln_s[k] : 0.f;
    bi_s[k] = k < C ? ln_b[k] : 0.f;
  }
  __syncthreads();

  const int n_tiles = (M + kRows - 1) / kRows;
  const bool vec = RL % 8 == 0;
  // Rows g and g + 8 of the warp's 16, pieces p: columns 32 p + 8 t.
  auto load = [&](uint4 (&v)[2][kPieces], int tile) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int m = tile * kRows + 16 * warp + g + 8 * hr;
#pragma unroll
      for (int pc = 0; pc < kPieces; ++pc) {
        const int k = 32 * pc + 8 * t;
        v[hr][pc] = (m < M && k < C)
                        ? ldg_stream(x + static_cast<size_t>(m) * C + k)
                        : make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };
  uint4 cur[2][kPieces], nxt[2][kPieces];
  if (blockIdx.x < n_tiles) load(cur, blockIdx.x);
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    if (tile + gridDim.x < n_tiles) load(nxt, tile + gridDim.x);
    float mu[2], rstd[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float s = 0.f, s2 = 0.f;
#pragma unroll
      for (int pc = 0; pc < kPieces; ++pc) {
        float v[8];
        unpack8(cur[hr][pc], v);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          s += v[e];
          s2 += v[e] * v[e];
        }
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, o);
        s2 += __shfl_xor_sync(0xffffffffu, s2, o);
      }
      mu[hr] = s / C;
      rstd[hr] = rsqrtf(fmaxf(s2 / C - mu[hr] * mu[hr], 0.f) + 1e-5f);
    }
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
    for (int pc = 0; pc < kPieces; ++pc) {
      if (32 * pc >= C) break;
      const int k = 32 * pc + 8 * t;
      float ln[2][8];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        unpack8(cur[hr][pc], ln[hr]);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          ln[hr][e] = (ln[hr][e] - mu[hr]) * rstd[hr] * sc_s[k + e] +
                      bi_s[k + e];
      }
      // Slots (2t, 2t+1, 2t+8, 2t+9) of k-step 2 pc hold columns k + 0..3,
      // of k-step 2 pc + 1 columns k + 4..7.
      uint32_t a0[4], a1[4];
      a0[0] = pack_bf16(ln[0][0], ln[0][1]);
      a0[1] = pack_bf16(ln[1][0], ln[1][1]);
      a0[2] = pack_bf16(ln[0][2], ln[0][3]);
      a0[3] = pack_bf16(ln[1][2], ln[1][3]);
      a1[0] = pack_bf16(ln[0][4], ln[0][5]);
      a1[1] = pack_bf16(ln[1][4], ln[1][5]);
      a1[2] = pack_bf16(ln[0][6], ln[0][7]);
      a1[3] = pack_bf16(ln[1][6], ln[1][7]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const uint4 b =
            *reinterpret_cast<const uint4*>(w_s + (8 * j + g) * kLdW + k);
        mma_bf16(acc[j], a0, b.x, b.y);
        mma_bf16(acc[j], a1, b.z, b.w);
      }
    }
    // The tile transposed into the staging rows: st[h][row].
    const int r0 = 16 * warp + g;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int h = 8 * j + 2 * t;
      st[h * kLdS + r0] = __float2bfloat16(acc[j][0]);
      st[(h + 1) * kLdS + r0] = __float2bfloat16(acc[j][1]);
      st[h * kLdS + r0 + 8] = __float2bfloat16(acc[j][2]);
      st[(h + 1) * kLdS + r0 + 8] = __float2bfloat16(acc[j][3]);
    }
    __syncthreads();
    const int m0 = tile * kRows;
    for (int i = tid; i < H * (kRows / 8); i += kThreads) {
      const int h = i / (kRows / 8), r = (i % (kRows / 8)) * 8;
      const int m = m0 + r;
      if (m >= M) continue;
      const bf16* src = st + h * kLdS + r;
      if (vec && m + 8 <= M) {
        const int b = m / RL;
        *reinterpret_cast<uint4*>(
            out + (static_cast<size_t>(b) * H + h) * RL + (m - b * RL)) =
            *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < 8 && m + e < M; ++e) {
          const int b = (m + e) / RL;
          out[(static_cast<size_t>(b) * H + h) * RL + (m + e - b * RL)] =
              src[e];
        }
      }
    }
    __syncthreads();  // the staging rows are free again
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
#pragma unroll
      for (int pc = 0; pc < kPieces; ++pc) cur[hr][pc] = nxt[hr][pc];
  }
}

template <int NT>
cudaError_t launch_nt(const bf16* x, int M, int C, const float* ln_s,
                      const float* ln_b, const bf16* w, int H, int RL,
                      bf16* out, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<NT>();
  cudaError_t e = set_smem(pair_bias_kernel<NT>, smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, pair_bias_kernel<NT>, kThreads, smem);
  if (e != cudaSuccess) return e;
  const int n_tiles = (M + kRows - 1) / kRows;
  const int slots = sms * (per_sm > 0 ? per_sm : 1);
  const int grid = n_tiles < slots ? n_tiles : slots;
  pair_bias_kernel<NT><<<grid, kThreads, smem, stream>>>(x, M, C, ln_s, ln_b,
                                                         w, H, RL, out);
  return cudaGetLastError();
}

}  // namespace pb
}  // namespace abx

// bf16 pair-bias projection on the Hopper kernel: pair (M, C) with rows m =
// (b*R + r)*L + l, rl = R*L; w (H, C) bf16; ln_s, ln_b (C,) f32; out (B, H,
// R, L) bf16.  C a multiple of 8 and at most 192, 1 <= H <= 64, pair
// 16-byte aligned and out 16-byte aligned; cudaErrorInvalidValue otherwise
// (the caller routes other launches to abx_row_linear's out_mode 1).
extern "C" int abx_pair_bias_proj(const void* pair, int M, int C,
                                  const float* ln_s, const float* ln_b,
                                  const void* w, int H, int rl, void* out,
                                  void* stream) {
  if (C <= 0 || C % 8 != 0 || C > abx::pb::kMaxC || H < 1 || H > 64 ||
      rl <= 0 || (reinterpret_cast<uintptr_t>(pair) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return cudaErrorInvalidValue;
  if (M <= 0) return cudaSuccess;
  const auto* x = static_cast<const abx::bf16*>(pair);
  const auto* wb = static_cast<const abx::bf16*>(w);
  auto* o = static_cast<abx::bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H <= 8)
    return abx::pb::launch_nt<1>(x, M, C, ln_s, ln_b, wb, H, rl, o, s);
  if (H <= 16)
    return abx::pb::launch_nt<2>(x, M, C, ln_s, ln_b, wb, H, rl, o, s);
  if (H <= 32)
    return abx::pb::launch_nt<4>(x, M, C, ln_s, ln_b, wb, H, rl, o, s);
  return abx::pb::launch_nt<8>(x, M, C, ln_s, ln_b, wb, H, rl, o, s);
}
