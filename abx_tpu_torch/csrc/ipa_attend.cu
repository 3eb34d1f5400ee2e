// IPA attend-over-pair: out[b, i, h*C + c] = sum_j bf16(attn[b, h, i, j]) *
// pair[b, i, j, c], summed in f32 and rounded once to the pair dtype.
//
// Replaces the Pallas TPU kernel abx_tpu/ops/ipa_attend.py::ipa_pair_attend
// (the non-fused IPA route, ABX_FUSED_IPA_ATTN=0 with ABX_IPA_ATTEND=1).
// Each query row i contracts its own pair row: an (H x L) by (L x C)
// product per (b, i) with H = 12.
// Bound on the H100: device-memory bytes.  The pair track is read once
// (85 MB in bf16 at B=4, L=288, C=128), the f32 attention once (16 MB) and
// the output written once (3.5 MB): 0.031 ms at 3.35 TB/s; the products are
// ~1 GFLOP.
// What held the first design back (0.070 ms): a block a (query row, batch)
// in 1.09 waves of the SMs, each 64-key chunk of the pair row staged
// synchronously between two barriers (no load in flight during the
// products), and wmma 16x16 tiles.  A cp.async ring of 16-byte pieces, the
// first design of this kernel, was slower still (0.093 ms): more stages did
// not help, more blocks an SM or larger chunks did, so each SM's rate of
// 16-byte requests set the pace (tools/l2_pieces.py measured the same).
// With the pair fed by TMA, one block an SM took 0.052 ms of device time
// and two blocks an SM 0.042: each block's chain of per-chunk waits and
// barriers, not the bytes in flight, sets the pace (more stages gained
// ~1 us).
// Design (the structure of ipa_attention.cu's pair stage, the pair fed by
// the Tensor Memory Accelerator):
// - One wave: a block takes IB query rows of one batch element, IB chosen
//   by the launcher so that the grid fills the SMs at most once with two
//   blocks an SM in bf16 where their shared memory fits, one otherwise and
//   in f32 (IB = 5 at B=4, L=288 on 132 SMs: 232 blocks in bf16).
// - The (row, 64-key chunk) sequence of the block streams through a ring
//   of stages, the rows one after the other, so the next row's chunks are
//   in flight during the current products.  In bf16 one thread loads a
//   chunk by TMA (a 3-d map (C, L, B*L) of 64-channel boxes, 128-byte
//   swizzle; keys past L zero-filled) completing on the stage's mbarrier;
//   in f32 every thread copies 16-byte pieces by cp.async into rows padded
//   by 16 bytes.  Each row's H attention rows (f32) come by cp.async with
//   its first chunk, into one of a few row buffers, and are rounded to
//   bf16 A fragments as they are read (the JAX wrapper's
//   attn.astype(pair.dtype)).  One barrier a chunk frees the stage read
//   before it.
// - Products on mma.sync.m16n8k16 with the heads as M (padded to 16), the
//   keys as K and the channels as N: warp w owns the n8 channel tiles
//   2 w, 2 w + 1 (and 2 w + 16, 2 w + 17 for C > 128); in bf16 one
//   ldmatrix.x4.trans loads the B fragments of both tiles (conflict-free
//   on the swizzled rows).
// - A row's f32 sums are rounded once into a staging tile ([head][channel]
//   rows padded by 16 bytes, two of them in turn) and written out as
//   16-byte pieces in the concat-ready (B, L, H*C) layout at the next
//   chunk's barrier.
// The float32 instance runs the same code with every product bf16x3 (see
// common.cuh), its B fragments from scalar reads.
#include "common.cuh"
#include "mma_sync.cuh"
#include "tma.cuh"

namespace abx {
namespace {

constexpr int kHeads = 16;  // heads as the M of one mma tile
constexpr int kPC = 64;     // keys per pair chunk
constexpr int kMaxC = 192;  // the ring's stages fit in shared memory
constexpr size_t kSmemMax = 227 * 1024;

// Stages of the pair ring: 16 KB each in bf16 (C = 128), 33 KB in f32;
// blocks an SM at most: two in bf16 (~89 KB of shared memory each at H =
// 12, L = 288, C = 128), one in f32.
constexpr int kStages = 3;
template <typename T>
__host__ __device__ constexpr int blocks_per_sm() {
  return IsF32<T>::value ? 1 : 2;
}

// Shared-memory plan, byte offsets from the 1024-aligned base: the pair
// ring (bf16: ceil(C / 64) swizzled atoms of kPC rows of 128 bytes a stage;
// f32: kPC rows of C + 4 floats), the attention row buffers (f32), the two
// output staging tiles, the stages' mbarriers.
template <typename T>
struct Plan {
  int ldp, ldb, ldo, nkc, na, stage;
  size_t attn_off, out_off, bar_off, total;
  __host__ __device__ Plan(int L, int H, int C, int IB) {
    constexpr int pad = 16 / sizeof(T);  // 16 bytes
    ldp = round_up(L, kPC) + 8;  // heads of a row 8 banks apart
    ldb = C + pad;
    ldo = C + pad;
    nkc = round_up(L, kPC) / kPC;
    // Enough row buffers that a row's attention is issued (stages - 1
    // chunks ahead) only once the row that last held its buffer is done.
    na = 1 + (kStages - 2 + nkc) / nkc;
    na = na < IB ? na : IB;
    stage = IsF32<T>::value ? kPC * ldb * 4 : (C + 63) / 64 * kPC * 128;
    attn_off = static_cast<size_t>(kStages) * stage;
    out_off = attn_off + sizeof(float) * static_cast<size_t>(na) * H * ldp;
    bar_off = out_off + 2 * sizeof(T) * static_cast<size_t>(kHeads) * ldo;
    total = 1024 + bar_off + 8 * kStages;
  }
};

// Byte offset of the 16-byte piece j (0..7) of row r in a swizzled atom of
// 128-byte rows (the TMA's 128-byte swizzle).
__device__ __forceinline__ int swz(int r, int j) {
  return r * 128 + ((j ^ (r & 7)) << 4);
}

// 4-byte asynchronous copy from device to shared memory; with ok false
// nothing is read and the 4 bytes are zero-filled.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// (x0, x1) -> bf16 pair, and with SPLIT its low halves.
template <bool SPLIT>
__device__ __forceinline__ void frag(float x0, float x1, uint32_t& hi,
                                     uint32_t& lo) {
  if constexpr (SPLIT) {
    split_bf16(x0, x1, hi, lo);
  } else {
    hi = pack_bf16(x0, x1);
    lo = 0u;
  }
}

template <bool SPLIT>
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&a)[4],
                                     const uint32_t (&al)[4], uint32_t b0,
                                     uint32_t b1, uint32_t b0l, uint32_t b1l) {
  mma_bf16(d, a, b0, b1);
  if constexpr (SPLIT) {
    mma_bf16(d, a, b0l, b1l);
    mma_bf16(d, al, b0, b1);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, blocks_per_sm<T>())
    ipa_attend_kernel(const __grid_constant__ CUtensorMap map_pair,
                      const float* __restrict__ attn,
                      const T* __restrict__ pair, T* __restrict__ out, int H,
                      int L, int C, int IB) {
  constexpr bool SPLIT = IsF32<T>::value;
  constexpr int S = kStages;
  constexpr int kVec = 16 / sizeof(T);
  const Plan<T> pl(L, H, C, IB);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* ring = smem_raw + (base - raw);
  float* attn_s = reinterpret_cast<float*>(ring + pl.attn_off);
  T* ost = reinterpret_cast<T*>(ring + pl.out_off);
  const uint32_t bars = base + pl.bar_off;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y, i0 = blockIdx.x * IB;
  const int rows = min(IB, L - i0);
  const int nkc = pl.nkc, n_steps = rows * nkc, lp = nkc * kPC;
  const size_t ll = static_cast<size_t>(L) * L;
  // Row attention rows as 16-byte pieces where every row starts aligned.
  const bool attn16 = L % 4 == 0;

  if constexpr (!SPLIT) {
    if (tid == 0) {
      for (int s = 0; s < S; ++s) mbar_init(bars + 8 * s, 1);
      mbar_fence_init();
    }
    __syncthreads();
  }

  auto issue = [&](int step) {
    if (step < n_steps) {
      const int r = step / nkc, j0 = (step % nkc) * kPC;
      if (j0 == 0) {  // the row's H attention rows, zero past L
        const float* src = attn + (static_cast<size_t>(b) * H * L + i0 + r) *
                                      static_cast<size_t>(L);
        float* dst = attn_s + (r % pl.na) * H * pl.ldp;
        if (attn16) {
          const int per = lp / 4;
          for (int v = tid; v < H * per; v += kThreads) {
            const int h = v / per, j = (v % per) * 4;
            const bool ok = j < L;
            cp_async16(dst + h * pl.ldp + j, ok ? src + h * ll + j : src, ok);
          }
        } else {
          for (int v = tid; v < H * lp; v += kThreads) {
            const int h = v / lp, j = v % lp;
            const bool ok = j < L;
            cp_async4(dst + h * pl.ldp + j, ok ? src + h * ll + j : src, ok);
          }
        }
      }
      const int stage = step % S;
      if constexpr (SPLIT) {
        const T* src = pair + ((static_cast<size_t>(b) * L + i0 + r) * L +
                               j0) * static_cast<size_t>(C);
        T* dst = reinterpret_cast<T*>(ring + stage * pl.stage);
        const int pieces = kPC * C / kVec;
        for (int v = tid; v < pieces; v += kThreads) {
          const int jj = v / (C / kVec), c = (v % (C / kVec)) * kVec;
          const bool ok = j0 + jj < L;
          cp_async16(dst + jj * pl.ldb + c, ok ? src + jj * C + c : src, ok);
        }
      } else if (tid == 0) {
        const uint32_t bar = bars + 8 * stage;
        mbar_expect_tx(bar, pl.stage);
        for (int a = 0; a * 64 < C; ++a)
          tma_load_3d(base + stage * pl.stage + a * kPC * 128, &map_pair, bar,
                      64 * a, j0, b * L + i0 + r);
      }
    }
    cp_async_commit();
  };
  // Row r's staged output, 16-byte pieces out.
  auto flush = [&](int r) {
    const T* st = ost + (r & 1) * kHeads * pl.ldo;
    T* dst = out + (static_cast<size_t>(b) * L + i0 + r) * H * C;
    for (int v = tid; v < H * C / kVec; v += kThreads) {
      const int h = v / (C / kVec), c = (v % (C / kVec)) * kVec;
      *reinterpret_cast<uint4*>(dst + h * C + c) =
          *reinterpret_cast<const uint4*>(st + h * pl.ldo + c);
    }
  };

  for (int s = 0; s < S - 1; ++s) issue(s);
  const int ctiles = C / 8;
  float acc[2][2][4];
  for (int step = 0; step < n_steps; ++step) {
    const int r = step / nkc, kc = step % nkc;
    if (kc == 0) {
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int x = 0; x < 4; ++x) acc[u][n][x] = 0.f;
    }
    cp_async_wait<S - 2>();
    if constexpr (!SPLIT) mbar_wait(bars + 8 * (step % S), (step / S) & 1);
    // Every thread's copies landed; the stage read in the last step free.
    __syncthreads();
    if (kc == 0 && r > 0) flush(r - 1);
    issue(step + S - 1);
    const unsigned char* st = ring + (step % S) * pl.stage;
    const float* pa = attn_s + (r % pl.na) * H * pl.ldp + kc * kPC + 2 * t;
#pragma unroll
    for (int ks2 = 0; ks2 < kPC / 16; ++ks2) {
      // A: heads g, g + 8 (zero past H), keys 16 ks2 + 2t.. and + 8..,
      // rounded to bf16 (split for f32).
      auto pget = [&](int h, int c) -> float2 {
        return h < H ? *reinterpret_cast<const float2*>(
                           pa + h * pl.ldp + 16 * ks2 + c)
                     : make_float2(0.f, 0.f);
      };
      uint32_t af[4], al[4];
      float2 v = pget(g, 0);
      frag<SPLIT>(v.x, v.y, af[0], al[0]);
      v = pget(g + 8, 0);
      frag<SPLIT>(v.x, v.y, af[1], al[1]);
      v = pget(g, 8);
      frag<SPLIT>(v.x, v.y, af[2], al[2]);
      v = pget(g + 8, 8);
      frag<SPLIT>(v.x, v.y, af[3], al[3]);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int tp = 2 * (warp + kWarps * u);  // the pair's first n8 tile
        if (tp >= ctiles) break;
        if constexpr (SPLIT) {
          const T* stf = reinterpret_cast<const T*>(st);
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            if (tp + n >= ctiles) break;
            const T* c = stf + (16 * ks2 + 2 * t) * pl.ldb + 8 * (tp + n) + g;
            uint32_t b0, b1, b0l, b1l;
            frag<true>(to_f32(c[0]), to_f32(c[pl.ldb]), b0, b0l);
            frag<true>(to_f32(c[8 * pl.ldb]), to_f32(c[9 * pl.ldb]), b1, b1l);
            mma3<true>(acc[u][n], af, al, b0, b1, b0l, b1l);
          }
        } else {
          // Keys 16 ks2 + 0..15 of channels 8 tp .. 8 tp + 15, transposed:
          // registers 0, 1 the B fragment of tile tp, 2, 3 of tile tp + 1
          // (zero-filled channels where tp + 1 lies past C).
          const int row = 16 * ks2 + (lane & 15);
          const int col = 8 * tp + 8 * (lane >> 4);
          uint32_t rr[4];
          ldmatrix_x4_trans(rr, st + (col >> 6) * (kPC * 128) +
                                    swz(row, (col >> 3) & 7));
          mma_bf16(acc[u][0], af, rr[0], rr[1]);
          if (tp + 1 < ctiles) mma_bf16(acc[u][1], af, rr[2], rr[3]);
        }
      }
    }
    if (kc == nkc - 1) {
      // Lane (g, t) holds heads g, g + 8 and channels 2t, 2t + 1 of each
      // n8 tile: rounded once into the row's staging tile.
      T* so = ost + (r & 1) * kHeads * pl.ldo;
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int tile = 2 * (warp + kWarps * u) + n;
          if (tile >= ctiles) continue;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int h = g + 8 * hh;
            if (h >= H) continue;
            T* o = so + h * pl.ldo + 8 * tile + 2 * t;
            if constexpr (SPLIT) {
              *reinterpret_cast<float2*>(o) =
                  make_float2(acc[u][n][2 * hh], acc[u][n][2 * hh + 1]);
            } else {
              *reinterpret_cast<uint32_t*>(o) =
                  pack_bf16(acc[u][n][2 * hh], acc[u][n][2 * hh + 1]);
            }
          }
        }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  if (rows > 0) flush(rows - 1);
}

// Rows a block: the fewest that keep the grid within `slots` blocks.
int rows_per_block(int B, int L, int slots) {
  int ib = (B * L + slots - 1) / slots;
  ib = ib < 1 ? 1 : ib;
  while (ib < L && B * ((L + ib - 1) / ib) > slots) ++ib;
  return ib < L ? ib : L;
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// The bf16 pair (B, L, L, C) as a 3-d tensor map (C, L keys, B*L rows) of
// {64 channels, kPC keys, 1 row} boxes, 128-byte swizzle: keys past L
// zero-filled.
bool encode_pair(CUtensorMap* map, const void* pair, int B, int L, int C) {
  auto enc = tensor_map_encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(C),
                              static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(B) * L};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(C) * 2,
      static_cast<cuuint64_t>(L) * static_cast<cuuint64_t>(C) * 2};
  const cuuint32_t box[3] = {64, kPC, 1};
  const cuuint32_t estride[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(pair),
             dims, strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The launch's host work is a share of a call's time at the model's size
// (the kernel takes ~0.04 ms), so the tensor map of the last pair and the
// shared-memory limit already set are kept (the wrappers launch from one
// thread).
template <typename T>
cudaError_t launch_attend(const float* attn, const void* pair, void* out,
                          int B, int H, int L, int C, cudaStream_t stream) {
  // As many blocks an SM as fit, at most blocks_per_sm<T>().
  int per_sm = blocks_per_sm<T>(), ib;
  size_t smem;
  for (;; --per_sm) {
    ib = rows_per_block(B, L, per_sm * sm_count());
    smem = Plan<T>(L, H, C, ib).total;
    if (per_sm == 1 || smem * per_sm <= kSmemMax) break;
  }
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  static CUtensorMap map{};  // the f32 instance copies by cp.async
  static const void* map_of = nullptr;
  static int map_dims[3] = {0, 0, 0};
  if (!IsF32<T>::value &&
      (map_of != pair || map_dims[0] != B || map_dims[1] != L ||
       map_dims[2] != C)) {
    map_of = nullptr;
    if (!encode_pair(&map, pair, B, L, C)) return cudaErrorInvalidValue;
    map_of = pair;
    map_dims[0] = B, map_dims[1] = L, map_dims[2] = C;
  }
  static size_t smem_set = 0;
  if (smem > smem_set) {
    cudaError_t e = set_smem(ipa_attend_kernel<T>, smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  const dim3 grid((L + ib - 1) / ib, B);
  ipa_attend_kernel<T><<<grid, kThreads, smem, stream>>>(
      map, attn, static_cast<const T*>(pair), static_cast<T*>(out), H, L, C,
      ib);
  return cudaGetLastError();
}

}  // namespace
}  // namespace abx

// dtype (of pair and out): 0 = float32, 1 = bfloat16.  attn (B, H, L, L)
// f32 with H <= 16; pair (B, L, L, C) with C a multiple of 8, at most 192;
// out (B, L, H*C); attn, pair and out contiguous and 16-byte aligned.
// Returns the cudaError_t of the launch (cudaErrorInvalidValue for shapes
// it does not take).
extern "C" int abx_ipa_pair_attend(int dtype, const float* attn,
                                   const void* pair, void* out, int B, int H,
                                   int L, int C, void* stream) {
  if (H <= 0 || H > abx::kHeads || C <= 0 || C % 8 != 0 || C > abx::kMaxC ||
      (reinterpret_cast<uintptr_t>(attn) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(pair) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || L <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? abx::launch_attend<float>(attn, pair, out, B, H, L, C, s)
             : abx::launch_attend<abx::bf16>(attn, pair, out, B, H, L, C, s);
}
