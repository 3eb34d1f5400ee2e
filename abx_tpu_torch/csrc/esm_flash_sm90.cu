// Hopper kernel of ESM2's flash route in bf16 (esm_flash_attention, kernel
// row 15): the stock TPU flash kernel's function with segment ids 1 - pad.
//
// Replaces abx_tpu/models/esm.py:117 _esm_flash_attention (JAX's stock
// Pallas TPU flash kernel, block_q = block_k = 128) for bf16 operands; the
// f32 instance stays on the segment mode of flash_attention.cuh (wgmma has
// no full-f32 product).  The function, at the stock kernel's rounding
// points:
// - keys come in blocks of 128; the running max m is updated once a
//   block, p = exp(s - m) is rounded to bf16 for P V and the row sum takes
//   the f32 p;
// - key j is visible to query l iff both are valid or both are padded;
//   the keys from L up to Lp (L rounded up to 128) are padded keys with
//   zero k and v;
// - a masked logit is s + kSegMask (-0.7 FLT_MAX), never -inf: a block
//   with no visible key gives p = 1 everywhere, which the next block's
//   exp(m_prev - m_next) = 0 wipes;
// - where Lp = 128 P is normalised before it is rounded and the output is
//   not divided again (the stock kernel's one-step path);
// - every output row l < L is written, the padded query rows included.
// Bound on the H100: bytes.  At ESM2-3B (B = 4, H = 40, L = 306, D = 64)
// q, k, v, the output and the pad row are 25.1 MB, 7.5 us at 3.35 TB/s,
// against 3.8 GFLOP of products (3.9 us at 989 TFLOP/s); at the masked-PLL
// batch (32, 40, 122, 64) 80.0 MB, 23.9 us.
// What held the first version (the core's segment mode) back: 188
// registers and 84.5 KB a 4-warp block (two stages of 128-key K and V
// tiles for 64 queries), so an SM held 8 warps where row 12 holds 16, in a
// kernel whose steps are chains of latencies; and every 64 queries staged
// their own K and V.
// Design:
// - One CTA of two warpgroups (128 queries) per (query tile, head, batch);
//   the warpgroups share every K and V tile.  Q (one 128-row box) and the
//   128-key K and V tiles arrive by TMA: 4-d tensor maps (D, and H, L, B
//   ordered by stride) over the strided views, 64-column x 128-row boxes
//   with the 128-byte swizzle, encoded on the host (the last calls' maps
//   kept for reuse) and passed as __grid_constant__ parameters.  TMA
//   zero-fills past L and past D: the stock kernel's zero tail and the zero
//   columns of D < 64 take no bounds arithmetic.  D = 128 takes two boxes a
//   tile (its own instance).
// - A two-stage ring of K / V tiles guarded by full / empty mbarriers.
//   Thread 0 starts every copy: Q and the first two key blocks at the
//   start, and block kb + 2 once every warp has released block kb.  A
//   producer warp of its own would cut the consumers' register cap from
//   128 to 112 at two CTAs an SM (a producer warpgroup giving its
//   registers back with setmaxnreg leaves 104), and a CTA starts at most a
//   few copies (PLL: one key block; ESM2-3B: three, one refill).  While
//   warp 0 starts them, warps 1-7 build the two key-bias rows (one a query
//   segment) from key_pad: the kernel's only global loads, all sent at once,
//   and the query rows' segments are read back from the rows.
// - S = Q K^T of one key block is one chain of wgmma.m64n128k16 (DP / 16
//   steps, A and B K-major from shared memory): the stock block is one
//   product, so the running max is updated exactly once a block.  S sits
//   in 64 f32 registers a thread; a row's 128 keys lie on the four lanes
//   of a quad (two shuffles for its max and sum).  The segment mask is
//   added from the key-bias rows.
// - P is rounded to bf16 in registers and is the register A operand of
//   wgmma.m64n64k16 for P V (the f32 accumulator layout of two n8 tiles of
//   S is the A fragment of one k16 step); V is read from shared memory
//   MN-major (the transpose bit).  O stays in registers (32 f32 a thread a
//   64-column atom), is scaled by the reciprocal of the row sum once at the
//   end, rounded to bf16 into the warpgroup's own Q rows and written with
//   16-byte stores into the (B, L, H, D) output.  The one-block path
//   normalises P by the reciprocal of its row sum, not by 64 divisions a
//   thread (the divisions took half the PLL batch's device time).
// - Budget: 84 KB of shared memory (Q 16 KB, two stages of 32 KB, the
//   key-bias rows) and 128 registers, no spill (__launch_bounds__(256,
//   2)): two CTAs, 16 warps, an SM.  D = 128 runs one CTA an SM.
// - Grid: ESM2-3B 3 x 40 x 4 = 480 CTAs (1.82 waves of 264; the last query
//   tile's second warpgroup has no rows and leaves at once); PLL 1,280
//   CTAs of one key block each, so K and V are read once per (b, h).
// What bounds it (tools/ablate_kernels.py, PERF.md): at the PLL batch the
// bytes, at ~77% of the memory's rate; at ESM2-3B (3.2x its bound) a chain
// of latencies: leaving out Q K^T, the exponent or P V each saves 10-13%.
// A persistent grid that prefetched the next tile's Q, K and V while the
// current one computed was slower at both shapes.
#include <mutex>

#include "common.cuh"
#include "flash_attention.cuh"
#include "mma_sync.cuh"
#include "row_linear_sm90.cuh"
#include "tma.cuh"

namespace abx {
// Internal linkage: the launch-side caches (reserve_smem) stay per library
// when several builds of this file are loaded in one process.
namespace {
namespace esm90 {

using flash::kLog2e;
using flash::kSegMask;
using flash::quad_max;
using flash::quad_sum;
using sm90::desc_mn_sw128;
using sm90::desc_sw128;
using sm90::wgmma_128;
using sm90::wgmma_commit;
using sm90::wgmma_fence;
using sm90::wgmma_wait0;

constexpr int kKB = flash::kSegKB;  // keys a block: the stock kernel's, S's N
constexpr int kQB = 128;            // queries a CTA: two warpgroups of 64
constexpr int kStages = 2;          // K / V ring
constexpr int kThreads = 256;
constexpr int kAtom = 128 * 128;    // bytes of a 128-row box of 64 columns
constexpr size_t kMaxSmem = 232448;

// Byte offsets from the 1024-aligned base: Q (DA atoms of 128 rows,
// warpgroup w's rows from 64 w), the stages ([DA K atoms | DA V atoms]),
// the barriers, the two key-bias rows of Lp floats.
template <int DA>
struct Plan {
  static constexpr int kQ = 0;
  static constexpr int kKV = DA * kAtom;
  static constexpr int kStage = 2 * DA * kAtom;
  static constexpr int kBar = kKV + kStages * kStage;
  static constexpr int kBias = kBar + 64;
  static size_t smem(int lp) { return 1024 + kBias + 2 * sizeof(float) * lp; }
};

struct Args {
  const unsigned char* key_pad;  // (B, L) bool, nonzero = padded
  bf16* out;                     // (b, l, h) element strides ob, ol, oh
  long long ob, ol, oh;
  int L, D;
  // Where h and l go among the tensor maps' coordinates 1..3 (b takes the
  // third): slot of h | slot of l << 2, one a map.
  int slots_q, slots_k, slots_v;
};

// d = A(64 x 16, registers) B(16 x 64) + d, B MN-major (V: rows are keys,
// 64 head-dim columns a 128-byte row), 128-byte swizzle.
__device__ __forceinline__ void wgmma_rs_tv(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The box at column col, position l of head h, batch b.
__device__ __forceinline__ void load_box(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int slots, int col,
                                         int h, int l, int b) {
  const int sh = slots & 3, sl = (slots >> 2) & 3;
  auto at = [&](int i) { return sh == i ? h : (sl == i ? l : b); };
  tma_load(dst, map, bar, col, at(1), at(2), at(3));
}

// DA: 64-column atoms of the head dim (1: D <= 64, 2: D <= 128).
template <int DA>
__global__ void __launch_bounds__(kThreads, DA == 1 ? 2 : 1)
    esm_flash_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const Args p) {
  using P = Plan<DA>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t q_full = base + P::kBar;
  const uint32_t full = q_full + 8, empty = full + 8 * kStages;
  float* kbias = reinterpret_cast<float*>(gbase + P::kBias);

  const int L = p.L, lp = round_up(L, kKB), nkb = lp / kKB;
  const int q0 = blockIdx.x * kQB, h = blockIdx.y, b = blockIdx.z;
  const int nwg = min(2, (L - q0 + 63) / 64);  // warpgroups with rows
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, wi = warp & 3, g = lane >> 2, t = lane & 3;
  const unsigned char* pad_b = p.key_pad + static_cast<size_t>(b) * L;

  // Key block kb into stage kb % kStages (thread 0 only).
  auto load_kv = [&](int kb) {
    const int s = kb % kStages;
    const uint32_t dst = base + P::kKV + s * P::kStage;
    mbar_expect_tx(full + 8 * s, P::kStage);
#pragma unroll
    for (int a = 0; a < DA; ++a) {
      load_box(dst + a * kAtom, &map_k, full + 8 * s, p.slots_k, 64 * a, h,
               kb * kKB, b);
      load_box(dst + (DA + a) * kAtom, &map_v, full + 8 * s, p.slots_v,
               64 * a, h, kb * kKB, b);
    }
  };
  if (tid == 0) {  // warp 0 starts the copies, warps 1-7 build the rows
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * nwg);
    }
    mbar_fence_init();
    mbar_expect_tx(q_full, DA * kAtom);
#pragma unroll
    for (int a = 0; a < DA; ++a)
      load_box(base + P::kQ + a * kAtom, &map_q, q_full, p.slots_q, 64 * a,
               h, q0, b);
    for (int kb = 0; kb < nkb && kb < kStages; ++kb) load_kv(kb);
  }
  // The key-bias rows: row 0 for padded queries, row 1 for valid ones; key
  // j is valid iff j < L and not padded (the tail past L is the padded
  // segment).  Leaving this build out saved 31% of the PLL batch's device
  // time while every thread took part and each read its query rows'
  // segments from key_pad after the barrier; in this form (warp 0 free to
  // start the copies, the segments read back from the rows) it saves no
  // measurable time.
  if (warp > 0) {
    for (int j = tid - 32; j < lp; j += kThreads - 32) {
      const bool valid = j < L && !pad_b[j];
      kbias[j] = valid ? kSegMask : 0.f;
      kbias[lp + j] = valid ? 0.f : kSegMask;
    }
  }
  __syncthreads();
  if (wg >= nwg) return;

  // The key-bias row of each of this thread's two query rows: a valid
  // query's is the one whose entry at its own position is 0 (rows past L
  // are in the padded segment; they are not stored).
  const int r0 = 64 * wg + 16 * wi + g;  // row of the h = 0 elements
  const float* kb_row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int l = q0 + r0 + 8 * r;
    kb_row[r] = kbias + (l < L && kbias[lp + l] == 0.f ? lp : 0) + 2 * t;
  }
  float o[DA][32];
#pragma unroll
  for (int a = 0; a < DA; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[a][i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  const uint32_t q_wg = base + P::kQ + 64 * wg * 128;
  mbar_wait(q_full, 0);

  for (int kb = 0; kb < nkb; ++kb) {
    const int s = kb % kStages;
    const uint32_t k_s = base + P::kKV + s * P::kStage;
    const uint32_t v_s = k_s + DA * kAtom;
    mbar_wait(full + 8 * s, (kb / kStages) & 1);
    // S = Q K^T: element sc[4 n + 2 r + x] is row r0 + 8 r, key
    // 128 kb + 8 n + 2 t + x.
    float sc[64];
    wgmma_fence();
#pragma unroll
    for (int a = 0; a < DA; ++a)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_128(sc, desc_sw128(q_wg + a * kAtom + 32 * kk),
                  desc_sw128(k_s + a * kAtom + 32 * kk), a + kk > 0);
    wgmma_commit();
    wgmma_wait0();

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 kv = *reinterpret_cast<const float2*>(
            kb_row[r] + kb * kKB + 8 * n);
        sc[4 * n + 2 * r] += kv.x;
        sc[4 * n + 2 * r + 1] += kv.y;
        mx[r] = fmaxf(mx[r], fmaxf(sc[4 * n + 2 * r], sc[4 * n + 2 * r + 1]));
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m_run[r], quad_max(mx[r]));
      alpha[r] = exp2f((m_run[r] - m_new) * kLog2e);
      m_run[r] = m_new;
    }
    // exp(x) = 2^(x log2 e), the difference taken first: exact where s is
    // the row max (a block with no visible key has every logit at
    // kSegMask).
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      sc[i] = exp2f((sc[i] - m_run[(i >> 1) & 1]) * kLog2e);
      sum[(i >> 1) & 1] += sc[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + sum[r];
    if (nkb == 1) {
      // The one-block path: P normalised before it is rounded, by the
      // reciprocal of the row sum (64 divisions a thread took half the
      // PLL batch's time).
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float inv = 1.f / quad_sum(sum[r]);
#pragma unroll
        for (int n = 0; n < 16; ++n) {
          sc[4 * n + 2 * r] *= inv;
          sc[4 * n + 2 * r + 1] *= inv;
        }
      }
    }
    // P in bf16: S's n8 tiles 2 kk and 2 kk + 1 are the A fragment of
    // P V's k-step kk.
    uint32_t pf[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      pf[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);  // row g,     k 2t
      pf[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);  // row g + 8
      pf[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);  // k 2t + 8
      pf[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
#pragma unroll
    for (int a = 0; a < DA; ++a)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[a][i] *= alpha[(i >> 1) & 1];
    wgmma_fence();
#pragma unroll
    for (int a = 0; a < DA; ++a)
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_rs_tv(o[a], pf[kk],
                    desc_mn_sw128(v_s + a * kAtom + kk * 16 * 128));
    wgmma_commit();
    wgmma_wait0();
    // Stage s free; thread 0 refills it with block kb + kStages once
    // every warp has released it.
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
    if (tid == 0 && kb + kStages < nkb) {
      mbar_wait(empty + 8 * s, (kb / kStages) & 1);
      load_kv(kb + kStages);
    }
    __syncwarp();
  }

  // O / l rounded to bf16 into this warp's 16 rows of the Q tile (the
  // swizzled layout: conflict-free), then 16-byte stores, a quarter-warp
  // per 128-byte row.
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    inv[r] = nkb == 1 ? 1.f : 1.f / quad_sum(l_run[r]);
  unsigned char* st = gbase + P::kQ + (64 * wg + 16 * wi) * 128;
#pragma unroll
  for (int a = 0; a < DA; ++a)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = g + 8 * r;
        *reinterpret_cast<uint32_t*>(st + a * kAtom + row * 128 +
                                     ((n ^ g) << 4) + 4 * t) =
            pack_bf16(o[a][4 * n + 2 * r] * inv[r],
                      o[a][4 * n + 2 * r + 1] * inv[r]);
      }
  __syncwarp();
  const int l0 = q0 + 64 * wg + 16 * wi;
  bf16* ob = p.out + b * p.ob + h * p.oh;
#pragma unroll
  for (int a = 0; a < DA; ++a)
#pragma unroll
    for (int i = lane; i < 16 * 8; i += 32) {
      const int r = i >> 3, j = i & 7, c = 64 * a + 8 * j;
      if (l0 + r < L && c < p.D)
        *reinterpret_cast<uint4*>(ob + (l0 + r) * p.ol + c) =
            *reinterpret_cast<const uint4*>(st + a * kAtom + r * 128 +
                                            ((j ^ (r & 7)) << 4));
    }
}

// A (B, H, L, D) bf16 view with element strides (sb, sl, sh) and unit
// stride along D as a 4-d tensor map: D, then H, L and B in order of
// stride; 64-column x 128-position boxes, 128-byte swizzle.  slots gets
// where h and l go among the coordinates.  False if no encoder is
// available or the map is refused.
inline bool encode_op(CUtensorMap* map, int* slots, const void* ptr,
                      long long sb, long long sl, long long sh, int B, int L,
                      int H, int D) {
  auto enc = tensor_map_encoder();
  if (enc == nullptr) return false;
  struct Dim {
    long long stride;
    int size, role, box;
  } d[3] = {{sh, H, 0, 1}, {sl, L, 1, kKB}, {sb, B, 2, 1}};
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && d[j].stride < d[j - 1].stride; --j) {
      const Dim x = d[j];
      d[j] = d[j - 1];
      d[j - 1] = x;
    }
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(d[0].size),
                              static_cast<cuuint64_t>(d[1].size),
                              static_cast<cuuint64_t>(d[2].size)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(d[0].stride) * 2,
                                 static_cast<cuuint64_t>(d[1].stride) * 2,
                                 static_cast<cuuint64_t>(d[2].stride) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(d[0].box),
                             static_cast<cuuint32_t>(d[1].box),
                             static_cast<cuuint32_t>(d[2].box)};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  int slot[3];
  for (int i = 0; i < 3; ++i) slot[d[i].role] = i + 1;
  *slots = slot[0] | slot[1] << 2;
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The maps of the last calls, reused when a call passes an operand of the
// same address, sizes and strides (the map encodes nothing else, so a hit
// is the map it would encode): the ESM2 layers hand in q, k and v at the
// addresses the allocator gave the layer before, and the ESM2 pass is
// bound by the host, where three encodings a call add to the wrapper's
// time.
struct MapKey {
  const void* ptr;
  long long sb, sl, sh;
  int B, L, H, D;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && sb == o.sb && sl == o.sl && sh == o.sh &&
           B == o.B && L == o.L && H == o.H && D == o.D;
  }
};

inline bool cached_map(CUtensorMap* map, int* slots, const MapKey& k) {
  constexpr int kEntries = 16;
  struct Entry {
    MapKey key;
    CUtensorMap map;
    int slots;
    bool used;
  };
  static std::mutex mu;
  static Entry cache[kEntries];
  static int next = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& e : cache)
    if (e.used && e.key == k) {
      *map = e.map;
      *slots = e.slots;
      return true;
    }
  Entry& e = cache[next];
  next = (next + 1) % kEntries;
  e.used = encode_op(&e.map, &e.slots, k.ptr, k.sb, k.sl, k.sh, k.B, k.L,
                     k.H, k.D);
  e.key = k;
  *map = e.map;
  *slots = e.slots;
  return e.used;
}

// The dynamic shared memory the instance may take, raised only when a
// launch needs more (one attribute call an instance, not one a launch).
template <int DA>
cudaError_t reserve_smem(size_t bytes) {
  static size_t set = 0;
  if (bytes <= set) return cudaSuccess;
  const cudaError_t e = set_smem(esm_flash_sm90_kernel<DA>, bytes);
  if (e == cudaSuccess) set = bytes;
  return e;
}

template <int DA>
cudaError_t launch_da(const void* q, const void* k, const void* v,
                      const unsigned char* key_pad, void* out,
                      const long long* st, int B, int L, int H, int D,
                      cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  Args p{};
  if (!cached_map(&mq, &p.slots_q, {q, st[0], st[1], st[2], B, L, H, D}) ||
      !cached_map(&mk, &p.slots_k, {k, st[3], st[4], st[5], B, L, H, D}) ||
      !cached_map(&mv, &p.slots_v, {v, st[6], st[7], st[8], B, L, H, D}))
    return cudaErrorInvalidValue;
  p.key_pad = key_pad;
  p.out = static_cast<bf16*>(out);
  p.ob = st[9];
  p.ol = st[10];
  p.oh = st[11];
  p.L = L;
  p.D = D;
  const size_t smem = Plan<DA>::smem(round_up(L, kKB));
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const cudaError_t e = reserve_smem<DA>(smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((L + kQB - 1) / kQB, H, B);
  esm_flash_sm90_kernel<DA><<<grid, kThreads, smem, stream>>>(mq, mk, mv, p);
  return cudaGetLastError();
}

// The bf16 flash route's launch (abx_esm_flash_attention's bf16 branch):
// q, k, v (B, H, L, D) bf16 views, 16-byte aligned, with (b, l, h)
// element strides in strides[0..8] that are multiples of 8 and unit stride
// along D; out's in strides[9..11]; D a multiple of 8 up to 128.
cudaError_t launch(const void* q, const void* k, const void* v,
                   const unsigned char* key_pad, void* out,
                   const long long* strides, int B, int L, int H, int D,
                   cudaStream_t stream) {
  if (B < 1 || L < 1 || H < 1 || D < 8 || D > 128 || D % 8 != 0)
    return cudaErrorInvalidValue;
  return D <= 64 ? launch_da<1>(q, k, v, key_pad, out, strides, B, L, H, D,
                                stream)
                 : launch_da<2>(q, k, v, key_pad, out, strides, B, L, H, D,
                                stream);
}

template <int DA>
cudaError_t info_da(int l, int* info) {
  const size_t smem = Plan<DA>::smem(round_up(l, kKB));
  cudaFuncAttributes attr;
  cudaError_t e = reserve_smem<DA>(smem);
  if (e == cudaSuccess)
    e = cudaFuncGetAttributes(&attr, esm_flash_sm90_kernel<DA>);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &info[0], esm_flash_sm90_kernel<DA>, kThreads, smem);
  if (e != cudaSuccess) return e;
  info[1] = attr.numRegs;
  info[2] = static_cast<int>(attr.localSizeBytes);
  info[3] = static_cast<int>(smem);
  return cudaSuccess;
}

}  // namespace esm90
}  // namespace
}  // namespace abx

// The stock TPU flash kernel's function (segment ids 1 - pad, the keys
// past L up to a multiple of 128 in the padded segment with zero k and v,
// a running max a 128-key block): every row, the padded ones included.
// Arguments as abx_esm_attention's; D at most 64 in f32, 128 in bf16.
// bf16 launches the Hopper kernel (esm_flash_sm90.cu), f32 the core's
// segment mode; where the Hopper kernel refuses a launch (no tensor-map
// encoder, a refused map) its error is returned.
extern "C" int abx_esm_flash_attention(int dtype, const void* q,
                                       const void* k, const void* v,
                                       const void* key_pad, void* out,
                                       const long long* strides, int B,
                                       int L, int H, int D, void* stream) {
  namespace flash = abx::flash;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0)
    return abx::esm90::launch(q, k, v,
                              static_cast<const unsigned char*>(key_pad), out,
                              strides, B, L, H, D, s);
  flash::Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.key_pad = static_cast<const unsigned char*>(key_pad);
  a.out = out;
  a.qs = flash::Strides{strides[0], 0, strides[1], strides[2]};
  a.ks = flash::Strides{strides[3], 0, strides[4], strides[5]};
  a.vs = flash::Strides{strides[6], 0, strides[7], strides[8]};
  a.os = flash::Strides{strides[9], 0, strides[10], strides[11]};
  a.R = 1;
  a.L = L;
  a.H = H;
  a.D = D;
  a.qscale = 1.f;
  return flash::launch_d<float, 4, 1, false, false, true>(a, B, s);
}

// What the bf16 instance for head dim d gets on this card at length l:
// info[0] CTAs an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// info[1] registers a thread, info[2] local (spill) bytes a thread,
// info[3] dynamic shared memory bytes a CTA.  Returns a cudaError_t.
extern "C" int abx_esm_flash_sm90_info(int d, int l, int* info) {
  return d <= 64 ? abx::esm90::info_da<1>(l, info)
                 : abx::esm90::info_da<2>(l, info);
}
