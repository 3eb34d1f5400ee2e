// Fused pair-track recycling assembly:
//   out = concat(static_pair, t_vec) + LayerNorm(prev_pair) + table[bins].
//
// Replaces abx_tpu/ops/recycle_embed.py::recycle_embed (Pallas TPU).
// Bound on the H100: device-memory bytes.  Per pair element (row) it reads
// C0 static channels, C prev_pair channels and one int64 bin, and writes
// C channels, with ~10 flops a channel: at the flagship shape (B=4, L=288,
// C0=128, C=192, bf16) 342.4 MB a call, 0.102 ms at 3.35 TB/s.
// What held the first kernel back (0.331 ms, ~1.0 TB/s): one warp a
// 192-channel row with 8 channels a lane (24 of 32 lanes working); each
// warp waited on its first 384 bytes and two shuffle reductions before it
// issued the row's second loads (prev_pair again, static_pair), and on the
// bin before the table row; the LN params, table row and time vector came
// from global memory one f32 at a time.
// Design:
// - Eight lanes a row, four rows a warp, every lane working: lane j of a
//   row takes the 8-channel pieces j, j + 8, j + 16, ... (Q = C / 64
//   pieces, rounded up), so a row's pieces of one step are 8 adjacent
//   16-byte pieces and each load and store instruction of a warp moves
//   four whole 128-byte lines.
// - A persistent grid (as many blocks as fit on the SMs) walks 32-row
//   groups; each warp loads its next four rows (prev_pair, static_pair
//   and the bin, all independent 16-byte loads) into registers before it
//   computes and stores the current ones, so two row groups of loads are
//   in flight a warp.
// - The LN params and the f32 table (n_bins x C) are staged into shared
//   memory once a block; the time vector is read through L1 (its B rows
//   are a few hundred bytes), 16 bytes at a time where its pieces are
//   aligned.  Channels C0..C-1 take t_vec[(c - C0) mod t_width], so the
//   caller hands in its time embedding once however often it repeats (the
//   model's two index-embed blocks: no concatenated copy a call).
// - The LN moments are one-pass sums (f32, max(var, 0), eps 1e-5) reduced
//   over the row's eight lanes by three shuffles.
// - Rounding as the TPU kernel: every term in f32, one cast at the end.
//   An out-of-range bin adds zero, as the TPU kernel's one-hot product
//   does.  Rows past M and channels past C are masked; unaligned pieces
//   (C or C0 not a multiple of 8) take element loads and stores.
#include "common.cuh"

namespace abx {
namespace recycle {

constexpr int kLanesPerRow = 8;
constexpr int kRowsPerWarp = 32 / kLanesPerRow;
constexpr int kRowsPerGroup = kWarps * kRowsPerWarp;
constexpr int kMaxQ = 4;  // at most 4 pieces a lane: C <= 256

struct Args {
  const void* static_pair;  // (M, C0), dtype T
  const void* t_vec;        // (B, t_width), f32 (t_f32) or T
  const void* prev_pair;    // (M, C), dtype T
  const float* ln_scale;    // (C,)
  const float* ln_bias;     // (C,)
  const float* table;       // (n_bins, C)
  const int64_t* bins;      // (M,)
  void* out;                // (M, C), dtype T
  int M, C0, C, rows_per_batch, n_bins, t_width, t_f32;
};

// Eight elements of T as raw bits: one 16-byte word for bf16, two for f32.
template <typename T>
struct Raw8 {
  uint4 v[sizeof(T) / 2];

  // The first n (<= 8) elements at p, zero after them; 16-byte loads where
  // all eight are wanted and p is 16-byte aligned.
  __device__ __forceinline__ void load(const T* p, int n) {
    if (n >= 8 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
#pragma unroll
      for (int i = 0; i < static_cast<int>(sizeof(T) / 2); ++i)
        v[i] = reinterpret_cast<const uint4*>(p)[i];
    } else {
      T* e = reinterpret_cast<T*>(v);
#pragma unroll
      for (int k = 0; k < 8; ++k) e[k] = k < n ? p[k] : from_f32<T>(0.f);
    }
  }
  __device__ __forceinline__ float get(int k) const {
    return to_f32(reinterpret_cast<const T*>(v)[k]);
  }
};

// One row's inputs as a lane holds them between their load and their use.
template <typename T, int Q>
struct RowIn {
  Raw8<T> pp[Q];  // prev_pair pieces
  Raw8<T> sp[Q];  // static_pair pieces (those below C0)
  int64_t bin;
};

template <typename T, int Q>
__device__ __forceinline__ void load_row(RowIn<T, Q>& in, const Args& p,
                                         int m, int j) {
  if (m >= p.M) return;
  const T* pp = static_cast<const T*>(p.prev_pair) + static_cast<size_t>(m) * p.C;
  const T* sp = static_cast<const T*>(p.static_pair) + static_cast<size_t>(m) * p.C0;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int c = 8 * (j + kLanesPerRow * q);
    // Zero past C: every lane's pieces go into the row's moments.
    in.pp[q].load(pp + c, c < p.C ? p.C - c : 0);
    if (c < p.C0) in.sp[q].load(sp + c, p.C0 - c);
  }
  in.bin = p.bins[m];
}

// The time vector at channels c .. c + 7 (all >= C0) of batch element b.
template <typename T>
__device__ __forceinline__ void t_piece(const Args& p, int b, int c,
                                        float (&t)[8]) {
  const int ti = (c - p.C0) % p.t_width;
  const size_t row = static_cast<size_t>(b) * p.t_width;
  if (ti + 8 <= p.t_width) {
    if (p.t_f32) {
      Raw8<float> r;
      r.load(static_cast<const float*>(p.t_vec) + row + ti, 8);
#pragma unroll
      for (int k = 0; k < 8; ++k) t[k] = r.get(k);
    } else {
      Raw8<T> r;
      r.load(static_cast<const T*>(p.t_vec) + row + ti, 8);
#pragma unroll
      for (int k = 0; k < 8; ++k) t[k] = r.get(k);
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const size_t i = row + (ti + k) % p.t_width;
    t[k] = p.t_f32 ? static_cast<const float*>(p.t_vec)[i]
                   : to_f32(static_cast<const T*>(p.t_vec)[i]);
  }
}

template <typename T, int Q>
__device__ __forceinline__ void finish_row(const RowIn<T, Q>& in,
                                           const Args& p, int m, int j,
                                           const float* s_scale,
                                           const float* s_bias,
                                           const float* s_tab) {
  float s = 0.f, s2 = 0.f;
#pragma unroll
  for (int q = 0; q < Q; ++q)
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float v = in.pp[q].get(k);
      s += v;
      s2 += v * v;
    }
#pragma unroll
  for (int o = 1; o < kLanesPerRow; o <<= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
  }
  if (m >= p.M) return;
  const float mu = s / p.C;
  const float rstd = rsqrtf(fmaxf(s2 / p.C - mu * mu, 0.f) + 1e-5f);
  const bool bin_ok = in.bin >= 0 && in.bin < p.n_bins;
  const float* emb = s_tab + (bin_ok ? in.bin : 0) * (64 * Q);
  const int b = m / p.rows_per_batch;
  T* out = static_cast<T*>(p.out) + static_cast<size_t>(m) * p.C;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int c = 8 * (j + kLanesPerRow * q);
    if (c >= p.C) continue;
    float base[8];
    if (c + 8 <= p.C0) {
#pragma unroll
      for (int k = 0; k < 8; ++k) base[k] = in.sp[q].get(k);
    } else if (c >= p.C0) {
      t_piece<T>(p, b, c, base);
    } else {
      float t[8];
      t_piece<T>(p, b, p.C0, t);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        base[k] = c + k < p.C0 ? in.sp[q].get(k) : t[c + k - p.C0];
    }
    const float4* sc = reinterpret_cast<const float4*>(s_scale + c);
    const float4* bi = reinterpret_cast<const float4*>(s_bias + c);
    const float4* em = reinterpret_cast<const float4*>(emb + c);
    float o[8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 a = sc[h], bb = bi[h];
      const float4 e = bin_ok ? em[h] : make_float4(0.f, 0.f, 0.f, 0.f);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
      const float ev[4] = {e.x, e.y, e.z, e.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int kk = 4 * h + k;
        const float ln = (in.pp[q].get(kk) - mu) * rstd * av[k] + bv[k];
        o[kk] = base[kk] + ln + ev[k];
      }
    }
    if (c + 8 <= p.C && (reinterpret_cast<uintptr_t>(out + c) & 15) == 0) {
      store8(out + c, o);
    } else {
      for (int k = 0; k < 8 && c + k < p.C; ++k) out[c + k] = from_f32<T>(o[k]);
    }
  }
}

template <typename T, int Q>
__global__ void __launch_bounds__(kThreads) recycle_kernel(Args p) {
  // LN scale, LN bias and the table, each row padded to 64 Q channels
  // (zero past C).
  extern __shared__ float smem[];
  constexpr int kCP = 64 * Q;
  float* s_scale = smem;
  float* s_bias = smem + kCP;
  float* s_tab = smem + 2 * kCP;
  for (int i = threadIdx.x; i < kCP; i += blockDim.x) {
    s_scale[i] = i < p.C ? p.ln_scale[i] : 0.f;
    s_bias[i] = i < p.C ? p.ln_bias[i] : 0.f;
  }
  for (int i = threadIdx.x; i < p.n_bins * kCP; i += blockDim.x) {
    const int r = i / kCP, c = i % kCP;
    s_tab[i] = c < p.C ? p.table[static_cast<size_t>(r) * p.C + c] : 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = lane % kLanesPerRow;
  const int row = warp * kRowsPerWarp + lane / kLanesPerRow;
  const int n_grp = (p.M + kRowsPerGroup - 1) / kRowsPerGroup;
  int grp = blockIdx.x;
  if (grp >= n_grp) return;
  RowIn<T, Q> cur, nxt;
  load_row(cur, p, grp * kRowsPerGroup + row, j);
  for (; grp < n_grp; grp += gridDim.x) {
    const int next = grp + gridDim.x;
    if (next < n_grp) load_row(nxt, p, next * kRowsPerGroup + row, j);
    finish_row(cur, p, grp * kRowsPerGroup + row, j, s_scale, s_bias, s_tab);
    cur = nxt;
  }
}

inline size_t smem_bytes(int q, int n_bins) {
  return static_cast<size_t>(2 + n_bins) * 64 * q * sizeof(float);
}

template <typename T, int Q>
cudaError_t launch_q(const Args& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(Q, p.n_bins);
  auto kernel = recycle_kernel<T, Q>;
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  // Blocks a card holds at once, for this table size (kept per instance).
  static size_t seen_smem = 0;
  static int resident = 0;
  if (seen_smem != smem) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
    if (e != cudaSuccess) return e;
    resident = sms * (per_sm > 0 ? per_sm : 1);
    seen_smem = smem;
  }
  const int n_grp = (p.M + kRowsPerGroup - 1) / kRowsPerGroup;
  recycle_kernel<T, Q>
      <<<n_grp < resident ? n_grp : resident, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Args& p, cudaStream_t s) {
  switch ((p.C + 63) / 64) {
    case 1: return launch_q<T, 1>(p, s);
    case 2: return launch_q<T, 2>(p, s);
    case 3: return launch_q<T, 3>(p, s);
    default: return launch_q<T, 4>(p, s);
  }
}

}  // namespace recycle
}  // namespace abx

// dtype: 0 = float32, 1 = bfloat16 (static_pair, prev_pair and out).
// t_vec is (B, t_width), float32 when t_f32 and of dtype otherwise; channel
// c >= C0 takes t_vec[b, (c - C0) mod t_width].  Rows m = b *
// rows_per_batch + (i * L + j).  C0 < C <= 256 and the staged params
// ((2 + n_bins) x C f32) within a block's shared memory, or
// cudaErrorInvalidValue.  Returns the cudaError_t of the launch.
extern "C" int abx_recycle_embed(int dtype, const void* static_pair,
                                 const void* t_vec, int t_f32, int t_width,
                                 const void* prev_pair,
                                 const float* ln_scale, const float* ln_bias,
                                 const float* table, const int64_t* bins,
                                 void* out, int M, int C0, int C,
                                 int rows_per_batch, int n_bins,
                                 void* stream) {
  namespace rc = abx::recycle;
  if (C <= 0 || C > 64 * rc::kMaxQ || C0 < 0 || C0 >= C || t_width <= 0 ||
      rows_per_batch <= 0 || n_bins < 0 ||
      rc::smem_bytes((C + 63) / 64, n_bins) > 232448 - 1024)
    return cudaErrorInvalidValue;
  if (M <= 0) return cudaSuccess;
  const rc::Args p{static_pair, t_vec,   prev_pair, ln_scale,       ln_bias,
                   table,       bins,    out,       M,              C0,
                   C,           rows_per_batch,     n_bins,         t_width,
                   t_f32};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? rc::launch<float>(p, s) : rc::launch<abx::bf16>(p, s);
}
