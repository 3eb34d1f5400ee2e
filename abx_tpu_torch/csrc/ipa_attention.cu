// Fused IPA attention: logits + softmax + scalar, point and pair attends.
//
// Replaces abx_tpu/ops/ipa_attention.py::ipa_attention (Pallas TPU).
// Per (batch b, query row i, head h):
//   logit_j = qs_i.ks_j + pw_h (|qp_i|^2 + |kp_j|^2 - 2 qp_i.kp_j)
//             + bias[b, h, i, j] + (1 - mask[b, j]) BIG_NEG
//   p = softmax_j(logit)   (f32)
//   out_s = sum_j p_j vs_j  (p rounded to the input dtype, f32 sums),
//   out_p = sum_j p_j vp_j  (f32),
//   out_2d[i, h, :] = sum_j p_j pair[b, i, j, :]  (p in the input dtype).
// pw is folded into the query points and both squared norms in the kernel
// (the TPU kernel's wrapper does the same), so the point term is q2 + k2 -
// 2 qp.kp, in f32 FMA: it is cancellation-sensitive (centred points) and
// the TPU kernel keeps it in f32.
// Bound on the H100: device-memory bytes, the pair track (B*L*L*C read
// once a layer, 85 MB in bf16 at B=4, L=288, C=128) and the bias; the
// products are ~1.5 GFLOP.  What held this kernel's first design back: 4-row blocks
// in 2.2 waves, each re-reading every key from L2; four serial phases of
// f32 FMA loops with two barriers per 16-key chunk; a pair attend that
// staged its rows synchronously; and ~15 small launches and an f32 copy
// of the bias in its wrapper, every layer.
// Design:
// - One launch per call: the kernel reads the module's tensors where they
//   lie, through (batch, position, head) element strides (k / v are
//   column blocks of one projection, the value points a slice of the
//   key-value points), the bias through its four strides and in its own
//   dtype (the module's bias is a permuted view: each query row's bias is
//   one contiguous L x H block), and the (B, L) key mask itself.
// - A block takes IB query rows of one batch element, IB chosen by the
//   launcher so that the grid is one wave of the SMs (IB = 9 at B=4,
//   L=288 on 132 SMs) and the block's f32 probabilities (IB x H x L)
//   fit in shared memory beside the staging; keys are staged once a block
//   for all its rows: in 16-key chunks, a thread a (key, head), its loads
//   issued together and the next chunk's in flight while the current one
//   is computed.
// - Logits: the bias and the key mask bias of the block's rows are staged
//   into the f32 probability tile first, in one pass along the bias's
//   contiguous axis; then qs.ks on mma.sync.m16n8k16 (queries as M,
//   padded to 16, one k16 step per 16 scalar dims, per head) and the point
//   term in f32 FMA (the model's 3 x 4 points unrolled from registers) are
//   added by the lane that holds the logit; the softmax in f32, a warp a
//   (row, head).
// - Scalar attend on mma.sync from bf16 P fragments (p rounded to the
//   input dtype, as the TPU kernel's p.astype(in_dt)), the accumulators in
//   registers over all keys; point attend in f32 FMA, its sums in
//   registers (two threads a row and head).
// - Pair attend: per query row, P (heads as M, padded 12 -> 16) times the
//   row's pair slice (L x C), which streams through a six-stage cp.async
//   ring of 32-key chunks (one barrier a chunk), the rows one after the
//   other, so the next chunk is in flight during the current products; B
//   fragments by ldmatrix.trans from [key][channel] rows padded by 16
//   bytes.
// The float32 instance runs the same code with every product bf16x3 (see
// common.cuh), p split alike.
#include "common.cuh"
#include "mma_sync.cuh"

namespace abx {
namespace {

constexpr int kKC = 16;       // keys per staged chunk (logits, attends)
constexpr int kPC = 32;       // keys per pair chunk
constexpr int kPStages = 6;   // pair ring
constexpr int kMaxIB = 16;    // query rows a block (the M of one mma tile)
constexpr int kMaxDs = 32;    // scalar dims (two k16 steps)
constexpr int kMaxP3 = 48;    // 3 x points of a head

struct IpaArgs {
  const void* qs;  long long qs_b, qs_l, qs_h;   // (B, L, H, Ds), scaled
  const void* ks;  long long ks_b, ks_l, ks_h;
  const void* vs;  long long vs_b, vs_l, vs_h;
  const float* qp; long long qp_b, qp_l, qp_h;   // (B, L, H, P3q) f32
  const float* kp; long long kp_b, kp_l, kp_h;
  const float* vp; long long vp_b, vp_l, vp_h;   // (B, L, H, P3v) f32
  const float* pw;                               // (H,)
  const void* bias; long long bs_b, bs_h, bs_i, bs_j;  // (B, H, L, L)
  int bias_f32;                                  // bias f32, else dtype T
  const float* mask;                             // (B, L), 1 = valid key
  const void* pair;                              // (B, L, L, C) contiguous
  void* out_s;                                   // (B, L, H*Ds) T
  float* out_p;                                  // (B, L, H*P3v)
  void* out_2d;                                  // (B, L, H*C) T
  int L, H, Ds, P3q, P3v, C, IB;
};

// Shared-memory plan (floats unless noted).  Phase-local buffers share
// one region: the key chunk (logits), the value chunk (attends), the pair
// ring.
struct Plan {
  int ldp, ldq, ldk, ldv, ldb;
  size_t p_off, qs_off, qp_off, q2_off, accp_off, region_off, total;
  size_t ks_off, kp_off, k2_off, vs_off, vp_off;  // within the region
  __host__ __device__ static size_t cb(size_t n) {
    return (n + 127) / 128 * 128;
  }
  __host__ __device__ Plan(int L, int H, int Ds, int P3q, int P3v, int C,
                           int IB, int tsize) {
    ldp = round_up(L, 32) + 8;  // p rows: heads of a row 8 banks apart
    ldq = Ds + 8;               // staged query / key scalars
    ldk = P3q + 1;
    ldv = Ds + 4;
    ldb = C + 8;                // pair chunk rows, in elements of T
    p_off = 0;
    qs_off = p_off + cb(sizeof(float) * IB * H * ldp);
    qp_off = qs_off + cb(sizeof(float) * H * kMaxIB * ldq);
    q2_off = qp_off + cb(sizeof(float) * IB * H * P3q);
    accp_off = q2_off + cb(sizeof(float) * IB * H);
    region_off = accp_off + cb(sizeof(float) * IB * H * P3v);
    ks_off = 0;
    kp_off = ks_off + cb(sizeof(float) * H * kKC * ldq);
    k2_off = kp_off + cb(sizeof(float) * H * kKC * ldk);
    const size_t logit_bytes = k2_off + cb(sizeof(float) * H * kKC);
    vs_off = 0;
    vp_off = vs_off + cb(sizeof(float) * H * kKC * ldv);
    const size_t attend_bytes = vp_off + cb(sizeof(float) * H * kKC * P3v);
    const size_t ring_bytes =
        static_cast<size_t>(kPStages) * kPC * ldb * tsize;
    size_t region = logit_bytes > attend_bytes ? logit_bytes : attend_bytes;
    region = region > ring_bytes ? region : ring_bytes;
    total = region_off + region;
  }
};

template <typename T>
__device__ __forceinline__ float ld(const T* p, long long i) {
  return to_f32(p[i]);
}

// v[e] = src[e] for e < n <= N (0 elsewhere, and everywhere unless ok):
// the loads are issued together, so a staged chunk costs one round trip.
template <int N, typename S>
__device__ __forceinline__ void fetch(float (&v)[N], const S* src, int n,
                                      bool ok) {
#pragma unroll
  for (int e = 0; e < N; ++e) v[e] = (ok && e < n) ? to_f32(src[e]) : 0.f;
}

template <int N>
__device__ __forceinline__ void put_row(float* dst, const float (&v)[N],
                                        int n) {
#pragma unroll
  for (int e = 0; e < N; ++e)
    if (e < n) dst[e] = v[e];
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

// DS, P3Q, P3V: the model's scalar dims and 3 x points (16, 12, 24) as
// compile-time constants, so the point loops unroll and the point rows sit
// in registers; 0 for a generic instance that reads them from the args.
template <typename T, int DS, int P3Q, int P3V>
__global__ void __launch_bounds__(kThreads, 1) ipa_kernel(IpaArgs a) {
  constexpr bool SPLIT = IsF32<T>::value;
  constexpr int NDS = DS ? DS : kMaxDs, NQ = P3Q ? P3Q : kMaxP3,
                NV = P3V ? P3V : kMaxP3;
  const int Ds = DS ? DS : a.Ds, P3q = P3Q ? P3Q : a.P3q,
            P3v = P3V ? P3V : a.P3v;
  const int L = a.L, H = a.H, C = a.C;
  const int IB = a.IB;
  const Plan pl(L, H, Ds, P3q, P3v, C, IB, sizeof(T));
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* p_s = reinterpret_cast<float*>(smem_raw + pl.p_off);
  float* qs_s = reinterpret_cast<float*>(smem_raw + pl.qs_off);
  float* qp_s = reinterpret_cast<float*>(smem_raw + pl.qp_off);
  float* q2_s = reinterpret_cast<float*>(smem_raw + pl.q2_off);
  float* accp = reinterpret_cast<float*>(smem_raw + pl.accp_off);
  unsigned char* region = smem_raw + pl.region_off;
  float* ks_s = reinterpret_cast<float*>(region + pl.ks_off);
  float* kp_s = reinterpret_cast<float*>(region + pl.kp_off);
  float* k2_s = reinterpret_cast<float*>(region + pl.k2_off);
  float* vs_s = reinterpret_cast<float*>(region + pl.vs_off);
  float* vp_s = reinterpret_cast<float*>(region + pl.vp_off);
  T* ring = reinterpret_cast<T*>(region);

  const T* qs = static_cast<const T*>(a.qs);
  const T* ks = static_cast<const T*>(a.ks);
  const T* vs = static_cast<const T*>(a.vs);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y, i0 = blockIdx.x * IB;
  const int rows = min(IB, L - i0);
  const float* maskb = a.mask + static_cast<size_t>(b) * L;

  // Query rows: scalars [h][row][d] (rows past IB zero), points x pw_h
  // [row][h][e] and q2 = pw_h |qp|^2 [row][h].
  for (int idx = tid; idx < H * kMaxIB * Ds; idx += kThreads) {
    const int d = idx % Ds, r = (idx / Ds) % kMaxIB, h = idx / (Ds * kMaxIB);
    qs_s[(h * kMaxIB + r) * pl.ldq + d] =
        r < rows ? ld(qs, b * a.qs_b + (i0 + r) * a.qs_l + h * a.qs_h + d)
                 : 0.f;
  }
  for (int idx = tid; idx < IB * H; idx += kThreads) {
    const int r = idx / H, h = idx % H;
    const float w = a.pw[h];
    float s = 0.f;
    for (int e = 0; e < P3q; ++e) {
      const float v =
          r < rows ? a.qp[b * a.qp_b + (i0 + r) * a.qp_l + h * a.qp_h + e]
                   : 0.f;
      s += v * v;
      qp_s[idx * P3q + e] = v * w;
    }
    q2_s[idx] = s * w;
  }
  for (int idx = tid; idx < IB * H * P3v; idx += kThreads) accp[idx] = 0.f;

  // --- logits -------------------------------------------------------------
  // A thread stages one (key, head) of a chunk; the next chunk's loads are
  // in flight while the current one is computed.
  const bool stager = tid < kKC * H;
  const int sj = tid / H, sh = tid % H;
  float kq[NDS], kpt[NQ];
  auto fetch_k = [&](int j0) {
    const int j = j0 + sj;
    const bool ok = stager && j < L;
    fetch(kq, ks + b * a.ks_b + j * a.ks_l + sh * a.ks_h, Ds, ok);
    fetch(kpt, a.kp + b * a.kp_b + j * a.kp_l + sh * a.kp_h, P3q, ok);
  };
  // The bias and the key mask bias of the block's rows, into p_s in one
  // pass, the bias read along its contiguous axis (heads, in the module's
  // permuted layout).
  const bool rows_contiguous =
      !IsF32<T>::value && !a.bias_f32 && a.bs_h == 1 && a.bs_j == H &&
      (L * H) % 8 == 0 && a.bs_i % 8 == 0 && a.bs_b % 8 == 0 &&
      (reinterpret_cast<uintptr_t>(a.bias) & 15) == 0;
  if (rows_contiguous) {
    // The module's bias: each row one contiguous (L, H) run of bf16, read
    // 16 bytes a thread, four in flight.
    const bf16* bias = static_cast<const bf16*>(a.bias) + b * a.bs_b +
                       static_cast<long long>(i0) * a.bs_i;
    const int per_row = L * H / 8, total = rows * per_row;
    for (int v0 = tid; v0 < total; v0 += 4 * kThreads) {
      uint4 buf[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int v = v0 + u * kThreads;
        if (v < total)
          buf[u] = *reinterpret_cast<const uint4*>(
              bias + (v / per_row) * a.bs_i + (v % per_row) * 8);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int v = v0 + u * kThreads;
        if (v >= total) continue;
        const int r = v / per_row, e0 = (v % per_row) * 8;
        int j = e0 / H, h = e0 % H;
        const bf16* x = reinterpret_cast<const bf16*>(&buf[u]);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          p_s[(r * H + h) * pl.ldp + j] =
              __bfloat162float(x[k]) + (1.f - maskb[j]) * kBigNeg;
          if (++h == H) {
            h = 0;
            ++j;
          }
        }
      }
    }
  } else {
    const bool heads_inner = a.bs_h < a.bs_j;
    for (int idx = tid; idx < rows * H * L; idx += kThreads) {
      int r, h, j;
      if (heads_inner) {
        h = idx % H;
        j = (idx / H) % L;
        r = idx / (H * L);
      } else {
        j = idx % L;
        h = (idx / L) % H;
        r = idx / (H * L);
      }
      const long long bi =
          b * a.bs_b + h * a.bs_h + (i0 + r) * a.bs_i + j * a.bs_j;
      const float bias = a.bias_f32 ? static_cast<const float*>(a.bias)[bi]
                                    : ld(static_cast<const T*>(a.bias), bi);
      p_s[(r * H + h) * pl.ldp + j] = bias + (1.f - maskb[j]) * kBigNeg;
    }
  }
  fetch_k(0);
  for (int j0 = 0; j0 < L; j0 += kKC) {
    __syncthreads();
    if (stager) {
      put_row(ks_s + (sh * kKC + sj) * pl.ldq, kq, Ds);
      put_row(kp_s + (sh * kKC + sj) * pl.ldk, kpt, P3q);
      float s2 = 0.f;
#pragma unroll
      for (int e = 0; e < NQ; ++e) s2 += kpt[e] * kpt[e];
      k2_s[sh * kKC + sj] = s2 * a.pw[sh];
    }
    __syncthreads();
    if (j0 + kKC < L) fetch_k(j0 + kKC);
    // (head, n8 key tile) units: S = Qs Ks^T on the tensor cores.
    for (int unit = warp; unit < H * (kKC / 8); unit += kWarps) {
      const int h = unit / (kKC / 8), nt = unit % (kKC / 8);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k0 = 0; k0 < Ds; k0 += 16) {
        const float* qa = qs_s + (h * kMaxIB) * pl.ldq + k0 + 2 * t;
        uint32_t af[4], al[4];
        frag<SPLIT>(qa[g * pl.ldq], qa[g * pl.ldq + 1], af[0], al[0]);
        frag<SPLIT>(qa[(g + 8) * pl.ldq], qa[(g + 8) * pl.ldq + 1], af[1],
                    al[1]);
        frag<SPLIT>(qa[g * pl.ldq + 8], qa[g * pl.ldq + 9], af[2], al[2]);
        frag<SPLIT>(qa[(g + 8) * pl.ldq + 8], qa[(g + 8) * pl.ldq + 9],
                    af[3], al[3]);
        const float* kb = ks_s + (h * kKC + 8 * nt + g) * pl.ldq + k0 + 2 * t;
        uint32_t b0, b1, b0l, b1l;
        frag<SPLIT>(kb[0], kb[1], b0, b0l);
        frag<SPLIT>(kb[8], kb[9], b1, b1l);
        mma3<SPLIT>(acc, af, al, b0, b1, b0l, b1l);
      }
      // The point term where the lane holds the logit, added to the staged
      // bias: (qs.ks + point) + (bias + mask bias), the reference's sum
      // for every valid key.
      float cross[4] = {0.f, 0.f, 0.f, 0.f};
      if constexpr (P3Q > 0) {
        float qr[2][NQ], kr[2][NQ];
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < NQ; ++e) {
            const int r = min(g + 8 * u, IB - 1);
            qr[u][e] = qp_s[(r * H + h) * P3q + e];
            kr[u][e] = kp_s[(h * kKC + 8 * nt + 2 * t + u) * pl.ldk + e];
          }
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int e = 0; e < NQ; ++e)
            cross[x] += qr[x >> 1][e] * kr[x & 1][e];
      } else {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int r = min(g + 8 * (x >> 1), IB - 1);
          const float* q = qp_s + (r * H + h) * P3q;
          const float* k = kp_s + (h * kKC + 8 * nt + 2 * t + (x & 1)) *
                                      pl.ldk;
          for (int e = 0; e < P3q; ++e) cross[x] += q[e] * k[e];
        }
      }
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int r = g + 8 * (x >> 1), jj = 8 * nt + 2 * t + (x & 1);
        const int j = j0 + jj;
        if (r >= rows || j >= L) continue;
        const float point =
            q2_s[r * H + h] + k2_s[h * kKC + jj] - 2.f * cross[x];
        float* o = p_s + (r * H + h) * pl.ldp + j;
        *o = (acc[x] + point) + *o;
      }
    }
  }
  __syncthreads();

  // --- softmax (f32), a warp a (row, head); keys L .. round_up(L, 32) - 1
  // set to 0 for the tensor-core attends ----------------------------------
  const int lpad = round_up(L, kPC);
  for (int row = warp; row < rows * H; row += kWarps) {
    float* pr = p_s + row * pl.ldp;
    float mx = -INFINITY;
    for (int j = lane; j < L; j += 32) mx = fmaxf(mx, pr[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float e = expf(pr[j] - mx);
      pr[j] = e;
      sum += e;
    }
    const float inv = 1.f / warp_sum(sum);
    for (int j = lane; j < lpad; j += 32) pr[j] = j < L ? pr[j] * inv : 0.f;
  }
  // Rows past `rows` (the last block) stay zero for the mma A fragments.
  for (int idx = tid; idx < (IB - rows) * H * pl.ldp; idx += kThreads)
    p_s[rows * H * pl.ldp + idx] = 0.f;

  // --- scalar (tensor cores) and point (f32 FMA) attends ------------------
  // Warp w takes heads w and w + 8 for the scalar attend: rows as M, Ds
  // dims as N (n8 tiles), keys as K.
  constexpr int kMaxDT = 4;  // Ds <= 32
  float acc_s[2][kMaxDT][4];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int n = 0; n < kMaxDT; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc_s[u][n][x] = 0.f;
  const int dtiles = Ds / 8;
  // The templated instance keeps the point attend's sums in registers: two
  // threads a (row, head), half the 3 Pv outputs each, read as float4 (the
  // launcher keeps IB * H <= kThreads / 2 for it).
  constexpr bool kRegPoints = P3V > 0 && P3V % 8 == 0;
  constexpr int kPE = kRegPoints ? P3V / 2 : 1;
  const int pt_rh = tid >> 1, pt_half = tid & 1, pt_h = pt_rh % H;
  const bool pt_own = pt_rh < rows * H;
  float acc_p[kPE];
#pragma unroll
  for (int e = 0; e < kPE; ++e) acc_p[e] = 0.f;
  float vq[NDS], vpt[NV];
  auto fetch_v = [&](int j0) {
    const int j = j0 + sj;
    const bool ok = stager && j < L;
    fetch(vq, vs + b * a.vs_b + j * a.vs_l + sh * a.vs_h, Ds, ok);
    fetch(vpt, a.vp + b * a.vp_b + j * a.vp_l + sh * a.vp_h, P3v, ok);
  };
  fetch_v(0);
  for (int j0 = 0; j0 < L; j0 += kKC) {
    __syncthreads();
    if (stager) {
      put_row(vs_s + (sh * kKC + sj) * pl.ldv, vq, Ds);
      put_row(vp_s + (sh * kKC + sj) * P3v, vpt, P3v);
    }
    __syncthreads();
    if (j0 + kKC < L) fetch_v(j0 + kKC);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int h = warp + kWarps * u;
      if (h >= H) continue;
      // A: p of rows g, g + 8 and keys 2t.., 2t + 8.. (zero past L and
      // past the block's rows), rounded to bf16 (split for f32).
      const float* pa = p_s + h * pl.ldp + j0 + 2 * t;
      const size_t rs = static_cast<size_t>(H) * pl.ldp;
      auto pget = [&](int r, int c) -> float2 {
        return r < IB ? *reinterpret_cast<const float2*>(pa + r * rs + c)
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
      const float* vb = vs_s + (h * kKC + 2 * t) * pl.ldv + g;
#pragma unroll
      for (int n = 0; n < kMaxDT; ++n) {
        if (n >= dtiles) break;
        const float* c = vb + 8 * n;
        uint32_t b0, b1, b0l, b1l;
        frag<SPLIT>(c[0], c[pl.ldv], b0, b0l);
        frag<SPLIT>(c[8 * pl.ldv], c[9 * pl.ldv], b1, b1l);
        mma3<SPLIT>(acc_s[u][n], af, al, b0, b1, b0l, b1l);
      }
    }
    const int nj = min(kKC, L - j0);
    if constexpr (kRegPoints) {
      if (pt_own) {
        const float* pr = p_s + pt_rh * pl.ldp + j0;
        const float* vr = vp_s + pt_h * kKC * P3V + pt_half * kPE;
#pragma unroll
        for (int jj = 0; jj < kKC; ++jj) {
          if (jj >= nj) break;
          const float p = pr[jj];
          const float4* v4 = reinterpret_cast<const float4*>(vr + jj * P3V);
#pragma unroll
          for (int q = 0; q < kPE / 4; ++q) {
            const float4 w = v4[q];
            acc_p[4 * q] += p * w.x;
            acc_p[4 * q + 1] += p * w.y;
            acc_p[4 * q + 2] += p * w.z;
            acc_p[4 * q + 3] += p * w.w;
          }
        }
      }
    } else {
      for (int idx = tid; idx < rows * H * P3v; idx += kThreads) {
        const int e = idx % P3v, rh = idx / P3v, h = rh % H;
        const float* pr = p_s + rh * pl.ldp + j0;
        const float* vr = vp_s + h * kKC * P3v + e;
        float s = accp[idx];
#pragma unroll
        for (int jj = 0; jj < kKC; ++jj)
          if (jj < nj) s += pr[jj] * vr[jj * P3v];
        accp[idx] = s;
      }
    }
  }
  // Scalar attend out: lane (g, t) holds rows g, g + 8, dims 2t, 2t + 1 of
  // each n8 tile.
  T* out_s = static_cast<T*>(a.out_s);
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int h = warp + kWarps * u;
    if (h >= H) continue;
#pragma unroll
    for (int n = 0; n < kMaxDT; ++n) {
      if (n >= dtiles) break;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int r = g + 8 * (x >> 1);
        if (r >= rows) continue;
        const int d = 8 * n + 2 * t + (x & 1);
        out_s[(static_cast<size_t>(b) * L + i0 + r) * H * Ds + h * Ds + d] =
            from_f32<T>(acc_s[u][n][x]);
      }
    }
  }
  if constexpr (kRegPoints) {
    if (pt_own) {
#pragma unroll
      for (int e = 0; e < kPE; ++e)
        a.out_p[(static_cast<size_t>(b) * L + i0) * H * P3V +
                pt_rh * P3V + pt_half * kPE + e] = acc_p[e];
    }
  } else {
    for (int idx = tid; idx < rows * H * P3v; idx += kThreads)
      a.out_p[(static_cast<size_t>(b) * L + i0) * H * P3v + idx] =
          accp[idx];
  }

  // --- pair attend: per row, P (heads as M) x pair[b, i] (L x C) ---------
  // The (row, 32-key chunk) sequence streams through the ring; warp w owns
  // the n8 channel tiles w, w + 8, w + 16, w + 24 (those below C / 8).
  __syncthreads();  // the value chunk region becomes the ring
  const T* pair = static_cast<const T*>(a.pair);
  const int nkc = lpad / kPC, n_steps = rows * nkc;
  constexpr int kVec = 16 / sizeof(T);
  const int pieces = kPC * C / kVec;
  auto issue = [&](int step) {
    if (step < n_steps) {
      const int r = step / nkc, j0 = (step % nkc) * kPC;
      const T* src = pair + ((static_cast<size_t>(b) * L + i0 + r) * L + j0) *
                                static_cast<size_t>(C);
      T* dst = ring + (step % kPStages) * kPC * pl.ldb;
      for (int v = tid; v < pieces; v += kThreads) {
        const int jj = v / (C / kVec), c = (v % (C / kVec)) * kVec;
        const bool ok = j0 + jj < L;
        cp_async16(dst + jj * pl.ldb + c, ok ? src + jj * C + c : src, ok);
      }
    }
    cp_async_commit();
  };
  for (int s = 0; s < kPStages - 1; ++s) issue(s);
  const int ctiles = C / 8;
  float acc[4][4];
  T* out_2d = static_cast<T*>(a.out_2d);
  for (int step = 0; step < n_steps; ++step) {
    const int r = step / nkc, kc = step % nkc;
    if (kc == 0) {
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[n][x] = 0.f;
    }
    cp_async_wait<kPStages - 2>();
    __syncthreads();
    issue(step + kPStages - 1);
    const T* st = ring + (step % kPStages) * kPC * pl.ldb;
    const float* pa = p_s + r * H * pl.ldp + kc * kPC + 2 * t;
#pragma unroll
    for (int ks2 = 0; ks2 < kPC / 16; ++ks2) {
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
      for (int n = 0; n < 4; ++n) {
        const int tile = warp + kWarps * n;
        if (tile >= ctiles) break;
        uint32_t b0, b1, b0l = 0, b1l = 0;
        if constexpr (SPLIT) {
          const T* c = st + (16 * ks2 + 2 * t) * pl.ldb + 8 * tile + g;
          frag<true>(to_f32(c[0]), to_f32(c[pl.ldb]), b0, b0l);
          frag<true>(to_f32(c[8 * pl.ldb]), to_f32(c[9 * pl.ldb]), b1, b1l);
        } else {
          // keys 16 ks2 + 0..7 and + 8..15 of channels 8 tile .. + 7,
          // transposed: (keys 2t, 2t + 1; channel g).
          uint32_t rr[4];
          ldmatrix_x4_trans(
              rr, st + (16 * ks2 + (lane & 15)) * pl.ldb + 8 * tile);
          b0 = rr[0];
          b1 = rr[1];
        }
        mma3<SPLIT>(acc[n], af, al, b0, b1, b0l, b1l);
      }
    }
    if (kc == nkc - 1) {
      const size_t orow = (static_cast<size_t>(b) * L + i0 + r) * H * C;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int tile = warp + kWarps * n;
        if (tile >= ctiles) break;
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int h = g + 8 * (x >> 1);
          if (h < H)
            out_2d[orow + h * C + 8 * tile + 2 * t + (x & 1)] =
                from_f32<T>(acc[n][x]);
        }
      }
    }
  }
  cp_async_wait<0>();
}

// Rows a block: the fewest blocks that still fill every SM once, then
// fewer rows while the shared memory does not fit.
int rows_per_block(int B, int L, int H, int Ds, int P3q, int P3v, int C,
                   int tsize, size_t smem_max) {
  int sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int ib = (B * L + sms - 1) / sms;
  ib = ib < 1 ? 1 : (ib > kMaxIB ? kMaxIB : ib);
  while (ib > 1 &&
         Plan(L, H, Ds, P3q, P3v, C, ib, tsize).total > smem_max)
    --ib;
  return ib;
}

template <typename T, int DS, int P3Q, int P3V>
cudaError_t launch_ipa_inst(const IpaArgs& a, int B, size_t smem,
                            cudaStream_t stream) {
  cudaError_t e = set_smem(ipa_kernel<T, DS, P3Q, P3V>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.L + a.IB - 1) / a.IB, B);
  ipa_kernel<T, DS, P3Q, P3V><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_ipa(IpaArgs a, int B, cudaStream_t stream) {
  constexpr size_t kSmemMax = 227 * 1024;
  if (a.Ds > kMaxDs || a.P3q > kMaxP3 || a.P3v > kMaxP3 || a.H > 16)
    return cudaErrorInvalidValue;
  a.IB = rows_per_block(B, a.L, a.H, a.Ds, a.P3q, a.P3v, a.C, sizeof(T),
                        kSmemMax);
  const size_t smem =
      Plan(a.L, a.H, a.Ds, a.P3q, a.P3v, a.C, a.IB, sizeof(T)).total;
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  if (a.Ds == 16 && a.P3q == 12 && a.P3v == 24 && 2 * a.IB * a.H <= kThreads)
    return launch_ipa_inst<T, 16, 12, 24>(a, B, smem, stream);
  return launch_ipa_inst<T, 0, 0, 0>(a, B, smem, stream);
}

}  // namespace
}  // namespace abx

// dtype: 0 = float32, 1 = bfloat16 (qs, ks, vs, pair, out_s, out_2d; the
// bias in that dtype or, with bias_f32, in float32).  Strides in elements:
// qs / ks / vs / qp / kp / vp as (batch, position, head) with the last
// axis contiguous; bias as (batch, head, query, key).  pair (B, L, L, C)
// contiguous and 16-byte aligned; Ds a multiple of 16, at most 32; C a
// multiple of 16, at most 256; H at most 16; 3 Pq and 3 Pv at most 48 (the
// wrapper checks).
extern "C" int abx_ipa_attention(
    int dtype, const void* qs, int qs_b, int qs_l, int qs_h, const void* ks,
    int ks_b, int ks_l, int ks_h, const void* vs, int vs_b, int vs_l,
    int vs_h, const float* qp, int qp_b, int qp_l, int qp_h, const float* kp,
    int kp_b, int kp_l, int kp_h, const float* vp, int vp_b, int vp_l,
    int vp_h, const float* pw, const void* bias, int bs_b, int bs_h,
    int bs_i, int bs_j, int bias_f32, const float* mask, const void* pair,
    void* out_s, float* out_p, void* out_2d, int B, int L, int H, int Ds,
    int P3q, int P3v, int C, void* stream) {
  abx::IpaArgs a{qs,   qs_b, qs_l, qs_h, ks,   ks_b, ks_l, ks_h, vs,
                 vs_b, vs_l, vs_h, qp,   qp_b, qp_l, qp_h, kp,   kp_b,
                 kp_l, kp_h, vp,   vp_b, vp_l, vp_h, pw,   bias, bs_b,
                 bs_h, bs_i, bs_j, bias_f32, mask, pair, out_s, out_p,
                 out_2d, L,    H,    Ds,   P3q,  P3v,  C,    0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? abx::launch_ipa<float>(a, B, s)
                    : abx::launch_ipa<abx::bf16>(a, B, s);
}
