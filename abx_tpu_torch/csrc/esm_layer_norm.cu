// ESM2's LayerNorm in eval mode, one row of D channels at a time:
//   out = (x - mean) * rsqrt(var + eps) * w + b in f32, rounded once to the
//   dtype of x, w, b and out (f32 or bf16, one dtype as the module holds it).
//
// Replaces no pallas_call.  On the TPU, XLA fuses the JAX package's one-pass
// `modules.layer_norm` (abx_tpu/models/modules.py:138, called by
// abx_tpu/models/esm.py:215 `_esm_layer_norm`) into one read of x and one
// write; in eager PyTorch the same function is 14 launches, each a full pass
// over the activations, most of them in f32.
// Bound on the H100: device-memory bytes.  A call reads x and writes out once
// with ~6 flops an element: at ESM2-3B's (16 x 306, 2560) in bf16,
// 2 x 25.07 MB = 50.1 MB, 15.0 us at 3.35 TB/s.  The D weights and biases are
// read through L2 by every row and add no device-memory traffic.
// Design:
// - 32 x wpr lanes a row (wpr warps: 1 where the row is at most 32 x 10
//   16-byte pieces, so up to D = 2560 in bf16), 8 warps a block.  Lane t of a
//   row takes the 16-byte pieces t, t + 32 wpr, ..., so each load and store
//   instruction of a warp moves whole 128-byte lines.
// - The row stays in registers, as its raw pieces, between the sums and the
//   write: a lane issues all its loads before its first add, and x is read
//   from device memory once.
// - The moments are the JAX package's inference form, in f32 in the one
//   sweep: Sx and Sxx, mean = Sx / D, var = max(Sxx / D - mean^2, 0), reduced
//   by shuffles within a warp and through shared memory across a row's warps.
// - Each product and sum of the output is rounded as the plain version
//   rounds it (no contraction into an FMA), then once to the output dtype;
//   the weight and bias are read a piece at a time as the row is written.
#include "common.cuh"

namespace abx {
namespace esm_ln {

constexpr int kMaxD = 5120;
constexpr int kMaxPieces = 10;  // 16-byte pieces of x a lane holds

struct Args {
  const void* x;  // (rows, D), dtype T
  const void* w;  // (D,), dtype T
  const void* b;  // (D,), dtype T
  void* out;      // (rows, D), dtype T
  int rows, D, wpr;
  float eps;
};

// The elements of T in a 16-byte piece, as f32.  The piece is taken by
// value: a piece in device memory is read by one 16-byte load, not element
// by element.
template <typename T>
__device__ __forceinline__ void piece_f32(const uint4 q, float* v) {
  const T* e = reinterpret_cast<const T*>(&q);
#pragma unroll
  for (int k = 0; k < 16 / int(sizeof(T)); ++k) v[k] = to_f32(e[k]);
}

// V: 16-byte pieces of x a lane holds (the least that covers the row).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    esm_layer_norm_kernel(const Args a) {
  constexpr int kVec = 16 / sizeof(T);  // elements in a piece
  __shared__ float2 part[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wpr = a.wpr;
  const int group = warp / wpr;                // the block's row
  const int t = (warp % wpr) * 32 + lane;      // lane within the row
  const int lanes = wpr * 32;
  const int64_t row = int64_t(blockIdx.x) * (kWarps / wpr) + group;
  const bool live = row < a.rows;
  const int pieces = a.D / kVec;
  const uint4* x = static_cast<const uint4*>(a.x) + row * pieces;

  uint4 raw[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int p = i * lanes + t;
    raw[i] = live && p < pieces ? x[p] : make_uint4(0u, 0u, 0u, 0u);
  }
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    float v[kVec];
    piece_f32<T>(raw[i], v);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      s += v[k];
      ss += v[k] * v[k];
    }
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  if (wpr > 1) {  // uniform over the block
    if (lane == 0) part[warp] = make_float2(s, ss);
    __syncthreads();
    s = ss = 0.f;
    for (int j = 0; j < wpr; ++j) {
      const float2 q = part[group * wpr + j];
      s += q.x;
      ss += q.y;
    }
  }
  if (!live) return;
  const float d = static_cast<float>(a.D);
  const float mean = __fdiv_rn(s, d);
  const float var =
      fmaxf(__fsub_rn(__fdiv_rn(ss, d), __fmul_rn(mean, mean)), 0.f);
  const float r = rsqrtf(__fadd_rn(var, a.eps));

  const uint4* w = static_cast<const uint4*>(a.w);
  const uint4* b = static_cast<const uint4*>(a.b);
  uint4* out = static_cast<uint4*>(a.out) + row * pieces;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int p = i * lanes + t;
    if (p >= pieces) break;
    float v[kVec], wv[kVec], bv[kVec];
    piece_f32<T>(raw[i], v);
    piece_f32<T>(w[p], wv);
    piece_f32<T>(b[p], bv);
    uint4 q;
    T* e = reinterpret_cast<T*>(&q);
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      e[k] = from_f32<T>(__fadd_rn(
          __fmul_rn(__fmul_rn(__fsub_rn(v[k], mean), r), wv[k]), bv[k]));
    out[p] = q;
  }
}

template <typename T, int V>
cudaError_t launch_v(const Args& a, int blocks, int v, cudaStream_t s) {
  if constexpr (V < kMaxPieces) {
    if (v > V) return launch_v<T, V + 1>(a, blocks, v, s);
  }
  esm_layer_norm_kernel<T, V><<<blocks, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(Args a, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const int pieces = a.D / kVec;
  a.wpr = 1;
  while ((pieces + 32 * a.wpr - 1) / (32 * a.wpr) > kMaxPieces) a.wpr *= 2;
  const int v = (pieces + 32 * a.wpr - 1) / (32 * a.wpr);
  const int rows_per_block = kWarps / a.wpr;
  const int blocks = (a.rows + rows_per_block - 1) / rows_per_block;
  return launch_v<T, 1>(a, blocks, v, s);
}

}  // namespace esm_ln
}  // namespace abx

// dtype code of x, w, b and out alike: 0 float32, 1 bfloat16.  x and out
// (rows, D) contiguous, w and b (D,) contiguous, all 16-byte aligned; D a
// multiple of 8, at most 5120.
extern "C" int abx_esm_layer_norm(int dtype, const void* x, const void* w,
                                  const void* b, void* out, int rows, int D,
                                  float eps, void* stream) {
  namespace el = abx::esm_ln;
  if (D <= 0 || D % 8 || D > el::kMaxD || rows < 0 || dtype < 0 || dtype > 1)
    return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const el::Args a{x, w, b, out, rows, D, 1, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? el::launch<abx::bf16>(a, s) : el::launch<float>(a, s);
}
