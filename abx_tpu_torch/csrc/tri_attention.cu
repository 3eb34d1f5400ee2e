// Attention cores of the triangle / seq attentions, on the register-resident
// flash core of flash_attention.cuh (its instances with a bias).
//
// abx_tri_attention_core replaces the softmax-attend body of
// abx_tpu/ops/tri_attention.py::triangle_attention_packed (rows) and of
// ::triangle_attention_packed_cols (columns: the ending-node attention on
// the natural pair tensor), both Pallas TPU kernels.  Their wrappers
// (abx_tpu_torch/ops/tri_attention.py) run them as launches of this
// repository's kernels: row_linear.cu for LN + the fused [q|k|v|gate]
// projection of the natural rows, this kernel, and (rows, with out_proj)
// row_linear.cu again for the out-proj + bias + residual epilogue.  It
// reads q / k / v / gate as column blocks of the projection rows y, with
// the (B, H, L, L) bias in the input dtype and the (B, L) f32 key mask;
// the query scale D^-1/2 is folded into wq by the wrapper.  For columns,
// query / key position l of column i is projection row (b*L + l)*L + i:
// the core's row stride walks the columns, its position stride whole rows
// of the pair, and the output is written to the same natural places, so
// no transpose goes through device memory.  With bf16_exp (bf16 only) the
// exponent is the TPU kernel's, exp(bf16(s - m)) rounded to bf16 with m
// the row's final max (two passes over the keys, flash_attention.cuh).
//
// abx_triangle_attention_fused replaces
// abx_tpu/ops/tri_attention.py::triangle_attention_fused: head-major q, k,
// v (B, R, H, L, D), an f32 (B, H, L, L) bias shared by the rows, the
// query scale D^-1/2 applied in f32 to q . k (the TPU kernel scales the
// f32-upcast q and takes both products in f32; here they are bf16 with
// f32 accumulation for bf16 inputs, bf16x3 for f32), with the online f32
// exponent.
//
// Bound on the H100 at the flagship shapes (B=4, R=L=288, H=4, D=48,
// bf16), bytes both:
// - rows: y (q, k, v, gate) 510 MB read and the output 127 MB written
//   (0.19 ms at 3.35 TB/s) against 73 GFLOP of products (0.074 ms);
// - row 13: q, k, v and the output 4 x 127 MB and the f32 bias 5.3 MB
//   (0.154 ms).
// What the design moves besides: each block reads K and V of its rows
// once per query tile, from L2 after the first (288-key rows of 96-byte
// pieces), and the QB x 64 bias tiles of its (b, h) once for its RB rows.
// Per (b, r, h) at the flagship shape, with nq = L / QB query tiles,
// K is 27.6 KB x nq (x 2 with the bf16 exponent's two passes), V 27.6 KB
// x nq and the bias 166 KB (332 KB f32; x 2 passes) / RB; without the
// sharing the bias alone would be 764 MB (bf16) or 1.53 GB (f32, row 13)
// of L2 reads a call.  Those bytes are not what sets the time (see
// flash_attention.cuh).  The query tile and rows a block were chosen on
// the card: tools/tune_tri_attention.py builds this file with -DABX_TRI_QW
// and -DABX_TRI_RB and times each.  96-query tiles (L = 288 in three, none
// half empty) and two rows a block were the fastest on the bf16-exponent
// tri shape, which the design path runs 54 times a num_t 8 design, and on
// the seq shape; one row a block was a few percent faster on the f32
// exponent (row 13, the exponent off), 64-query tiles and four rows a
// block slower everywhere (NVIDIA H100 80GB HBM3, 700 W).
#include <cmath>

#include "flash_attention.cuh"

#ifndef ABX_TRI_QW
#define ABX_TRI_QW 6  // warps of 16 queries a row group: 96-query tiles
#endif
#ifndef ABX_TRI_RB
#define ABX_TRI_RB 2  // rows a block, sharing each bias tile
#endif

namespace {

int launch_tri(int dtype, const abx::flash::Args& a, int B, int bf16_exp,
               void* stream) {
  namespace flash = abx::flash;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int QW = ABX_TRI_QW, RB = ABX_TRI_RB;
  if (dtype == 0) return flash::launch_d<float, QW, RB, true, false>(a, B, s);
  if (bf16_exp)
    return flash::launch_d<abx::bf16, QW, RB, true, true>(a, B, s);
  return flash::launch_d<abx::bf16, QW, RB, true, false>(a, B, s);
}

}  // namespace

// y: (B*R*L, ldy) rows [q (H*D) | k (H*D) | v (H*D) | gate (H*D)?], in the
// natural order of a (B, R, L) tensor, R == L for columns; bias: (B, H, L,
// L) in the input dtype; mask: (B, L) f32, 1 = valid key; out: (B*R*L, H*D)
// in the same order as y.  D <= 128.
extern "C" int abx_tri_attention_core(int dtype, const void* y, int ldy,
                                      int B, int R, int L, int H, int D,
                                      const void* bias, const float* mask,
                                      int has_gate, int bf16_exp, int columns,
                                      void* out, void* stream) {
  namespace flash = abx::flash;
  const size_t es = dtype == 0 ? sizeof(float) : sizeof(abx::bf16);
  const long long hd = (long long)H * D;
  const char* base = static_cast<const char*>(y);
  const long long rl = (long long)R * L;
  // Rows: row r of batch b is the run of L positions at (b*R + r)*L.
  // Columns: column i of batch b takes every L-th row from b*L*L + i.
  const flash::Strides in =
      columns ? flash::Strides{rl * ldy, ldy, (long long)L * ldy, D}
              : flash::Strides{rl * ldy, (long long)L * ldy, ldy, D};
  const flash::Strides os = columns ? flash::Strides{rl * hd, hd, L * hd, D}
                                    : flash::Strides{rl * hd, L * hd, hd, D};
  flash::Args a{};
  a.q = base;
  a.k = base + hd * es;
  a.v = base + 2 * hd * es;
  a.gate = has_gate ? base + 3 * hd * es : nullptr;
  a.bias = bias;
  a.bias_f32 = dtype == 0;
  a.mask = mask;
  a.out = out;
  a.qs = a.ks = a.vs = a.gs = in;
  a.os = os;
  a.R = R;
  a.L = L;
  a.H = H;
  a.D = D;
  a.qscale = 1.f;
  return launch_tri(dtype, a, B, bf16_exp, stream);
}

// q, k, v, out: contiguous (B, R, H, L, D); bias: (B, H, L, L) f32;
// mask: (B, L) f32, 1 = valid key.  D <= 128.
extern "C" int abx_triangle_attention_fused(int dtype, const void* q,
                                            const void* k, const void* v,
                                            const float* bias,
                                            const float* mask, void* out,
                                            int B, int R, int H, int L, int D,
                                            void* stream) {
  namespace flash = abx::flash;
  const long long ld = (long long)L * D;
  const flash::Strides s{(long long)R * H * ld, H * ld, D, ld};
  flash::Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.bias = bias;
  a.bias_f32 = 1;
  a.mask = mask;
  a.out = out;
  a.qs = a.ks = a.vs = a.os = s;
  a.R = R;
  a.L = L;
  a.H = H;
  a.D = D;
  a.qscale = (float)std::pow((double)D, -0.5);  // D ** -0.5, as the TPU
  return launch_tri(dtype, a, B, 0, stream);
}
