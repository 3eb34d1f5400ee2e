// Attention cores of the triangle / seq attentions.
//
// abx_tri_attention_core replaces the softmax-attend body of
// abx_tpu/ops/tri_attention.py::triangle_attention_packed (rows) and of
// ::triangle_attention_packed_cols (columns: the ending-node attention on
// the natural pair tensor), both Pallas TPU kernels.  Their wrappers
// (abx_tpu_torch/ops/tri_attention.py) run them as launches of this
// repository's kernels: row_linear.cu for LN + the fused [q|k|v|gate]
// projection of the natural rows, this kernel, and (rows, with out_proj)
// row_linear.cu again for the out-proj + bias + residual epilogue.
// Bound on the H100: at the flagship tri-attention shape (B=4, R=L=288,
// H=4, D=48) the logits are 4*288*4*288*288 f32 = 1.5 GB if materialised;
// here they live only in shared memory.  The products are a small part of
// the time; the softmax (exp, row max/sum shuffles) and the block's
// barrier phases bound it.
// Design: the shared core of attention.cuh, reading q / k / v / gate as
// column blocks of the fused projection rows, with the (B, H, L, L) bias
// in the input dtype.  The query scale D^-1/2 is folded into wq by the
// wrapper.  For columns, query / key position l of column i is projection
// row (b*L + l)*L + i: the core's row stride walks the columns, its
// position stride whole rows of the pair, and the output is written to
// the same natural places, so no transpose goes through device memory.
//
// abx_triangle_attention_fused replaces
// abx_tpu/ops/tri_attention.py::triangle_attention_fused: head-major q, k,
// v (B, R, H, L, D), an f32 (B, H, L, L) bias shared by the rows, the
// query scale D^-1/2 applied in f32 to q . k (the TPU kernel scales the
// f32-upcast q and takes both products in f32; here they are bf16 with
// f32 accumulation for bf16 inputs, bf16x3 for f32, and P is rounded to
// bf16 for PV in the bf16 kernel).  At the flagship shape q, k, v and out
// are 4 x 127 MB: bytes bound it (0.154 ms at 3.35 TB/s against 0.074 ms
// of bf16 tensor-core work).
#include <cmath>

#include "attention.cuh"

// y: (B*R*L, ldy) rows [q (H*D) | k (H*D) | v (H*D) | gate (H*D)?], in the
// natural order of a (B, R, L) tensor, R == L for columns; bias: (B, H, L,
// L) in the input dtype; maskbias: (B, L) f32 additive; out: (B*R*L, H*D)
// in the same order as y.
extern "C" int abx_tri_attention_core(int dtype, const void* y, int ldy,
                                      int B, int R, int L, int H, int D,
                                      const void* bias, const float* maskbias,
                                      int has_gate, int bf16_exp, int columns,
                                      void* out, void* stream) {
  const size_t es = dtype == 0 ? sizeof(float) : sizeof(abx::bf16);
  const long long hd = (long long)H * D;
  const char* base = static_cast<const char*>(y);
  const long long rl = (long long)R * L;
  // Rows: row r of batch b is the run of L positions at (b*R + r)*L.
  // Columns: column i of batch b takes every L-th row from b*L*L + i.
  const abx::Strides in =
      columns ? abx::Strides{rl * ldy, ldy, (long long)L * ldy, D}
              : abx::Strides{rl * ldy, (long long)L * ldy, ldy, D};
  const abx::Strides os = columns ? abx::Strides{rl * hd, hd, L * hd, D}
                                  : abx::Strides{rl * hd, L * hd, hd, D};
  abx::AttnArgs a;
  a.q = base;
  a.k = base + hd * es;
  a.v = base + 2 * hd * es;
  a.gate = has_gate ? base + 3 * hd * es : nullptr;
  a.bias = bias;
  a.bias_f32 = 0;
  a.maskbias = maskbias;
  a.out = out;
  a.qs = a.ks = a.vs = a.gs = in;
  a.os = os;
  a.R = R;
  a.L = L;
  a.H = H;
  a.D = D;
  a.qscale = 1.f;
  a.bf16_exp = bf16_exp;
  return abx::launch_attention(dtype, a, B, stream);
}

// q, k, v, out: contiguous (B, R, H, L, D); bias: (B, H, L, L) f32;
// maskbias: (B, L) f32 additive.
extern "C" int abx_triangle_attention_fused(int dtype, const void* q,
                                            const void* k, const void* v,
                                            const float* bias,
                                            const float* maskbias, void* out,
                                            int B, int R, int H, int L, int D,
                                            void* stream) {
  const long long ld = (long long)L * D;
  const abx::Strides s{(long long)R * H * ld, H * ld, D, ld};
  abx::AttnArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.gate = nullptr;
  a.bias = bias;
  a.bias_f32 = 1;
  a.maskbias = maskbias;
  a.out = out;
  a.qs = a.ks = a.vs = a.gs = a.os = s;
  a.R = R;
  a.L = L;
  a.H = H;
  a.D = D;
  a.qscale = (float)std::pow((double)D, -0.5);  // D ** -0.5, as the TPU
  a.bf16_exp = 0;
  return abx::launch_attention(dtype, a, B, stream);
}
