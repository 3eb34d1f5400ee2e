// Attention core of the packed triangle / seq attention.
//
// Replaces the softmax-attend body of
// abx_tpu/ops/tri_attention.py::triangle_attention_packed (Pallas TPU).
// The wrapper (abx_tpu_torch/ops/tri_attention.py) runs it as three
// launches of this repository's kernels: row_linear.cu for LN + the fused
// [q|k|v|gate] projection, this kernel, and row_linear.cu again for the
// out-proj + bias + residual epilogue.
// Bound on the H100: at the flagship tri-attention shape (B=4, R=L=288,
// H=4, D=48) the logits are 4*288*4*288*288 f32 = 1.5 GB if materialised;
// here they live only in shared memory.  The products are a small part of
// the time; the softmax (exp, row max/sum shuffles) and the block's
// barrier phases bound it.
// Design: the shared core of attention.cuh, reading q / k / v / gate as
// column blocks of the fused projection rows, with the (B, H, L, L) bias
// in the input dtype.  The query scale D^-1/2 is folded into wq by the
// wrapper.
#include "attention.cuh"

// y: (B*R*L, ldy) rows [q (H*D) | k (H*D) | v (H*D) | gate (H*D)?];
// bias: (B, H, L, L) in the input dtype; maskbias: (B, L) f32 additive;
// out: (B*R*L, H*D).
extern "C" int abx_tri_attention_core(int dtype, const void* y, int ldy,
                                      int B, int R, int L, int H, int D,
                                      const void* bias, const float* maskbias,
                                      int has_gate, void* out, void* stream) {
  const size_t es = dtype == 0 ? sizeof(float) : sizeof(abx::bf16);
  const long long hd = (long long)H * D;
  const char* base = static_cast<const char*>(y);
  const abx::Strides in{(long long)L * ldy, ldy, D};
  abx::AttnArgs a;
  a.q = base;
  a.k = base + hd * es;
  a.v = base + 2 * hd * es;
  a.gate = has_gate ? base + 3 * hd * es : nullptr;
  a.bias = bias;
  a.maskbias = maskbias;
  a.out = out;
  a.qs = a.ks = a.vs = a.gs = in;
  a.os = abx::Strides{L * hd, hd, D};
  a.R = R;
  a.L = L;
  a.H = H;
  a.D = D;
  return abx::launch_attention(dtype, a, B, stream);
}
