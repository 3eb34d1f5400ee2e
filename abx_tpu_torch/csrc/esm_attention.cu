// ESM2 self-attention: per (batch, head), softmax(q k^T + key-pad bias) v.
//
// Replaces abx_tpu/ops/esm_attention.py::esm_attention (Pallas TPU), which
// holds one head's whole (L x L) f32 logits in VMEM.  At the ESM2-3B shape
// (B=4, H=40, L=306, D=64) those are 375 KB per head, more than a Hopper
// SM's shared memory, so the kernel is the flash-style core of
// attention.cuh instead: one block per (64-query block, head, batch), an
// online f32 softmax over 64-key blocks, bf16 m16n16k16 tensor-core
// products (bf16x3 for f32 operands) and no bias operand; the pad mask is
// an f32 additive row (BIG_NEG).  L = 306 leaves a ragged last block of 50
// queries and keys, zero-padded in shared memory and masked.
// Bound on the H100 (bf16): q, k, v and the output are 4 x 6.3 MB, read
// and written once (7.5 us at 3.35 TB/s), against 3.8 GFLOP of products
// (3.9 us at 989 TFLOP/s): bytes bound it.  The core re-reads k / v once
// per query block (5 blocks at L = 306, from L2) and runs five barriers
// per key block; making it reach the bound (TMA, wgmma, one block per
// head holding all queries) is later work.
// q / k / v / out are read and written through strides: the wrapper hands
// in head-major views of the (B, L, H, D) projection output, so no
// transpose copies are made.
#include "attention.cuh"

// q, k, v: (B, H, L, D) views; strides[12] = (b, l, h) element strides of
// q, k, v and out, in that order; maskbias: (B, L) f32 additive.
extern "C" int abx_esm_attention(int dtype, const void* q, const void* k,
                                 const void* v, const float* maskbias,
                                 void* out, const long long* strides, int B,
                                 int L, int H, int D, void* stream) {
  abx::AttnArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.gate = nullptr;
  a.bias = nullptr;
  a.bias_f32 = 0;
  a.maskbias = maskbias;
  a.out = out;
  a.qs = abx::Strides{strides[0], 0, strides[1], strides[2]};
  a.ks = abx::Strides{strides[3], 0, strides[4], strides[5]};
  a.vs = abx::Strides{strides[6], 0, strides[7], strides[8]};
  a.gs = a.qs;
  a.os = abx::Strides{strides[9], 0, strides[10], strides[11]};
  a.R = 1;
  a.L = L;
  a.H = H;
  a.D = D;
  a.qscale = 1.f;
  a.bf16_exp = 0;
  return abx::launch_attention(dtype, a, B, stream);
}
