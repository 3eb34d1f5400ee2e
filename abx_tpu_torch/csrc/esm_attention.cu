// ESM2 self-attention: per (batch, head), softmax(q k^T + key-pad bias) v.
//
// Replaces abx_tpu/ops/esm_attention.py:47 esm_attention (Pallas TPU),
// which holds one head's whole (L x L) f32 logits in VMEM.  At the ESM2-3B
// shape (B=4, H=40, L=306, D=64) those are 375 KB per head, more than a
// Hopper SM's shared memory, so the kernel is the register-resident flash
// core of flash_attention.cuh (its instances without a bias): one 4-warp
// block per (64 queries, head, batch), K / V streamed through a cp.async
// ring, S, P and O in registers, the key-pad mask read as the (B, L) bool
// row itself (no f32 bias tensor is built per call).  L = 306 leaves a
// ragged last block of 50 queries and keys, zero-filled and masked.
// Bound on the H100 (bf16): q, k, v and the output are 4 x 6.3 MB, read
// and written once (7.5 us at 3.35 TB/s), against 3.8 GFLOP of products
// (3.9 us at 989 TFLOP/s): bytes bound it.  The design keeps the logits,
// probabilities and output out of shared and device memory and runs one
// barrier per 64-key tile; k / v are read once per query block (5 at
// L = 306), from L2 after the first.
// q / k / v / out are read and written through strides: the wrapper hands
// in head-major views of the (B, L, H, D) projection output, so no
// transpose copies are made.
//
// The flash route (abx_tpu/models/esm.py:117 _esm_flash_attention, the
// stock TPU flash kernel with segment ids) has its entry,
// abx_esm_flash_attention, in esm_flash_sm90.cu: bf16 on the Hopper kernel
// there, f32 on this core's segment mode (flash_attention.cuh).
#include "flash_attention.cuh"

// q, k, v: (B, H, L, D) views; strides[12] = (b, l, h) element strides of
// q, k, v and out, in that order; key_pad: (B, L) bool, true = padded.
// D at most 128 (the wrapper takes multiples of 8 with 16-byte aligned
// rows).  Returns the cudaError_t of the launch.
extern "C" int abx_esm_attention(int dtype, const void* q, const void* k,
                                 const void* v, const void* key_pad,
                                 void* out, const long long* strides, int B,
                                 int L, int H, int D, void* stream) {
  namespace flash = abx::flash;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 4-warp blocks of 64 queries, no bias, the online f32 exponent.
  return dtype == 0 ? flash::launch_d<float, 4, 1, false, false>(a, B, s)
                    : flash::launch_d<abx::bf16, 4, 1, false, false>(a, B, s);
}
