// Micro-benchmark behind the triangle_multiply design (csrc/triangle.cu):
// how fast the SMs take in operand data from L2 when every piece is W
// contiguous bytes of a (B, L, L, 128) bf16 tensor's cells (256 bytes
// apart), at a fixed 48 KB per block and step, through a 3-stage cp.async
// ring.  A natural-layout contraction that holds C channels of a cell per
// block reads pieces of W = 2C bytes.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace {

constexpr int kStepBytes = 48 * 1024;
constexpr int kCellStride = 256;

template <int W>
__global__ void __launch_bounds__(256) ingest(const unsigned char* base,
                                              int L, int steps) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kCells = kStepBytes / W, kPer = W / 16, kRows = kCells / 16;
  const int blk = blockIdx.x;
  const int row0 = (blk * 37) % (L - kRows);
  const size_t batch = static_cast<size_t>(blk % 4) * L * L * kCellStride;
  const int part = ((blk / 4) % (kCellStride / W)) * W;
  for (int s = 0; s < steps; ++s) {
    unsigned char* dst = smem + (s % 3) * kStepBytes;
    for (int v = threadIdx.x; v < kCells * kPer; v += 256) {
      const int q = v % kPer, cell = v / kPer, r = cell / 16, k = cell % 16;
      const unsigned char* src =
          base + batch +
          (static_cast<size_t>(row0 + r) * L + (s * 16 + k) % L) *
              kCellStride +
          part + q * 16;
      abx::cp_async16(dst + cell * W + q * 16, src, true);
    }
    abx::cp_async_commit();
    abx::cp_async_wait<1>();
    __syncthreads();
  }
  abx::cp_async_wait<0>();
}

template <int W>
cudaError_t launch(const void* base, int L, int steps, int blocks,
                   cudaStream_t stream) {
  const int smem = 3 * kStepBytes;
  cudaError_t e = cudaFuncSetAttribute(
      ingest<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  ingest<W><<<blocks, 256, smem, stream>>>(
      static_cast<const unsigned char*>(base), L, steps);
  return cudaGetLastError();
}

}  // namespace

// Pieces of w bytes (16, 32, 64, 128 or 256) from a (4, L, L, 256-byte)
// tensor at base; `steps` steps of 48 KB in each of `blocks` blocks.
extern "C" int abx_l2_pieces(int w, const void* base, int L, int steps,
                             int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (w) {
    case 16: return launch<16>(base, L, steps, blocks, s);
    case 32: return launch<32>(base, L, steps, blocks, s);
    case 64: return launch<64>(base, L, steps, blocks, s);
    case 128: return launch<128>(base, L, steps, blocks, s);
    case 256: return launch<256>(base, L, steps, blocks, s);
  }
  return cudaErrorInvalidValue;
}
