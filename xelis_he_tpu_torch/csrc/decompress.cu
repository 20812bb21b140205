// K1: batched validating ristretto255 decode.
//
// Replaces xelis_he_tpu/ops/pallas_msm.py _decompress_kernel (and the
// bit-255 check of its wrapper decompress_pallas).  One thread per
// encoding reads its 32 bytes and writes canonical (X, Y, 1, T) rows plus a
// valid flag; invalid encodings give the identity (0, 1, 1, 0).
//
// Bound: operations, reached only as far as latency allows.  Each encoding
// costs one inverse square root (~250 squarings) against 32 bytes in and
// 289 bytes out.  Each thread's chain is serial, so the card nears its issue
// rate only with several warps a scheduler to interleave: at 194 registers
// (2 blocks of 128 an SM, 2 warps a scheduler) the kernel reached half its
// bound.  decompress_one now holds only the chain's value over the chain and
// recomputes the rest from the encoding after it, and __launch_bounds__
// caps the registers at 128 (4 blocks an SM, 4 warps a scheduler) with no
// spills.  3 blocks, and two rounds of parallel carries in place of
// fe_reduce64's chain (~10 more instructions a field operation), were
// slower (PERF.md, PR 4).  The wrapper launches exactly the caller's
// encodings; the last block masks its ragged edge.

#include <cuda_runtime.h>

#include "ed25519.cuh"

using namespace xhe;

__global__ void __launch_bounds__(128, 4)
    decompress_kernel(const uint8_t *__restrict__ enc, int32_t *__restrict__ rows,
                      uint8_t *__restrict__ valid, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bool ok = decompress_one(rows + 72 * (size_t)i, reinterpret_cast<const uint32_t *>(enc + 32 * (size_t)i));
  valid[i] = ok ? 1 : 0;
}

extern "C" int xhe_decompress(const void *enc, void *rows, void *valid, int n, void *stream) {
  if (n > 0) {
    decompress_kernel<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
        (const uint8_t *)enc, (int32_t *)rows, (uint8_t *)valid, n);
  }
  return (int)cudaGetLastError();
}
