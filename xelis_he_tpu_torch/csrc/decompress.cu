// K1: batched validating ristretto255 decode.
//
// Replaces xelis_he_tpu/ops/pallas_msm.py _decompress_kernel (and the
// bit-255 check of its wrapper decompress_pallas).  One thread per
// encoding reads its 32 bytes and writes canonical (X, Y, 1, T) rows plus a
// valid flag; invalid encodings give the identity (0, 1, 1, 0).
//
// Bound: operations.  Each encoding costs one inverse square root (~250
// squarings) against 32 bytes in and 289 bytes out, so the kernel is
// compute-bound on 32-bit multiply-adds; one thread per encoding keeps the
// whole chain in registers with no shared memory and no synchronisation.

#include <cuda_runtime.h>

#include "ed25519.cuh"

using namespace xhe;

__global__ void __launch_bounds__(128)
    decompress_kernel(const uint8_t *__restrict__ enc, int32_t *__restrict__ rows,
                      uint8_t *__restrict__ valid, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  alignas(16) uint8_t b[32];
  const uint4 *src = reinterpret_cast<const uint4 *>(enc + 32 * (size_t)i);
  *reinterpret_cast<uint4 *>(b) = src[0];
  *reinterpret_cast<uint4 *>(b + 16) = src[1];
  const bool ok = decompress_one(rows + 72 * (size_t)i, b);
  valid[i] = ok ? 1 : 0;
}

extern "C" int xhe_decompress(const void *enc, void *rows, void *valid, int n, void *stream) {
  if (n > 0) {
    decompress_kernel<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
        (const uint8_t *)enc, (int32_t *)rows, (uint8_t *)valid, n);
  }
  return (int)cudaGetLastError();
}
