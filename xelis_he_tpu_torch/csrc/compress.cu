// K4: batched ristretto255 encode.
//
// Replaces xelis_he_tpu/ops/pallas_msm.py _compress_kernel together with the
// limb-to-byte shuffle of its wrapper (_limbs_to_bytes).  One thread per
// point reads its (4, 18) rows and writes the 32 encoding bytes directly.
// The encoding is 32 zero bytes exactly for the identity class, so the
// caller also reads identity checks off this kernel.
//
// Bound: operations (one inverse square root per point against 288 bytes in
// and 32 out); one thread per point keeps the chain in registers.

#include <cuda_runtime.h>

#include "ed25519.cuh"

using namespace xhe;

__global__ void __launch_bounds__(128)
    compress_kernel(const int32_t *__restrict__ rows, uint8_t *__restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  alignas(16) uint8_t b[32];
  compress_one(b, rows + 72 * (size_t)i);
  uint4 *dst = reinterpret_cast<uint4 *>(out + 32 * (size_t)i);
  dst[0] = *reinterpret_cast<const uint4 *>(b);
  dst[1] = *reinterpret_cast<const uint4 *>(b + 16);
}

extern "C" int xhe_compress(const void *rows, void *out, int n, void *stream) {
  if (n > 0) {
    compress_kernel<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
        (const int32_t *)rows, (uint8_t *)out, n);
  }
  return (int)cudaGetLastError();
}
