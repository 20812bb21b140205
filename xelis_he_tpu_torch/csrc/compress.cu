// K4: batched ristretto255 encode.
//
// Replaces xelis_he_tpu/ops/pallas_msm.py _compress_kernel together with the
// limb-to-byte shuffle of its wrapper (_limbs_to_bytes).  One thread per
// point reads its (4, 18) rows and writes the 32 encoding bytes directly.
// The encoding is 32 zero bytes exactly for the identity class, so the
// caller also reads identity checks off this kernel.
//
// Bound: latency.  The main path's launch is 10,242 points, one inverse
// square root each (~290 field operations in one dependent chain): 81
// blocks of 128 leave 51 SMs idle and give each scheduler one warp, which
// waits on its own chain (~540 cycles a field operation).  More or smaller
// blocks change nothing; only a shorter chain a point would.
//
// A point spread over 2 or 4 warps (each warp a share of every product's
// column sums, exchanged through shared memory behind one __syncthreads, each
// warp carrying them itself) lost to this one-thread body on the H100: the
// exchange and the carry each warp repeats cost more than the products they
// split (PERF.md, PR 4).  So each point stays one thread (T = 1).

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
