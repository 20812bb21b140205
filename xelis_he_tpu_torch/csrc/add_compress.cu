// K8: batched point addition and ristretto255 encode, lane i = a[i or 0] +
// b[i or 0] (a side of one row is broadcast over the lanes).
//
// Replaces no Pallas kernel: the JAX package's ECDLP (xelis_he_tpu/ecdlp.py
// ECDLPTables.build and par_decode) adds in XLA (curve.add) and encodes with
// its accelerator's compress.  One launch serves both of the port's uses:
//   the table build: a = a chunk of baby steps (n rows), b = the step point
//   (broadcast); every lane's encoding and sum (the next chunk) are written;
//   a giant-step round: a = the cursor (broadcast), b = the lane offsets and,
//   as one more lane, the big step; every lane's encoding is written and only
//   the last lane's sum (the next cursor): sums go out for lanes i >=
//   sums_from, to sums[i - sums_from].
//
// Bound: operations.  A lane is one unified addition (9 multiplications)
// and one encode (32 multiplications and 255 squarings, one inverse square
// root in a dependent chain) against at most 288 + 288 + 32 + 288 bytes.
// One thread a lane with K4's body (compress.cu, whose note says why one
// thread a point beat a point over several warps); the sum stays in
// registers between the addition and the encode.

#include <cuda_runtime.h>

#include "ed25519.cuh"

using namespace xhe;

__global__ void __launch_bounds__(128)
    add_compress_kernel(const int32_t *__restrict__ a, const int32_t *__restrict__ b,
                        uint8_t *__restrict__ enc, int32_t *__restrict__ sums, int a_rows, int b_rows,
                        int sums_from, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  alignas(16) uint8_t bytes[32];
  int32_t *sum = (sums != nullptr && i >= sums_from) ? sums + 72 * (size_t)(i - sums_from) : nullptr;
  add_compress_one(bytes, sum, a + 72 * (size_t)(a_rows == 1 ? 0 : i), b + 72 * (size_t)(b_rows == 1 ? 0 : i));
  uint4 *dst = reinterpret_cast<uint4 *>(enc + 32 * (size_t)i);
  dst[0] = *reinterpret_cast<const uint4 *>(bytes);
  dst[1] = *reinterpret_cast<const uint4 *>(bytes + 16);
}

extern "C" int xhe_add_compress(const void *a, const void *b, void *enc, void *sums, int a_rows, int b_rows,
                                int sums_from, int n, void *stream) {
  if (n > 0) {
    add_compress_kernel<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
        (const int32_t *)a, (const int32_t *)b, (uint8_t *)enc, (int32_t *)sums, a_rows, b_rows, sums_from, n);
  }
  return (int)cudaGetLastError();
}
