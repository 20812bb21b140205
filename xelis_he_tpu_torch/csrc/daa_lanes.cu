// K7: per-lane binary double-and-add, lane i = s_i * P_i over 253 bits.
//
// Replaces xelis_he_tpu/ops/pallas_msm.py _daa_kernel (wrapper
// msm_daa_lanes_pallas), the kernel form of MsmEngine.msm_daa_lanes.  Bits
// arrive packed 32 to a word, (8, N) words, LSB first (pack_bits); each of
// the 253 steps adds the running base where the bit is set and doubles the
// base.  The TPU kernel computed the sum on every step and selected by the
// bit; scalars are public, so here a thread branches on its bit and skips
// the addition.  The results are the same points coordinate by coordinate.
//
// Bound: operations, 1,012 multiplications and 1,012 squarings per lane for
// the doublings plus 9 multiplications per set bit, against 608 bytes moved.
// One thread per lane with both points in registers; the word rows are read
// coalesced.  Lanes of a warp diverge on their bits, so a warp pays for an
// addition on nearly every step.  The addition is a real call (ge_add_call in
// ed25519.cuh says why), the doubling is inlined.

#include <cuda_runtime.h>

#include "ed25519.cuh"

using namespace xhe;

__global__ void __launch_bounds__(128)
    daa_lanes_kernel(const int32_t *__restrict__ pts, const int32_t *__restrict__ bits,
                     int32_t *__restrict__ out, int N) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  daa_lane(out + (size_t)i * 72, pts, bits, N, i);
}

extern "C" int xhe_daa_lanes(const void *pts, const void *bits, void *out, int N, void *stream) {
  if (N > 0) {
    daa_lanes_kernel<<<(N + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
        (const int32_t *)pts, (const int32_t *)bits, (int32_t *)out, N);
  }
  return (int)cudaGetLastError();
}
