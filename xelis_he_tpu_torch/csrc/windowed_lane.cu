// K5: single-lane windowed scalar multiplication, lane i = s_i * P_i.
//
// Replaces xelis_he_tpu/ops/pallas_msm.py _windowed_kernel (wrapper
// msm_windowed_lanes_pallas).  Same sequence of formulas: an extended table
// 1P..8P per lane, then 64 signed 4-bit windows from the top, each 4
// doublings (T only on the 4th), a table pick with negation of X and T, and
// one unified addition.  Digits are stored as e + 8 with e in [-7, 8]; stored
// 8 (e = 0) picks the identity.
//
// Bound: operations, 1,451 field multiplications and 1,040 squarings per lane
// against 640 bytes moved.  One thread per lane: the accumulator lives in
// registers and the 8-entry extended table (1,280 bytes) in local memory,
// an eighth of the packed kernel's tables; the digit rows (64, N) are read
// coalesced across the lanes of a warp.  A lane pays the whole doubling chain
// for one scalar, some 2.6 times the packed kernel's work per scalar, which
// is why the packed kernel is the default and this one serves lane counts
// that do not fill whole packed tiles.

#include <cuda_runtime.h>

#include "ed25519.cuh"

using namespace xhe;

__global__ void __launch_bounds__(128)
    windowed_lane_kernel(const int32_t *__restrict__ pts, const uint8_t *__restrict__ digits,
                         int32_t *__restrict__ out, int N) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  windowed_lane(out + (size_t)i * 72, pts, digits, N, i);
}

extern "C" int xhe_windowed_lanes(const void *pts, const void *digits, void *out, int N,
                                  void *stream) {
  if (N > 0) {
    windowed_lane_kernel<<<(N + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
        (const int32_t *)pts, (const uint8_t *)digits, (int32_t *)out, N);
  }
  return (int)cudaGetLastError();
}
