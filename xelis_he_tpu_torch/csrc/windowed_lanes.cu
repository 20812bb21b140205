// K2: 8-packed windowed lanes, slot = sum_{k<8} s_k * P_k.
//
// Replaces xelis_he_tpu/ops/pallas_msm.py _windowed_kernel_k4_fe13 (the
// 20x13-bit tier of the packed lanes kernel, msm_windowed_lanes_pallas_k4).
// Same algorithm: each sub k builds a 1P..8P table in niels form, then 64
// windows from the top each run 4 doublings of the one shared accumulator
// and 8 signed-digit table adds.  Digits are stored as e + 8 with e in
// [-7, 8]; stored 8 (e = 0) adds the identity niels entry (1, 1, 0, 2).
//
// Bound: operations, 5,336 field multiplications and 1,152 squarings per
// slot against ~3 KB of
// inputs.  One thread per slot keeps the accumulator in registers; the eight
// 8-entry niels tables (~10 KB per thread) sit in local memory (L1/L2), read
// once per table add.  The radix-2^25.5 limbs with 64-bit column sums
// cannot overflow, which removes the u32-overflow hazard of the TPU's 13-bit
// tier.  First redesign candidate: the local-memory tables and the low
// thread count (one per slot) at blocks of 10,000 transactions.

#include <cuda_runtime.h>

#include "ed25519.cuh"

using namespace xhe;

__global__ void __launch_bounds__(64)
    windowed_lanes_k8_kernel(const int32_t *__restrict__ pts, const uint8_t *__restrict__ digits,
                             int32_t *__restrict__ out, int S) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  windowed_slot_k8<fe>(out + (size_t)s * 72, pts, digits, S, s);
}

extern "C" int xhe_windowed_lanes_k8(const void *pts, const void *digits, void *out, int S,
                                     void *stream) {
  if (S > 0) {
    windowed_lanes_k8_kernel<<<(S + 63) / 64, 64, 0, (cudaStream_t)stream>>>(
        (const int32_t *)pts, (const uint8_t *)digits, (int32_t *)out, S);
  }
  return (int)cudaGetLastError();
}
