// K6: 8-packed windowed lanes on the 15-bit field tier,
// slot = sum_{k<8} s_k * P_k.
//
// Replaces xelis_he_tpu/ops/pallas_msm.py _windowed_kernel_k4 (the 18x15-bit
// tier of the packed lanes kernel, selected by XELIS_FE13=0).  The function,
// the signature and the point formulas are those of windowed_lanes.cu: both
// instantiate windowed_slot_k8 of ed25519.cuh, this one over fe15 (eighteen
// 15-bit limbs, 324 products a multiplication, 171 a squaring, 64-bit column
// sums) where the default runs radix 2^25.5 (100 and 55).  The boundary rows
// are 15-bit limbs already, so nothing is repacked at the edges.  Two
// independent arithmetics under one algorithm: each holds the other to
// account on edge scalars.
//
// Bound: operations, 5,336 field multiplications and 1,152 squarings per
// slot, about three times the default tier's products, against ~3 KB of
// inputs.  One thread per slot, the undivided body that K2 split; the eight
// 9-entry niels tables (20 KB a thread) sit in local memory.  fe15's multiplication and squaring are real calls, not
// inlined, which keeps the build time and the code size near the default
// kernel's at the cost of passing operands through local memory.

#include <cuda_runtime.h>

#include "ed25519.cuh"

using namespace xhe;

__global__ void __launch_bounds__(64)
    windowed_lanes_k8_fe15_kernel(const int32_t *__restrict__ pts,
                                  const uint8_t *__restrict__ digits, int32_t *__restrict__ out,
                                  int S) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  windowed_slot_k8<fe15>(out + (size_t)s * 72, pts, digits, S, s);
}

extern "C" int xhe_windowed_lanes_k8_fe15(const void *pts, const void *digits, void *out, int S,
                                          void *stream) {
  if (S > 0) {
    windowed_lanes_k8_fe15_kernel<<<(S + 63) / 64, 64, 0, (cudaStream_t)stream>>>(
        (const int32_t *)pts, (const uint8_t *)digits, (int32_t *)out, S);
  }
  return (int)cudaGetLastError();
}
