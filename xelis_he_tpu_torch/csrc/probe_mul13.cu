// K13: the JAX kernels' 20 x 13-bit field multiplication and its carry
// variants, chained.
//
// Replaces scripts/bench_roofline.py's lane_call13(make_fm13) (:135, body
// :148-167) and bench_fe13.py's k_full, k_def and k_def2 (:51, :79-140):
// mode 0 is _mul13 (xelis_he_tpu/ops/pallas_msm.py:1078-1091, the 3-pass
// _carry13_mul_out :1065), mode 2 the script's _mul13_2pass (bench_fe13.py
// :79-95: the fold, a wide and a simple carry, row 0 left above 13 bits),
// mode 1 that form with the consumer's _carry13; each repeated reps times on
// 4 chains of a lane, out the XOR of the chains, limb for limb the JAX
// helpers'.
//
// Bound: operations, 400 products and 41 multiplies by 608 a multiplication
// (42 with the consumer's carry) against 160 bytes a lane.  The 13-bit limbs
// need no split of a product (20 of them sum below 2^31), which is what made
// this the TPU's faster tier.  One thread a lane, as K12; each mode its own
// instantiation.

#include <cuda_runtime.h>

#include "probes.cuh"

using namespace xhe;

constexpr int BLOCK = 256;

template <int MODE>
__global__ void __launch_bounds__(BLOCK)
    probe_mul13_kernel(const uint32_t *__restrict__ x, const uint32_t *__restrict__ y, uint32_t *__restrict__ out,
                       int T, int reps) {
  const int t = blockIdx.x * BLOCK + threadIdx.x;
  if (t < T) probe_mul13<MODE>(out, x, y, T, t, reps);
}

// x, y, out: (20, T); mode: MUL13_3PASS, MUL13_2PASS_CONSUMER or MUL13_2PASS
extern "C" int xhe_probe_mul13(const void *x, const void *y, void *out, int T, int reps, int mode, void *stream) {
  if (mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
  if (T > 0) {
    const dim3 grid((T + BLOCK - 1) / BLOCK);
    const uint32_t *a = (const uint32_t *)x, *b = (const uint32_t *)y;
    uint32_t *o = (uint32_t *)out;
    cudaStream_t s = (cudaStream_t)stream;
    if (mode == MUL13_3PASS)
      probe_mul13_kernel<MUL13_3PASS><<<grid, BLOCK, 0, s>>>(a, b, o, T, reps);
    else if (mode == MUL13_2PASS_CONSUMER)
      probe_mul13_kernel<MUL13_2PASS_CONSUMER><<<grid, BLOCK, 0, s>>>(a, b, o, T, reps);
    else
      probe_mul13_kernel<MUL13_2PASS><<<grid, BLOCK, 0, s>>>(a, b, o, T, reps);
  }
  return (int)cudaGetLastError();
}
