// K14: the port's own field multiplication and squaring, chained.
//
// No Pallas kernel: the H100 counterpart of the probes' "production field
// multiplication".  The TPU's probes time _mul_t and _mul13, the JAX
// kernels' field; the port's kernels multiply with ed25519.cuh's fe_mul and
// fe_sq on the radix-2^25.5 tier (K1-K5, K7-K10) and on fe15 (K6), and this
// times those, reps times on 4 chains of a lane, each chain written out.
//
// Bound: operations, ops/kernels.py's MULADDS_PER_FIELD_MUL/_SQ (and _MUL15/
// _SQ15 on fe15) a multiplication, against 80 (fe15: 144) bytes in and four
// times that out a lane.  One thread a lane: this is a rate at which an end
// kernel's field count (FIELD_MULS/FIELD_SQS) predicts its time.  fe15's
// fe_mul and fe_sq are real calls (XHE_NOINLINE), as in K6.

#include <cuda_runtime.h>

#include "probes.cuh"

using namespace xhe;

constexpr int BLOCK = 256;

template <class F, bool SQ>
__global__ void __launch_bounds__(BLOCK)
    probe_fe_kernel(const uint32_t *__restrict__ x, const uint32_t *__restrict__ y, uint32_t *__restrict__ out,
                    int T, int reps) {
  const int t = blockIdx.x * BLOCK + threadIdx.x;
  if (t < T) probe_fe<F, SQ>(out, x, y, T, t, reps);
}

template <class F, bool SQ>
static void launch(const void *x, const void *y, void *out, int T, int reps, cudaStream_t stream) {
  probe_fe_kernel<F, SQ><<<(T + BLOCK - 1) / BLOCK, BLOCK, 0, stream>>>((const uint32_t *)x, (const uint32_t *)y,
                                                                        (uint32_t *)out, T, reps);
}

// x, y: (10, T) limbs (fe15: (18, T)); out: (4, 10 or 18, T), the chains
extern "C" int xhe_probe_fe(const void *x, const void *y, void *out, int T, int reps, int fe15, int square,
                            void *stream) {
  if (T > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (fe15)
      square ? launch<xhe::fe15, true>(x, y, out, T, reps, s) : launch<xhe::fe15, false>(x, y, out, T, reps, s);
    else
      square ? launch<fe, true>(x, y, out, T, reps, s) : launch<fe, false>(x, y, out, T, reps, s);
  }
  return (int)cudaGetLastError();
}
