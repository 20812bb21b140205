// K11: the card's integer multiply-add rate, x = x * y + 1 on 4 chains.
//
// Replaces the raw u32 multiply-add probe of scripts/bench_roofline.py
// (lane_call(make_raw), :57, body :83-101): 81 steps a rep on 4 independent
// chains, out the XOR of the chains.  Every element of the (rows, T) input
// is its own lane, as every limb row is on the TPU: one thread an element.
//
// Bound: operations, 324 multiply-adds an element a rep against 12 bytes
// moved.  The 4 chains give each warp 4 independent multiply-adds in flight;
// the reps loop stays rolled (#pragma unroll 1) around 324 unrolled ones,
// so the loop's own instructions are ~1% of its body.  Inputs come from
// memory and the XOR is written out, so the compiler cannot fold a chain.
//
// The wide form runs each chain as acc = lo(acc) * y + acc with a 64-bit
// sum: one 32 x 32 -> 64-bit multiply-add a step, the operation of the
// CUDA field's column sums (ed25519.cuh fe_mul, fe15's fe_mul).  Its rate
// against the u32 form's says what a wide product costs in issue slots,
// which the kernels' bounds (ops/kernels.py MULADDS_PER_FIELD_*) charge.
//
// The high form runs each chain as x = hi32(x * y) + x, one mad.hi.u32 a
// step: what a product's high part costs on the FMA pipe, in u32 slots
// (K12's mul_t takes it on the ALU instead, with LEA.HI).

#include <cuda_runtime.h>

#include "probes.cuh"

using namespace xhe;

constexpr int BLOCK = 256;

__global__ void __launch_bounds__(BLOCK)
    probe_imad_kernel(const uint32_t *__restrict__ x, const uint32_t *__restrict__ y, uint32_t *__restrict__ out,
                      int n, int reps) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i < n) out[i] = probe_imad(x[i], y[i], reps);
}

__global__ void __launch_bounds__(BLOCK)
    probe_imad_wide_kernel(const uint32_t *__restrict__ x, const uint32_t *__restrict__ y,
                           uint32_t *__restrict__ out, int n, int reps) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i < n) out[i] = probe_imad_wide(x[i], y[i], reps);
}

__global__ void __launch_bounds__(BLOCK)
    probe_imad_hi_kernel(const uint32_t *__restrict__ x, const uint32_t *__restrict__ y,
                         uint32_t *__restrict__ out, int n, int reps) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i < n) out[i] = probe_imad_hi(x[i], y[i], reps);
}

// n elements; form 0 for the u32 chain, 1 for the 64-bit one, 2 for the
// high word's
extern "C" int xhe_probe_imad(const void *x, const void *y, void *out, int n, int reps, int form, void *stream) {
  if (form < 0 || form > 2) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const dim3 grid((n + BLOCK - 1) / BLOCK);
    const uint32_t *xs = (const uint32_t *)x, *ys = (const uint32_t *)y;
    cudaStream_t s = (cudaStream_t)stream;
    if (form == 1)
      probe_imad_wide_kernel<<<grid, BLOCK, 0, s>>>(xs, ys, (uint32_t *)out, n, reps);
    else if (form == 2)
      probe_imad_hi_kernel<<<grid, BLOCK, 0, s>>>(xs, ys, (uint32_t *)out, n, reps);
    else
      probe_imad_kernel<<<grid, BLOCK, 0, s>>>(xs, ys, (uint32_t *)out, n, reps);
  }
  return (int)cudaGetLastError();
}
