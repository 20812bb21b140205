// K12: the JAX kernels' 18 x 15-bit field multiplication _mul_t, chained.
//
// Replaces the field-multiplication probes of scripts/bench_roofline.py
// (lane_call(make_fm), :57, body :108-127), bench_fe13.py (k15, :143-152)
// and bench_qtile.py's tile sweep (:41-72): _mul_t (xelis_he_tpu/ops/
// pallas_msm.py:67-108, _carry_t :54-64) repeated reps times on 4 chains
// of a lane, out the XOR of the chains, limb for limb the JAX helper's.
//
// Bound: operations, 344 u32 multiplies a _mul_t (324 products, 17 times
// 19 and one times 361 in the fold, one times 19 in each carry) against 144
// bytes a lane.  One thread a lane (a column of the (18, T) arrays, read
// and written coalesced), its 4 chains and the operand in registers.
//
// The JAX kernels split every product at bit 15 (a mask and a shift) and add
// both halves, because the TPU's u32 lanes needed every column below 2^32.
// On the H100 that is about three ALU operations beside each multiply, and
// the ALU pipe issues no faster than the multiply's FMA pipe: that body,
// carried over instruction for instruction, ran at about a third of the
// bound.  The column-sum form (probes.cuh mul_t) adds whole products and
// their high parts apart and splits once per column: a product is one
// multiply, a shift-and-add (LEA.HI) and half a three-way add.  (Taking some
// rows' high parts from mad.hi.u32 on the FMA pipe instead was measured and
// lost: a mad.hi costs 2.5 u32 issue slots, PERF.md section 6.)
//
// The block width is a launch argument (128, 256 or 512 threads), each width
// its own instantiation with __launch_bounds__ of that width: the H100's
// counterpart of bench_qtile.py's tile widths.

#include <cuda_runtime.h>

#include "probes.cuh"

using namespace xhe;

// one block an SM at least: ptxas may take 255 registers a thread at 128 and
// 256 threads (one block of 256 an SM ran ~5% faster than two at 128
// registers)
template <int B>
__global__ void __launch_bounds__(B, 1)
    probe_mul15_kernel(const uint32_t *__restrict__ x, const uint32_t *__restrict__ y, uint32_t *__restrict__ out,
                       int T, int reps) {
  const int t = blockIdx.x * B + threadIdx.x;
  if (t < T) probe_mul15(out, x, y, T, t, reps);
}

template <int B>
static void launch(const void *x, const void *y, void *out, int T, int reps, cudaStream_t stream) {
  probe_mul15_kernel<B><<<(T + B - 1) / B, B, 0, stream>>>((const uint32_t *)x, (const uint32_t *)y,
                                                            (uint32_t *)out, T, reps);
}

// x, y, out: (18, T); block: 128, 256 or 512
extern "C" int xhe_probe_mul15(const void *x, const void *y, void *out, int T, int reps, int block, void *stream) {
  if (block != 128 && block != 256 && block != 512) return (int)cudaErrorInvalidValue;
  if (T > 0) {
    if (block == 128)
      launch<128>(x, y, out, T, reps, (cudaStream_t)stream);
    else if (block == 256)
      launch<256>(x, y, out, T, reps, (cudaStream_t)stream);
    else
      launch<512>(x, y, out, T, reps, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}
