// K7: per-lane binary double-and-add, lane i = s_i * P_i over 253 bits.
//
// Replaces xelis_he_tpu/ops/pallas_msm.py _daa_kernel (wrapper
// msm_daa_lanes_pallas), the kernel form of MsmEngine.msm_daa_lanes.  Bits
// arrive packed 32 to a word, (8, N) words, LSB first (pack_bits); each of
// the 253 steps adds the running base where the bit is set and doubles the
// base.  As the TPU kernel does, the sum is computed on every step and
// selected by the bit.
//
// Bound: operations, 1,012 multiplications and 1,012 squarings per lane for
// the doublings plus 9 multiplications per set bit, against 608 bytes moved.
// The work is a chain: 253 dependent doublings.  One thread a lane ran ~17
// dependent field operations a step, and MsmEngine.msm_daa's 512 lanes
// filled 4 of the 132 SMs.  So a lane is held by a quad of threads (the
// round functions in ed25519.cuh): a step is two rounds, each of one or two
// independent field operations a thread (role 2 takes a third product in
// round 1), so the chain floor is 253 doublings of two rounds each.  After
// each round the quad gathers its four results with __shfl_sync inside the
// quad (10 words each, 160 shuffles a step): no shared memory, no barrier.
// The select keeps the quad convergent; a warp of 8 lanes would pay for an
// addition on all but 2^-8 of its steps even with a branch.  What the select
// executes, 253 additions a lane, is k7_executed in ops/kernels.py.  Blocks
// of 32 threads spread the 2,048 threads of 512 lanes over 64 SMs.  The quad
// issues about twice the instructions of one thread a lane (the adds of
// E..H on every thread, the shuffles and the picks), which a card that is
// full of lanes pays for (PERF.md).

#include <cuda_runtime.h>

#include "ed25519.cuh"

using namespace xhe;

constexpr int BLOCK = 32;  // threads a block: 8 lanes

__global__ void __launch_bounds__(BLOCK)
    daa_lanes_kernel(const int32_t *__restrict__ pts, const int32_t *__restrict__ bits,
                     int32_t *__restrict__ out, int N) {
  const int tid = blockIdx.x * BLOCK + threadIdx.x;
  const int i = tid / K7_QUAD, r = tid % K7_QUAD;
  if (i >= N) return;  // whole quads leave: the quads that stay are full
  const unsigned mask = 0xfu << (threadIdx.x & 31 & ~(K7_QUAD - 1));
  ge acc, base;
  ge_identity(acc);
  ge_from_rows(base, pts + (size_t)i * 72);
#pragma unroll 1
  for (int k = 0; k < 253; ++k) {
    const bool bit = daa_bit(bits, N, i, k);
    fe sq, pr, sqs[K7_QUAD], prs[K7_QUAD];
    daa_round1(sq, pr, acc, base, r);
    quad_gather(sqs, sq, mask);
    quad_gather(prs, pr, mask);
    fe dbl, add, dbls[K7_QUAD], adds[K7_QUAD];
    daa_round2(dbl, add, sqs, prs, r);
    quad_gather(dbls, dbl, mask);
    quad_gather(adds, add, mask);
    daa_step_end(acc, base, dbls, adds, bit);
  }
  daa_write(out + (size_t)i * 72, acc, r);
}

extern "C" int xhe_daa_lanes(const void *pts, const void *bits, void *out, int N, void *stream) {
  if (N > 0) {
    const long threads = (long)N * K7_QUAD;
    daa_lanes_kernel<<<(unsigned)((threads + BLOCK - 1) / BLOCK), BLOCK, 0, (cudaStream_t)stream>>>(
        (const int32_t *)pts, (const int32_t *)bits, (int32_t *)out, N);
  }
  return (int)cudaGetLastError();
}
