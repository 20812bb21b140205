// K6: 8-packed windowed lanes on the 15-bit field tier,
// slot = sum_{k<8} s_k * P_k.
//
// Replaces xelis_he_tpu/ops/pallas_msm.py _windowed_kernel_k4 (the 18x15-bit
// tier of the packed lanes kernel, selected by XELIS_FE13=0).  The function,
// the signature, the point formulas and the design are those of
// windowed_lanes.cu (K2): both run windowed_part_k8 and combine_parts of
// ed25519.cuh, this one over fe15 (eighteen 15-bit limbs, 324 products a
// multiplication, 171 a squaring, 64-bit column sums) where K2 runs radix
// 2^25.5 (100 and 55).  The boundary rows are 15-bit limbs already, so
// nothing is repacked at the edges.  Two independent arithmetics under one
// algorithm: each holds the other to account on edge scalars.
//
// Bound: operations, 5,336 field multiplications and 1,152 squarings per
// slot, about three times K2's products, against ~3 KB of inputs.  One
// thread a slot with its tables in local memory (20.7 KB a thread) ran a
// chain of ~5,950 field operations with 2 warps an SM, and every table
// lookup whose entry differed by thread touched a 128-byte line for each of
// the entry's 72 words.  So, as in K2, a slot is split over T = K6_SPLIT
// threads laid out tid = j * SLOTS + slot (a warp's digit loads coalesce),
// each with its own accumulator over 8/T subs, and the partial sums meet in
// shared memory, where thread 0 of the slot adds them (T - 1 unified
// additions).  The work rises with T (1.70x the function's at T = 4:
// k6_executed in ops/kernels.py) while the chain shortens and the threads
// quadruple.  On the H100 T = 4 was the fastest of T = 1, 2 and 4 (PERF.md):
// unlike K2's, fe15's products pass their operands through the stack, and
// the latency that costs wants more warps.  At 255 registers a thread the
// SM holds 8 warps, which 7,936 slots at T = 4 about fill.
//
// The niels tables live in a device scratch the wrapper allocates: entry a
// of sub k of slot s at (9 k + a) S + s, 288 contiguous bytes read as
// eighteen 16-byte loads.  At 7,936 slots the scratch is ~165 MB, more than
// the 50 MB L2, so a launch's ~1.2 GB of table reads come from device
// memory: ~0.35 ms at 3.35 TB/s, under the operations bound.  A layout with
// the words of an entry interleaved across slots (word w of every slot's
// entry side by side) would put a warp's reads in one line only where the
// 32 slots pick the same entry, which signed digits of random scalars almost
// never do; it was not tried.  fe15's multiplication and squaring stay real
// calls: inlined, they spilled ~5 KB a thread and the kernel was 38% slower
// at T = 4, with a build of ~5 minutes against seconds (PERF.md).

#include <cuda_runtime.h>

#include "ed25519.cuh"

using namespace xhe;

constexpr int SLOTS = 32;  // slots a block
constexpr int T = K6_SPLIT;

__global__ void __launch_bounds__(SLOTS * T)
    windowed_lanes_k8_fe15_kernel(const int32_t *__restrict__ pts, const uint8_t *__restrict__ digits,
                                  int32_t *__restrict__ out, ge_niels_t<fe15> *__restrict__ tables, int S) {
  __shared__ ge_t<fe15> parts[SLOTS][T];
  const int slot = threadIdx.x % SLOTS, j = threadIdx.x / SLOTS;
  const int s = blockIdx.x * SLOTS + slot;
  if (s < S) {
    ge_t<fe15> acc;
    windowed_part_k8<fe15, T>(acc, tables + (size_t)j * (8 / T) * K2_TABLE * S + s, S, pts, digits, S, s, j);
    parts[slot][j] = acc;
  }
  __syncthreads();
  if (j == 0 && s < S) {
    combine_parts<fe15, T>(parts[slot]);
    ge_to_rows(out + (size_t)s * 72, parts[slot][0]);
  }
}

// tables: scratch of 8 x 9 x S fe15 niels entries (288 B each, 16-byte aligned)
extern "C" int xhe_windowed_lanes_k8_fe15(const void *pts, const void *digits, void *out, void *tables,
                                          int S, void *stream) {
  if (S > 0) {
    windowed_lanes_k8_fe15_kernel<<<(S + SLOTS - 1) / SLOTS, SLOTS * T, 0, (cudaStream_t)stream>>>(
        (const int32_t *)pts, (const uint8_t *)digits, (int32_t *)out, (ge_niels_t<fe15> *)tables, S);
  }
  return (int)cudaGetLastError();
}
