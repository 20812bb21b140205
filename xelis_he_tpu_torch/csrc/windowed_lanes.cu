// K2: 8-packed windowed lanes, slot = sum_{k<8} s_k * P_k.
//
// Replaces xelis_he_tpu/ops/pallas_msm.py _windowed_kernel_k4_fe13 (the
// 20x13-bit tier of the packed lanes kernel, msm_windowed_lanes_pallas_k4).
// Same function: each sub k builds a 1P..8P table in niels form, and 64
// signed 4-bit windows from the top add s_k P_k into the slot.  Digits are
// stored as e + 8 with e in [-7, 8]; stored 8 (e = 0) adds the identity niels
// entry (1, 1, 0, 2).
//
// Bound: operations, 5,336 field multiplications and 1,152 squarings per
// slot against ~3 KB of inputs.  One thread per slot left the card nearly
// empty at a 10,000-transaction block (7,936 threads, 2 warps an SM) and ran
// ~5,950 dependent field operations in one chain.  So a slot is split over
// T = K2_SPLIT threads (ed25519.cuh): thread j of a slot owns subs
// [j 8/T, (j+1) 8/T), builds their tables and runs its own accumulator, 4
// doublings and 8/T table adds a window.  The T partial sums meet in shared
// memory, where thread 0 of the slot adds them by a tree of T - 1 unified
// additions and writes the canonical rows.  Each thread doubles its own
// accumulator, so the work rises with T (1.24x the function's at T = 2,
// 1.70x at T = 4) while the chain shortens (~3,900 and ~2,900 field
// operations) and the thread count doubles or quadruples.  T = 2 was the
// faster of T = 1, 2 and 4 on the H100 (PERF.md), so it is the constant
// K2_SPLIT: at T = 4 the card is full and the 1.70x work is paid in issue
// slots.
//
// Threads are laid out tid = j * SLOTS + slot, so the lanes of a warp are 32
// neighbouring slots with one j: the digit loads digits[(k 64 + w) S + s]
// coalesce across the warp.
//
// The niels tables (5.8 KB a thread at T = 2) cannot sit in shared memory
// at the occupancy the split is for (~120 threads an SM x 5.8 KB > 227 KB).
// In local memory the hardware interleaves a thread's words 4 bytes at a
// time across the warp, so a lookup whose entry differs by thread touches a
// 128-byte line for every word: 40 lines for a 160-byte entry.  So the
// wrapper hands the kernel a device scratch (tables: 8 x 9 entries a slot),
// where entry a of sub k of slot s lies at (9 k + a) S + s and is 160
// contiguous bytes, read as ten 16-byte loads.  A table add reads 160 B
// through L1/L2, ~650 MB a launch of 7,936 slots (and 91 MB of tables
// written), ~0.2 ms at 3.35 TB/s even from device memory: under the
// operations bound.  Tensor cores do not serve this: integer MMA is int8 x
// int8 -> int32, and a 255-bit product in 8-bit limbs is ~1,024 partial
// products against the 100 of radix 2^25.5.

#include <cuda_runtime.h>

#include "ed25519.cuh"

using namespace xhe;

constexpr int SLOTS = 32;  // slots a block
constexpr int T = K2_SPLIT;

__global__ void __launch_bounds__(SLOTS * T)
    windowed_lanes_k8_kernel(const int32_t *__restrict__ pts, const uint8_t *__restrict__ digits,
                             int32_t *__restrict__ out, ge_niels *__restrict__ tables, int S) {
  __shared__ ge parts[SLOTS][T];
  const int slot = threadIdx.x % SLOTS, j = threadIdx.x / SLOTS;
  const int s = blockIdx.x * SLOTS + slot;
  if (s < S) {
    ge acc;
    windowed_part_k8<fe, T>(acc, tables + (size_t)j * (8 / T) * K2_TABLE * S + s, S, pts, digits, S, s, j);
    parts[slot][j] = acc;
  }
  __syncthreads();
  if (j == 0 && s < S) {
    combine_parts<fe, T>(parts[slot]);
    ge_to_rows(out + (size_t)s * 72, parts[slot][0]);
  }
}

// tables: scratch of 8 x 9 x S niels entries (160 B each, 16-byte aligned)
extern "C" int xhe_windowed_lanes_k8(const void *pts, const void *digits, void *out, void *tables,
                                     int S, void *stream) {
  if (S > 0) {
    windowed_lanes_k8_kernel<<<(S + SLOTS - 1) / SLOTS, SLOTS * T, 0, (cudaStream_t)stream>>>(
        (const int32_t *)pts, (const uint8_t *)digits, (int32_t *)out, (ge_niels *)tables, S);
  }
  return (int)cudaGetLastError();
}
