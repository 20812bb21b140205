// K9: Pippenger's bucket sums, for each window w and bucket b (1 <= b < 2^c)
// the sum of the points whose digit in window w is b.
//
// Replaces no Pallas kernel: the JAX package builds the buckets in XLA, by
// the segmented scan and scatter of MsmEngine._window_sum
// (xelis_he_tpu/ops/msm.py _combine_seg, _inclusive_scan).  The port's torch
// glue (ops/msm.py MsmEngine.msm) sorts each window's lanes by digit with a
// stable sort and counts the digits, so bucket b of window w is the run
// order[w][offsets[w][b] .. offsets[w][b + 1]) of lane indices into rows.
// Digit 0 (bucket 0) is never read: it adds nothing to the window's sum.
//
// A launch is one pass (ed25519.cuh bucket_block): each bucket's run is cut
// into blocks of 2^K9_K positions aligned in the scan's tree, one thread a
// block, indexed by block through the prefix sum of the blocks a bucket
// makes (ops/kernels.py bucket_passes, torch glue); a thread finds its bucket
// by a binary search of that sum.  Pass 1 reads the lanes through order;
// each later pass walks the block sums of the runs the previous pass split,
// until every run is one block.  Empty buckets write the identity.  The
// additions are the scan's, in its order, so the plain version
// (ops/kernels.py bucket_sums_plain, that scan on the torch Curve) gives the
// same canonical rows.
//
// Bound: operations, 9 field multiplications an addition, against 288 bytes
// a lane read once, 4 a lane a window of order and 288 a bucket written.
// At 65,536 lanes and c = 13 (20 windows of 8,191 buckets) a bucket holds ~8
// lanes; the top window of scalars below L holds ~32 buckets of ~2,048
// lanes, which one thread a bucket walked alone while the card waited
// (36.4 ms against a 0.130 ms bound, PERF.md).  Here no thread walks more
// than 2^K9_K lanes: the long runs are 2,048 / 2^K9_K threads in pass 1 and
// a few in the passes above.  A thread's stack is K9_K + 1 points in local
// memory (a dynamic index): registers cannot index it, and in shared memory
// (K9_K + 1) x 160 bytes a thread would cap an SM at 290 threads (K9_K = 4),
// fewer than its 148 registers allow (384).  K9_K = 4, measured on an
// NVIDIA H100 80GB HBM3 at 700 W (xelis_he_tpu_torch/scripts/bench_k8_k9.py,
// device time of a call at 65,536 lanes of random scalars, window 13):
// k = 3, 4, 5, 6 took 1.957, 1.572, 1.610, 1.921 ms in 6, 4, 4, 3 passes.

#include <cuda_runtime.h>

#include "ed25519.cuh"

using namespace xhe;

constexpr int BLOCK = 128;

// pass 1 (order set) reads rows[order[i]], later passes (order NULL) the
// previous pass's block sums in[i]
__global__ void __launch_bounds__(BLOCK)
    bucket_sums_kernel(const int32_t *__restrict__ rows, const int32_t *__restrict__ order,
                       const ge *__restrict__ in, const long long *__restrict__ start,
                       const long long *__restrict__ len, const long long *__restrict__ first, int nbk,
                       int32_t *__restrict__ out, ge *__restrict__ blocks) {
  ge stack[K9_K + 1];
  const k9_input input = {rows, order, in};
  const long long total = first[nbk];
#pragma unroll 1
  for (long long t = (long long)blockIdx.x * BLOCK + threadIdx.x; t < total; t += (long long)gridDim.x * BLOCK)
    bucket_block(out, blocks, stack, t, start, len, first, nbk, input);
}

// One pass over nbk buckets.  rows: (N, 4, 18) int32; order: (W, N) int32
// lane indices sorted by digit, or NULL after pass 1; in: the previous
// pass's block sums (40-word points), or NULL in pass 1; start, len: (nbk,)
// int64 runs of the pass's input; first: (nbk + 1,) int64 first thread of
// each bucket; threads: the launch's threads (it loops over first[nbk]);
// out: (W, 2^c - 1, 4, 18) int32; blocks: the block sums this pass writes
// (first[nbk] points at most), NULL in the last pass
extern "C" int xhe_bucket_sums(const void *rows, const void *order, const void *in, const void *start,
                               const void *len, const void *first, int nbk, int threads, void *out, void *blocks,
                               void *stream) {
  if (nbk < 1 || threads < 1 || (order == nullptr) == (in == nullptr)) return (int)cudaErrorInvalidValue;
  bucket_sums_kernel<<<(threads + BLOCK - 1) / BLOCK, BLOCK, 0, (cudaStream_t)stream>>>(
      (const int32_t *)rows, (const int32_t *)order, (const ge *)in, (const long long *)start,
      (const long long *)len, (const long long *)first, nbk, (int32_t *)out, (ge *)blocks);
  return (int)cudaGetLastError();
}
