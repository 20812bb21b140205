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
// One thread a bucket walks its run once (ed25519.cuh bucket_sum_one): the
// run's length - 1 additions, in the order of the JAX package's scan, so the
// plain version (ops/kernels.py bucket_sums_plain, that scan on the torch
// Curve) gives the same canonical rows.  Empty buckets write the identity.
//
// Bound: operations, 9 field multiplications an addition, against 288 bytes
// a lane read once, 4 a lane a window of order and 288 a bucket written.
// At 65,536 lanes and c = 13 (20 windows of 8,191 buckets) a bucket holds ~8
// lanes and the card is full (163,820 threads); the top window of scalars
// below 2^253 has only 63 buckets of ~1,040 lanes each, and so has any window
// whose digits repeat: its threads walk ~1,000 dependent additions while the
// rest of the card waits.  A run split over several threads, with a second
// pass over the partial sums, is the remedy; it is left for a later PR.

#include <cuda_runtime.h>

#include "ed25519.cuh"

using namespace xhe;

constexpr int BLOCK = 128;

__global__ void __launch_bounds__(BLOCK)
    bucket_sums_kernel(const int32_t *__restrict__ rows, const int32_t *__restrict__ order,
                       const int32_t *__restrict__ offsets, int32_t *__restrict__ out, int W, int N, int nb) {
  const long t = (long)blockIdx.x * BLOCK + threadIdx.x;
  const int per = nb - 1;  // buckets 1 .. nb - 1 of a window
  if (t >= (long)W * per) return;
  const int w = (int)(t / per), b = (int)(t % per) + 1;
  const int32_t *off = offsets + (size_t)w * (nb + 1);
  const int lo = off[b], hi = off[b + 1];
  ge sum;
  if (hi > lo) {
    ge stack[K9_LEVELS];
    bucket_sum_one(sum, stack, rows, order + (size_t)w * N, lo, hi);
  } else {
    ge_identity(sum);
  }
  ge_to_rows(out + 72 * (size_t)t, sum);
}

// rows: (N, 4, 18) int32; order: (W, N) int32 lane indices sorted by digit;
// offsets: (W, 2^c + 1) int32 run starts; out: (W, 2^c - 1, 4, 18) int32
extern "C" int xhe_bucket_sums(const void *rows, const void *order, const void *offsets, void *out, int W,
                               int N, int c, void *stream) {
  if (c < 1 || c > 24 || N < 0) return (int)cudaErrorInvalidValue;
  const int nb = 1 << c;
  const long threads = (long)W * (nb - 1);
  if (threads > 0) {
    bucket_sums_kernel<<<(unsigned)((threads + BLOCK - 1) / BLOCK), BLOCK, 0, (cudaStream_t)stream>>>(
        (const int32_t *)rows, (const int32_t *)order, (const int32_t *)offsets, (int32_t *)out, W, N, nb);
  }
  return (int)cudaGetLastError();
}
