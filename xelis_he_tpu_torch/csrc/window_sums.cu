// K10: Pippenger's window sums and their Horner combination, from the
// (W, 2^c - 1) bucket sums of K9 to sum_w 2^(c w) sum_b b S_{w,b}.
//
// Replaces no Pallas kernel: the JAX package does this in XLA, by
// MsmEngine._window_sum's suffix scan and tree (the weighted bucket sum
// sum_b b S_b = sum_b R_b with R_b = sum_{j >= b} S_j) and MsmEngine.msm's
// loop of c doublings and one addition a window (xelis_he_tpu/ops/msm.py).
//
// One block of T = min(256, 2^(c-1)) threads a window.  Thread k walks a
// chunk of m = 2^c / T buckets from the top (ed25519.cuh window_chunk): its
// running suffix sum r and their sum acc, 2 (m - 2) + 1 additions.  Then in
// shared memory the block takes the suffix sums R_k of the chunks' totals
// (log2 T levels), their sum by a tree (slot 0 holding the identity), m times
// that by log2 m doublings, and the tree of the acc_k, and adds the two: the
// window's sum_b b S_b.  Each block writes it to a scratch; the block that
// finishes last (a counter, as K3's tiles) runs Horner over the windows, c
// doublings and one addition a window, and writes the canonical rows.  The
// plain version (ops/kernels.py window_sums_plain) runs the same steps in
// the same order on the torch Curve, so the rows agree exactly.
//
// Bound: operations, 2 (2^c - 2) additions a window for the weighted sum and
// (W - 1) (c doublings + 1 addition) for Horner, against 288 bytes a bucket.
// At c = 13 that is 20 blocks of 256 threads, each thread a chain of 61
// additions, then 16 levels of a block-wide scan or tree and a Horner chain
// of 247 doublings on one thread: latency, not issue, bounds it.
//
// CUDA 12.9's cicc died with a segmentation fault on this kernel with every
// addition inlined (as it did on K7's old body, ROADMAP): each step below
// is a real call, with one or two additions inlined in it.

#include <cuda_runtime.h>

#include "ed25519.cuh"

using namespace xhe;

// a window sum written by another block: read through L2, past this SM's L1
static __device__ __forceinline__ ge load_partial(const ge *p) {
  ge r;
  const unsigned *src = reinterpret_cast<const unsigned *>(p);
  unsigned *dst = reinterpret_cast<unsigned *>(&r);
#pragma unroll
  for (int i = 0; i < 40; ++i) dst[i] = __ldcg(src + i);
  return r;
}

static __device__ __noinline__ void chunk_step(ge &r, ge &acc, const int32_t *buckets, int k, int m) {
  window_chunk(r, acc, buckets, k, m);
}

static __device__ __noinline__ void suffix_step(ge &v, const ge *buf, int k, int s, int n) {
  v = suffix_node(buf, k, s, n);
}

static __device__ __noinline__ void tree_step(ge *buf, int k, int h) { tree_node(buf, k, h); }

static __device__ __noinline__ void dbl_step(ge &p, int n) { ge_dbl_n(p, n); }

static __device__ __noinline__ void add_step(ge &r, const ge &p, const ge &q) { ge_add(r, p, q); }

__device__ __forceinline__ void block_tree(ge *buf, int k, int n) {
#pragma unroll 1
  for (int h = n / 2; h >= 1; h >>= 1) {
    if (k < h) tree_step(buf, k, h);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(K10_THREADS)
    window_sums_kernel(const int32_t *__restrict__ buckets, ge *__restrict__ sums, unsigned *__restrict__ counter,
                       int32_t *__restrict__ out, int W, int c) {
  __shared__ ge buf[K10_THREADS];
  __shared__ bool last;
  const int nb = 1 << c, T = blockDim.x, m = nb / T;
  const int k = threadIdx.x, w = blockIdx.x;
  ge r, acc;
  chunk_step(r, acc, buckets + (size_t)w * (nb - 1) * 72, k, m);

  buf[k] = r;  // the chunks' totals, then their suffix sums
  __syncthreads();
#pragma unroll 1
  for (int s = 1; s < T; s <<= 1) {
    ge v;
    suffix_step(v, buf, k, s, T);
    __syncthreads();
    buf[k] = v;
    __syncthreads();
  }
  if (k == 0) ge_identity(buf[0]);
  __syncthreads();
  block_tree(buf, k, T);
  ge x = buf[0];  // sum_k k T_k (thread 0 uses it)
  __syncthreads();
  buf[k] = acc;
  __syncthreads();
  block_tree(buf, k, T);

  if (k == 0) {
    int log_m = 0;
    while ((1 << log_m) < m) ++log_m;
    dbl_step(x, log_m);
    ge y = buf[0];
    add_step(y, y, x);
    sums[w] = y;
    __threadfence();
    last = atomicAdd(counter, 1u) == (unsigned)(W - 1);
  }
  __syncthreads();
  if (k != 0 || !last) return;
  __threadfence();
  ge total = load_partial(sums + W - 1);
#pragma unroll 1
  for (int v = W - 2; v >= 0; --v) {
    dbl_step(total, c);
    const ge p = load_partial(sums + v);
    add_step(total, total, p);
  }
  ge_to_rows(out, total);
  *counter = 0;
}

// buckets: (W, 2^c - 1, 4, 18) int32; sums: W points of 40 words (scratch);
// counter: one word at zero, which the launch leaves at zero; out: (1, 4, 18)
extern "C" int xhe_window_sums(const void *buckets, void *sums, void *counter, void *out, int W, int c,
                               void *stream) {
  if (c < 1 || c > 24) return (int)cudaErrorInvalidValue;
  const int threads = (1 << (c - 1)) < K10_THREADS ? (1 << (c - 1)) : K10_THREADS;
  if (W > 0) {
    window_sums_kernel<<<W, threads, 0, (cudaStream_t)stream>>>((const int32_t *)buckets, (ge *)sums,
                                                                (unsigned *)counter, (int32_t *)out, W, c);
  }
  return (int)cudaGetLastError();
}
