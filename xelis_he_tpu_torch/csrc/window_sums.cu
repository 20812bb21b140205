// K10: Pippenger's window sums and their Horner combination, from the
// (W, 2^c - 1) bucket sums of K9 to sum_w 2^(c w) sum_b b S_{w,b}.
//
// Replaces no Pallas kernel: the JAX package does this in XLA, by
// MsmEngine._window_sum's suffix scan and tree (the weighted bucket sum
// sum_b b S_b = sum_b R_b with R_b = sum_{j >= b} S_j) and MsmEngine.msm's
// loop of c doublings and one addition a window (xelis_he_tpu/ops/msm.py).
//
// Bound: operations, 2 (2^c - 2) additions a window for the weighted sum and
// (W - 1) (c doublings + 1 addition) for Horner, against 288 bytes a bucket:
// at c = 13, W = 20 about 330,000 additions, 0.037 ms at the card's rate.
// What no width hides is the chain: Horner's (W - 1) c dependent doublings,
// 247 at c = 13, after the top window's sum.  The design (ed25519.cuh has
// the identity its steps use):
//
// - Every point operation runs on a quad of threads with K7's rounds and
//   __shfl_sync gathers (quad_steps): an addition or a doubling is two
//   rounds of one or two field operations a thread, not eight dependent
//   ones.  A doubling that another doubling follows skips T.
// - Phase 1 spreads the windows over the card.  A window is cut into G
//   pieces, one block of Q quads a piece (ops/kernels.py k10_shape: W G
//   blocks fill the 132 SMs twice).  Each quad walks its chunk of m =
//   2^c / (G Q) buckets, two additions a step (window_chunk), then the
//   block takes the chunks' suffix sums, their tree, log2 m doublings and
//   the tree of the acc in shared memory (block_weighted) and writes the
//   piece's weighted sum and total to its slot (w, g).  The piece that
//   finishes its window last (a counter a window, as K3's tiles) combines
//   the G slots the same way one level up and publishes the window's sum
//   with a ready flag.  Every sum is taken in an order that the indices
//   fix, not the order of arrival, so the rows are the same run after run.
// - Horner overlaps phase 1.  Blocks take tickets in the order in which
//   they start: ticket 0 is the chain (one quad), then the pieces from the
//   top window down.  The chain waits on window v's flag only after its
//   c (W - 1 - v) doublings.  Only the chain waits, and only on blocks that
//   never wait, so no grid size can deadlock.  Flags and slots are read
//   through L2.
//
// The plain version (ops/kernels.py window_sums_plain) runs the same steps
// in the same order on the torch Curve, so the rows agree exactly.  Two
// other modes of the launch are timing aids: phase 1 alone (no chain, no
// rows), and the chain after phase 1 (it waits on every window before its
// first doubling: no overlap).  A third aid, k10_rounds_kernel, runs the
// chain's steps alone on one quad, with nothing to wait on or load: the
// latency floor of the chain's dependent rounds.
//
// CUDA 12.9's cicc died with a segmentation fault on K10's first body with
// every addition inlined (as it did on K7's old body, ROADMAP): each step of
// phase 1 below is a real call with its rounds inlined in it.

#include <cuda_runtime.h>

#include "ed25519.cuh"

using namespace xhe;

// a point written by another block: read through L2, past this SM's L1
static __device__ __forceinline__ ge load_partial(const ge *p) {
  ge r;
  const unsigned *src = reinterpret_cast<const unsigned *>(p);
  unsigned *dst = reinterpret_cast<unsigned *>(&r);
#pragma unroll
  for (int i = 0; i < 40; ++i) dst[i] = __ldcg(src + i);
  return r;
}

// spin until another block sets *flag
static __device__ __forceinline__ void wait_ready(const unsigned *flag) {
  unsigned v;
  do {
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(flag) : "memory");
  } while (v == 0);
}

// window w's sum, then its ready flag
static __device__ __forceinline__ void publish(ge *sum, unsigned *ready, const ge &p) {
  *sum = p;
  __threadfence();
  atomicExch(ready, 1u);
}

// K10's steps on the quad of this thread: role r of the four lanes in mask
struct quad_steps {
  int r;
  unsigned mask;

  __device__ __forceinline__ void add(ge &a, const ge &b) const {
    fe mine, got[K7_QUAD];
    add_round1(mine, a, b, r);
    quad_gather(got, mine, mask);
    add_round2(mine, got, r);
    quad_gather(got, mine, mask);
    quad_point(a, got);
  }

  __device__ __forceinline__ void add2(ge &a, const ge &b, ge &c, const ge &d) const {
    fe m1, m2, g1[K7_QUAD], g2[K7_QUAD];
    add_round1(m1, a, b, r);
    add_round1(m2, c, d, r);
    quad_gather(g1, m1, mask);
    quad_gather(g2, m2, mask);
    add_round2(m1, g1, r);
    add_round2(m2, g2, r);
    quad_gather(g1, m1, mask);
    quad_gather(g2, m2, mask);
    quad_point(a, g1);
    quad_point(c, g2);
  }

  __device__ __forceinline__ void dbl(ge &p, bool want_t) const {
    fe mine, got[K7_QUAD];
    dbl_round1(mine, p, r);
    quad_gather(got, mine, mask);
    k10_dbl_round2(mine, got, p, r, want_t);
    quad_gather(got, mine, mask);
    quad_point(p, got);
  }
};

// The steps below work on copies of their arguments and write the results
// once: a point passed by reference to a call lives in local memory, and
// written through the reference on every round it would be stored again
// around each load of a bucket that might alias it.

static __device__ __noinline__ void chunk_step(ge &r_out, ge &acc_out, const int32_t *buckets, int k, int m,
                                               quad_steps q) {
  ge r, acc;
  window_chunk(r, acc, buckets, k, m, q);
  r_out = r;
  acc_out = acc;
}

static __device__ __noinline__ void node_step(ge &v, const ge *buf, int k, int s, int n, quad_steps q) {
  v = suffix_node(buf, k, s, n, q);
}

static __device__ __noinline__ void dbl_step(ge &p, int n, quad_steps q) {
  ge x = p;
  dbl_n(x, n, q);
  p = x;
}

static __device__ __noinline__ void add_step(ge &a, const ge &b, quad_steps q) {
  ge x = a;
  q.add(x, b);
  a = x;
}

// the tree over buf[0 .. n) into buf[0], quad k adding buf[k + h] onto
// buf[k] (every role has read buf[k] before role 0 writes it: the gathers
// order them)
__device__ __forceinline__ void block_tree(ge *buf, int k, int n, quad_steps q) {
#pragma unroll 1
  for (int h = n / 2; h >= 1; h >>= 1) {
    if (k < h) {
      ge v;
      node_step(v, buf, k, h, 2 * h, q);
      if (q.r == 0) buf[k] = v;
    }
    __syncthreads();
  }
}

// n items of 2^log_s buckets each, quad k < n holding item k's total tot
// and local weighted sum acc: on quad 0, sum = sum_k acc_k + 2^log_s sum_k
// k tot_k and total = sum_k tot_k.  Every thread of the block calls it.
__device__ __forceinline__ void block_weighted(ge *buf, const ge &tot, const ge &acc, int n, int log_s, ge &sum,
                                               ge &total, quad_steps q) {
  const int k = threadIdx.x / K7_QUAD;
  const bool lead = k < n && q.r == 0;  // the role that writes the quad's point
  if (lead) buf[k] = tot;  // the totals, then their suffix sums
  __syncthreads();
#pragma unroll 1
  for (int s = 1; s < n; s <<= 1) {
    ge v;
    if (k < n) node_step(v, buf, k, s, n, q);
    __syncthreads();
    if (lead) buf[k] = v;
    __syncthreads();
  }
  if (k == 0) {
    total = buf[0];
    __syncwarp(q.mask);
    if (q.r == 0) ge_identity(buf[0]);
  }
  __syncthreads();
  block_tree(buf, k, n, q);
  ge x;  // sum_k k tot_k (quad 0 uses it)
  if (k == 0) x = buf[0];
  __syncthreads();
  if (lead) buf[k] = acc;
  __syncthreads();
  block_tree(buf, k, n, q);
  if (k == 0) {
    dbl_step(x, log_s, q);
    sum = buf[0];
    add_step(sum, x, q);
  }
}

enum k10_mode { PHASE1 = 0, OVERLAPPED = 1, SERIAL = 2 };

// Horner over the windows' sums on the quad q (threads 0..3): from the top
// window, c doublings and one addition a window; role r writes coordinate r
// of the result.  SERIAL waits on every window first.
static __device__ __noinline__ void horner(const ge *sums, const unsigned *ready, int32_t *out, int W, int c,
                                           int mode, quad_steps q) {
#pragma unroll 1
  for (int v = mode == SERIAL ? 0 : W - 1; v < W; ++v) wait_ready(ready + v);
  ge total = load_partial(sums + W - 1);
#pragma unroll 1
  for (int v = W - 2; v >= 0; --v) {
    dbl_n(total, c, q);
    wait_ready(ready + v);
    const ge p = load_partial(sums + v);
    q.add(total, p);
  }
  daa_write(out, total, q.r);
}

__global__ void __launch_bounds__(K10_MAX_THREADS)
    window_sums_kernel(const int32_t *__restrict__ buckets, ge *__restrict__ slots, ge *__restrict__ sums,
                       unsigned *__restrict__ sync, int32_t *__restrict__ out, int W, int c, int G, int Q,
                       int mode) {
  extern __shared__ ge buf[];  // Q points
  __shared__ int ticket;
  __shared__ bool last;
  unsigned *const done = sync + 1, *const ready = sync + 1 + W;  // pieces done, window sums ready
  const int k = threadIdx.x / K7_QUAD;
  const quad_steps q = {(int)(threadIdx.x % K7_QUAD), 0xfu << (threadIdx.x & 31 & ~(K7_QUAD - 1))};
  if (threadIdx.x == 0) ticket = (int)atomicAdd(sync, 1u) - (mode != PHASE1);
  __syncthreads();
  if (ticket < 0) {
    if (k == 0) horner(sums, ready, out, W, c, mode, q);
    return;
  }
  const int w = W - 1 - ticket / G, g = ticket % G;
  const int log_p = c - (__ffs(G) - 1), log_m = log_p - (__ffs(Q) - 1);
  ge r, acc, sum, total;
  if (k < Q) chunk_step(r, acc, buckets + (size_t)w * ((1 << c) - 1) * 72, g * Q + k, 1 << log_m, q);
  block_weighted(buf, r, acc, Q, log_m, sum, total, q);
  if (G == 1) {
    if (threadIdx.x == 0) publish(sums + w, ready + w, sum);
    return;
  }
  ge *const slot = slots + 2 * (size_t)w * G;  // piece g: its weighted sum, then its total
  if (threadIdx.x == 0) {
    slot[2 * g] = sum;
    slot[2 * g + 1] = total;
    __threadfence();
    last = atomicAdd(done + w, 1u) == (unsigned)(G - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (k < G) {
    acc = load_partial(slot + 2 * k);
    r = load_partial(slot + 2 * k + 1);
  }
  block_weighted(buf, r, acc, G, log_p, sum, total, q);
  if (threadIdx.x == 0) publish(sums + w, ready + w, sum);
}

// buckets: (W, 2^c - 1, 4, 18) int32; slots: 2 W G points and sums: W points
// of 40 words (scratch); sync: 1 + 2 W words at zero (the ticket, each
// window's pieces done, each window's ready flag); out: (1, 4, 18).  G pieces
// a window and Q quads a piece, powers of two with G <= Q, 4 Q <=
// K10_MAX_THREADS and 2 G Q <= 2^c; mode: a k10_mode.
extern "C" int xhe_window_sums(const void *buckets, void *slots, void *sums, void *sync, void *out, int W, int c,
                               int G, int Q, int mode, void *stream) {
  if (c < 1 || c > 24 || W < 1 || G < 1 || (G & (G - 1)) || Q < G || (Q & (Q - 1)) ||
      K7_QUAD * Q > K10_MAX_THREADS || 2ll * G * Q > (1ll << c) || mode < PHASE1 || mode > SERIAL)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)W * G + (mode != PHASE1);
  window_sums_kernel<<<blocks, K7_QUAD * Q, Q * sizeof(ge), (cudaStream_t)stream>>>(
      (const int32_t *)buckets, (ge *)slots, (ge *)sums, (unsigned *)sync, (int32_t *)out, W, c, G, Q, mode);
  return (int)cudaGetLastError();
}

// The Horner chain's steps alone, on one quad (threads 0..3): n times c
// doublings (T on the last) and one addition of the point p, from p, with
// no flag to wait on and no load after p's; out: the result's rows.  A
// timing aid: the latency of 2 n (c + 1) of the chain's rounds.
__global__ void __launch_bounds__(K7_QUAD)
    k10_rounds_kernel(const int32_t *__restrict__ p, int32_t *__restrict__ out, int c, int n) {
  const quad_steps q = {(int)threadIdx.x, 0xfu};
  ge a;
  ge_from_rows(a, p);
  ge total = a;
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    dbl_n(total, c, q);
    q.add(total, a);
  }
  daa_write(out, total, q.r);
}

// p: (1, 4, 18) int32 rows; out: (1, 4, 18); c in 1..24, n >= 1
extern "C" int xhe_k10_rounds(const void *p, void *out, int c, int n, void *stream) {
  if (c < 1 || c > 24 || n < 1) return (int)cudaErrorInvalidValue;
  k10_rounds_kernel<<<1, K7_QUAD, 0, (cudaStream_t)stream>>>((const int32_t *)p, (int32_t *)out, c, n);
  return (int)cudaGetLastError();
}
