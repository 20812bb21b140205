// K8: point additions on a two-dimensional lane grid and their ristretto255
// encodings: lane (r, j) of an R x n grid is a[r] + b[j].
//
// Replaces no Pallas kernel: the JAX package's ECDLP (xelis_he_tpu/ecdlp.py
// ECDLPTables.build and par_decode) adds in XLA (curve.add) and encodes with
// its accelerator's compress.  Encodings come out as (R, n, 32), row-major;
// the sums of the columns j >= sums_from come out for every row r, as
// (R, n - sums_from, 4, 18) canonical rows.  The port's uses (ecdlp.py):
//   the table build: a = the starts r * chunk * G, b = the baby steps
//   j * G (j < chunk), so lane (r, j) is (r * chunk + j) * G; a few launches
//   of about a million lanes make the whole table.  The rows a and b
//   themselves come from short doubling chains: a = the rows k P (k < m)
//   and one more row m P, b = P (n = 1), every sum kept;
//   a group of G decode rounds: a = the G cursors, b = the lane offsets and,
//   as one more column, G times the round's big step, whose sums are the
//   next group's cursors.
//
// Bound: operations.  A lane is one unified addition (9 multiplications)
// and one encode (32 multiplications and 255 squarings, one inverse square
// root in a dependent chain) against at most 288 + 288 + 32 + 288 bytes.
// One thread a lane with K4's body (compress.cu, whose note says why one
// thread a point beat a point over several warps); the sum stays in
// registers between the addition and the encode.  The body is latency-bound
// (~290 field operations in one chain), so what a launch needs is many
// independent chains: a grid of R x n lanes gives each launch of the build
// and of a decode group 2^17 lanes or more, where a row or a column alone
// gave 4,096 or 8,193 (32 and 65 blocks of 128 on 132 SMs).
//
// Block shape, measured on an NVIDIA H100 80GB HBM3 at 700 W
// (xelis_he_tpu_torch/scripts/bench_k8_k9.py, two runs, a table launch of
// 256 x 4,096 lanes): the body needs 194-196 registers unspilled (K4's
// alone 218; K1 runs at 128).  Capped at 255 in blocks of 128 (8 warps an
// SM) it took 3.90 and 3.88 ms; at 200 in blocks of 64 or 32 (10 warps)
// 3.85 and 3.77, 3.84 and 3.81, the best without spills; at 168 (12 warps)
// 3.38 and 3.37 with 88 bytes of spills.  Spills are not allowed here, so
// 32 threads a block at 200 registers.  A launch of 2^17 lanes or more
// (4,096 blocks) fills the 132 SMs: ns a lane at 2^17 is 4-9% above
// 2^20's, at 2^15 16-39% above.

#include <cuda_runtime.h>

#include "ed25519.cuh"

using namespace xhe;

constexpr int K8_THREADS = 32;    // a block: one warp
constexpr int K8_REGISTERS = 200;  // a thread at most (__maxnreg__): 10 warps an SM

__global__ void __maxnreg__(K8_REGISTERS)
    add_compress_kernel(const int32_t *__restrict__ a, const int32_t *__restrict__ b,
                        uint8_t *__restrict__ enc, int32_t *__restrict__ sums, int n, int sums_from,
                        long long lanes) {
  const long long i = (long long)blockIdx.x * K8_THREADS + threadIdx.x;
  if (i >= lanes) return;
  alignas(16) uint8_t bytes[32];
  const k8_lane l = add_compress_lane(i, a, b, sums, n, sums_from);
  add_compress_one(bytes, l.sum, l.a, l.b);
  uint4 *dst = reinterpret_cast<uint4 *>(enc + 32 * i);
  dst[0] = *reinterpret_cast<const uint4 *>(bytes);
  dst[1] = *reinterpret_cast<const uint4 *>(bytes + 16);
}

// a: (R, 4, 18), b: (n, 4, 18) int32 rows; enc: (R, n, 32) uint8; sums:
// (R, n - sums_from, 4, 18) int32, or NULL for none
extern "C" int xhe_add_compress(const void *a, const void *b, void *enc, void *sums, int R, int n, int sums_from,
                                void *stream) {
  if (R < 0 || n < 0 || sums_from < 0 || sums_from > n) return (int)cudaErrorInvalidValue;
  const long long lanes = (long long)R * n;
  if (lanes > 0) {
    add_compress_kernel<<<(unsigned)((lanes + K8_THREADS - 1) / K8_THREADS), K8_THREADS, 0,
                          (cudaStream_t)stream>>>((const int32_t *)a, (const int32_t *)b, (uint8_t *)enc,
                                                  (int32_t *)sums, n, sums_from, lanes);
  }
  return (int)cudaGetLastError();
}
