// K3: per-tile point sums.
//
// Replaces xelis_he_tpu/ops/pallas_msm.py _tile_reduce_kernel.  The TPU
// kernel reduced a 512-lane tile in VMEM by 9 roll-and-add steps; here one
// block per tile runs a tree in shared memory: each of tile/2 threads loads
// two points (i and i + tile/2) and adds them, then halving levels separated
// by __syncthreads() leave the tile's sum in slot 0.  The port's plain
// version (ops/kernels.py tile_sums_plain) adds in the same order, so the
// canonical outputs agree exactly.
//
// Bound: operations (tile - 1 point additions per 288 * tile bytes read);
// the shared-memory tree keeps partial sums out of device memory.  A tile of
// 512 needs 256 * 160 B = 40 KB of shared memory; 1024 needs 80 KB, granted
// through the dynamic shared-memory attribute.

#include <cuda_runtime.h>

#include "ed25519.cuh"

using namespace xhe;

// 512 threads (tile 1024) must fit the SM's 65,536 registers: cap at 128 each
__global__ void __launch_bounds__(512) tile_sums_kernel(const int32_t *__restrict__ rows, int32_t *__restrict__ out,
                                 int tile) {
  extern __shared__ uint32_t smem[];
  ge *pts = reinterpret_cast<ge *>(smem);
  const int t = threadIdx.x;
  const int half = tile >> 1;
  const int32_t *base = rows + (size_t)blockIdx.x * tile * 72;
  ge a;
  ge_from_rows(a, base + 72 * t);
  if (half >= 1) {
    ge b;
    ge_from_rows(b, base + 72 * (t + half));
    ge_add(a, a, b);
  }
  if (half <= 1) {
    ge_to_rows(out + (size_t)blockIdx.x * 72, a);
    return;
  }
  pts[t] = a;
  __syncthreads();
#pragma unroll 1
  for (int h = half >> 1; h >= 1; h >>= 1) {
    if (t < h) {
      ge x = pts[t];
      const ge y = pts[t + h];
      ge_add(x, x, y);
      pts[t] = x;
    }
    __syncthreads();
  }
  if (t == 0) ge_to_rows(out + (size_t)blockIdx.x * 72, pts[0]);
}

extern "C" int xhe_tile_sums(const void *rows, void *out, int n_tiles, int tile, void *stream) {
  if (tile < 1 || tile > 1024 || (tile & (tile - 1)) != 0) return (int)cudaErrorInvalidValue;
  if (n_tiles > 0) {
    const int threads = tile > 1 ? tile / 2 : 1;
    const size_t shmem = tile > 2 ? (size_t)threads * sizeof(ge) : 0;
    if (shmem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          tile_sums_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
      if (e != cudaSuccess) return (int)e;
    }
    tile_sums_kernel<<<n_tiles, threads, shmem, (cudaStream_t)stream>>>(
        (const int32_t *)rows, (int32_t *)out, tile);
  }
  return (int)cudaGetLastError();
}
