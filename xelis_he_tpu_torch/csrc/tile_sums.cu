// K3: per-tile point sums.
//
// Replaces xelis_he_tpu/ops/pallas_msm.py _tile_reduce_kernel.  The TPU
// kernel reduced a 512-lane tile in VMEM by 9 roll-and-add steps, one tile
// per grid step.  Here a tile is cut into sub-tiles of K3_SUB = 64 rows
// (ed25519.cuh), one block of one warp each: thread t loads rows t and
// t + 32 and adds them, and 5 levels of the tree follow within the warp
// under __syncwarp.  Each block writes its partial sum to a scratch buffer
// in device memory, then counts itself done on the tile's counter after a
// __threadfence; the block that finishes a tile last reduces the tile's
// partials (at most 16) by the same tree and sets the counter back to 0,
// so the wrapper zeroes the counters only when it makes them.  Tiles of
// 64 rows or fewer are one block each and need no scratch.  The port's
// plain version (ops/kernels.py tile_sums_plain) adds in the same order, so
// the canonical outputs agree exactly.
//
// Bound: operations (tile - 1 point additions per 288 * tile bytes read).
// At the main path's 6,656 rows in tiles of 512 the work is 104 blocks
// instead of the 13 that one block per tile made, and no level waits on a
// block-wide barrier; the depth of the tree (log2 tile additions) is what
// is left.  Partial sums travel in the kernels' radix-2^25.5 form (160 B).

#include <cuda_runtime.h>

#include "ed25519.cuh"

using namespace xhe;

// a partial sum written by another block: read through L2, past this SM's L1
static __device__ __forceinline__ ge load_partial(const ge *p) {
  ge r;
  const unsigned *src = reinterpret_cast<const unsigned *>(p);
  unsigned *dst = reinterpret_cast<unsigned *>(&r);
#pragma unroll
  for (int i = 0; i < 40; ++i) dst[i] = __ldcg(src + i);
  return r;
}

__global__ void __launch_bounds__(32)
    tile_sums_kernel(const int32_t *__restrict__ rows, int32_t *__restrict__ out,
                     ge *__restrict__ partials, unsigned *__restrict__ counters, int tile) {
  __shared__ ge buf[32];
  __shared__ bool last;
  const int sub = tile < K3_SUB ? tile : K3_SUB;
  const int nsub = tile / sub;
  const int t = threadIdx.x;
  const int tile_idx = blockIdx.x / nsub;
  int32_t *dst = out + (size_t)tile_idx * 72;

  if (t < (sub > 1 ? sub / 2 : 1)) buf[t] = tile_leaf(rows + (size_t)blockIdx.x * sub * 72, t, sub);
  __syncwarp();
#pragma unroll 1
  for (int h = sub / 4; h >= 1; h >>= 1) {
    if (t < h) tree_node(buf, t, h);
    __syncwarp();
  }
  if (nsub == 1) {
    if (t == 0) ge_to_rows(dst, buf[0]);
    return;
  }

  if (t == 0) {
    partials[blockIdx.x] = buf[0];
    __threadfence();
    last = atomicAdd(counters + tile_idx, 1u) == (unsigned)(nsub - 1);
  }
  __syncwarp();
  if (!last) return;
  __threadfence();
  if (t < nsub) buf[t] = load_partial(partials + (size_t)tile_idx * nsub + t);
  __syncwarp();
#pragma unroll 1
  for (int h = nsub / 2; h >= 1; h >>= 1) {
    if (t < h) tree_node(buf, t, h);
    __syncwarp();
  }
  if (t == 0) {
    ge_to_rows(dst, buf[0]);
    counters[tile_idx] = 0;
  }
}

// partials: (n_tiles * tile / 64) points of 40 words and counters: n_tiles
// words at zero, which the launch leaves at zero; both only for tiles above
// 64 rows (NULL otherwise)
extern "C" int xhe_tile_sums(const void *rows, void *out, void *partials, void *counters,
                             int n_tiles, int tile, void *stream) {
  if (tile < 1 || tile > 1024 || (tile & (tile - 1)) != 0) return (int)cudaErrorInvalidValue;
  const int nsub = tile > K3_SUB ? tile / K3_SUB : 1;
  if (nsub > 1 && (partials == nullptr || counters == nullptr)) return (int)cudaErrorInvalidValue;
  if (n_tiles > 0) {
    tile_sums_kernel<<<n_tiles * nsub, 32, 0, (cudaStream_t)stream>>>(
        (const int32_t *)rows, (int32_t *)out, (ge *)partials, (unsigned *)counters, tile);
  }
  return (int)cudaGetLastError();
}
