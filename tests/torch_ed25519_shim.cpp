// Host build of xelis_he_tpu_torch/csrc/ed25519.cuh for the CPU tests:
// the kernels' per-thread bodies run here on plain loops, one item at a
// time, so their arithmetic is checked without a GPU.
//   g++ -x c++ -DXHE_HD= -DXHE_NOINLINE= -DXHE_COUNT_MULS -O2 -shared -fPIC -I<csrc> this.cpp

#include "ed25519.cuh"

using namespace xhe;

extern "C" {

void shim_decompress(const uint8_t *enc, int32_t *rows, uint8_t *valid, int n) {
  for (int i = 0; i < n; ++i) valid[i] = decompress_one(rows + 72 * i, enc + 32 * i) ? 1 : 0;
}

void shim_compress(const int32_t *rows, uint8_t *out, int n) {
  for (int i = 0; i < n; ++i) compress_one(out + 32 * i, rows + 72 * i);
}

void shim_windowed_lanes_k8(const int32_t *pts, const uint8_t *digits, int32_t *out, int S) {
  for (int s = 0; s < S; ++s) windowed_slot_k8<fe>(out + 72 * s, pts, digits, S, s);
}

void shim_windowed_lanes_k8_fe15(const int32_t *pts, const uint8_t *digits, int32_t *out, int S) {
  for (int s = 0; s < S; ++s) windowed_slot_k8<fe15>(out + 72 * s, pts, digits, S, s);
}

void shim_windowed_lanes(const int32_t *pts, const uint8_t *digits, int32_t *out, int N) {
  for (int i = 0; i < N; ++i) windowed_lane(out + 72 * i, pts, digits, N, i);
}

void shim_daa_lanes(const int32_t *pts, const int32_t *bits, int32_t *out, int N) {
  for (int i = 0; i < N; ++i) daa_lane(out + 72 * i, pts, bits, N, i);
}

// n field elements of 18 limbs each on the 15-bit tier: f * g by fe_mul, f^2
// by fe_sq, f - g by fe_sub, each as a canonical row
void shim_fe15(const int32_t *f, const int32_t *g, int32_t *out_mul, int32_t *out_sq,
               int32_t *out_sub, int n) {
  for (int i = 0; i < n; ++i) {
    fe15 a, b, r;
    fe_from_row15(a, f + 18 * i);
    fe_from_row15(b, g + 18 * i);
    fe_mul(r, a, b);
    fe_to_row15(out_mul + 18 * i, r);
    fe_sq(r, a);
    fe_to_row15(out_sq + 18 * i, r);
    fe_sub(r, a, b);
    fe_to_row15(out_sub + 18 * i, r);
  }
}

// the tile tree of tile_sums.cu, level by level
void shim_tile_sums(const int32_t *rows, int32_t *out, int n_tiles, int tile) {
  ge buf[1024];
  for (int b = 0; b < n_tiles; ++b) {
    const int32_t *base = rows + (size_t)b * tile * 72;
    const int half = tile >> 1;
    const int width = half >= 1 ? half : 1;
    for (int t = 0; t < width; ++t) {
      ge_from_rows(buf[t], base + 72 * t);
      if (half >= 1) {
        ge y;
        ge_from_rows(y, base + 72 * (t + half));
        ge_add(buf[t], buf[t], y);
      }
    }
    for (int h = width >> 1; h >= 1; h >>= 1)
      for (int t = 0; t < h; ++t) ge_add(buf[t], buf[t], buf[t + h]);
    ge_to_rows(out + (size_t)b * 72, buf[0]);
  }
}

// n field elements of 10 limbs each: out_mul = f * f by fe_mul, out_sq = f^2 by fe_sq
void shim_square(const uint32_t *f, uint32_t *out_mul, uint32_t *out_sq, int n) {
  for (int i = 0; i < n; ++i) {
    fe a, m, s;
    for (int k = 0; k < 10; ++k) a.v[k] = f[10 * i + k];
    fe_mul(m, a, a);
    fe_sq(s, a);
    for (int k = 0; k < 10; ++k) {
      out_mul[10 * i + k] = m.v[k];
      out_sq[10 * i + k] = s.v[k];
    }
  }
}

unsigned long long shim_mul_count(void) { return xhe_mul_count; }

unsigned long long shim_sq_count(void) { return xhe_sq_count; }

void shim_reset_mul_count(void) { xhe_mul_count = xhe_sq_count = 0; }
}
