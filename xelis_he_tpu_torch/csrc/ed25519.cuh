// Field and ristretto255 point arithmetic shared by the Hopper kernels.
//
// Field elements use radix 2^25.5: ten unsigned 32-bit limbs of 26, 25, 26,
// ... bits (curve25519-dalek's u32 backend, the crate the reference forks).
// Products are 32x32 -> 64-bit (IMAD.WIDE.U32 on the GPU) summed in 64-bit
// column accumulators, so no column sum can overflow: every operation ends
// with a carry, which keeps limbs below 2^26 + 2^17, and with such inputs a
// column of fe_mul stays below 2^61.
//
// At the kernels' edges points travel as the port's (4, 18) rows of 15-bit
// limbs (X, Y, Z, T); outputs are always canonical, so rows compare exactly.
//
// Every function is XHE_HD: __host__ __device__ under nvcc.  A host build
// (g++ -x c++ -DXHE_HD=) compiles the same arithmetic for the CPU tests.

#pragma once
#include <stddef.h>
#include <stdint.h>

#ifndef XHE_HD
#define XHE_HD __host__ __device__ __forceinline__
#endif

#ifdef XHE_COUNT_MULS
// host-only test hook: counts field multiplications and squarings
static unsigned long long xhe_mul_count = 0, xhe_sq_count = 0;
#define XHE_COUNT_MUL() (++xhe_mul_count)
#define XHE_COUNT_SQ() (++xhe_sq_count)
#else
#define XHE_COUNT_MUL() ((void)0)
#define XHE_COUNT_SQ() ((void)0)
#endif

namespace xhe {

struct fe {
  uint32_t v[10];
};

struct ge {  // extended twisted-Edwards coordinates
  fe X, Y, Z, T;
};

struct ge_niels {  // (Y+X, Y-X, 2d*T, 2Z): the addend form of a table entry
  fe YpX, YmX, T2d, Z2;
};

static XHE_HD int limb_width(int i) { return (i & 1) ? 25 : 26; }

// bit offset of limb i: 0, 26, 51, 77, ...
static XHE_HD int limb_offset(int i) { return 26 * ((i + 1) >> 1) + 25 * (i >> 1); }

static XHE_HD void fe_set_small(fe &h, uint32_t x) {
#pragma unroll
  for (int i = 0; i < 10; ++i) h.v[i] = 0;
  h.v[0] = x;
}

static XHE_HD void fe_copy(fe &h, const fe &f) {
#pragma unroll
  for (int i = 0; i < 10; ++i) h.v[i] = f.v[i];
}

// constants (limbs of d, 2d, sqrt(-1), 1/sqrt(a-d))
static XHE_HD void fe_d(fe &h) {
  const uint32_t c[10] = {0x35978a3u, 0xd37284u, 0x3156ebdu, 0x6a0a0eu, 0x1c029u,
                          0x179e898u, 0x3a03cbbu, 0x1ce7198u, 0x2e2b6ffu, 0x1480db3u};
#pragma unroll
  for (int i = 0; i < 10; ++i) h.v[i] = c[i];
}

static XHE_HD void fe_d2(fe &h) {
  const uint32_t c[10] = {0x2b2f159u, 0x1a6e509u, 0x22add7au, 0xd4141du, 0x38052u,
                          0xf3d130u, 0x3407977u, 0x19ce331u, 0x1c56dffu, 0x901b67u};
#pragma unroll
  for (int i = 0; i < 10; ++i) h.v[i] = c[i];
}

static XHE_HD void fe_sqrt_m1(fe &h) {
  const uint32_t c[10] = {0x20ea0b0u, 0x186c9d2u, 0x8f189du, 0x35697fu, 0xbd0c60u,
                          0x1fbd7a7u, 0x2804c9eu, 0x1e16569u, 0x4fc1du, 0xae0c92u};
#pragma unroll
  for (int i = 0; i < 10; ++i) h.v[i] = c[i];
}

static XHE_HD void fe_invsqrt_a_minus_d(fe &h) {
  const uint32_t c[10] = {0x5d40eau, 0x3f6aa0u, 0x257d339u, 0xbad20bu, 0x274bc58u,
                          0x1d840u, 0x13dc8ffu, 0x19442d8u, 0x5cfaffu, 0x1e1b224u};
#pragma unroll
  for (int i = 0; i < 10; ++i) h.v[i] = c[i];
}

// carry a 32-bit limb vector (limbs < 2^31) back under the limb widths;
// the limb-9 carry wraps into limb 0 with weight 19 (2^255 = 19 mod p)
static XHE_HD void fe_carry(fe &h) {
  uint32_t c;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const int w = limb_width(i);
    c = h.v[i] >> w;
    h.v[i] &= (1u << w) - 1u;
    h.v[i + 1] += c;
  }
  c = h.v[9] >> 25;
  h.v[9] &= 0x1ffffffu;
  h.v[0] += 19u * c;
  c = h.v[0] >> 26;
  h.v[0] &= 0x3ffffffu;
  h.v[1] += c;
}

// carry 64-bit column sums (each < 2^63) into a limb vector
static XHE_HD void fe_reduce64(fe &h, uint64_t t[10]) {
  uint64_t c;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const int w = limb_width(i);
    c = t[i] >> w;
    t[i] &= (1ull << w) - 1ull;
    t[i + 1] += c;
  }
  c = t[9] >> 25;
  t[9] &= 0x1ffffffull;
  t[0] += 19ull * c;
  c = t[0] >> 26;
  t[0] &= 0x3ffffffull;
  t[1] += c;
#pragma unroll
  for (int i = 0; i < 10; ++i) h.v[i] = (uint32_t)t[i];
}

static XHE_HD void fe_add(fe &h, const fe &f, const fe &g) {
#pragma unroll
  for (int i = 0; i < 10; ++i) h.v[i] = f.v[i] + g.v[i];
  fe_carry(h);
}

// f - g as f + 4p - g: every limb of 4p exceeds any carried limb of g
static XHE_HD void fe_sub(fe &h, const fe &f, const fe &g) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t four_p = (i == 0) ? 0xfffffb4u : ((i & 1) ? 0x7fffffcu : 0xffffffcu);
    h.v[i] = f.v[i] + four_p - g.v[i];
  }
  fe_carry(h);
}

static XHE_HD void fe_neg(fe &h, const fe &f) {
  fe z;
  fe_set_small(z, 0);
  fe_sub(h, z, f);
}

// h = f * g.  Limb i sits at bit ceil(25.5 i), so a product of two odd limbs
// lands one bit above its column (doubled), and columns >= 10 wrap with 19.
static XHE_HD void fe_mul(fe &h, const fe &f, const fe &g) {
  XHE_COUNT_MUL();
  uint32_t g19[10], f2[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    g19[i] = 19u * g.v[i];
    f2[i] = (i & 1) ? 2u * f.v[i] : f.v[i];
  }
  uint64_t t[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) t[k] = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
#pragma unroll
    for (int j = 0; j < 10; ++j) {
      const uint32_t a = ((i & 1) && (j & 1)) ? f2[i] : f.v[i];
      if (i + j < 10)
        t[i + j] += (uint64_t)a * g.v[j];
      else
        t[i + j - 10] += (uint64_t)a * g19[j];
    }
  }
  fe_reduce64(h, t);
}

// h = f^2: the columns of fe_mul(h, f, f), each cross product f_i f_j (i < j)
// taken once with weight 2, so 55 products instead of 100.  Operand a carries
// the factors 2 (cross product, two odd limbs) and stays below 2^28.1;
// operand b carries the wrap 19 and stays below 2^30.3.  The column sums are
// those of fe_mul, so the result is bit for bit fe_mul's.
static XHE_HD void fe_sq(fe &h, const fe &f) {
  XHE_COUNT_SQ();
  uint64_t t[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) t[k] = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
#pragma unroll
    for (int j = i; j < 10; ++j) {
      uint32_t a = (i == j) ? f.v[i] : 2u * f.v[i];
      if ((i & 1) && (j & 1)) a *= 2u;
      if (i + j < 10)
        t[i + j] += (uint64_t)a * f.v[j];
      else
        t[i + j - 10] += (uint64_t)a * (19u * f.v[j]);
    }
  }
  fe_reduce64(h, t);
}

static XHE_HD void fe_sqn(fe &h, const fe &f, int n) {
  fe_sq(h, f);
#pragma unroll 1
  for (int i = 1; i < n; ++i) fe_sq(h, h);
}

// canonical limbs: the value reduced into [0, p), every limb exactly its width
static XHE_HD void fe_canon(fe &h, const fe &f) {
  fe_copy(h, f);
  fe_carry(h);
  // q = 1 iff h + 19 >= 2^255, i.e. h >= p
  uint32_t q = (h.v[0] + 19u) >> 26;
#pragma unroll
  for (int i = 1; i < 10; ++i) q = (h.v[i] + q) >> limb_width(i);
  h.v[0] += 19u * q;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const int w = limb_width(i);
    h.v[i + 1] += h.v[i] >> w;
    h.v[i] &= (1u << w) - 1u;
  }
  h.v[9] &= 0x1ffffffu;  // drops the 2^255 * q
}

static XHE_HD bool fe_is_negative(const fe &f) {
  fe c;
  fe_canon(c, f);
  return (c.v[0] & 1u) != 0;
}

static XHE_HD bool fe_is_zero(const fe &f) {
  fe c;
  fe_canon(c, f);
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) acc |= c.v[i];
  return acc == 0;
}

static XHE_HD bool fe_eq(const fe &f, const fe &g) {
  fe a, b;
  fe_canon(a, f);
  fe_canon(b, g);
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) acc |= a.v[i] ^ b.v[i];
  return acc == 0;
}

static XHE_HD void fe_select(fe &h, bool cond, const fe &a, const fe &b) {
#pragma unroll
  for (int i = 0; i < 10; ++i) h.v[i] = cond ? a.v[i] : b.v[i];
}

static XHE_HD void fe_cneg(fe &h, bool cond, const fe &f) {
  fe n;
  fe_neg(n, f);
  fe_select(h, cond, n, f);
}

static XHE_HD void fe_abs(fe &h, const fe &f) { fe_cneg(h, fe_is_negative(f), f); }

// (x^(2^250 - 1), x^11): the shared prefix of invert and pow_p58
static XHE_HD void fe_pow22501(fe &t7, fe &t0, const fe &x) {
  fe t1, t2, t3, t4, t5, t6;
  fe_sq(t0, x);          // 2
  fe_sqn(t1, t0, 2);     // 8
  fe_mul(t1, x, t1);     // 9
  fe_mul(t0, t0, t1);    // 11
  fe_sq(t2, t0);         // 22
  fe_mul(t2, t1, t2);    // 2^5 - 1
  fe_sqn(t3, t2, 5);
  fe_mul(t3, t3, t2);    // 2^10 - 1
  fe_sqn(t4, t3, 10);
  fe_mul(t4, t4, t3);    // 2^20 - 1
  fe_sqn(t5, t4, 20);
  fe_mul(t5, t5, t4);    // 2^40 - 1
  fe_sqn(t5, t5, 10);
  fe_mul(t5, t5, t3);    // 2^50 - 1
  fe_sqn(t6, t5, 50);
  fe_mul(t6, t6, t5);    // 2^100 - 1
  fe_sqn(t7, t6, 100);
  fe_mul(t7, t7, t6);    // 2^200 - 1
  fe_sqn(t7, t7, 50);
  fe_mul(t7, t7, t5);    // 2^250 - 1
}

// x^((p-5)/8) = x^(2^252 - 3)
static XHE_HD void fe_pow_p58(fe &h, const fe &x) {
  fe t7, t0, x0;
  fe_copy(x0, x);  // h may alias x
  fe_pow22501(t7, t0, x0);
  fe_sqn(h, t7, 2);
  fe_mul(h, h, x0);
}

// RFC 9496 SQRT_RATIO_M1: returns was_square, r = nonnegative sqrt(u/v)
// (or sqrt(i*u/v) when u/v is not square)
static XHE_HD bool fe_sqrt_ratio_m1(fe &r, const fe &u, const fe &v) {
  fe v3, v7, t, check, neg_u, neg_u_i, sqrt_m1, r_prime;
  fe_sq(t, v);
  fe_mul(v3, t, v);
  fe_sq(t, v3);
  fe_mul(v7, t, v);
  fe_mul(t, u, v7);
  fe_pow_p58(t, t);
  fe_mul(r, u, v3);
  fe_mul(r, r, t);
  fe_sq(t, r);
  fe_mul(check, v, t);
  fe_neg(neg_u, u);
  fe_sqrt_m1(sqrt_m1);
  fe_mul(neg_u_i, neg_u, sqrt_m1);
  const bool correct = fe_eq(check, u);
  const bool flipped = fe_eq(check, neg_u);
  const bool flipped_i = fe_eq(check, neg_u_i);
  fe_mul(r_prime, r, sqrt_m1);
  fe_select(r, flipped || flipped_i, r_prime, r);
  fe_abs(r, r);
  return correct || flipped;
}

// -- edges: (18,) rows of 15-bit limbs ---------------------------------------

// any row of limbs < 2^17 (canonical or not) -> field element
static XHE_HD void fe_from_row15(fe &h, const int32_t *row) {
  uint64_t t[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) t[i] = 0;
#pragma unroll
  for (int k = 0; k < 18; ++k) {
    const int pos = 15 * k;
    const uint64_t v = (uint32_t)row[k];
    if (pos >= 255) {
      t[0] += 19ull * (v << (pos - 255));
    } else {
      int j = 9;
      while (limb_offset(j) > pos) --j;
      t[j] += v << (pos - limb_offset(j));
    }
  }
  fe_reduce64(h, t);
}

// field element -> canonical row of 15-bit limbs (limb 17 is always 0)
static XHE_HD void fe_to_row15(int32_t *row, const fe &f) {
  fe c;
  fe_canon(c, f);
#pragma unroll
  for (int k = 0; k < 17; ++k) {
    const int pos = 15 * k;
    int j = 9;
    while (limb_offset(j) > pos) --j;
    const int sh = pos - limb_offset(j);
    uint64_t x = c.v[j] >> sh;
    const int got = limb_width(j) - sh;
    if (got < 15 && j + 1 < 10) x |= (uint64_t)c.v[j + 1] << got;
    row[k] = (int32_t)(x & 0x7fffu);
  }
  row[17] = 0;
}

// field element -> 32 little-endian bytes of its canonical value
static XHE_HD void fe_to_bytes(uint8_t *out, const fe &f) {
  fe c;
  fe_canon(c, f);
  uint64_t acc = 0;
  int nb = 0, o = 0;
  for (int i = 0; i < 10; ++i) {
    acc |= (uint64_t)c.v[i] << nb;
    nb += limb_width(i);
    while (nb >= 8) {
      out[o++] = (uint8_t)(acc & 0xffu);
      acc >>= 8;
      nb -= 8;
    }
  }
  out[o] = (uint8_t)acc;  // bits 248..254; bit 255 is 0
}

static XHE_HD void ge_from_rows(ge &p, const int32_t *rows) {
  fe_from_row15(p.X, rows);
  fe_from_row15(p.Y, rows + 18);
  fe_from_row15(p.Z, rows + 36);
  fe_from_row15(p.T, rows + 54);
}

static XHE_HD void ge_to_rows(int32_t *rows, const ge &p) {
  fe_to_row15(rows, p.X);
  fe_to_row15(rows + 18, p.Y);
  fe_to_row15(rows + 36, p.Z);
  fe_to_row15(rows + 54, p.T);
}

// -- group operations (the same formulas as the port's ops/curve.py) -------

static XHE_HD void ge_identity(ge &p) {
  fe_set_small(p.X, 0);
  fe_set_small(p.Y, 1);
  fe_set_small(p.Z, 1);
  fe_set_small(p.T, 0);
}

// unified extended addition (add-2008-hwcd-3, a = -1)
static XHE_HD void ge_add(ge &r, const ge &p, const ge &q) {
  fe a, b, c, d, e, f, g, h, t, d2;
  fe_sub(a, p.Y, p.X);
  fe_sub(t, q.Y, q.X);
  fe_mul(a, a, t);
  fe_add(b, p.Y, p.X);
  fe_add(t, q.Y, q.X);
  fe_mul(b, b, t);
  fe_d2(d2);
  fe_mul(c, p.T, d2);
  fe_mul(c, c, q.T);
  fe_add(d, p.Z, p.Z);
  fe_mul(d, d, q.Z);
  fe_sub(e, b, a);
  fe_sub(f, d, c);
  fe_add(g, d, c);
  fe_add(h, b, a);
  fe_mul(r.X, e, f);
  fe_mul(r.Y, g, h);
  fe_mul(r.Z, f, g);
  fe_mul(r.T, e, h);
}

// dedicated doubling (dbl-2008-hwcd, a = -1); T is skipped when the next
// operation is another doubling, which never reads it
static XHE_HD void ge_dbl(ge &r, const ge &p, bool want_t) {
  fe a, b, c, e, f, g, h, xy;
  fe_sq(a, p.X);
  fe_sq(b, p.Y);
  fe_sq(c, p.Z);
  fe_add(c, c, c);
  fe_add(h, a, b);
  fe_add(xy, p.X, p.Y);
  fe_sq(xy, xy);
  fe_sub(e, h, xy);
  fe_sub(g, a, b);
  fe_add(f, c, g);
  fe_mul(r.X, e, f);
  fe_mul(r.Y, g, h);
  fe_mul(r.Z, f, g);
  if (want_t) fe_mul(r.T, e, h);
}

static XHE_HD void ge_to_niels(ge_niels &n, const ge &p) {
  fe d2;
  fe_d2(d2);
  fe_add(n.YpX, p.Y, p.X);
  fe_sub(n.YmX, p.Y, p.X);
  fe_mul(n.T2d, p.T, d2);
  fe_add(n.Z2, p.Z, p.Z);
}

// the identity in niels form: (1, 1, 0, 2)
static XHE_HD void ge_niels_identity(ge_niels &n) {
  fe_set_small(n.YpX, 1);
  fe_set_small(n.YmX, 1);
  fe_set_small(n.T2d, 0);
  fe_set_small(n.Z2, 2);
}

// extended + niels -> extended; neg adds -Q (swap Y+-X, negate 2dT)
static XHE_HD void ge_add_niels(ge &r, const ge &p, const ge_niels &q, bool neg) {
  fe a, b, c, d, e, f, g, h, t2d;
  fe_sub(a, p.Y, p.X);
  fe_mul(a, a, neg ? q.YpX : q.YmX);
  fe_add(b, p.Y, p.X);
  fe_mul(b, b, neg ? q.YmX : q.YpX);
  fe_cneg(t2d, neg, q.T2d);
  fe_mul(c, p.T, t2d);
  fe_mul(d, p.Z, q.Z2);
  fe_sub(e, b, a);
  fe_sub(f, d, c);
  fe_add(g, d, c);
  fe_add(h, b, a);
  fe_mul(r.X, e, f);
  fe_mul(r.Y, g, h);
  fe_mul(r.Z, f, g);
  fe_mul(r.T, e, h);
}

// -- ristretto255 encoding (RFC 9496) ----------------------------------------

// ENCODE: canonical s of the encoding
static XHE_HD void ge_compress_s(fe &s, const ge &p) {
  fe u1, u2, t, invsqrt, den1, den2, z_inv, ix0, iy0, enchanted, x, y, den_inv, one, k;
  fe_add(t, p.Z, p.Y);
  fe_sub(u1, p.Z, p.Y);
  fe_mul(u1, t, u1);
  fe_mul(u2, p.X, p.Y);
  fe_sq(t, u2);
  fe_mul(t, u1, t);
  fe_set_small(one, 1);
  fe_sqrt_ratio_m1(invsqrt, one, t);
  fe_mul(den1, invsqrt, u1);
  fe_mul(den2, invsqrt, u2);
  fe_mul(z_inv, den1, den2);
  fe_mul(z_inv, z_inv, p.T);
  fe_sqrt_m1(k);
  fe_mul(ix0, p.X, k);
  fe_mul(iy0, p.Y, k);
  fe_invsqrt_a_minus_d(k);
  fe_mul(enchanted, den1, k);
  fe_mul(t, p.T, z_inv);
  const bool rotate = fe_is_negative(t);
  fe_select(x, rotate, iy0, p.X);
  fe_select(y, rotate, ix0, p.Y);
  fe_select(den_inv, rotate, enchanted, den2);
  fe_mul(t, x, z_inv);
  fe_cneg(y, fe_is_negative(t), y);
  fe_sub(t, p.Z, y);
  fe_mul(t, den_inv, t);
  fe_abs(t, t);
  fe_canon(s, t);
}

// DECODE with validation of the 32 bytes (s < p, s >= 0, square, t >= 0,
// y != 0, bit 255 clear).  Invalid encodings give the identity.
static XHE_HD bool ge_decompress(ge &p, const uint8_t *bytes) {
  const bool top_clear = (bytes[31] >> 7) == 0;
  // s from bits 0..254
  uint64_t t64[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) t64[i] = 0;
  for (int b = 0; b < 32; ++b) {
    const int pos = 8 * b;
    uint32_t v = bytes[b];
    if (b == 31) v &= 0x7fu;
    int j = 9;
    while (limb_offset(j) > pos) --j;
    t64[j] += (uint64_t)v << (pos - limb_offset(j));
  }
  fe s_raw, s, one, ss, u1, u2, u2_sqr, v, t, invsqrt, den_x, den_y, x, y;
  fe_reduce64(s_raw, t64);  // exact limbs: the value is < 2^255
  fe_canon(s, s_raw);
  uint32_t diff = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) diff |= s.v[i] ^ s_raw.v[i];
  const bool canonical = diff == 0;
  const bool nonneg = (s.v[0] & 1u) == 0;

  fe_set_small(one, 1);
  fe_sq(ss, s);
  fe_sub(u1, one, ss);
  fe_add(u2, one, ss);
  fe_sq(u2_sqr, u2);
  fe_d(t);
  fe_mul(t, t, u1);
  fe_mul(t, t, u1);
  fe_neg(t, t);
  fe_sub(v, t, u2_sqr);
  fe_mul(t, v, u2_sqr);
  const bool was_square = fe_sqrt_ratio_m1(invsqrt, one, t);
  fe_mul(den_x, invsqrt, u2);
  fe_mul(den_y, invsqrt, den_x);
  fe_mul(den_y, den_y, v);
  fe_add(t, s, s);
  fe_mul(t, t, den_x);
  fe_abs(x, t);
  fe_mul(y, u1, den_y);
  fe_mul(t, x, y);
  const bool valid = top_clear && canonical && nonneg && was_square &&
                     !fe_is_negative(t) && !fe_is_zero(y);
  if (valid) {
    p.X = x;
    p.Y = y;
    fe_set_small(p.Z, 1);
    p.T = t;
  } else {
    ge_identity(p);
  }
  return valid;
}

// -- per-thread kernel bodies (shared with the host test build) ------------

// K1 body: one encoding -> canonical rows, returns the valid flag
static XHE_HD bool decompress_one(int32_t *rows, const uint8_t *enc) {
  ge p;
  const bool ok = ge_decompress(p, enc);
  ge_to_rows(rows, p);
  return ok;
}

// K4 body: one point's rows -> 32 encoding bytes
static XHE_HD void compress_one(uint8_t *out, const int32_t *rows) {
  ge p;
  ge_from_rows(p, rows);
  fe s;
  ge_compress_s(s, p);
  fe_to_bytes(out, s);
}

// K2 body: slot s of pts (8, S, 4, 18) and digits (8, 64, S) -> out (4, 18)
static XHE_HD void windowed_slot_k8(int32_t *out, const int32_t *pts, const uint8_t *digits,
                                    int S, int s) {
  ge_niels table[8][8];
#pragma unroll 1
  for (int k = 0; k < 8; ++k) {
    ge p1, p2, p3, p4, q;
    ge_from_rows(p1, pts + ((size_t)k * S + s) * 72);
    ge_dbl(p2, p1, true);
    ge_add(p3, p2, p1);
    ge_dbl(p4, p2, true);
    ge_to_niels(table[k][0], p1);
    ge_to_niels(table[k][1], p2);
    ge_to_niels(table[k][2], p3);
    ge_to_niels(table[k][3], p4);
    ge_add(q, p4, p1);  // 5P
    ge_to_niels(table[k][4], q);
    ge_dbl(q, p3, true);  // 6P
    ge_to_niels(table[k][5], q);
    ge_add(q, q, p1);  // 7P
    ge_to_niels(table[k][6], q);
    ge_dbl(q, p4, true);  // 8P
    ge_to_niels(table[k][7], q);
  }

  ge_niels ident;
  ge_niels_identity(ident);
  ge acc;
  ge_identity(acc);
#pragma unroll 1
  for (int w = 63; w >= 0; --w) {
    ge_dbl(acc, acc, false);
    ge_dbl(acc, acc, false);
    ge_dbl(acc, acc, false);
    ge_dbl(acc, acc, true);
#pragma unroll 1
    for (int k = 0; k < 8; ++k) {
      const int e = (int)digits[((size_t)k * 64 + w) * S + s] - 8;
      const bool neg = e < 0;
      const int a = neg ? -e : e;
      ge_add_niels(acc, acc, a ? table[k][a - 1] : ident, neg);
    }
  }
  ge_to_rows(out, acc);
}

}  // namespace xhe
