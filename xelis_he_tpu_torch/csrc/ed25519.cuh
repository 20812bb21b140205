// Field and ristretto255 point arithmetic shared by the Hopper kernels.
//
// Field elements use radix 2^25.5: ten unsigned 32-bit limbs of 26, 25, 26,
// ... bits (curve25519-dalek's u32 backend, the crate the reference forks).
// Products are 32x32 -> 64-bit (IMAD.WIDE.U32 on the GPU) summed in 64-bit
// column accumulators, so no column sum can overflow: every operation ends
// with a carry, which keeps limbs below 2^26 + 2^17, and with such inputs a
// column of fe_mul stays below 2^61.
//
// A second tier, fe15, keeps eighteen 15-bit limbs (the boundary rows' own
// radix) with 64-bit column sums: 324 products a multiplication instead of
// 100.  The point functions and the packed-lanes body are templates over the
// field type, so the two tiers run the same formulas on independent
// arithmetic and can be held to each other.
//
// At the kernels' edges points travel as the port's (4, 18) rows of 15-bit
// limbs (X, Y, Z, T); outputs are always canonical, so rows compare exactly.
//
// Every function is XHE_HD: __host__ __device__ under nvcc.  A host build
// (g++ -x c++ -DXHE_HD= -DXHE_NOINLINE=) compiles the same arithmetic for the
// CPU tests.

#pragma once
#include <stddef.h>
#include <stdint.h>

#ifndef XHE_HD
#define XHE_HD __host__ __device__ __forceinline__
#endif
// the 324-product bodies of the 15-bit tier are real calls on the device:
// inlined into K6 they spilled ~5 KB a thread, ran 38% slower and built in
// minutes instead of seconds (PERF.md)
#ifndef XHE_NOINLINE
#define XHE_NOINLINE __host__ __device__ __noinline__
#endif

// before a template whose steps are device-only on the card (K10's quad
// steps): nvcc does not check that what it calls runs on the host too
#ifdef __CUDACC__
#define XHE_STEPS_TEMPLATE _Pragma("nv_exec_check_disable")
#else
#define XHE_STEPS_TEMPLATE
#endif

#ifdef XHE_COUNT_MULS
// host-only test hook: counts field multiplications and squarings, and
// their 32 x 32 -> 64-bit products
static unsigned long long xhe_mul_count = 0, xhe_sq_count = 0, xhe_wide_count = 0;
#define XHE_COUNT_MUL() (++xhe_mul_count)
#define XHE_COUNT_SQ() (++xhe_sq_count)
#define XHE_COUNT_WIDE() (++xhe_wide_count)
#else
#define XHE_COUNT_MUL() ((void)0)
#define XHE_COUNT_SQ() ((void)0)
#define XHE_COUNT_WIDE() ((void)0)
#endif

namespace xhe {

struct fe {
  uint32_t v[10];
};

template <class F>
struct ge_t {  // extended twisted-Edwards coordinates over field tier F
  F X, Y, Z, T;
};

// (Y+X, Y-X, 2d*T, 2Z): the addend form of a table entry; 16-byte aligned,
// so an entry in device memory is read with 128-bit loads
template <class F>
struct alignas(16) ge_niels_t {
  F YpX, YmX, T2d, Z2;
};

using ge = ge_t<fe>;
using ge_niels = ge_niels_t<fe>;

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
      XHE_COUNT_WIDE();
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
      XHE_COUNT_WIDE();
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

// RFC 9496 SQRT_RATIO_M1 (u, v) in three parts, so that a caller can drop
// its other values over the long middle one and recompute them after (K1
// does):
//   front: x = u v^7 and v3 = v^3;
//   the chain: pw = x^((p-5)/8) (fe_pow_p58);
//   back: r = u v3 pw, the checks, and was_square.
static XHE_HD void fe_sqrt_ratio_front(fe &x, fe &v3, const fe &u, const fe &v) {
  fe t;
  fe_sq(t, v);
  fe_mul(v3, t, v);
  fe_sq(t, v3);
  fe_mul(x, t, v);  // v^7
  fe_mul(x, u, x);
}

// returns was_square, r = nonnegative sqrt(u/v) (or sqrt(i*u/v) when u/v
// is not square)
static XHE_HD bool fe_sqrt_ratio_back(fe &r, const fe &pw, const fe &u, const fe &v, const fe &v3) {
  fe t, check, neg_u, neg_u_i, sqrt_m1, r_prime;
  fe_mul(r, u, v3);
  fe_mul(r, r, pw);
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

// RFC 9496 SQRT_RATIO_M1 whole (K4)
static XHE_HD bool fe_sqrt_ratio_m1(fe &r, const fe &u, const fe &v) {
  fe x, v3;
  fe_sqrt_ratio_front(x, v3, u, v);
  fe_pow_p58(x, x);
  return fe_sqrt_ratio_back(r, x, u, v, v3);
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

// -- second tier: eighteen 15-bit limbs ----------------------------------------
//
// value = sum v[i] 2^(15 i) over 270 bits; 2^270 = 19 * 2^15 (mod p), so the
// carry out of limb 17 wraps into limb 1 with weight 19.  Every operation
// leaves limbs below 2^15 + 2^8; with such inputs a product is below 2^31 and
// a folded column of fe_mul below 2^39.

struct fe15 {
  uint32_t v[18];
};

static XHE_HD void fe_set_small(fe15 &h, uint32_t x) {
#pragma unroll
  for (int i = 0; i < 18; ++i) h.v[i] = 0;
  h.v[0] = x;
}

static XHE_HD void fe_d2(fe15 &h) {
  const uint32_t c[18] = {0x7159u, 0x4d65u, 0x6e50u, 0x5eb4u, 0x156eu, 0x5076u,
                          0x26a0u, 0x700au, 0x3000u, 0x67a2u, 0x4bbbu, 0x7407u,
                          0x7198u, 0x7f9cu, 0x15b7u, 0x6ceeu, 0x2406u, 0x0u};
#pragma unroll
  for (int i = 0; i < 18; ++i) h.v[i] = c[i];
}

// carry limbs below 2^18 back under 2^15 (limb 1 keeps the wrap, at most 19 * 8)
static XHE_HD void fe_carry(fe15 &h) {
  uint32_t c = 0;
#pragma unroll
  for (int i = 0; i < 18; ++i) {
    h.v[i] += c;
    c = h.v[i] >> 15;
    h.v[i] &= 0x7fffu;
  }
  h.v[1] += 19u * c;
}

static XHE_HD void fe_add(fe15 &h, const fe15 &f, const fe15 &g) {
#pragma unroll
  for (int i = 0; i < 18; ++i) h.v[i] = f.v[i] + g.v[i];
  fe_carry(h);
}

// f - g as f + 2p + 2^16 p - g: the limbs of that multiple of p are
// 2 (2^15 - 19), 2 (2^15 - 1) + 2 (2^15 - 19), fifteen of 4 (2^15 - 1), and
// 2 (2^15 - 1), each above any carried limb of g
static XHE_HD void fe_sub(fe15 &h, const fe15 &f, const fe15 &g) {
#pragma unroll
  for (int i = 0; i < 18; ++i) {
    const uint32_t pad = (i == 0) ? 65498u : (i == 1) ? 131032u : (i == 17) ? 65534u : 131068u;
    h.v[i] = f.v[i] + pad - g.v[i];
  }
  fe_carry(h);
}

static XHE_HD void fe_neg(fe15 &h, const fe15 &f) {
  fe15 z;
  fe_set_small(z, 0);
  fe_sub(h, z, f);
}

static XHE_HD void fe_select(fe15 &h, bool cond, const fe15 &a, const fe15 &b) {
#pragma unroll
  for (int i = 0; i < 18; ++i) h.v[i] = cond ? a.v[i] : b.v[i];
}

static XHE_HD void fe_cneg(fe15 &h, bool cond, const fe15 &f) {
  fe15 n;
  fe_neg(n, f);
  fe_select(h, cond, n, f);
}

// 35 column sums (each < 2^35) -> limbs.  Column k >= 18 has weight
// 2^(15 k) = 19 * 2^(15 (k - 17)) and folds into column k - 17.  The carry
// out of limb 17 (< 2^24) wraps into limb 1 and is carried on once more.
static XHE_HD void fe15_reduce(fe15 &h, uint64_t t[35]) {
#pragma unroll
  for (int k = 18; k < 35; ++k) t[k - 17] += 19ull * t[k];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 18; ++i) {
    t[i] += c;
    c = t[i] >> 15;
    h.v[i] = (uint32_t)(t[i] & 0x7fffull);
  }
  const uint64_t w = h.v[1] + 19ull * c;
  h.v[1] = (uint32_t)(w & 0x7fffull);
  uint32_t c2 = (uint32_t)(w >> 15);
#pragma unroll
  for (int i = 2; i < 18; ++i) {
    h.v[i] += c2;
    c2 = h.v[i] >> 15;
    h.v[i] &= 0x7fffu;
  }
  h.v[1] += 19u * c2;  // c2 <= 1
}

static XHE_NOINLINE void fe_mul(fe15 &h, const fe15 &f, const fe15 &g) {
  XHE_COUNT_MUL();
  uint64_t t[35];
#pragma unroll
  for (int k = 0; k < 35; ++k) t[k] = 0;
#pragma unroll
  for (int i = 0; i < 18; ++i) {
#pragma unroll
    for (int j = 0; j < 18; ++j) {
      XHE_COUNT_WIDE();
      t[i + j] += (uint64_t)f.v[i] * g.v[j];
    }
  }
  fe15_reduce(h, t);
}

// the columns of fe_mul(h, f, f) with each cross product taken once, doubled:
// 171 products
static XHE_NOINLINE void fe_sq(fe15 &h, const fe15 &f) {
  XHE_COUNT_SQ();
  uint64_t t[35];
#pragma unroll
  for (int k = 0; k < 35; ++k) t[k] = 0;
#pragma unroll
  for (int i = 0; i < 18; ++i) {
    XHE_COUNT_WIDE();
    t[2 * i] += (uint64_t)f.v[i] * f.v[i];
#pragma unroll
    for (int j = i + 1; j < 18; ++j) {
      XHE_COUNT_WIDE();
      t[i + j] += (uint64_t)(2u * f.v[i]) * f.v[j];
    }
  }
  fe15_reduce(h, t);
}

// a boundary row (limbs < 2^17, canonical or not) is a field element as it is
static XHE_HD void fe_from_row15(fe15 &h, const int32_t *row) {
#pragma unroll
  for (int i = 0; i < 18; ++i) h.v[i] = (uint32_t)row[i];
  fe_carry(h);
}

// canonical row: the value reduced into [0, p), limb 17 zero
static XHE_HD void fe_to_row15(int32_t *row, const fe15 &f) {
  fe15 c = f;
  fe_carry(c);
  // fold limb 17 (bits 255 and up) with 2^255 = 19; after the second fold
  // the value is below 2^255 and every limb exact
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    c.v[0] += 19u * c.v[17];
    c.v[17] = 0;
    uint32_t cy = 0;
#pragma unroll
    for (int i = 0; i < 18; ++i) {
      c.v[i] += cy;
      cy = c.v[i] >> 15;
      c.v[i] &= 0x7fffu;
    }
  }
  // q = 1 iff value + 19 >= 2^255, i.e. value >= p
  uint32_t q = (c.v[0] + 19u) >> 15;
#pragma unroll
  for (int i = 1; i < 17; ++i) q = (c.v[i] + q) >> 15;
  c.v[0] += 19u * q;
  uint32_t cy = 0;
#pragma unroll
  for (int i = 0; i < 17; ++i) {
    c.v[i] += cy;
    cy = c.v[i] >> 15;
    c.v[i] &= 0x7fffu;
    row[i] = (int32_t)c.v[i];
  }
  row[17] = 0;  // the carry out of limb 16 is the 2^255 q that was subtracted
}

// -- points, over either tier -----------------------------------------------------

template <class F>
static XHE_HD void ge_from_rows(ge_t<F> &p, const int32_t *rows) {
  fe_from_row15(p.X, rows);
  fe_from_row15(p.Y, rows + 18);
  fe_from_row15(p.Z, rows + 36);
  fe_from_row15(p.T, rows + 54);
}

template <class F>
static XHE_HD void ge_to_rows(int32_t *rows, const ge_t<F> &p) {
  fe_to_row15(rows, p.X);
  fe_to_row15(rows + 18, p.Y);
  fe_to_row15(rows + 36, p.Z);
  fe_to_row15(rows + 54, p.T);
}

// -- group operations (the same formulas as the port's ops/curve.py) -------

template <class F>
static XHE_HD void ge_identity(ge_t<F> &p) {
  fe_set_small(p.X, 0);
  fe_set_small(p.Y, 1);
  fe_set_small(p.Z, 1);
  fe_set_small(p.T, 0);
}

// unified extended addition (add-2008-hwcd-3, a = -1)
template <class F>
static XHE_HD void ge_add(ge_t<F> &r, const ge_t<F> &p, const ge_t<F> &q) {
  F a, b, c, d, e, f, g, h, t, d2;
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
template <class F>
static XHE_HD void ge_dbl(ge_t<F> &r, const ge_t<F> &p, bool want_t) {
  F a, b, c, e, f, g, h, xy;
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

template <class F>
static XHE_HD void ge_to_niels(ge_niels_t<F> &n, const ge_t<F> &p) {
  F d2;
  fe_d2(d2);
  fe_add(n.YpX, p.Y, p.X);
  fe_sub(n.YmX, p.Y, p.X);
  fe_mul(n.T2d, p.T, d2);
  fe_add(n.Z2, p.Z, p.Z);
}

// the identity in niels form: (1, 1, 0, 2)
template <class F>
static XHE_HD void ge_niels_identity(ge_niels_t<F> &n) {
  fe_set_small(n.YpX, 1);
  fe_set_small(n.YmX, 1);
  fe_set_small(n.T2d, 0);
  fe_set_small(n.Z2, 2);
}

// extended + niels -> extended; neg adds -Q (swap Y+-X, negate 2dT)
template <class F>
static XHE_HD void ge_add_niels(ge_t<F> &r, const ge_t<F> &p, const ge_niels_t<F> &q, bool neg) {
  F a, b, c, d, e, f, g, h, t2d;
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

// DECODE, in pieces for K1.  The 32 bytes come as eight little-endian words.
// decode_parse: s from bits 0..254 with exact limbs (value below 2^255, so a
// field element as it is), and the byte checks: bit 255 clear, s < p
// (canonical), s even (nonnegative).
static XHE_HD bool decode_parse(fe &s, const uint32_t w[8]) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const int off = limb_offset(i), word = off >> 5;
    const uint64_t x = w[word] | (word < 7 ? (uint64_t)w[word + 1] << 32 : 0ull);
    s.v[i] = (uint32_t)(x >> (off & 31)) & ((1u << limb_width(i)) - 1u);
  }
  // s >= p iff s + 19 carries out of bit 255
  uint32_t q = (s.v[0] + 19u) >> 26;
#pragma unroll
  for (int i = 1; i < 10; ++i) q = (s.v[i] + q) >> limb_width(i);
  return (w[7] >> 31) == 0 && q == 0 && (s.v[0] & 1u) == 0;
}

// u1 = 1 - s^2, u2 = 1 + s^2, u2^2 and v = -d u1^2 - u2^2
static XHE_HD void decode_terms(fe &u1, fe &u2, fe &u2_sqr, fe &v, const fe &s) {
  fe one, ss, t;
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
}

// -- per-thread kernel bodies (shared with the host test build) ------------

// A read the compiler must make every time it is written (volatile), so a
// value read before a long chain and read again after it is not kept in
// registers over the chain.
template <class T>
static XHE_HD void load_again(T *dst, const T *src, int n) {
  const volatile T *v = src;
#pragma unroll
  for (int k = 0; k < n; ++k) dst[k] = v[k];
}

// K1 body: one encoding (eight little-endian words at src) -> canonical rows
// of the decoded point, or the identity's when the encoding is invalid
// (s >= p, s negative, bit 255 set, not square, t negative or y = 0);
// returns the valid flag.
//
// Over the inverse square root's chain of ~250 squarings only the chain's
// value stays live, and over the square root's checks only their inputs:
// s, u1, u2, u2^2, v, the ratio's denominator t and t^3 are computed before
// the chain for its input, again after it from the encoding read once more,
// and s, u1, u2 and v a third time after the checks (5 squarings and 6
// multiplications more than the function needs: k1_executed in
// ops/kernels.py).  That frees their ~80 registers for more resident
// threads.
static XHE_HD bool decompress_one(int32_t *rows, const uint32_t *src) {
  uint32_t w[8];
  fe one, s, u1, u2, u2_sqr, v, t, x, v3;
  fe_set_small(one, 1);
  load_again(w, src, 8);
  decode_parse(s, w);
  decode_terms(u1, u2, u2_sqr, v, s);
  fe_mul(t, v, u2_sqr);
  fe_sqrt_ratio_front(x, v3, one, t);
  fe_pow_p58(x, x);
  load_again(w, src, 8);
  decode_parse(s, w);
  decode_terms(u1, u2, u2_sqr, v, s);
  fe_mul(t, v, u2_sqr);
  fe_sq(v3, t);
  fe_mul(v3, v3, t);
  fe invsqrt, den_x, den_y, y;
  const bool was_square = fe_sqrt_ratio_back(invsqrt, x, one, t, v3);
  load_again(w, src, 8);
  const bool bytes_ok = decode_parse(s, w);
  decode_terms(u1, u2, u2_sqr, v, s);
  fe_mul(den_x, invsqrt, u2);
  fe_mul(den_y, invsqrt, den_x);
  fe_mul(den_y, den_y, v);
  fe_add(t, s, s);
  fe_mul(t, t, den_x);
  fe_abs(x, t);
  fe_mul(y, u1, den_y);
  fe_mul(t, x, y);
  const bool valid = bytes_ok && was_square && !fe_is_negative(t) && !fe_is_zero(y);
  ge p;
  if (valid) {
    p.X = x;
    p.Y = y;
    fe_set_small(p.Z, 1);
    p.T = t;
  } else {
    ge_identity(p);
  }
  ge_to_rows(rows, p);
  return valid;
}

// K4 body: one point's rows -> 32 encoding bytes
static XHE_HD void compress_one(uint8_t *out, const int32_t *rows) {
  ge p;
  ge_from_rows(p, rows);
  fe s;
  ge_compress_s(s, p);
  fe_to_bytes(out, s);
}

// K8 body: the rows of a and b -> their sum's 32 encoding bytes, and the
// sum's canonical rows where sum_rows is not null
static XHE_HD void add_compress_one(uint8_t *out, int32_t *sum_rows, const int32_t *a, const int32_t *b) {
  ge p, q;
  ge_from_rows(p, a);
  ge_from_rows(q, b);
  ge_add(p, p, q);
  if (sum_rows != nullptr) ge_to_rows(sum_rows, p);
  fe s;
  ge_compress_s(s, p);
  fe_to_bytes(out, s);
}

// K8's lane i of an R x n grid, (r, j) = (i / n, i % n): its addends a[r]
// and b[j], and where its sum goes (column j >= sums_from: slot
// r (n - sums_from) + j - sums_from of sums; otherwise nowhere)
struct k8_lane {
  const int32_t *a, *b;
  int32_t *sum;
};

static XHE_HD k8_lane add_compress_lane(long long i, const int32_t *a, const int32_t *b, int32_t *sums, int n,
                                        int sums_from) {
  const long long r = i / n;
  const int j = (int)(i - r * n);
  k8_lane l;
  l.a = a + 72 * r;
  l.b = b + 72 * (size_t)j;
  l.sum = (sums != nullptr && j >= sums_from) ? sums + 72 * (r * (n - sums_from) + j - sums_from) : nullptr;
  return l;
}

// One node of the pairwise tree over a power-of-two run of points: lane i + h
// onto lane i.  K3's trees and K2's combine take h from half the run down
// to 1, which is the order of the port's ops/msm.py _tree_reduce.
template <class F>
static XHE_HD void tree_node(ge_t<F> *buf, int i, int h) {
  ge_t<F> x = buf[i];
  const ge_t<F> y = buf[i + h];
  ge_add(x, x, y);
  buf[i] = x;
}

// -- K2 / K6: slot s of pts (8, S, 4, 18) and digits (8, 64, S) is
// sum_{k<8} s_k P_k.  The slot's 8 subs are split over T threads: thread j
// owns subs [j 8/T, (j+1) 8/T) and runs its own accumulator, and the T
// partial sums are added at the end.  K2 runs T = K2_SPLIT on the default
// tier, K6 T = K6_SPLIT on fe15.
//
// A sub's table holds 9 niels entries, entry a = aP (entry 0 the identity,
// which stored digit 8, e = 0, picks).  Entry a of a thread's sub kk lies at
// table[(9 kk + a) stride]: both kernels keep the tables in a device scratch
// with the stride S, so one slot's entry is contiguous (160 bytes on the
// default tier, 288 on fe15).

constexpr int K2_SPLIT = 2;  // threads a slot of K2 (ops/kernels.py K2_SPLIT)
constexpr int K6_SPLIT = 4;  // threads a slot of K6 (ops/kernels.py K6_SPLIT)
constexpr int K2_TABLE = 9;  // niels entries a sub: 0P..8P

template <class F>
static XHE_HD void niels_table_0_to_8(ge_niels_t<F> *table, size_t stride, const int32_t *rows) {
  ge_t<F> p1, p2, p3, p4, q;
  ge_niels_t<F> n;
  ge_niels_identity(n);
  table[0] = n;
  ge_from_rows(p1, rows);
  ge_dbl(p2, p1, true);
  ge_add(p3, p2, p1);
  ge_dbl(p4, p2, true);
  ge_to_niels(n, p1);
  table[stride] = n;
  ge_to_niels(n, p2);
  table[2 * stride] = n;
  ge_to_niels(n, p3);
  table[3 * stride] = n;
  ge_to_niels(n, p4);
  table[4 * stride] = n;
  ge_add(q, p4, p1);  // 5P
  ge_to_niels(n, q);
  table[5 * stride] = n;
  ge_dbl(q, p3, true);  // 6P
  ge_to_niels(n, q);
  table[6 * stride] = n;
  ge_add(q, q, p1);  // 7P
  ge_to_niels(n, q);
  table[7 * stride] = n;
  ge_dbl(q, p4, true);  // 8P
  ge_to_niels(n, q);
  table[8 * stride] = n;
}

// thread j's part: the tables of its 8/T subs, then 64 windows from the top,
// each of 4 doublings of its own accumulator and 8/T signed-digit table adds.
// A window's digits are loaded before its doublings, which hide the load.
template <class F, int T>
static XHE_HD void windowed_part_k8(ge_t<F> &acc, ge_niels_t<F> *table, size_t stride,
                                    const int32_t *pts, const uint8_t *digits, int S, int s, int j) {
  constexpr int KT = 8 / T;
  static_assert(KT * T == 8, "T divides the 8 subs");
#pragma unroll 1
  for (int kk = 0; kk < KT; ++kk)
    niels_table_0_to_8(table + (size_t)kk * K2_TABLE * stride, stride,
                       pts + ((size_t)(j * KT + kk) * S + s) * 72);

  ge_identity(acc);
#pragma unroll 1
  for (int w = 63; w >= 0; --w) {
    uint64_t stored = 0;  // byte kk: the stored digit of sub j KT + kk
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)
      stored |= (uint64_t)digits[((size_t)(j * KT + kk) * 64 + w) * S + s] << (8 * kk);
    ge_dbl(acc, acc, false);
    ge_dbl(acc, acc, false);
    ge_dbl(acc, acc, false);
    ge_dbl(acc, acc, true);
#pragma unroll 1
    for (int kk = 0; kk < KT; ++kk) {
      const int e = (int)((stored >> (8 * kk)) & 0xffu) - 8;
      const bool neg = e < 0;
      const int a = neg ? -e : e;
      ge_add_niels(acc, acc, table[((size_t)kk * K2_TABLE + a) * stride], neg);
    }
  }
}

// the combine: parts[0] = the sum of the T partial sums, by the tree of
// tree_node (T - 1 unified additions)
template <class F, int T>
static XHE_HD void combine_parts(ge_t<F> *parts) {
#pragma unroll
  for (int h = T / 2; h >= 1; h >>= 1)
#pragma unroll
    for (int i = 0; i < h; ++i) tree_node(parts, i, h);
}

// -- K3: a tile of rows is cut into sub-tiles of K3_SUB rows (the whole tile
// when it is smaller).  Each sub-tile is reduced by the tree, and the
// sub-tiles' partial sums by the tree again.

constexpr int K3_SUB = 64;  // rows a block of K3 reduces (ops/kernels.py K3_SUB)

// thread t's leaf of a sub-tile of n rows: row t plus row t + n/2 (row 0
// alone when n is 1)
static XHE_HD ge tile_leaf(const int32_t *rows, int t, int n) {
  ge a;
  ge_from_rows(a, rows + 72 * t);
  if (n > 1) {
    ge b;
    ge_from_rows(b, rows + 72 * (t + n / 2));
    ge_add(a, a, b);
  }
  return a;
}

// K5 body: lane i of pts (N, 4, 18) and digits (64, N) -> out (4, 18) =
// s_i * P_i.  An extended table 1P..8P, then 64 windows from the top of 4
// doublings (T on the last only), a table pick (stored 8 picks the identity),
// negation of X and T for a negative digit, and one unified addition.
static XHE_HD void windowed_lane(int32_t *out, const int32_t *pts, const uint8_t *digits, int N,
                                 int i) {
  ge table[8];
  ge_from_rows(table[0], pts + (size_t)i * 72);
  ge_dbl(table[1], table[0], true);
  ge_add(table[2], table[1], table[0]);
  ge_dbl(table[3], table[1], true);
  ge_add(table[4], table[3], table[0]);
  ge_dbl(table[5], table[2], true);
  ge_add(table[6], table[5], table[0]);
  ge_dbl(table[7], table[3], true);

  ge acc, sel;
  ge_identity(acc);
#pragma unroll 1
  for (int w = 63; w >= 0; --w) {
    ge_dbl(acc, acc, false);
    ge_dbl(acc, acc, false);
    ge_dbl(acc, acc, false);
    ge_dbl(acc, acc, true);
    const int e = (int)digits[(size_t)w * N + i] - 8;
    const bool neg = e < 0;
    const int a = neg ? -e : e;
    if (a) {
      sel = table[a - 1];
    } else {
      ge_identity(sel);
    }
    fe_cneg(sel.X, neg, sel.X);
    fe_cneg(sel.T, neg, sel.T);
    ge_add(acc, acc, sel);
  }
  ge_to_rows(out, acc);
}

// -- K7: lane i of pts (N, 4, 18) and bit words (8, N) -> out (4, 18) =
// s_i * P_i by binary double-and-add over bits 0..252, LSB first: words 0-6
// give 32 bits each and word 7 gives 29; bits 253-255 are ignored.  Each of
// the 253 steps adds the running base into acc (the unified addition,
// selected by the bit) and doubles the base (the doubling, T kept).
//
// A lane is held by a quad of threads, roles r = 0..3, each holding both
// points whole.  The addition and the doubling each fall into two rounds of
// four independent field operations (Hisil, Wong, Carter, Dawson 2008, the
// 4-processor form), and the doubling of the base is independent of the
// addition that reads it, so a step is two rounds in which thread r takes
// the r-th operation of each:
//   round 1: X^2, Y^2, Z^2, (X+Y)^2 of base, and (Y1-X1)(Y2-X2),
//            (Y1+X1)(Y2+X2), T1 2d T2 (two products, role 2), 2Z1 Z2 of
//            acc + base;
//   round 2: E F, G H, F G, E H of each, from the four values of round 1.
// After each round every thread gathers the quad's four results (the
// kernel's exchange), so the E..H adds are repeated on each thread.  The
// operands are picked by role with data selects, not branches, so the quad
// runs one instruction stream; only role 2's second product is a branch.
// The formulas, their order and the association of T1 2d T2 are those of
// ge_dbl and ge_add, so every value equals theirs limb for limb.

constexpr int K7_QUAD = 4;  // threads a lane of K7

#ifdef __CUDACC__
// out[r] = the value of role r of this thread's quad (K7's lanes, K10's
// Horner chain): the quad's exchange after each round
static __device__ __forceinline__ void quad_gather(fe out[K7_QUAD], const fe &mine, unsigned mask) {
#pragma unroll
  for (int r = 0; r < K7_QUAD; ++r)
#pragma unroll
    for (int i = 0; i < 10; ++i) out[r].v[i] = __shfl_sync(mask, mine.v[i], r, K7_QUAD);
}
#endif

// h = the r-th of a, b, c, d
static XHE_HD void fe_pick4(fe &h, int r, const fe &a, const fe &b, const fe &c, const fe &d) {
#pragma unroll
  for (int i = 0; i < 10; ++i) h.v[i] = r == 0 ? a.v[i] : r == 1 ? b.v[i] : r == 2 ? c.v[i] : d.v[i];
}

// bit k of lane i's scalar
static XHE_HD bool daa_bit(const int32_t *bits, int N, int i, int k) {
  return ((uint32_t)bits[(size_t)(k >> 5) * N + i] >> (k & 31)) & 1u;
}

// round 1 of a doubling of p, role r: its squaring of X, Y, Z, X+Y
static XHE_HD void dbl_round1(fe &sq, const ge &p, int r) {
  fe u, xy;
  fe_add(xy, p.X, p.Y);
  fe_pick4(u, r, p.X, p.Y, p.Z, xy);
  fe_sq(sq, u);
}

// round 1 of the addition p + q, role r: its product of (Y1-X1)(Y2-X2),
// (Y1+X1)(Y2+X2), T1 2d T2, 2Z1 Z2
static XHE_HD void add_round1(fe &pr, const ge &p, const ge &q, int r) {
  fe u, v, ymx, ypx, zz, d2;
  fe_sub(ymx, p.Y, p.X);
  fe_add(ypx, p.Y, p.X);
  fe_add(zz, p.Z, p.Z);
  fe_pick4(u, r, ymx, ypx, p.T, zz);
  fe_sub(ymx, q.Y, q.X);
  fe_add(ypx, q.Y, q.X);
  fe_d2(d2);
  fe_pick4(v, r, ymx, ypx, d2, q.Z);
  fe_mul(pr, u, v);
  if (r == 2) fe_mul(pr, pr, q.T);
}

// round 1, role r: sq = its squaring of the doubling of base, pr = its
// product of the addition acc + base
static XHE_HD void daa_round1(fe &sq, fe &pr, const ge &acc, const ge &base, int r) {
  dbl_round1(sq, base, r);
  add_round1(pr, acc, base, r);
}

// E, F, G, H from round 1's four values of one operation, and role r's
// product of round 2 (X3 = E F, Y3 = G H, Z3 = F G, T3 = E H)
static XHE_HD void daa_round2_one(fe &out, const fe &e, const fe &f, const fe &g, const fe &h, int r) {
  fe u, v;
  fe_pick4(u, r, e, g, f, e);
  fe_pick4(v, r, f, h, g, h);
  fe_mul(out, u, v);
}

// round 2 of a doubling, role r: its coordinate of the double, from the
// quad's round-1 squarings sq[4] (ge_dbl's a, b, c, (X+Y)^2)
static XHE_HD void dbl_round2(fe &out, const fe sq[4], int r) {
  fe c, e, f, g, h;
  fe_add(c, sq[2], sq[2]);
  fe_add(h, sq[0], sq[1]);
  fe_sub(e, h, sq[3]);
  fe_sub(g, sq[0], sq[1]);
  fe_add(f, c, g);
  daa_round2_one(out, e, f, g, h, r);
}

// round 2 of an addition, role r: its coordinate of the sum, from the
// quad's round-1 products pr[4] (ge_add's a, b, c, d)
static XHE_HD void add_round2(fe &out, const fe pr[4], int r) {
  fe e, f, g, h;
  fe_sub(e, pr[1], pr[0]);
  fe_sub(f, pr[3], pr[2]);
  fe_add(g, pr[3], pr[2]);
  fe_add(h, pr[1], pr[0]);
  daa_round2_one(out, e, f, g, h, r);
}

// round 2, role r, from the quad's round-1 results sq[4] and pr[4]: dbl and
// add are its coordinates of the doubled base and of acc + base
static XHE_HD void daa_round2(fe &dbl, fe &add, const fe sq[4], const fe pr[4], int r) {
  dbl_round2(dbl, sq, r);
  add_round2(add, pr, r);
}

// p = the point whose coordinates roles 0..3 computed in round 2
static XHE_HD void quad_point(ge &p, const fe v[4]) {
  p.X = v[0];
  p.Y = v[1];
  p.Z = v[2];
  p.T = v[3];
}

// the end of a step, from the quad's round-2 results: base doubled, acc
// replaced by acc + base where the bit is set
static XHE_HD void daa_step_end(ge &acc, ge &base, const fe dbl[4], const fe add[4], bool bit) {
  quad_point(base, dbl);
  fe_select(acc.X, bit, add[0], acc.X);
  fe_select(acc.Y, bit, add[1], acc.Y);
  fe_select(acc.Z, bit, add[2], acc.Z);
  fe_select(acc.T, bit, add[3], acc.T);
}

// role r writes coordinate r of acc: its canonical row of 18 limbs at out + 18 r
static XHE_HD void daa_write(int32_t *out, const ge &acc, int r) {
  fe c;
  fe_pick4(c, r, acc.X, acc.Y, acc.Z, acc.T);
  fe_to_row15(out + 18 * r, c);
}

// -- K9: the bucket sums of Pippenger's windows.  A window's lanes are sorted
// by digit, so bucket b is a run [lo, hi) of the sorted order.  Its sum is
// the last element of the run in the JAX package's segmented Hillis-Steele
// scan (xelis_he_tpu/ops/msm.py _inclusive_scan): at shift s, element j of
// the run becomes x[j - s] + x[j] unless the run's head lies within s of it.
// For the last element, at offset L = hi - lo - 1, that is a balanced binary
// tree over the 2^K positions ending at L (2^K >= the run's length), whose
// positions before the run's head are empty: a node with an empty left half
// is its right half, with no addition.  Point j of the run sits at position
// pad + j, pad = 2^K - len.
//
// The positions are cut into blocks of 2^K9_K, aligned, so that each block
// is a subtree of that tree: a pass gives each block one thread, which walks
// it once (subtree_sum) and writes the block's subtree sum.  A run's block
// sums are then the leaves of the tree's levels above K9_K, with pad >> K9_K
// empty positions before them, and the next pass walks them the same way.
// A run of at most 2^K9_K points is one block, whose thread writes the
// bucket's sum.  Every addition is the scan's, with its operands on the
// same sides, so a bucket takes its run's length - 1 additions and the
// plain version's scan and the kernel give the same rows.

constexpr int K9_K = 4;  // log2 of the positions a thread of K9 walks (ops/kernels.py K9_K)

// The subtree over positions [0, 2^top) whose positions before p0 are empty,
// point(node, i) giving the point at position p0 + i: one partial sum a
// level (a binary counter over the positions), left + right as the scan
// adds them.  stack holds top + 1 points.
template <class Point>
static XHE_HD void subtree_sum(ge &out, ge *stack, unsigned p0, int top, Point point) {
  unsigned present = 0;  // bit l: stack[l] holds a left sibling
  ge node;
#pragma unroll 1
  for (unsigned p = p0; p < (1u << top); ++p) {
    point(node, p - p0);
    int l = 0;
#pragma unroll 1
    while ((p >> l) & 1) {  // node is a right child at level l
      if ((present >> l) & 1u) {
        ge_add(node, stack[l], node);
        present &= ~(1u << l);
      }
      ++l;
    }
    stack[l] = node;
    present |= 1u << l;
  }
  out = stack[top];
}

// the bucket u whose threads first[u] .. first[u + 1] - 1 hold thread t
// (first: nbk + 1 ascending entries, first[0] = 0 <= t < first[nbk])
static XHE_HD int bucket_of(const long long *first, int nbk, long long t) {
  int lo = 0, hi = nbk;
#pragma unroll 1
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (first[mid] <= t) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// A K9 pass's input point i: rows[order[i]] in pass 1 (order set), the
// previous pass's block sum in[i] after it
struct k9_input {
  const int32_t *rows, *order;
  const ge *in;
  XHE_HD void operator()(ge &p, long long i) const {
    if (order != nullptr) {
      ge_from_rows(p, rows + 72 * (size_t)order[i]);
    } else {
      p = in[i];
    }
  }
};

// Thread t of a K9 pass.  Bucket u's run is len[u] points at start[u] of the
// pass's input, point(node, i) giving input point i; its blocks are threads
// first[u] .. first[u + 1] - 1.  A run of at most 2^K9_K points (or none:
// the identity) is the bucket's sum, written to out + 72 u as rows; a longer
// run's block sums go to blocks[t], in order, for the next pass.  stack
// holds K9_K + 1 points.
template <class Point>
static XHE_HD void bucket_block(int32_t *out, ge *blocks, ge *stack, long long t, const long long *start,
                                const long long *len, const long long *first, int nbk, Point point) {
  const int u = bucket_of(first, nbk, t);
  const long long n = len[u], at = start[u];
  ge sum;
  if (n == 0) {
    ge_identity(sum);
    ge_to_rows(out + 72 * (size_t)u, sum);
    return;
  }
  int levels = 0;
  while ((1ll << levels) < n) ++levels;
  const long long pad = (1ll << levels) - n;
  if (levels <= K9_K) {
    subtree_sum(sum, stack, (unsigned)pad, levels, [&](ge &p, unsigned i) { point(p, at + i); });
    ge_to_rows(out + 72 * (size_t)u, sum);
    return;
  }
  const long long lo = ((pad >> K9_K) + t - first[u]) << K9_K;  // the block's first position
  const long long j0 = lo > pad ? lo - pad : 0;                  // its first point of the run
  subtree_sum(sum, stack, (unsigned)(pad + j0 - lo), K9_K, [&](ge &p, unsigned i) { point(p, at + j0 + i); });
  blocks[t] = sum;
}

// -- K10: the windows' weighted bucket sums, then Horner over the windows.
// Window w's buckets 1 .. 2^c - 1 are cut into G pieces of P = 2^c / G
// buckets and each piece into Q chunks of m = P / Q (bucket 0, the dropped
// digit, is the first of the window's chunk 0 and is never read).  Chunk k
// of a window is walked from the top: r runs over the suffix sums and acc
// adds them, so acc_k = sum_j j S_{k m + j} and r ends at the chunk's total
// T_k.  The same identity then serves twice, over the Q chunks of a piece
// and over the G pieces of a window: n items of s buckets each, with
// totals T_i and local weighted sums A_i, have
//   sum_b b S_b = sum_i A_i + s sum_i i T_i,  sum_i i T_i = sum_{i >= 1} R_i,
// R_i = sum_{j >= i} T_j, and R_0 is their total.
//
// On the card every point operation of K10 runs on a quad of threads with
// K7's rounds; the host build runs the same steps role by role.  The steps
// are a template argument: add(a, b) sets a = a + b, add2(a, b, c, d) sets
// a = a + b and c = c + d from the values before either (one pair of
// rounds for both), dbl(p, want_t) doubles p (T only where want_t).

constexpr int K10_MAX_THREADS = 256;  // threads of a K10 block, at most (its launch bound)

// chunk k of a window whose bucket b (1 <= b < 2^c) is at buckets + 72 (b -
// 1); m >= 2.  The walk is the running sum's, r = r + S_j then acc = acc +
// r for j = m - 2 .. 1 (and r = r + S_0 after the window's chunk 0), with
// each acc addition paired with the next r addition, which reads the same
// r: m - 1 steps, each step's bucket read during the step before it.  m is
// a power of two, so m > 2 means m >= 4.
XHE_STEPS_TEMPLATE
template <class Steps>
static XHE_HD void window_chunk(ge &r, ge &acc, const int32_t *buckets, int k, int m, const Steps &steps) {
  auto bucket = [&](ge &p, int j) { ge_from_rows(p, buckets + 72 * ((size_t)k * m + j - 1)); };  // S_{k m + j}
  ge s, ahead;
  bucket(r, m - 1);
  acc = r;
  if (m == 2) {
    if (k > 0) {
      bucket(s, 0);
      steps.add(r, s);
    }
    return;
  }
  bucket(s, m - 2);
  bucket(ahead, m - 3);
  steps.add(r, s);
#pragma unroll 1
  for (int j = m - 3; j >= 1; --j) {
    s = ahead;
    if (j > 1 || k > 0) bucket(ahead, j - 1);
    steps.add2(r, s, acc, r);
  }
  if (k > 0) {
    steps.add2(r, ahead, acc, r);
  } else {
    steps.add(acc, r);
  }
}

// buf[k] + buf[k + s] (buf[k] where k + s >= n): a level of the suffix scan
// over buf[0 .. n), and with n = 2 s a level of a tree
XHE_STEPS_TEMPLATE
template <class Steps>
static XHE_HD ge suffix_node(const ge *buf, int k, int s, int n, const Steps &steps) {
  ge v = buf[k];
  if (k + s < n) steps.add(v, buf[k + s]);
  return v;
}

// 2^n p, by n >= 1 doublings: T only on the last, which an addition reads
XHE_STEPS_TEMPLATE
template <class Steps>
static XHE_HD void dbl_n(ge &p, int n, const Steps &steps) {
#pragma unroll 1
  for (int i = 1; i <= n; ++i) steps.dbl(p, i == n);
}

// round 2 of a doubling for role r (dbl_round2) where want_t; a doubling
// that another doubling follows leaves T as it was (ge_dbl's want_t), so
// role 3 keeps its T there
static XHE_HD void k10_dbl_round2(fe &out, const fe sq[4], const ge &p, int r, bool want_t) {
  if (want_t || r != 3) {
    dbl_round2(out, sq, r);
  } else {
    out = p.T;
  }
}

}  // namespace xhe
