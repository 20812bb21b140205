// Host-side ristretto255 engine (SURVEY.md D1/D3/D4 host tier).
//
// The pure-Python layer (xelis_he_tpu_torch/pyref) is the exactness ground truth;
// this C++ engine mirrors it operation-for-operation (same formulas, same
// RFC 9496 encode/decode, same Pippenger windowing) and serves the host hot
// paths that are latency-bound rather than batch-bound: the transaction
// PROVER (per-tx commitments, sigma nonce points, range-proof MSMs), host
// fallbacks of the verifier, and symbolic-expression evaluation.  Batch-
// parallel verification math runs on the TPU (ops/pallas_msm.py); this
// engine exists so building a transaction does not cost seconds in Python
// ints.
//
// Field arithmetic: 5x51-bit limbs, unsigned __int128 products (ref10
// shape).  NOT constant-time: scalar multiplication uses a fixed window
// with data-independent op SEQUENCE, but table indexing is data-dependent;
// the Python-int fallback it replaces was fully variable-time already.
//
// Coordinates at the ABI boundary: extended Edwards (X:Y:Z:T), each a
// canonical 32-byte little-endian field element; points are 128 bytes.
//
// Built standalone as libxhecurve.so (hashcore/curve_native.py).

#include <cstdint>
#include <cstring>

typedef unsigned __int128 u128;
typedef uint64_t u64;

namespace {

constexpr u64 MASK51 = (((u64)1) << 51) - 1;

struct fe {
  u64 v[5];
};

inline void fe_load(const uint8_t b[32], fe &o) {
  u64 w[4];
  std::memcpy(w, b, 32);
  o.v[0] = w[0] & MASK51;
  o.v[1] = ((w[0] >> 51) | (w[1] << 13)) & MASK51;
  o.v[2] = ((w[1] >> 38) | (w[2] << 26)) & MASK51;
  o.v[3] = ((w[2] >> 25) | (w[3] << 39)) & MASK51;
  o.v[4] = (w[3] >> 12) & MASK51;  // masks bit 255
}

inline void fe_carry(fe &a) {
  // one pass of carry propagation with *19 wraparound; keeps limbs < 2^52
  u64 c;
  c = a.v[0] >> 51; a.v[0] &= MASK51; a.v[1] += c;
  c = a.v[1] >> 51; a.v[1] &= MASK51; a.v[2] += c;
  c = a.v[2] >> 51; a.v[2] &= MASK51; a.v[3] += c;
  c = a.v[3] >> 51; a.v[3] &= MASK51; a.v[4] += c;
  c = a.v[4] >> 51; a.v[4] &= MASK51; a.v[0] += 19 * c;
  c = a.v[0] >> 51; a.v[0] &= MASK51; a.v[1] += c;
}

// canonical freeze: limbs < 2^51 and value < p
inline void fe_freeze(fe &a) {
  fe_carry(a);
  fe_carry(a);
  // now a < 2^255; subtract p if >= p
  u64 t[5];
  // add 19 and see if it overflows 255 bits (i.e. a >= p)
  t[0] = a.v[0] + 19;
  u64 c = t[0] >> 51; t[0] &= MASK51;
  t[1] = a.v[1] + c; c = t[1] >> 51; t[1] &= MASK51;
  t[2] = a.v[2] + c; c = t[2] >> 51; t[2] &= MASK51;
  t[3] = a.v[3] + c; c = t[3] >> 51; t[3] &= MASK51;
  t[4] = a.v[4] + c; c = t[4] >> 51; t[4] &= MASK51;
  // a >= p: keep t (== a - p after dropping the 2^255 carry).  Branchless
  // select so freeze timing never depends on the value being frozen.
  u64 mask = 0 - c;  // c is 0 or 1
  for (int i = 0; i < 5; ++i) a.v[i] ^= mask & (a.v[i] ^ t[i]);
}

inline void fe_store(const fe &a_in, uint8_t b[32]) {
  fe a = a_in;
  fe_freeze(a);
  u64 w[4];
  w[0] = a.v[0] | (a.v[1] << 51);
  w[1] = (a.v[1] >> 13) | (a.v[2] << 38);
  w[2] = (a.v[2] >> 26) | (a.v[3] << 25);
  w[3] = (a.v[3] >> 39) | (a.v[4] << 12);
  std::memcpy(b, w, 32);
}

inline void fe_add(const fe &a, const fe &b, fe &o) {
  for (int i = 0; i < 5; ++i) o.v[i] = a.v[i] + b.v[i];
  fe_carry(o);
}

// 2p in 5x51 (so a - b never underflows for reduced a, b)
constexpr u64 TWO_P0 = 0xFFFFFFFFFFFDA * 2 - 0xFFFFFFFFFFFDA + 0xFFFFFFFFFFFDA;  // placeholder (unused)

inline void fe_sub(const fe &a, const fe &b, fe &o) {
  // a + 2p - b, limbwise (2p limbs: 0xFFFFFFFFFFFDA? p = 2^255-19:
  //   p = (2^51-19, 2^51-1, 2^51-1, 2^51-1, 2^51-1)
  //   2p = (2^52-38, 2^52-2, 2^52-2, 2^52-2, 2^52-2))
  const u64 P0 = ((((u64)1) << 52) - 38);
  const u64 PI = ((((u64)1) << 52) - 2);
  o.v[0] = a.v[0] + P0 - b.v[0];
  o.v[1] = a.v[1] + PI - b.v[1];
  o.v[2] = a.v[2] + PI - b.v[2];
  o.v[3] = a.v[3] + PI - b.v[3];
  o.v[4] = a.v[4] + PI - b.v[4];
  fe_carry(o);
}

inline void fe_neg(const fe &a, fe &o) {
  fe zero{};
  fe_sub(zero, a, o);
}

void fe_mul(const fe &a, const fe &b, fe &o) {
  u128 t0, t1, t2, t3, t4;
  u64 a0 = a.v[0], a1 = a.v[1], a2 = a.v[2], a3 = a.v[3], a4 = a.v[4];
  u64 b0 = b.v[0], b1 = b.v[1], b2 = b.v[2], b3 = b.v[3], b4 = b.v[4];
  u64 b1_19 = 19 * b1, b2_19 = 19 * b2, b3_19 = 19 * b3, b4_19 = 19 * b4;
  t0 = (u128)a0 * b0 + (u128)a1 * b4_19 + (u128)a2 * b3_19 + (u128)a3 * b2_19 + (u128)a4 * b1_19;
  t1 = (u128)a0 * b1 + (u128)a1 * b0 + (u128)a2 * b4_19 + (u128)a3 * b3_19 + (u128)a4 * b2_19;
  t2 = (u128)a0 * b2 + (u128)a1 * b1 + (u128)a2 * b0 + (u128)a3 * b4_19 + (u128)a4 * b3_19;
  t3 = (u128)a0 * b3 + (u128)a1 * b2 + (u128)a2 * b1 + (u128)a3 * b0 + (u128)a4 * b4_19;
  t4 = (u128)a0 * b4 + (u128)a1 * b3 + (u128)a2 * b2 + (u128)a3 * b1 + (u128)a4 * b0;
  u64 c;
  u64 r0 = (u64)t0 & MASK51; c = (u64)(t0 >> 51);
  t1 += c;
  u64 r1 = (u64)t1 & MASK51; c = (u64)(t1 >> 51);
  t2 += c;
  u64 r2 = (u64)t2 & MASK51; c = (u64)(t2 >> 51);
  t3 += c;
  u64 r3 = (u64)t3 & MASK51; c = (u64)(t3 >> 51);
  t4 += c;
  u64 r4 = (u64)t4 & MASK51; c = (u64)(t4 >> 51);
  r0 += 19 * c;
  c = r0 >> 51; r0 &= MASK51; r1 += c;
  o.v[0] = r0; o.v[1] = r1; o.v[2] = r2; o.v[3] = r3; o.v[4] = r4;
}

inline void fe_sqr(const fe &a, fe &o) { fe_mul(a, a, o); }

void fe_sqn(fe &a, int n) {
  for (int i = 0; i < n; ++i) fe_sqr(a, a);
}

// x^(2^250 - 1) and x^11 (shared prefix of invert / pow_p58)
void fe_pow22501(const fe &x, fe &t7_out, fe &t0_out) {
  fe t0, t1, t2, t3, t4, t5, t6, t7;
  fe_sqr(x, t0);            // x^2
  fe_sqr(t0, t1); fe_sqr(t1, t1);  // x^8
  fe_mul(x, t1, t1);        // x^9
  fe_mul(t0, t1, t0);       // x^11
  fe_sqr(t0, t2);           // x^22
  fe_mul(t1, t2, t2);       // x^31
  t3 = t2; fe_sqn(t3, 5); fe_mul(t3, t2, t3);     // 2^10-1
  t4 = t3; fe_sqn(t4, 10); fe_mul(t4, t3, t4);    // 2^20-1
  t5 = t4; fe_sqn(t5, 20); fe_mul(t5, t4, t5);    // 2^40-1
  fe_sqn(t5, 10); fe_mul(t5, t3, t5);             // 2^50-1
  t6 = t5; fe_sqn(t6, 50); fe_mul(t6, t5, t6);    // 2^100-1
  t7 = t6; fe_sqn(t7, 100); fe_mul(t7, t6, t7);   // 2^200-1
  fe_sqn(t7, 50); fe_mul(t7, t5, t7);             // 2^250-1
  t7_out = t7;
  t0_out = t0;
}

void fe_invert(const fe &x, fe &o) {
  fe t7, t0;
  fe_pow22501(x, t7, t0);
  fe_sqn(t7, 5);
  fe_mul(t7, t0, o);  // x^(2^255 - 21) = x^(p-2)
}

void fe_pow_p58(const fe &x, fe &o) {
  fe t7, t0;
  fe_pow22501(x, t7, t0);
  fe_sqn(t7, 2);
  fe_mul(t7, x, o);  // x^(2^252 - 3) = x^((p-5)/8)
}

inline bool fe_eq(const fe &a, const fe &b) {
  uint8_t ab[32], bb[32];
  fe_store(a, ab);
  fe_store(b, bb);
  return std::memcmp(ab, bb, 32) == 0;
}

inline bool fe_is_zero(const fe &a) {
  uint8_t ab[32];
  fe_store(a, ab);
  for (int i = 0; i < 32; ++i)
    if (ab[i]) return false;
  return true;
}

inline bool fe_is_negative(const fe &a) {
  uint8_t ab[32];
  fe_store(a, ab);
  return ab[0] & 1;
}

inline void fe_abs(const fe &a, fe &o) {
  if (fe_is_negative(a)) fe_neg(a, o);
  else o = a;
}

inline void fe_one(fe &o) { o = fe{{1, 0, 0, 0, 0}}; }

// -- derived constants (computed once; mirror pyref/field.py) ----------------

struct Consts {
  fe D, D2, SQRT_M1, INVSQRT_A_MINUS_D, ONE_MINUS_D_SQ, D_MINUS_ONE_SQ,
      SQRT_AD_MINUS_ONE;
};

bool sqrt_ratio_m1(const fe &u, const fe &v, const fe &sqrt_m1, fe &r_out);

const Consts &consts() {
  static Consts C;
  static bool init = false;
  if (!init) {
    // d = -121665/121666
    fe n{{121665, 0, 0, 0, 0}}, m{{121666, 0, 0, 0, 0}}, mi, nd;
    fe_invert(m, mi);
    fe_mul(n, mi, nd);
    fe_neg(nd, C.D);
    fe_add(C.D, C.D, C.D2);
    // sqrt(-1) = 2^((p-1)/4): compute as sqrt_ratio... simpler: literal bytes
    static const uint8_t SQRT_M1_B[32] = {
        0xb0, 0xa0, 0x0e, 0x4a, 0x27, 0x1b, 0xee, 0xc4, 0x78, 0xe4, 0x2f,
        0xad, 0x06, 0x18, 0x43, 0x2f, 0xa7, 0xd7, 0xfb, 0x3d, 0x99, 0x00,
        0x4d, 0x2b, 0x0b, 0xdf, 0xc1, 0x4f, 0x80, 0x24, 0x83, 0x2b};
    fe_load(SQRT_M1_B, C.SQRT_M1);
    // 1 - d^2, (d-1)^2
    fe one, dd, dm1;
    fe_one(one);
    fe_sqr(C.D, dd);
    fe_sub(one, dd, C.ONE_MINUS_D_SQ);
    fe_sub(C.D, one, dm1);
    fe_sqr(dm1, C.D_MINUS_ONE_SQ);
    // invsqrt(-(1+d)) == invsqrt(a - d), a = -1
    fe a_minus_d, tmp;
    fe_add(one, C.D, tmp);
    fe_neg(tmp, a_minus_d);
    fe u1;
    fe_one(u1);
    sqrt_ratio_m1(u1, a_minus_d, C.SQRT_M1, C.INVSQRT_A_MINUS_D);
    // sqrt(ad - 1) = invsqrt_a_minus_d * (a - d), forced ODD
    fe_mul(C.INVSQRT_A_MINUS_D, a_minus_d, C.SQRT_AD_MINUS_ONE);
    if (!fe_is_negative(C.SQRT_AD_MINUS_ONE))
      fe_neg(C.SQRT_AD_MINUS_ONE, C.SQRT_AD_MINUS_ONE);
    init = true;
  }
  return C;
}

// RFC 9496 SQRT_RATIO_M1 (mirrors pyref.field.sqrt_ratio_m1)
bool sqrt_ratio_m1(const fe &u, const fe &v, const fe &sqrt_m1, fe &r_out) {
  fe v3, v7, r, check, t;
  fe_sqr(v, t);
  fe_mul(t, v, v3);
  fe_sqr(v3, t);
  fe_mul(t, v, v7);
  fe uv7;
  fe_mul(u, v7, uv7);
  fe p58;
  fe_pow_p58(uv7, p58);
  fe_mul(u, v3, t);
  fe_mul(t, p58, r);
  fe rr;
  fe_sqr(r, rr);
  fe_mul(v, rr, check);

  fe neg_u, neg_u_i;
  fe_neg(u, neg_u);
  fe_mul(neg_u, sqrt_m1, neg_u_i);
  bool correct = fe_eq(check, u);
  bool flipped = fe_eq(check, neg_u);
  bool flipped_i = fe_eq(check, neg_u_i);
  if (flipped || flipped_i) {
    fe_mul(r, sqrt_m1, r);
  }
  fe_abs(r, r_out);
  return correct || flipped;
}

// -- extended Edwards points -------------------------------------------------

struct pt {
  fe X, Y, Z, T;
};

inline void pt_load(const uint8_t b[128], pt &p) {
  fe_load(b, p.X);
  fe_load(b + 32, p.Y);
  fe_load(b + 64, p.Z);
  fe_load(b + 96, p.T);
}

inline void pt_store(const pt &p, uint8_t b[128]) {
  fe_store(p.X, b);
  fe_store(p.Y, b + 32);
  fe_store(p.Z, b + 64);
  fe_store(p.T, b + 96);
}

inline void pt_identity(pt &p) {
  p.X = fe{};
  fe_one(p.Y);
  fe_one(p.Z);
  p.T = fe{};
}

// add-2008-hwcd-3, a = -1 (complete on edwards25519)
void pt_add(const pt &p, const pt &q, pt &o) {
  const Consts &C = consts();
  fe A, B, Cc, Dd, E, F, G, H, t1, t2;
  fe_sub(p.Y, p.X, t1);
  fe_sub(q.Y, q.X, t2);
  fe_mul(t1, t2, A);
  fe_add(p.Y, p.X, t1);
  fe_add(q.Y, q.X, t2);
  fe_mul(t1, t2, B);
  fe_mul(p.T, C.D2, t1);
  fe_mul(t1, q.T, Cc);
  fe_add(p.Z, p.Z, t1);
  fe_mul(t1, q.Z, Dd);
  fe_sub(B, A, E);
  fe_sub(Dd, Cc, F);
  fe_add(Dd, Cc, G);
  fe_add(B, A, H);
  fe_mul(E, F, o.X);
  fe_mul(G, H, o.Y);
  fe_mul(F, G, o.Z);
  fe_mul(E, H, o.T);
}

// dbl-2008-hwcd, a = -1
void pt_dbl(const pt &p, pt &o) {
  fe A, B, Cc, E, F, G, H, t;
  fe_sqr(p.X, A);
  fe_sqr(p.Y, B);
  fe_sqr(p.Z, Cc);
  fe_add(Cc, Cc, Cc);
  fe_add(A, B, H);
  fe_add(p.X, p.Y, t);
  fe_sqr(t, t);
  fe_sub(H, t, E);
  fe_sub(A, B, G);
  fe_add(Cc, G, F);
  fe_mul(E, F, o.X);
  fe_mul(G, H, o.Y);
  fe_mul(F, G, o.Z);
  fe_mul(E, H, o.T);
}

inline void pt_neg(const pt &p, pt &o) {
  fe_neg(p.X, o.X);
  o.Y = p.Y;
  o.Z = p.Z;
  fe_neg(p.T, o.T);
}

// constant-time conditional move: r = mask ? a : r  (mask is 0 or ~0)
inline void fe_cmov(fe &r, const fe &a, u64 mask) {
  for (int i = 0; i < 5; ++i) r.v[i] ^= mask & (r.v[i] ^ a.v[i]);
}

inline void pt_cmov(pt &r, const pt &a, u64 mask) {
  fe_cmov(r.X, a.X, mask);
  fe_cmov(r.Y, a.Y, mask);
  fe_cmov(r.Z, a.Z, mask);
  fe_cmov(r.T, a.T, mask);
}

// constant-time table lookup: o = table[idx] via a full masked scan
inline void pt_select(const pt table[16], u64 idx, pt &o) {
  pt_identity(o);
  for (u64 j = 0; j < 16; ++j) {
    // mask = ~0 iff j == idx, without a branch
    u64 diff = j ^ idx;
    u64 mask = (u64)(((diff | (0 - diff)) >> 63) - 1);  // 0 -> ~0, else 0
    pt_cmov(o, table[j], mask);
  }
}

// best-effort secret wipe (volatile writes defeat dead-store elimination)
inline void secure_wipe(void *p, size_t n) {
  volatile uint8_t *q = (volatile uint8_t *)p;
  for (size_t i = 0; i < n; ++i) q[i] = 0;
}

// CONSTANT-TIME fixed 4-bit window scalar mul (SURVEY.md §5 prover
// discipline; reference parity: dalek's subtle-based ops).  The op
// sequence is scalar-independent (64 windows x 4 doubles + 1 unified add,
// identity rows handled by the unified formulas), the table lookup is a
// full masked scan (no data-dependent indexing), and the window table is
// wiped on exit.  fe muls use u64->u128 multiplies (constant-time on all
// supported targets).
void pt_mul(const uint8_t k[32], const pt &p, pt &o) {
  pt table[16];
  pt_identity(table[0]);
  table[1] = p;
  for (int i = 2; i < 16; ++i) pt_add(table[i - 1], p, table[i]);
  pt acc;
  pt_identity(acc);
  for (int i = 63; i >= 0; --i) {
    if (i != 63) {  // iteration count is public; this branch is index-only
      pt_dbl(acc, acc);
      pt_dbl(acc, acc);
      pt_dbl(acc, acc);
      pt_dbl(acc, acc);
    }
    u64 nib = (u64)((k[i / 2] >> ((i & 1) * 4)) & 0xF);
    pt sel, t;
    pt_select(table, nib, sel);
    pt_add(acc, sel, t);
    acc = t;
  }
  o = acc;
  secure_wipe(table, sizeof table);
  secure_wipe(&acc, sizeof acc);
}

}  // namespace

extern "C" {

void xhe_pt_add(const uint8_t *p, const uint8_t *q, uint8_t *out) {
  pt a, b, c;
  pt_load(p, a);
  pt_load(q, b);
  pt_add(a, b, c);
  pt_store(c, out);
}

void xhe_pt_dbl(const uint8_t *p, uint8_t *out) {
  pt a, c;
  pt_load(p, a);
  pt_dbl(a, c);
  pt_store(c, out);
}

void xhe_pt_neg(const uint8_t *p, uint8_t *out) {
  pt a, c;
  pt_load(p, a);
  pt_neg(a, c);
  pt_store(c, out);
}

// scalar k: 32-byte little-endian, already reduced mod L by the caller
void xhe_pt_mul(const uint8_t *k, const uint8_t *p, uint8_t *out) {
  pt a, c;
  pt_load(p, a);
  pt_mul(k, a, c);
  pt_store(c, out);
}

// ristretto equality: X1*Y2 == Y1*X2 or X1*X2 == Y1*Y2
int xhe_pt_eq(const uint8_t *p, const uint8_t *q) {
  pt a, b;
  pt_load(p, a);
  pt_load(q, b);
  fe t1, t2;
  fe_mul(a.X, b.Y, t1);
  fe_mul(a.Y, b.X, t2);
  if (fe_eq(t1, t2)) return 1;
  fe_mul(a.X, b.X, t1);
  fe_mul(a.Y, b.Y, t2);
  return fe_eq(t1, t2) ? 1 : 0;
}

// RFC 9496 ENCODE (mirrors pyref RistrettoPoint.compress)
void xhe_pt_compress(const uint8_t *p, uint8_t *out) {
  const Consts &C = consts();
  pt a;
  pt_load(p, a);
  fe u1, u2, t1, t2, invsqrt, one;
  fe_add(a.Z, a.Y, t1);
  fe_sub(a.Z, a.Y, t2);
  fe_mul(t1, t2, u1);
  fe_mul(a.X, a.Y, u2);
  fe u2s;
  fe_sqr(u2, u2s);
  fe_mul(u1, u2s, t1);
  fe_one(one);
  sqrt_ratio_m1(one, t1, C.SQRT_M1, invsqrt);
  fe den1, den2, z_inv;
  fe_mul(invsqrt, u1, den1);
  fe_mul(invsqrt, u2, den2);
  fe_mul(den1, den2, t1);
  fe_mul(t1, a.T, z_inv);
  fe ix0, iy0, ench;
  fe_mul(a.X, C.SQRT_M1, ix0);
  fe_mul(a.Y, C.SQRT_M1, iy0);
  fe_mul(den1, C.INVSQRT_A_MINUS_D, ench);
  fe tz;
  fe_mul(a.T, z_inv, tz);
  fe X = a.X, Y = a.Y, den_inv;
  if (fe_is_negative(tz)) {
    X = iy0;
    Y = ix0;
    den_inv = ench;
  } else {
    den_inv = den2;
  }
  fe xz;
  fe_mul(X, z_inv, xz);
  if (fe_is_negative(xz)) fe_neg(Y, Y);
  fe zy, s;
  fe_sub(a.Z, Y, zy);
  fe_mul(den_inv, zy, s);
  fe_abs(s, s);
  fe_store(s, out);
}

// RFC 9496 DECODE; returns 1 and writes 128-byte point if valid, else 0
int xhe_pt_decompress(const uint8_t *data, uint8_t *out) {
  const Consts &C = consts();
  // canonical check: s < p and even
  if (data[0] & 1) return 0;
  if (data[31] & 0x80) return 0;
  // s >= p check
  static const uint8_t PB[32] = {0xed, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
                                 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
                                 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
                                 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
                                 0xff, 0xff, 0xff, 0x7f};
  for (int i = 31; i >= 0; --i) {
    if (data[i] < PB[i]) break;
    if (data[i] > PB[i]) return 0;
    if (i == 0) return 0;  // s == p
  }
  fe s, ss, u1, u2, u2s, v, t1, one;
  fe_load(data, s);
  fe_one(one);
  fe_sqr(s, ss);
  fe_sub(one, ss, u1);
  fe_add(one, ss, u2);
  fe_sqr(u2, u2s);
  // v = -d*u1^2 - u2^2
  fe du1, du11;
  fe_mul(C.D, u1, du1);
  fe_mul(du1, u1, du11);
  fe_neg(du11, du11);
  fe_sub(du11, u2s, v);
  fe vu2s, invsqrt;
  fe_mul(v, u2s, vu2s);
  bool was_square = sqrt_ratio_m1(one, vu2s, C.SQRT_M1, invsqrt);
  fe den_x, den_y;
  fe_mul(invsqrt, u2, den_x);
  fe_mul(invsqrt, den_x, t1);
  fe_mul(t1, v, den_y);
  fe x, y, t;
  fe_add(s, s, t1);
  fe_mul(t1, den_x, x);
  fe_abs(x, x);
  fe_mul(u1, den_y, y);
  fe_mul(x, y, t);
  if (!was_square || fe_is_negative(t) || fe_is_zero(y)) return 0;
  pt o;
  o.X = x;
  o.Y = y;
  fe_one(o.Z);
  o.T = t;
  pt_store(o, out);
  return 1;
}

// Pippenger variable-time MSM (mirrors pyref.multiscalar_mul windowing):
// scalars (n, 32) canonical LE, points (n, 128) extended coords.
void xhe_pt_msm(const uint8_t *scalars, const uint8_t *points, size_t n,
                uint8_t *out) {
  pt acc;
  pt_identity(acc);
  if (n == 0) {
    pt_store(acc, out);
    return;
  }
  // window size minimizing windows * (inserts + 2*buckets): the old
  // `2^(c+1) < n` heuristic overshot by ~2 bits at large n
  int c = 4;
  double bestc = 1e30;
  for (int t = 4; t <= 16; ++t) {
    double cost = ((253 + t - 1) / t) * ((double)n + 2.0 * (1u << t));
    if (cost < bestc) {
      bestc = cost;
      c = t;
    }
  }
  const size_t nb = ((size_t)1) << c;
  const u64 mask = nb - 1;
  int windows = (253 + c - 1) / c;

  pt *pts = new pt[n];
  for (size_t i = 0; i < n; ++i) pt_load(points + 128 * i, pts[i]);
  pt *buckets = new pt[nb];
  bool *used = new bool[nb];

  bool acc_zero = true;
  for (int w = windows - 1; w >= 0; --w) {
    if (!acc_zero)
      for (int i = 0; i < c; ++i) pt_dbl(acc, acc);
    std::memset(used, 0, nb);
    for (size_t i = 0; i < n; ++i) {
      // digit = (s >> (w*c)) & mask over the 32-byte scalar
      int bit = w * c;
      int byte = bit >> 3, off = bit & 7;
      u64 chunk = 0;
      for (int k = 0; k < 4 && byte + k < 32; ++k)
        chunk |= ((u64)scalars[32 * i + byte + k]) << (8 * k);
      u64 digit = (chunk >> off) & mask;
      if (!digit) continue;
      if (used[digit]) {
        pt t;
        pt_add(buckets[digit], pts[i], t);
        buckets[digit] = t;
      } else {
        buckets[digit] = pts[i];
        used[digit] = true;
      }
    }
    pt running, window_sum;
    pt_identity(running);
    pt_identity(window_sum);
    for (size_t b = nb - 1; b >= 1; --b) {
      if (used[b]) {
        pt t;
        pt_add(running, buckets[b], t);
        running = t;
      }
      pt t;
      pt_add(window_sum, running, t);
      window_sum = t;
    }
    pt t;
    pt_add(acc, window_sum, t);
    acc = t;
    acc_zero = false;
  }
  delete[] pts;
  delete[] buckets;
  delete[] used;
  pt_store(acc, out);
}

}  // extern "C"
