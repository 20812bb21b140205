// Batched scalar arithmetic mod the Ristretto group order
//   L = 2^252 + 27742317777372353535851937790883648493
// for the host-side proof bookkeeping (SURVEY.md D2: the reference consumes
// curve25519-dalek Scalar ops; the TPU rebuild keeps secrets and per-proof
// scalar folding on host, batched through this C++ engine).
//
// Representation at the API boundary: 32-byte little-endian canonical
// scalars, arrays of shape (n, 32).  Internally 4x64-bit limbs with CIOS
// Montgomery multiplication (R = 2^256).
//
// Build: part of libxhehashcore-adjacent library libxhescalar.so (see
// hashcore/native.py's sibling loader in scalarops.py).

#include <cstdint>
#include <cstring>

typedef unsigned __int128 u128;
typedef uint64_t u64;

static const u64 Lm[4] = {0x5812631a5cf5d3edULL, 0x14def9dea2f79cd6ULL,
                          0x0000000000000000ULL, 0x1000000000000000ULL};
static const u64 LPRIME = 0xd2b51da312547e1bULL;  // -L^{-1} mod 2^64
static const u64 R1m[4] = {0xd6ec31748d98951dULL, 0xc6ef5bf4737dcf70ULL,
                           0xfffffffffffffffeULL, 0x0fffffffffffffffULL};  // 2^256 mod L
static const u64 R2m[4] = {0xa40611e3449c0f01ULL, 0xd00e1ba768859347ULL,
                           0xceec73d217f5be65ULL, 0x0399411b7c309a3dULL};  // 2^512 mod L

struct Sc {
  u64 v[4];
};

static inline bool geq_L(const u64 a[4]) {
  for (int i = 3; i >= 0; --i) {
    if (a[i] > Lm[i]) return true;
    if (a[i] < Lm[i]) return false;
  }
  return true;  // equal
}

static inline void sub_L(u64 a[4]) {
  u128 borrow = 0;
  for (int i = 0; i < 4; ++i) {
    u128 d = (u128)a[i] - Lm[i] - borrow;
    a[i] = (u64)d;
    borrow = (d >> 64) & 1;
  }
}

static inline void cond_reduce(u64 a[4]) {
  if (geq_L(a)) sub_L(a);
}

// out = a + b mod L  (inputs < L)
static inline void add_mod(const u64 a[4], const u64 b[4], u64 out[4]) {
  u128 carry = 0;
  for (int i = 0; i < 4; ++i) {
    u128 s = (u128)a[i] + b[i] + carry;
    out[i] = (u64)s;
    carry = s >> 64;
  }
  // a+b < 2L < 2^254 so carry == 0; one conditional subtract suffices
  cond_reduce(out);
}

// out = a - b mod L  (inputs < L)
static inline void sub_mod(const u64 a[4], const u64 b[4], u64 out[4]) {
  u128 borrow = 0;
  for (int i = 0; i < 4; ++i) {
    u128 d = (u128)a[i] - b[i] - borrow;
    out[i] = (u64)d;
    borrow = (d >> 64) & 1;
  }
  if (borrow) {  // add L back
    u128 carry = 0;
    for (int i = 0; i < 4; ++i) {
      u128 s = (u128)out[i] + Lm[i] + carry;
      out[i] = (u64)s;
      carry = s >> 64;
    }
  }
}

// CIOS Montgomery multiplication: out = a * b * R^{-1} mod L
static void mont_mul(const u64 a[4], const u64 b[4], u64 out[4]) {
  u64 t[6] = {0, 0, 0, 0, 0, 0};
  for (int i = 0; i < 4; ++i) {
    // t += a[i] * b
    u128 carry = 0;
    for (int j = 0; j < 4; ++j) {
      u128 s = (u128)t[j] + (u128)a[i] * b[j] + carry;
      t[j] = (u64)s;
      carry = s >> 64;
    }
    u128 s = (u128)t[4] + carry;
    t[4] = (u64)s;
    t[5] = (u64)(s >> 64);
    // m = t[0] * LPRIME mod 2^64; t += m * L; t >>= 64
    u64 m = t[0] * LPRIME;
    carry = ((u128)t[0] + (u128)m * Lm[0]) >> 64;
    for (int j = 1; j < 4; ++j) {
      u128 s2 = (u128)t[j] + (u128)m * Lm[j] + carry;
      t[j - 1] = (u64)s2;
      carry = s2 >> 64;
    }
    s = (u128)t[4] + carry;
    t[3] = (u64)s;
    t[4] = t[5] + (u64)(s >> 64);
    t[5] = 0;
  }
  // t[4] can be at most 1; final reduction
  if (t[4]) sub_L(t);  // t - L still may exceed? t < 2L when t[4]==1 handled below
  std::memcpy(out, t, 32);
  cond_reduce(out);
}

// normal-form product: a*b mod L = mont(mont(a,b), R2)
static inline void mul_mod(const u64 a[4], const u64 b[4], u64 out[4]) {
  u64 m[4];
  mont_mul(a, b, m);
  mont_mul(m, R2m, out);
}

static inline void load(const uint8_t* p, u64 v[4]) { std::memcpy(v, p, 32); }
static inline void store(uint8_t* p, const u64 v[4]) { std::memcpy(p, v, 32); }

// double a (Montgomery- or normal-form) value in place (add mod L)
static inline void dbl_mod(u64 a[4]) {
  u64 t[4];
  add_mod(a, a, t);
  std::memcpy(a, t, 32);
}

extern "C" {

// elementwise out[i] = a[i] * b[i]
void xhe_sc_mul(const uint8_t* a, const uint8_t* b, uint8_t* out, size_t n) {
  for (size_t i = 0; i < n; ++i) {
    u64 x[4], y[4], z[4];
    load(a + 32 * i, x);
    load(b + 32 * i, y);
    mul_mod(x, y, z);
    store(out + 32 * i, z);
  }
}

// out[i] = a[i] * s
void xhe_sc_muls(const uint8_t* a, const uint8_t* s, uint8_t* out, size_t n) {
  u64 y[4], ym[4];
  load(s, y);
  mont_mul(y, R2m, ym);  // y*R
  for (size_t i = 0; i < n; ++i) {
    u64 x[4], z[4];
    load(a + 32 * i, x);
    mont_mul(x, ym, z);  // x*yR*R^{-1} = x*y
    store(out + 32 * i, z);
  }
}

void xhe_sc_add(const uint8_t* a, const uint8_t* b, uint8_t* out, size_t n) {
  for (size_t i = 0; i < n; ++i) {
    u64 x[4], y[4], z[4];
    load(a + 32 * i, x);
    load(b + 32 * i, y);
    add_mod(x, y, z);
    store(out + 32 * i, z);
  }
}

void xhe_sc_sub(const uint8_t* a, const uint8_t* b, uint8_t* out, size_t n) {
  for (size_t i = 0; i < n; ++i) {
    u64 x[4], y[4], z[4];
    load(a + 32 * i, x);
    load(b + 32 * i, y);
    sub_mod(x, y, z);
    store(out + 32 * i, z);
  }
}

// acc[i] = acc[i] + a[i] * s   (the batch-fold primitive)
void xhe_sc_axpy(uint8_t* acc, const uint8_t* a, const uint8_t* s, size_t n) {
  u64 y[4], ym[4];
  load(s, y);
  mont_mul(y, R2m, ym);
  for (size_t i = 0; i < n; ++i) {
    u64 x[4], p[4], c[4], z[4];
    load(a + 32 * i, x);
    mont_mul(x, ym, p);
    load(acc + 32 * i, c);
    add_mod(c, p, z);
    store(acc + 32 * i, z);
  }
}

// out[i] = x^i for i in [0, n)
void xhe_sc_powers(const uint8_t* x, uint8_t* out, size_t n) {
  if (n == 0) return;
  u64 xm[4], acc[4], xv[4];
  load(x, xv);
  mont_mul(xv, R2m, xm);  // x*R
  u64 one[4] = {1, 0, 0, 0};
  std::memcpy(acc, one, 32);
  store(out, acc);
  for (size_t i = 1; i < n; ++i) {
    u64 t[4];
    mont_mul(acc, xm, t);  // acc*xR*R^{-1} = acc*x
    std::memcpy(acc, t, 32);
    store(out + 32 * i, acc);
  }
}

// out = sum a[i]*b[i]
void xhe_sc_inner(const uint8_t* a, const uint8_t* b, uint8_t* out, size_t n) {
  u64 acc[4] = {0, 0, 0, 0};
  for (size_t i = 0; i < n; ++i) {
    u64 x[4], y[4], p[4], t[4];
    load(a + 32 * i, x);
    load(b + 32 * i, y);
    mul_mod(x, y, p);
    add_mod(acc, p, t);
    std::memcpy(acc, t, 32);
  }
  store(out, acc);
}

// out = sum a[i]  (mod L)
void xhe_sc_sum(const uint8_t* a, uint8_t* out, size_t n) {
  u64 acc[4] = {0, 0, 0, 0};
  for (size_t i = 0; i < n; ++i) {
    u64 x[4], t[4];
    load(a + 32 * i, x);
    add_mod(acc, x, t);
    std::memcpy(acc, t, 32);
  }
  store(out, acc);
}

// Fermat inversion a^(L-2) via fixed 4-bit window over the 253-bit exponent.
static void invert_one(const u64 a[4], u64 out[4]) {
  // exponent L-2, little-endian limbs
  u64 e[4] = {0x5812631a5cf5d3ebULL, 0x14def9dea2f79cd6ULL, 0ULL,
              0x1000000000000000ULL};
  // Montgomery domain
  u64 am[4], acc[4];
  mont_mul(a, R2m, am);
  // table[i] = a^i in Montgomery form, i in [0,16)
  u64 table[16][4];
  std::memcpy(table[0], R1m, 32);  // 1*R
  std::memcpy(table[1], am, 32);
  for (int i = 2; i < 16; ++i) mont_mul(table[i - 1], am, table[i]);
  std::memcpy(acc, R1m, 32);
  bool started = false;
  for (int w = 63; w >= 0; --w) {
    int limb = w / 16, off = (w % 16) * 4;
    int digit = (int)((e[limb] >> off) & 0xF);
    if (started) {
      u64 t[4];
      mont_mul(acc, acc, t);
      mont_mul(t, t, acc);
      mont_mul(acc, acc, t);
      mont_mul(t, t, acc);
    }
    if (digit || started) {
      if (digit) {
        u64 t[4];
        mont_mul(acc, table[digit], t);
        std::memcpy(acc, t, 32);
      }
      started = true;
    }
  }
  u64 onev[4] = {1, 0, 0, 0};
  mont_mul(acc, onev, out);  // leave Montgomery domain
}

// Montgomery-batched inversion: out[i] = a[i]^{-1}; zero entries -> 0.
void xhe_sc_invert(const uint8_t* a, uint8_t* out, size_t n) {
  if (n == 0) return;
  // prefix products (zeros substituted by 1, flagged)
  Sc* pref = new Sc[n + 1];
  Sc* vals = new Sc[n];
  bool* zero = new bool[n];
  u64 one[4] = {1, 0, 0, 0};
  std::memcpy(pref[0].v, one, 32);
  for (size_t i = 0; i < n; ++i) {
    load(a + 32 * i, vals[i].v);
    zero[i] = !(vals[i].v[0] | vals[i].v[1] | vals[i].v[2] | vals[i].v[3]);
    if (zero[i]) std::memcpy(vals[i].v, one, 32);
    mul_mod(pref[i].v, vals[i].v, pref[i + 1].v);
  }
  u64 inv_all[4];
  invert_one(pref[n].v, inv_all);
  for (size_t i = n; i-- > 0;) {
    if (zero[i]) {
      std::memset(out + 32 * i, 0, 32);
    } else {
      u64 t[4];
      mul_mod(pref[i].v, inv_all, t);
      store(out + 32 * i, t);
    }
    u64 t2[4];
    mul_mod(inv_all, vals[i].v, t2);
    std::memcpy(inv_all, t2, 32);
  }
  delete[] pref;
  delete[] vals;
  delete[] zero;
}

// Inner-product-argument s vector (dalek layout): given u_sq[lg_n] and
// u_inv[lg_n] (both most-significant round first), s[0] = prod u_inv,
// s[i] = s[i - 2^k] * u_sq[lg_n - 1 - k] where 2^k is the highest bit of i.
void xhe_sc_ipp_s(const uint8_t* u_sq, const uint8_t* u_inv, size_t lg_n,
                  uint8_t* out, size_t n) {
  u64 s0[4] = {1, 0, 0, 0};
  for (size_t r = 0; r < lg_n; ++r) {
    u64 u[4], t[4];
    load(u_inv + 32 * r, u);
    mul_mod(s0, u, t);
    std::memcpy(s0, t, 32);
  }
  store(out, s0);
  // Montgomery-domain copies of u_sq for the chain
  Sc* um = new Sc[lg_n];
  for (size_t r = 0; r < lg_n; ++r) {
    u64 u[4];
    load(u_sq + 32 * r, u);
    mont_mul(u, R2m, um[r].v);
  }
  for (size_t i = 1; i < n; ++i) {
    // highest bit position k of i
    size_t k = 63 - __builtin_clzll((unsigned long long)i);
    u64 prev[4], t[4];
    load(out + 32 * (i - (size_t(1) << k)), prev);
    mont_mul(prev, um[lg_n - 1 - k].v, t);
    store(out + 32 * i, t);
  }
  delete[] um;
}

// Bulletproofs per-proof h-vector:
//   h[i] = z + y_inv_pow[i] * (zz * z_pow[i / n_bits] * 2^(i % n_bits)
//                              - b * s_inv[i])
// where s_inv[i] = s[nm-1-i].  Inputs: y_inv_pow (nm), z_pow (m), s (nm),
// scalars z, zz, b.  Output h (nm).
void xhe_sc_bp_h(const uint8_t* y_inv_pow, const uint8_t* z_pow,
                 const uint8_t* s, const uint8_t* z, const uint8_t* zz,
                 const uint8_t* b, size_t n_bits, size_t m, uint8_t* out) {
  size_t nm = n_bits * m;
  u64 zv[4], zzv[4], bv[4], bm[4];
  load(z, zv);
  load(zz, zzv);
  load(b, bv);
  mont_mul(bv, R2m, bm);
  for (size_t j = 0; j < m; ++j) {
    u64 zj[4], czz[4], czzm[4];
    load(z_pow + 32 * j, zj);
    mul_mod(zzv, zj, czz);  // zz * z^j
    mont_mul(czz, R2m, czzm);
    // pow2 accumulator: czz * 2^k
    u64 cur[4];
    std::memcpy(cur, czzm, 32);  // Montgomery form of czz
    for (size_t k = 0; k < n_bits; ++k) {
      size_t i = j * n_bits + k;
      u64 yi[4], si[4], t1[4], t2[4], t3[4], hm[4];
      load(y_inv_pow + 32 * i, yi);
      load(s + 32 * (nm - 1 - i), si);
      // t1 = b * s_inv[i]
      mont_mul(si, bm, t1);
      // t2 = cur (normal form) - t1
      u64 curn[4];
      u64 onev[4] = {1, 0, 0, 0};
      mont_mul(cur, onev, curn);
      sub_mod(curn, t1, t2);
      // t3 = y_inv_pow[i] * t2
      mul_mod(yi, t2, t3);
      add_mod(zv, t3, hm);
      store(out + 32 * i, hm);
      // cur *= 2
      dbl_mod(cur);
    }
  }
}

}  // extern "C"
