// Native verification-fold engine: per-proof Fiat-Shamir transcript replay
// + Bulletproofs batch-verification scalar computation in ONE call.
//
// Host profile of whole-block verification shows the per-proof Python loop
// (merlin framing, challenge reduction, scalar folds) dominating after the
// device MSM was fused; this engine collapses a proof's entire
// `_verification_scalars` (range_proof.py:174-247, mirroring the xelis
// bulletproofs fork's verification_view fold, xelis-he/src/tx/
// verify.rs:504-514) into one FFI round trip.
//
// Combines the STROBE-128 transcript (hashcore.cpp) and the 4x64 Montgomery
// scalar engine (scalarops.cpp) in a single translation unit; built as
// libxheverify.so by hashcore/verifyfold_native.py.

#include "hashcore.cpp"
#include "scalarops.cpp"

namespace {

// ---- transcript framing (merlin append/challenge semantics) ---------------

inline void u32le(uint32_t v, uint8_t out[4]) {
  out[0] = (uint8_t)v;
  out[1] = (uint8_t)(v >> 8);
  out[2] = (uint8_t)(v >> 16);
  out[3] = (uint8_t)(v >> 24);
}

void t_append(Strobe *s, const char *label, size_t lab_len,
              const uint8_t *msg, size_t len) {
  uint8_t lenb[4];
  u32le((uint32_t)len, lenb);
  xhe_strobe_meta_ad(s, (const uint8_t *)label, lab_len, 0);
  xhe_strobe_meta_ad(s, lenb, 4, 1);
  xhe_strobe_ad(s, msg, len, 0);
}

void t_append_u64(Strobe *s, const char *label, size_t lab_len, uint64_t v) {
  uint8_t b[8];
  for (int i = 0; i < 8; ++i) b[i] = (uint8_t)(v >> (8 * i));
  t_append(s, label, lab_len, b, 8);
}

void t_challenge(Strobe *s, const char *label, size_t lab_len, uint8_t *out,
                 size_t n) {
  uint8_t lenb[4];
  u32le((uint32_t)n, lenb);
  xhe_strobe_meta_ad(s, (const uint8_t *)label, lab_len, 0);
  xhe_strobe_meta_ad(s, lenb, 4, 1);
  xhe_strobe_prf(s, out, n, 0);
}

// 64-byte wide reduction mod L (merlin challenge_scalar semantics,
// from_bytes_mod_order_wide): out = lo + hi*2^256 mod L.
void wide_reduce(const uint8_t wide[64], u64 out[4]) {
  u64 lo[4], hi[4], lom[4], lon[4], hir[4];
  u64 one[4] = {1, 0, 0, 0};
  load(wide, lo);
  load(wide + 32, hi);
  mont_mul(lo, R2m, lom);   // lo*R  (also reduces)
  mont_mul(lom, one, lon);  // lo mod L
  mont_mul(hi, R2m, hir);   // hi*2^512*R^-1 = hi*2^256 mod L
  add_mod(lon, hir, out);
}

void challenge_scalar(Strobe *s, const char *label, size_t lab_len,
                      u64 out[4]) {
  uint8_t wide[64];
  t_challenge(s, label, lab_len, wide, 64);
  wide_reduce(wide, out);
}

inline bool is_zero32(const uint8_t *p) {
  uint64_t acc = 0;
  for (int i = 0; i < 4; ++i) {
    uint64_t v;
    std::memcpy(&v, p + 8 * i, 8);
    acc |= v;
  }
  return acc == 0;
}

// x^e mod L for small integer e (binary ladder, Montgomery internally)
void pow_small(const u64 x[4], uint64_t e, u64 out[4]) {
  u64 xm[4], acc[4], one[4] = {1, 0, 0, 0};
  mont_mul(x, R2m, xm);
  std::memcpy(acc, R1m, 32);  // 1 in Montgomery form
  int top = 63 - __builtin_clzll(e | 1);
  for (int bit = top; bit >= 0; --bit) {
    u64 t[4];
    mont_mul(acc, acc, t);
    std::memcpy(acc, t, 32);
    if ((e >> bit) & 1) {
      mont_mul(acc, xm, t);
      std::memcpy(acc, t, 32);
    }
  }
  mont_mul(acc, one, out);
}

// sum_{i<n} x^i = (x^n - 1) / (x - 1)  (x != 1; crypto-random challenges)
void sum_of_powers(const u64 x[4], uint64_t n, u64 out[4]) {
  u64 one[4] = {1, 0, 0, 0};
  u64 xm1[4];
  sub_mod(x, one, xm1);
  if (!(xm1[0] | xm1[1] | xm1[2] | xm1[3])) {
    u64 nv[4] = {n, 0, 0, 0};
    std::memcpy(out, nv, 32);
    cond_reduce(out);
    return;
  }
  u64 xn[4], num[4], inv[4];
  pow_small(x, n, xn);
  sub_mod(xn, one, num);
  invert_one(xm1, inv);
  mul_mod(num, inv, out);
}

// ---------------------------------------------------------------------------
// AVX-512 IFMA 8-wide Montgomery butterflies (radix-2^52).
//
// The generator-lane butterflies multiply a contiguous RANGE by one
// constant per level — ideal for vpmadd52: eight lanes run one CIOS
// Montgomery multiply (R = 2^260, 5x52-bit limbs) per instruction
// bundle.  Values stay < 2L throughout (CIOS without the final
// subtract); limbs re-normalized to < 2^52 after each mul; the output
// conversion does the single conditional subtract.  Scalar fallback on
// non-IFMA hosts or XELIS_IFMA=0.
// ---------------------------------------------------------------------------

#if defined(__AVX512IFMA__) && defined(__AVX512F__)
#include <immintrin.h>
#define XHE_HAVE_IFMA 1
#endif

constexpr u64 M52 = (((u64)1) << 52) - 1;

inline void to52(const u64 a[4], u64 out[5]) {
  out[0] = a[0] & M52;
  out[1] = ((a[0] >> 52) | (a[1] << 12)) & M52;
  out[2] = ((a[1] >> 40) | (a[2] << 24)) & M52;
  out[3] = ((a[2] >> 28) | (a[3] << 36)) & M52;
  out[4] = a[3] >> 16;
}

inline void from52(const u64 in[5], u64 out[4]) {
  out[0] = in[0] | (in[1] << 52);
  out[1] = (in[1] >> 12) | (in[2] << 40);
  out[2] = (in[2] >> 24) | (in[3] << 28);
  out[3] = (in[3] >> 36) | (in[4] << 16);
  if (geq_L(out)) sub_L(out);  // value < 2L on entry
}

// L in 5x52 limbs and -L^{-1} mod 2^52 (= LPRIME mod 2^52)
inline const u64 *L52_limbs() {
  static u64 l52[5];
  static bool init = [] {
    to52(Lm, l52);
    return true;
  }();
  (void)init;
  return l52;
}

// 2^260 mod L (normal form): lifts a mont64 constant to the R52 domain
// via one mont_mul (f*2^256 x 2^260 x 2^-256 = f*2^260)
inline const u64 *two260() {
  static u64 v[4];
  static bool init = [] {
    v[0] = 1; v[1] = v[2] = v[3] = 0;
    for (int k = 0; k < 260; ++k) dbl_mod(v);
    return true;
  }();
  (void)init;
  return v;
}

// scalar radix-52 CIOS (tails with half < 8); same algebra as the
// vector path so values stay interchangeable
inline void mont52_one(const u64 a[5], const u64 f[5], u64 dst[5]) {
  const u64 *l52 = L52_limbs();
  const u64 linv = LPRIME & M52;
  u64 t[6] = {0, 0, 0, 0, 0, 0};
  for (int j = 0; j < 5; ++j) {
    for (int k = 0; k < 5; ++k) {
      u128 p = (u128)a[k] * f[j];
      t[k] += (u64)p & M52;
      t[k + 1] += (u64)(p >> 52);
    }
    u64 m = (t[0] * linv) & M52;
    for (int k = 0; k < 5; ++k) {
      u128 p = (u128)m * l52[k];
      t[k] += (u64)p & M52;
      t[k + 1] += (u64)(p >> 52);
    }
    u64 c = t[0] >> 52;
    for (int k = 0; k < 5; ++k) t[k] = t[k + 1];
    t[0] += c;
    t[5] = 0;
  }
  for (int k = 0; k < 4; ++k) {
    t[k + 1] += t[k] >> 52;
    t[k] &= M52;
  }
  for (int k = 0; k < 5; ++k) dst[k] = t[k];
}

#ifdef XHE_HAVE_IFMA
inline void mont52_vec(const u64 *src[5], size_t i, const u64 f[5],
                       u64 *dst[5], size_t o) {
  const u64 *l52 = L52_limbs();
  const __m512i z = _mm512_setzero_si512();
  const __m512i linv =
      _mm512_set1_epi64((long long)(LPRIME & M52));
  __m512i s0 = _mm512_loadu_si512(src[0] + i);
  __m512i s1 = _mm512_loadu_si512(src[1] + i);
  __m512i s2 = _mm512_loadu_si512(src[2] + i);
  __m512i s3 = _mm512_loadu_si512(src[3] + i);
  __m512i s4 = _mm512_loadu_si512(src[4] + i);
  __m512i L0 = _mm512_set1_epi64((long long)l52[0]);
  __m512i L1 = _mm512_set1_epi64((long long)l52[1]);
  __m512i L2 = _mm512_set1_epi64((long long)l52[2]);
  __m512i L3 = _mm512_set1_epi64((long long)l52[3]);
  __m512i L4 = _mm512_set1_epi64((long long)l52[4]);
  __m512i t0 = z, t1 = z, t2 = z, t3 = z, t4 = z, t5 = z;
  for (int j = 0; j < 5; ++j) {
    __m512i fj = _mm512_set1_epi64((long long)f[j]);
    t0 = _mm512_madd52lo_epu64(t0, s0, fj);
    t1 = _mm512_madd52lo_epu64(t1, s1, fj);
    t2 = _mm512_madd52lo_epu64(t2, s2, fj);
    t3 = _mm512_madd52lo_epu64(t3, s3, fj);
    t4 = _mm512_madd52lo_epu64(t4, s4, fj);
    t1 = _mm512_madd52hi_epu64(t1, s0, fj);
    t2 = _mm512_madd52hi_epu64(t2, s1, fj);
    t3 = _mm512_madd52hi_epu64(t3, s2, fj);
    t4 = _mm512_madd52hi_epu64(t4, s3, fj);
    t5 = _mm512_madd52hi_epu64(t5, s4, fj);
    __m512i m = _mm512_madd52lo_epu64(z, t0, linv);
    t0 = _mm512_madd52lo_epu64(t0, m, L0);
    t1 = _mm512_madd52lo_epu64(t1, m, L1);
    t2 = _mm512_madd52lo_epu64(t2, m, L2);
    t3 = _mm512_madd52lo_epu64(t3, m, L3);
    t4 = _mm512_madd52lo_epu64(t4, m, L4);
    t1 = _mm512_madd52hi_epu64(t1, m, L0);
    t2 = _mm512_madd52hi_epu64(t2, m, L1);
    t3 = _mm512_madd52hi_epu64(t3, m, L2);
    t4 = _mm512_madd52hi_epu64(t4, m, L3);
    t5 = _mm512_madd52hi_epu64(t5, m, L4);
    __m512i c = _mm512_srli_epi64(t0, 52);
    t0 = _mm512_add_epi64(t1, c);
    t1 = t2;
    t2 = t3;
    t3 = t4;
    t4 = t5;
    t5 = z;
  }
  const __m512i mask = _mm512_set1_epi64((long long)M52);
  __m512i c;
  c = _mm512_srli_epi64(t0, 52);
  t0 = _mm512_and_epi64(t0, mask);
  t1 = _mm512_add_epi64(t1, c);
  c = _mm512_srli_epi64(t1, 52);
  t1 = _mm512_and_epi64(t1, mask);
  t2 = _mm512_add_epi64(t2, c);
  c = _mm512_srli_epi64(t2, 52);
  t2 = _mm512_and_epi64(t2, mask);
  t3 = _mm512_add_epi64(t3, c);
  c = _mm512_srli_epi64(t3, 52);
  t3 = _mm512_and_epi64(t3, mask);
  t4 = _mm512_add_epi64(t4, c);
  _mm512_storeu_si512(dst[0] + o, t0);
  _mm512_storeu_si512(dst[1] + o, t1);
  _mm512_storeu_si512(dst[2] + o, t2);
  _mm512_storeu_si512(dst[3] + o, t3);
  _mm512_storeu_si512(dst[4] + o, t4);
}
#endif  // XHE_HAVE_IFMA

// Fill the three generator-lane vectors (4x64 output layout, < L) with
// the IFMA engine.  Returns false when unavailable (caller runs the
// scalar 4x64 butterflies instead).
static bool ifma_butterfly3(u64 *gs, u64 *hc, u64 *hs, const u64 seed_g[4],
                            const u64 seed_hc[4], const u64 seed_hs[4],
                            u64 fg[][4], u64 fhc[][4], u64 fhs[][4],
                            size_t lg, size_t nm) {
#ifndef XHE_HAVE_IFMA
  (void)gs; (void)hc; (void)hs; (void)seed_g; (void)seed_hc; (void)seed_hs;
  (void)fg; (void)fhc; (void)fhs; (void)lg; (void)nm;
  return false;
#else
  static const bool enabled = [] {
    const char *e = getenv("XELIS_IFMA");
    return !(e && e[0] == '0');
  }();
  if (!enabled || nm < 16) return false;

  u64 *mem = new u64[15 * nm];
  u64 *pl[3][5];
  for (int v = 0; v < 3; ++v)
    for (int k = 0; k < 5; ++k) pl[v][k] = mem + (5 * v + k) * nm;
  const u64 *seeds[3] = {seed_g, seed_hc, seed_hs};
  for (int v = 0; v < 3; ++v) {
    u64 s5[5];
    to52(seeds[v], s5);
    for (int k = 0; k < 5; ++k) pl[v][k][0] = s5[k];
  }
  for (size_t hb = 0; hb < lg; ++hb) {
    size_t half = (size_t)1 << hb;
    u64 F[3][5];
    u64 (*fac[3])[4] = {fg, fhc, fhs};
    for (int v = 0; v < 3; ++v) {
      u64 t[4];
      mont_mul(fac[v][hb], two260(), t);  // f*2^260 (R52 domain)
      to52(t, F[v]);
    }
    for (int v = 0; v < 3; ++v) {
      if (half < 8) {
        for (size_t i = 0; i < half; ++i) {
          u64 a[5], d[5];
          for (int k = 0; k < 5; ++k) a[k] = pl[v][k][i];
          mont52_one(a, F[v], d);
          for (int k = 0; k < 5; ++k) pl[v][k][half + i] = d[k];
        }
      } else {
#ifdef XHE_HAVE_IFMA
        const u64 *srcp[5] = {pl[v][0], pl[v][1], pl[v][2], pl[v][3],
                              pl[v][4]};
        u64 *dstp[5] = {pl[v][0], pl[v][1], pl[v][2], pl[v][3], pl[v][4]};
        for (size_t i = 0; i < half; i += 8)
          mont52_vec(srcp, i, F[v], dstp, half + i);
#endif
      }
    }
  }
  u64 *outs[3] = {gs, hc, hs};
  for (int v = 0; v < 3; ++v) {
    for (size_t i = 0; i < nm; ++i) {
      u64 a[5];
      for (int k = 0; k < 5; ++k) a[k] = pl[v][k][i];
      from52(a, outs[v] + 4 * i);
    }
  }
  delete[] mem;
  return true;
#endif
}


}  // namespace

extern "C" {

// Per-proof Bulletproofs batch-verification fold.  Replays the proof's
// transcript segment on ``strobe`` (after executing ``pend``, the caller's
// buffered op records) and emits this proof's contribution to the block's
// random-linear-combination mega-MSM:
//
//   dyn_out   = rho * [1, x, c*x, c*x^2, u_sq[0..lg), u_inv_sq[0..lg),
//               c*zz*z^j for j in [0,m)]               ((4+2*lg+m) x 32)
//   g_acc[i] += rho * (-z - a*s[i])          for i < n_bits*m
//   h_acc[i] += rho * (z + y^-i*(zz*z^(i/n)*2^(i%n) - b*s_inv[i]))
//   b_acc   += rho * (w*(t_x - a*b) + c*(delta - t_x))
//   bb_acc  += rho * (-e_blinding - c*t_x_blinding)
//
// pts = A||S||T1||T2 (4x32); lr = L_vec||R_vec (2*lg x 32);
// sc3 = t_x||t_x_blinding||e_blinding; ab = a||b; V = m x 32.
// Returns 0 on success, 1 if an identity point was appended (transcript
// validation failure, transcript.rs:73-84 semantics).
int xhe_bp_fold(Strobe *strobe, const uint8_t *pend, size_t pend_len,
                const uint8_t *pts, const uint8_t *lr, size_t lg_n,
                const uint8_t *sc3, const uint8_t *ab, const uint8_t *V,
                size_t m, size_t n_bits, const uint8_t *rho_b,
                const uint8_t *c_b, uint8_t *dyn_out, uint8_t *g_acc,
                uint8_t *h_acc, uint8_t *b_acc, uint8_t *bb_acc) {
  const size_t nm = n_bits * m;
  if (pend_len) xhe_strobe_batch(strobe, pend, pend_len, nullptr);

  // rangeproof dom-sep + V commitments (identity/dud V allowed)
  t_append(strobe, "dom-sep", 7, (const uint8_t *)"rangeproof v1", 13);
  t_append_u64(strobe, "n", 1, (uint64_t)n_bits);
  t_append_u64(strobe, "m", 1, (uint64_t)m);
  for (size_t j = 0; j < m; ++j) t_append(strobe, "V", 1, V + 32 * j, 32);

  if (is_zero32(pts) || is_zero32(pts + 32)) return 1;
  t_append(strobe, "A", 1, pts, 32);
  t_append(strobe, "S", 1, pts + 32, 32);

  u64 y[4], z[4];
  challenge_scalar(strobe, "y", 1, y);
  challenge_scalar(strobe, "z", 1, z);

  if (is_zero32(pts + 64) || is_zero32(pts + 96)) return 1;
  t_append(strobe, "T_1", 3, pts + 64, 32);
  t_append(strobe, "T_2", 3, pts + 96, 32);

  u64 x[4];
  challenge_scalar(strobe, "x", 1, x);

  t_append(strobe, "t_x", 3, sc3, 32);
  t_append(strobe, "t_x_blinding", 12, sc3 + 32, 32);
  t_append(strobe, "e_blinding", 10, sc3 + 64, 32);

  u64 w[4];
  challenge_scalar(strobe, "w", 1, w);

  // inner-product argument rounds
  t_append(strobe, "dom-sep", 7, (const uint8_t *)"ipp v1", 6);
  t_append_u64(strobe, "n", 1, (uint64_t)nm);
  u64 u[32][4];
  for (size_t r = 0; r < lg_n; ++r) {
    const uint8_t *Lp = lr + 32 * r;
    const uint8_t *Rp = lr + 32 * (lg_n + r);
    if (is_zero32(Lp) || is_zero32(Rp)) return 1;
    t_append(strobe, "L", 1, Lp, 32);
    t_append(strobe, "R", 1, Rp, 32);
    challenge_scalar(strobe, "u", 1, u[r]);
  }

  // batch-invert [y, u_0..u_{lg-1}, y-1, z-1] with ONE Fermat inversion
  // (y-1 / z-1 feed the closed-form geometric sums in delta)
  u64 vals[35][4], pref[36][4], invs[35][4];
  size_t k = lg_n + 3;
  u64 one[4] = {1, 0, 0, 0};
  std::memcpy(vals[0], y, 32);
  for (size_t r = 0; r < lg_n; ++r) std::memcpy(vals[r + 1], u[r], 32);
  u64 z_loc[4];
  mul_mod(z, one, z_loc);  // reduce (challenges are already < L; keep safe)
  sub_mod(y, one, vals[lg_n + 1]);
  sub_mod(z_loc, one, vals[lg_n + 2]);
  std::memcpy(pref[0], one, 32);
  for (size_t i = 0; i < k; ++i) mul_mod(pref[i], vals[i], pref[i + 1]);
  u64 inv_all[4];
  invert_one(pref[k], inv_all);
  for (size_t i = k; i-- > 0;) {
    mul_mod(pref[i], inv_all, invs[i]);
    u64 t[4];
    mul_mod(inv_all, vals[i], t);
    std::memcpy(inv_all, t, 32);
  }
  u64 y_inv[4];
  std::memcpy(y_inv, invs[0], 32);
  u64 *ym1_inv = invs[lg_n + 1];
  u64 *zm1_inv = invs[lg_n + 2];

  u64 rho[4], c[4];
  load(rho_b, rho);
  load(c_b, c);
  u64 rhom[4];  // rho in Montgomery form for cheap scaling
  mont_mul(rho, R2m, rhom);

  // dyn_out = rho * [1, x, c*x, c*x^2, u_sq..., u_inv_sq..., c*zz*z^j...]
  u64 zz[4], cx[4], cxx[4];
  mul_mod(z, z, zz);
  mul_mod(c, x, cx);
  mul_mod(cx, x, cxx);
  {
    u64 t[4];
    store(dyn_out, rho);
    mont_mul(x, rhom, t);
    store(dyn_out + 32, t);
    mont_mul(cx, rhom, t);
    store(dyn_out + 64, t);
    mont_mul(cxx, rhom, t);
    store(dyn_out + 96, t);
    for (size_t r = 0; r < lg_n; ++r) {
      u64 usq[4], uisq[4];
      mul_mod(u[r], u[r], usq);
      mul_mod(invs[r + 1], invs[r + 1], uisq);
      mont_mul(usq, rhom, t);
      store(dyn_out + 32 * (4 + r), t);
      mont_mul(uisq, rhom, t);
      store(dyn_out + 32 * (4 + lg_n + r), t);
    }
  }

  // (ifma_butterfly3 + scalar fallback defined above xhe_bp_fold)
  // g/h generator-lane accumulation via THREE product butterflies.
  //
  // Every per-lane term is a product of per-BIT factors of the lane
  // index i (bit k of i selects one constant factor), so each vector
  // fills with exactly ONE Montgomery mul per element:
  //   gs[i] = -rho*a*s[i]                      (factors usq[lg-1-k])
  //   hc[i] = rho*zz * y^-i * z^(i/n) * 2^(i%n)
  //           (factors: k<log2(n): 2^(2^k)*y_inv^(2^k);
  //                     k>=log2(n): z^(2^(k-log2 n))*y_inv^(2^k))
  //   hs[i] = rho*b * y^-i * s_inv[i]          (s_inv[i] = s[nm-1-i] =
  //           1/s[i] up to the all-u product; factors
  //           u_inv_sq[lg-1-k]*y_inv^(2^k))
  // then g_acc[i] += gs[i] - rho*z and
  //      h_acc[i] += rho*z + hc[i] - hs[i]  (verify.rs / dalek h_i eq).
  // This replaces the round-4 per-element scale/walk loops (~5 muls per
  // lane incl. the s build) with 3 muls per lane.
  u64 a_sc[4], b_sc[4];
  load(ab, a_sc);
  load(ab + 32, b_sc);
  u64 zero[4] = {0, 0, 0, 0};
  u64 neg_a[4], neg_z[4], off[4], rho_z[4];
  sub_mod(zero, a_sc, neg_a);
  sub_mod(zero, z, neg_z);
  mul_mod(rho, neg_z, off);  // -rho*z
  mul_mod(rho, z, rho_z);

  size_t lgn_bits = 0;
  while (((size_t)1 << lgn_bits) < n_bits) ++lgn_bits;

  // per-bit y_inv^(2^k), 2^(2^k), z^(2^k) chains (normal form)
  u64 ypow[32][4], twopow[32][4], zpow[32][4];
  std::memcpy(ypow[0], y_inv, 32);
  twopow[0][0] = 2; twopow[0][1] = twopow[0][2] = twopow[0][3] = 0;
  std::memcpy(zpow[0], z_loc, 32);
  for (size_t k = 1; k < lg_n; ++k) {
    mul_mod(ypow[k - 1], ypow[k - 1], ypow[k]);
    mul_mod(twopow[k - 1], twopow[k - 1], twopow[k]);
    mul_mod(zpow[k - 1], zpow[k - 1], zpow[k]);
  }

  // butterfly factors (Montgomery form)
  u64 fg[32][4], fhc[32][4], fhs[32][4];
  for (size_t k = 0; k < lg_n; ++k) {
    u64 usq[4], uisq[4], t[4];
    const u64 *ur = u[lg_n - 1 - k];
    mul_mod(ur, ur, usq);
    mont_mul(usq, R2m, fg[k]);
    mul_mod(invs[lg_n - k], invs[lg_n - k], uisq);  // u_inv_sq[lg-1-k]
    mul_mod(uisq, ypow[k], t);
    mont_mul(t, R2m, fhs[k]);
    if (k < lgn_bits) {
      mul_mod(twopow[k], ypow[k], t);
    } else {
      mul_mod(zpow[k - lgn_bits], ypow[k], t);
    }
    mont_mul(t, R2m, fhc[k]);
  }

  // seeds: s0 = prod u_inv, s_hi = s[nm-1] = prod u
  u64 s0[4], s_hi[4];
  std::memcpy(s0, one, 32);
  std::memcpy(s_hi, one, 32);
  for (size_t r = 0; r < lg_n; ++r) {
    u64 t[4];
    mul_mod(s0, invs[r + 1], t);
    std::memcpy(s0, t, 32);
    mul_mod(s_hi, u[r], t);
    std::memcpy(s_hi, t, 32);
  }
  u64 seed_g[4], seed_hc[4], seed_hs[4], t0[4];
  mul_mod(rho, neg_a, t0);
  mul_mod(t0, s0, seed_g);   // -rho*a*s[0]
  mul_mod(rho, zz, seed_hc);  // rho*zz
  mul_mod(rho, b_sc, t0);
  mul_mod(t0, s_hi, seed_hs);  // rho*b*s_inv[0]

  u64 *gs = new u64[nm * 4 * 3];
  u64 *hc = gs + nm * 4;
  u64 *hs = gs + nm * 8;
  if (!ifma_butterfly3(gs, hc, hs, seed_g, seed_hc, seed_hs,
                       fg, fhc, fhs, lg_n, nm)) {
    std::memcpy(gs, seed_g, 32);
    std::memcpy(hc, seed_hc, 32);
    std::memcpy(hs, seed_hs, 32);
    for (size_t hb = 0; hb < lg_n; ++hb) {
      size_t half = (size_t)1 << hb;
      for (size_t i = 0; i < half; ++i) {
        mont_mul(gs + 4 * i, fg[hb], gs + 4 * (half + i));
        mont_mul(hc + 4 * i, fhc[hb], hc + 4 * (half + i));
        mont_mul(hs + 4 * i, fhs[hb], hs + 4 * (half + i));
      }
    }
  }
  for (size_t i = 0; i < nm; ++i) {
    u64 t1[4], t2[4], acc[4];
    add_mod(gs + 4 * i, off, t1);
    load(g_acc + 32 * i, acc);
    add_mod(acc, t1, t2);
    store(g_acc + 32 * i, t2);
    sub_mod(hc + 4 * i, hs + 4 * i, t1);
    add_mod(t1, rho_z, t2);
    load(h_acc + 32 * i, acc);
    add_mod(acc, t2, t1);
    store(h_acc + 32 * i, t1);
  }
  delete[] gs;

  // value scalars: rho * c * zz * z^j
  {
    u64 czz[4];
    mul_mod(c, zz, czz);
    u64 cur[4];
    mul_mod(czz, rho, cur);
    u64 zm[4];
    mont_mul(z, R2m, zm);
    for (size_t j = 0; j < m; ++j) {
      store(dyn_out + 32 * (4 + 2 * lg_n + j), cur);
      u64 t[4];
      mont_mul(cur, zm, t);
      std::memcpy(cur, t, 32);
    }
  }

  // delta(y, z) = (z - zz)*sum_y - zz*z*(2^n - 1)*sum_z, with the
  // geometric sums from the batched inverses: sum = (x^n - 1)/(x - 1)
  u64 delta[4];
  {
    u64 sum_y[4], sum_z[4], zmzz[4], t1[4], t2[4], t3[4];
    {
      u64 xn[4], num[4];
      pow_small(y, nm, xn);
      sub_mod(xn, one, num);
      mul_mod(num, ym1_inv, sum_y);
      pow_small(z, m, xn);
      sub_mod(xn, one, num);
      mul_mod(num, zm1_inv, sum_z);
    }
    sub_mod(z, zz, zmzz);
    mul_mod(zmzz, sum_y, t1);
    u64 two_n[4] = {n_bits == 64 ? ~0ULL : (((uint64_t)1 << n_bits) - 1), 0, 0, 0};
    u64 zzz[4];
    mul_mod(zz, z, zzz);
    mul_mod(zzz, two_n, t2);
    mul_mod(t2, sum_z, t3);
    sub_mod(t1, t3, delta);
  }

  // b_acc += rho * (w*(t_x - a*b) + c*(delta - t_x))
  {
    u64 t_x[4], ab_prod[4], t1[4], t2[4], t3[4], t4[4], acc[4];
    load(sc3, t_x);
    mul_mod(a_sc, b_sc, ab_prod);
    sub_mod(t_x, ab_prod, t1);
    mul_mod(w, t1, t2);
    sub_mod(delta, t_x, t3);
    mul_mod(c, t3, t4);
    add_mod(t2, t4, t1);
    mul_mod(t1, rho, t2);
    load(b_acc, acc);
    add_mod(acc, t2, t1);
    store(b_acc, t1);
  }

  // bb_acc += rho * (-e_blinding - c*t_x_blinding)
  {
    u64 e_bl[4], t_xb[4], t1[4], t2[4], acc[4];
    load(sc3 + 64, e_bl);
    load(sc3 + 32, t_xb);
    mul_mod(c, t_xb, t1);
    add_mod(e_bl, t1, t2);
    sub_mod(zero, t2, t1);
    mul_mod(t1, rho, t2);
    load(bb_acc, acc);
    add_mod(acc, t2, t1);
    store(bb_acc, t1);
  }

  return 0;
}

// CommitmentEqProof verifier fold (proofs.rs:134-211; sigma.py pre_verify).
// Replays the proof's transcript segment (equality-proof dom-sep is part of
// ``pend``) and emits the seven dynamic-lane scalars plus the shared-G/H
// contributions, all scaled by the caller's random batch factor:
//   out9 = bf * [z_s, -1, w*z_s, -w*c, -w, -ww*c, -ww,      (7 lanes)
//                (w+ww)*z_x,                                 (G add)
//                -c + ww*z_r]                                (H add)
// Returns 0 ok, 1 if Y_0/Y_1/Y_2 is the identity encoding.
int xhe_eq_fold(Strobe *strobe, const uint8_t *pend, size_t pend_len,
                const uint8_t *Y, const uint8_t *zs3, const uint8_t *bf_b,
                uint8_t *out9) {
  if (pend_len) xhe_strobe_batch(strobe, pend, pend_len, nullptr);
  for (int i = 0; i < 3; ++i)
    if (is_zero32(Y + 32 * i)) return 1;
  t_append(strobe, "Y_0", 3, Y, 32);
  t_append(strobe, "Y_1", 3, Y + 32, 32);
  t_append(strobe, "Y_2", 3, Y + 64, 32);
  u64 cch[4];
  challenge_scalar(strobe, "c", 1, cch);
  t_append(strobe, "z_s", 3, zs3, 32);
  t_append(strobe, "z_x", 3, zs3 + 32, 32);
  t_append(strobe, "z_r", 3, zs3 + 64, 32);
  u64 w[4];
  challenge_scalar(strobe, "w", 1, w);

  u64 z_s[4], z_x[4], z_r[4], bf[4], bfm[4], ww[4];
  load(zs3, z_s);
  load(zs3 + 32, z_x);
  load(zs3 + 64, z_r);
  load(bf_b, bf);
  mont_mul(bf, R2m, bfm);
  mul_mod(w, w, ww);

  u64 zero[4] = {0, 0, 0, 0};
  u64 t1[4], t2[4], neg[4];
  // 0: z_s * bf
  mont_mul(z_s, bfm, t1);
  store(out9, t1);
  // 1: -bf
  sub_mod(zero, bf, t1);
  store(out9 + 32, t1);
  // 2: w*z_s*bf
  mul_mod(w, z_s, t1);
  mont_mul(t1, bfm, t2);
  store(out9 + 64, t2);
  // 3: -w*c*bf
  mul_mod(w, cch, t1);
  mont_mul(t1, bfm, t2);
  sub_mod(zero, t2, neg);
  store(out9 + 96, neg);
  // 4: -w*bf
  mont_mul(w, bfm, t1);
  sub_mod(zero, t1, neg);
  store(out9 + 128, neg);
  // 5: -ww*c*bf
  mul_mod(ww, cch, t1);
  mont_mul(t1, bfm, t2);
  sub_mod(zero, t2, neg);
  store(out9 + 160, neg);
  // 6: -ww*bf
  mont_mul(ww, bfm, t1);
  sub_mod(zero, t1, neg);
  store(out9 + 192, neg);
  // 7 (G): (w + ww)*z_x*bf
  add_mod(w, ww, t1);
  mul_mod(t1, z_x, t2);
  mont_mul(t2, bfm, t1);
  store(out9 + 224, t1);
  // 8 (H): (-c + ww*z_r)*bf
  mul_mod(ww, z_r, t1);
  sub_mod(t1, cch, t2);
  mont_mul(t2, bfm, t1);
  store(out9 + 256, t1);
  return 0;
}

// CiphertextValidityProof verifier fold (proofs.rs:281-361).
//   out10 = bf * [-c, -1, w*z_r, -w*c, -w, ww*z_r, -ww*c, -ww,  (8 lanes)
//                 z_x,                                           (G add)
//                 z_r]                                           (H add)
// Returns 0 ok, 1 on identity Y encoding.
int xhe_validity_fold(Strobe *strobe, const uint8_t *pend, size_t pend_len,
                      const uint8_t *Y, const uint8_t *zs2,
                      const uint8_t *bf_b, uint8_t *out10) {
  if (pend_len) xhe_strobe_batch(strobe, pend, pend_len, nullptr);
  for (int i = 0; i < 3; ++i)
    if (is_zero32(Y + 32 * i)) return 1;
  t_append(strobe, "Y_0", 3, Y, 32);
  t_append(strobe, "Y_1", 3, Y + 32, 32);
  t_append(strobe, "Y_2", 3, Y + 64, 32);
  u64 cch[4];
  challenge_scalar(strobe, "c", 1, cch);
  t_append(strobe, "z_r", 3, zs2, 32);
  t_append(strobe, "z_x", 3, zs2 + 32, 32);
  u64 w[4];
  challenge_scalar(strobe, "w", 1, w);

  u64 z_r[4], z_x[4], bf[4], bfm[4], ww[4];
  load(zs2, z_r);
  load(zs2 + 32, z_x);
  load(bf_b, bf);
  mont_mul(bf, R2m, bfm);
  mul_mod(w, w, ww);

  u64 zero[4] = {0, 0, 0, 0};
  u64 t1[4], t2[4], neg[4];
  // 0: -c*bf
  mont_mul(cch, bfm, t1);
  sub_mod(zero, t1, neg);
  store(out10, neg);
  // 1: -bf
  sub_mod(zero, bf, t1);
  store(out10 + 32, t1);
  // 2: w*z_r*bf
  mul_mod(w, z_r, t1);
  mont_mul(t1, bfm, t2);
  store(out10 + 64, t2);
  // 3: -w*c*bf
  mul_mod(w, cch, t1);
  mont_mul(t1, bfm, t2);
  sub_mod(zero, t2, neg);
  store(out10 + 96, neg);
  // 4: -w*bf
  mont_mul(w, bfm, t1);
  sub_mod(zero, t1, neg);
  store(out10 + 128, neg);
  // 5: ww*z_r*bf
  mul_mod(ww, z_r, t1);
  mont_mul(t1, bfm, t2);
  store(out10 + 160, t2);
  // 6: -ww*c*bf
  mul_mod(ww, cch, t1);
  mont_mul(t1, bfm, t2);
  sub_mod(zero, t2, neg);
  store(out10 + 192, neg);
  // 7: -ww*bf
  mont_mul(ww, bfm, t1);
  sub_mod(zero, t1, neg);
  store(out10 + 224, neg);
  // 8 (G): z_x*bf
  mont_mul(z_x, bfm, t1);
  store(out10 + 256, t1);
  // 9 (H): z_r*bf
  mont_mul(z_r, bfm, t1);
  store(out10 + 288, t1);
  return 0;
}

// Whole-transaction fold script executor.  A script is a byte sequence of
// records that replays the ENTIRE verifier transcript of one transaction
// (sigma proofs + range proof) and emits every MSM scalar, in one FFI call:
//
//   kind 0 (OPS): u32 len, len bytes of strobe op records (merlin batch
//                 format) — transcript appends between proofs
//   kind 1 (EQ):  Y(96) z(96) bf(32)          -> writes 9 scalars
//   kind 2 (VAL): Y(96) z(64) bf(32)          -> writes 10 scalars
//   kind 3 (BP):  u32 m, u32 n_bits, u32 lg, V(m*32), pts(4*32),
//                 lr(2*lg*32), sc3(96), ab(64), rho(32), c(32)
//                 -> writes (4+2*lg+m) scalars; g/h/b/bb accumulate into
//                    the caller's buffers
//
// Scalar outputs are written sequentially into ``out``.  The call touches
// no Python state, so callers run one executor per transaction across a
// thread pool (ctypes releases the GIL) — transactions fold in parallel
// while remaining byte-exact serial within each transcript.
// Returns 0 ok, 1 identity-point rejection, 2 malformed script.
int xhe_tx_fold(Strobe *strobe, const uint8_t *script, size_t script_len,
                uint8_t *out, uint8_t *g_acc, uint8_t *h_acc, uint8_t *b_acc,
                uint8_t *bb_acc) {
  size_t i = 0, w = 0;
  while (i < script_len) {
    uint8_t kind = script[i++];
    if (kind == 0) {
      if (i + 4 > script_len) return 2;
      uint32_t len;
      std::memcpy(&len, script + i, 4);
      i += 4;
      if (i + len > script_len) return 2;
      xhe_strobe_batch(strobe, script + i, len, nullptr);
      i += len;
    } else if (kind == 1) {
      if (i + 96 + 96 + 32 > script_len) return 2;
      int rc = xhe_eq_fold(strobe, nullptr, 0, script + i, script + i + 96,
                           script + i + 192, out + w);
      if (rc) return rc;
      i += 224;
      w += 9 * 32;
    } else if (kind == 2) {
      if (i + 96 + 64 + 32 > script_len) return 2;
      int rc = xhe_validity_fold(strobe, nullptr, 0, script + i,
                                 script + i + 96, script + i + 160, out + w);
      if (rc) return rc;
      i += 192;
      w += 10 * 32;
    } else if (kind == 3) {
      if (i + 12 > script_len) return 2;
      uint32_t m, n_bits, lg;
      std::memcpy(&m, script + i, 4);
      std::memcpy(&n_bits, script + i + 4, 4);
      std::memcpy(&lg, script + i + 8, 4);
      i += 12;
      size_t need = (size_t)m * 32 + 128 + (size_t)2 * lg * 32 + 96 + 64 + 64;
      if (i + need > script_len || lg >= 32) return 2;
      const uint8_t *V = script + i;
      const uint8_t *pts = V + (size_t)m * 32;
      const uint8_t *lr = pts + 128;
      const uint8_t *sc3 = lr + (size_t)2 * lg * 32;
      const uint8_t *ab = sc3 + 96;
      const uint8_t *rho = ab + 64;
      const uint8_t *c = rho + 32;
      int rc = xhe_bp_fold(strobe, nullptr, 0, pts, lr, lg, sc3, ab, V, m,
                           n_bits, rho, c, out + w, g_acc, h_acc, b_acc,
                           bb_acc);
      if (rc) return rc;
      i += need;
      w += (size_t)(4 + 2 * lg + m) * 32;
    } else {
      return 2;
    }
  }
  return 0;
}

// Grouped fold executor: run ``n`` transaction fold scripts in ONE FFI call
// (one GIL release for the whole group instead of per tx — on small hosts
// the per-job Python/ctypes overhead of per-tx calls measurably steals CPU
// from the pre_verify producer thread).  Scripts ride as one concatenated
// blob with ``offs[n+1]`` byte offsets; scalar outputs land in one blob at
// 32-byte rows ``out_offs[i] .. out_offs[i+1]``.  ``strobes`` is an array
// of Strobe* values.  Per-tx return codes land in ``rcs``; returns nonzero
// if any script failed (all scripts still run — the per-slot g/h
// accumulators stay consistent for the block regardless).
int xhe_tx_fold_group(size_t n, const uint64_t *strobes,
                      const uint8_t *scripts, const uint64_t *offs,
                      uint8_t *outs, const uint64_t *out_offs,
                      uint8_t *g_acc, uint8_t *h_acc, uint8_t *b_acc,
                      uint8_t *bb_acc, int32_t *rcs) {
  int any = 0;
  for (size_t i = 0; i < n; ++i) {
    int rc = xhe_tx_fold((Strobe *)(uintptr_t)strobes[i], scripts + offs[i],
                         (size_t)(offs[i + 1] - offs[i]),
                         outs + 32 * out_offs[i], g_acc, h_acc, b_acc, bb_acc);
    rcs[i] = rc;
    if (rc) any = 1;
  }
  return any;
}

}  // extern "C"
