// Native inner-product-argument prover session (SURVEY.md §7 step 7 /
// builder.rs:525-533 hot path).
//
// The IPP rounds dominate transaction BUILD time: 2 MSMs of ~n+1 lanes per
// round plus O(n) scalar folds, repeated lg(n) times.  Running them through
// the generic byte-interface MSM costs per-call packing of every generator
// (~45k point packs per tx at n=256); this session keeps the generators,
// fold coefficients, and a/b vectors resident in C++ between rounds, so
// Python only relays the Fiat-Shamir challenge bytes each round (the
// transcript stays in Python — challenge order is byte-exact with
// dalek's inner_product_proof.rs via inner_product.py).
//
// Fold-coefficient formulation (inner_product.py:59-123): instead of
// folding the generator POINT vectors each round, track per-generator
// coefficients wg/wh over the original basis and emit L/R as one MSM over
// the original generators — group ops stay inside the Pippenger core.
//
// Built as libxheprover.so by hashcore/prover_native.py.

#include "curve25519.cpp"
#include "scalarops.cpp"

#include <thread>

namespace {

// pt-level Pippenger over a pointer array (mirrors xhe_pt_msm's windowing,
// minus the per-call byte unpacking).  Scalars are u64[4] little-endian.
void pt_msm_core(const u64 (*sc)[4], const pt *const *pts, size_t n, pt &o) {
  pt_identity(o);
  if (n == 0) return;
  // window size minimizing windows * (inserts + bucket merge): the old
  // `2^(c+1) < n` heuristic overshot by ~2 bits at large n (2^c buckets
  // cost TWO adds each in the merge), costing ~1.5x at n=16k
  int c = 4;
  double best = 1e30;
  for (int t = 4; t <= 16; ++t) {
    double cost = ((253 + t - 1) / t) * ((double)n + 2.0 * (1u << t));
    if (cost < best) {
      best = cost;
      c = t;
    }
  }
  const size_t nb = ((size_t)1) << c;
  const u64 mask = nb - 1;
  int windows = (253 + c - 1) / c;

  pt *buckets = new pt[nb];
  bool *used = new bool[nb];
  pt acc;
  pt_identity(acc);
  bool acc_zero = true;
  for (int w = windows - 1; w >= 0; --w) {
    if (!acc_zero)
      for (int i = 0; i < c; ++i) pt_dbl(acc, acc);
    std::memset(used, 0, nb);
    for (size_t i = 0; i < n; ++i) {
      int bit = w * c;
      int word = bit >> 6, off = bit & 63;
      u64 chunk = sc[i][word] >> off;
      if (off && word < 3) chunk |= sc[i][word + 1] << (63 - off) << 1;
      u64 digit = chunk & mask;
      if (!digit) continue;
      if (used[digit]) {
        pt t;
        pt_add(buckets[digit], *pts[i], t);
        buckets[digit] = t;
      } else {
        buckets[digit] = *pts[i];
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
  delete[] buckets;
  delete[] used;
  o = acc;
}

// ---- precomputed 8-bit generator tables -----------------------------------
//
// The IPP round MSMs run over a FIXED generator basis (BulletproofGens
// G_vec ‖ H_vec), so each generator gets a one-time [1..255]·g table and
// every MSM becomes Straus: 32 shared doubling windows with ONE table-add
// per lane per window — ~2x fewer point ops than windowed Pippenger at the
// n=256 shapes the prover hits.  Registered once per process per basis.

// precomputed ("niels"-style) form for read-only table entries: the add
// skips the per-entry Y±X / 2Z / 2d·T recomputation (9 -> 7 field muls
// and fewer adds than the unified pt_add)
struct ptp {
  fe ypx, ymx, z2, t2d;
};

inline void pt_precompute(const pt &q, ptp &o) {
  const Consts &C = consts();
  fe_add(q.Y, q.X, o.ypx);
  fe_sub(q.Y, q.X, o.ymx);
  fe_add(q.Z, q.Z, o.z2);
  fe_mul(q.T, C.D2, o.t2d);
}

inline void pt_add_pre(const pt &p, const ptp &q, pt &o) {
  fe A, B, Cc, Dd, E, F, G, H, t1;
  fe_sub(p.Y, p.X, t1);
  fe_mul(t1, q.ymx, A);
  fe_add(p.Y, p.X, t1);
  fe_mul(t1, q.ypx, B);
  fe_mul(p.T, q.t2d, Cc);
  fe_mul(p.Z, q.z2, Dd);
  fe_sub(B, A, E);
  fe_sub(Dd, Cc, F);
  fe_add(Dd, Cc, G);
  fe_add(B, A, H);
  fe_mul(E, F, o.X);
  fe_mul(G, H, o.Y);
  fe_mul(F, G, o.Z);
  fe_mul(E, H, o.T);
}

// p + (-q): -q in precomputed form swaps ypx/ymx and negates t2d, which
// lands as an F/G swap — same 7 muls
inline void pt_sub_pre(const pt &p, const ptp &q, pt &o) {
  fe A, B, Cc, Dd, E, F, G, H, t1;
  fe_sub(p.Y, p.X, t1);
  fe_mul(t1, q.ypx, A);
  fe_add(p.Y, p.X, t1);
  fe_mul(t1, q.ymx, B);
  fe_mul(p.T, q.t2d, Cc);
  fe_mul(p.Z, q.z2, Dd);
  fe_sub(B, A, E);
  fe_add(Dd, Cc, F);
  fe_sub(Dd, Cc, G);
  fe_add(B, A, H);
  fe_mul(E, F, o.X);
  fe_mul(G, H, o.Y);
  fe_mul(F, G, o.Z);
  fe_mul(E, H, o.T);
}

struct GensTables {
  size_t n_gens;
  ptp *tab;  // [gen][128], precomputed form (signed digits use [1..128])
};

constexpr int MAX_REGISTRIES = 16;
GensTables g_registries[MAX_REGISTRIES];
int g_n_registries = 0;

// Straus MSM over registered generators: lanes are (gen index, scalar).
// Scalars recode to SIGNED base-256 digits in [-128, 127] (canonical
// scalars are < 2^253, so the final carry never overflows digit 31) —
// tables shrink 2x ([1..128] per generator, 20 KB vs 41 KB), which keeps
// the digit-indexed random reads of the hot loop closer to cache, and a
// negative digit costs the same 7-mul pt_sub_pre.
void straus_msm(const GensTables &gt, const uint32_t *gen_idx,
                const u64 (*sc)[4], size_t n_lanes, pt &o,
                int8_t *dig_buf) {
  for (size_t i = 0; i < n_lanes; ++i) {
    const uint8_t *sb = (const uint8_t *)sc[i];
    int carry = 0;
    int8_t *d = dig_buf + 32 * i;
    for (int k = 0; k < 32; ++k) {
      int v = (int)sb[k] + carry;
      if (v >= 128) {  // digits in [-128, 127]; -128 uses table entry 128
        v -= 256;
        carry = 1;
      } else {
        carry = 0;
      }
      d[k] = (int8_t)v;
    }
  }
  pt acc;
  pt_identity(acc);
  constexpr size_t PF = 4;  // table reads are random over ~20 MB: prefetch
  for (int w = 31; w >= 0; --w) {
    for (int k = 0; k < 8; ++k) pt_dbl(acc, acc);
    for (size_t i = 0; i < n_lanes; ++i) {
      if (i + PF < n_lanes) {
        int dp = dig_buf[32 * (i + PF) + w];
        if (dp) {
          int ap = dp > 0 ? dp : -dp;
          const char *e = (const char *)&gt.tab[(size_t)gen_idx[i + PF] * 128 + ap - 1];
          __builtin_prefetch(e);
          __builtin_prefetch(e + 64);
          __builtin_prefetch(e + 128);
        }
      }
      int d = dig_buf[32 * i + w];
      if (!d) continue;
      pt t;
      if (d > 0)
        pt_add_pre(acc, gt.tab[(size_t)gen_idx[i] * 128 + d - 1], t);
      else
        pt_sub_pre(acc, gt.tab[(size_t)gen_idx[i] * 128 + (-d) - 1], t);
      acc = t;
    }
  }
  o = acc;
}

struct IppState {
  size_t n;      // original vector length (power of two)
  size_t lg;     // log2(n)
  size_t round;  // next round to emit (0-based)
  u64 (*a)[4];   // current a vector (first n >> round entries valid)
  u64 (*b)[4];
  u64 (*wg)[4];  // fold coefficients over the original G basis (length n)
  u64 (*wh)[4];
  pt *G;         // original generator points (length n each)
  pt *H;
  pt Q;
  int gens_id;   // table registry id, or -1 (pointer-Pippenger fallback)
  // scratch reused across rounds (two independent halves: the L and R
  // sides run on separate threads)
  u64 (*sc_buf)[4];
  const pt **pt_buf;
  uint32_t *idx_buf;
  int8_t *dig_buf;
};

int g_ipp_threads = 2;  // xhe_ipp_set_threads

// fold state with challenge u after round ``r`` has been emitted
void ipp_fold(IppState *s, const uint8_t *u_bytes, size_t r) {
  u64 u[4], u_inv[4];
  load(u_bytes, u);
  invert_one(u, u_inv);
  size_t n_r = s->n >> (r + 1);  // half-length of the folded vectors
  size_t hi_shift = s->lg - 1 - r;
  for (size_t i = 0; i < n_r; ++i) {
    u64 t1[4], t2[4];
    mul_mod(s->a[i], u, t1);
    mul_mod(s->a[n_r + i], u_inv, t2);
    add_mod(t1, t2, s->a[i]);
    mul_mod(s->b[i], u_inv, t1);
    mul_mod(s->b[n_r + i], u, t2);
    add_mod(t1, t2, s->b[i]);
  }
  for (size_t i = 0; i < s->n; ++i) {
    u64 t[4];
    if ((i >> hi_shift) & 1) {
      mul_mod(s->wg[i], u, t);
      std::memcpy(s->wg[i], t, 32);
      mul_mod(s->wh[i], u_inv, t);
      std::memcpy(s->wh[i], t, 32);
    } else {
      mul_mod(s->wg[i], u_inv, t);
      std::memcpy(s->wg[i], t, 32);
      mul_mod(s->wh[i], u, t);
      std::memcpy(s->wh[i], t, 32);
    }
  }
}

}  // namespace

extern "C" {

// One-time table build for a generator basis (G_vec ‖ H_vec, n each).
// Returns a registry id for xhe_ipp_new, or -1 when the registry is full /
// the basis is too large to table (callers fall back to Pippenger).
int xhe_ipp_gens_register(size_t n, const uint8_t *Gp, const uint8_t *Hp) {
  if (g_n_registries >= MAX_REGISTRIES || n == 0 || n > 1024) return -1;
  GensTables &gt = g_registries[g_n_registries];
  gt.n_gens = 2 * n;
  gt.tab = new ptp[gt.n_gens * 128];
  for (size_t g = 0; g < gt.n_gens; ++g) {
    pt base, run;
    pt_load((g < n ? Gp + 128 * g : Hp + 128 * (g - n)), base);
    ptp *row = gt.tab + g * 128;
    run = base;
    pt_precompute(run, row[0]);
    for (int k = 1; k < 128; ++k) {
      pt t;
      pt_add(run, base, t);
      run = t;
      pt_precompute(run, row[k]);
    }
  }
  return g_n_registries++;
}

// Table-Straus MSM over registered generators plus free (scalar, point)
// lanes: out32 = compress(sum sc[i]*gens[gen_idx[i]] + sum esc[j]*epts[j]).
// Serves the prover's A/S bit commitments (builder.rs:525 -> dalek
// prove_multiple), which run over the same fixed basis as the IPP rounds.
int xhe_gens_msm(int gens_id, const uint32_t *gen_idx, const uint8_t *sc,
                 size_t n_lanes, const uint8_t *extra_sc,
                 const uint8_t *extra_pts, size_t n_extra, uint8_t *out32) {
  if (gens_id < 0 || gens_id >= g_n_registries) return 1;
  const GensTables &gt = g_registries[gens_id];
  u64(*scv)[4] = new u64[n_lanes][4];
  for (size_t i = 0; i < n_lanes; ++i) {
    if (gen_idx[i] >= gt.n_gens) {
      delete[] scv;
      return 1;
    }
    load(sc + 32 * i, scv[i]);
  }
  int8_t *dig = new int8_t[32 * n_lanes];
  pt acc;
  straus_msm(gt, gen_idx, scv, n_lanes, acc, dig);
  delete[] dig;
  delete[] scv;
  for (size_t j = 0; j < n_extra; ++j) {
    uint8_t rb[128];
    xhe_pt_mul(extra_sc + 32 * j, extra_pts + 128 * j, rb);
    pt e, t;
    pt_load(rb, e);
    pt_add(acc, e, t);
    acc = t;
  }
  uint8_t packed[128];
  pt_store(acc, packed);
  xhe_pt_compress(packed, out32);
  return 0;
}

// Gp/Hp: n packed points (128B each, extended coords); Q packed; gfac/hfac/
// a/b: n 32-byte scalars each.  ``gens_id`` from xhe_ipp_gens_register (or
// -1 for the pointer-Pippenger fallback).  Returns an opaque handle.
void *xhe_ipp_new(size_t n, int gens_id, const uint8_t *Gp, const uint8_t *Hp,
                  const uint8_t *Qp, const uint8_t *gfac, const uint8_t *hfac,
                  const uint8_t *a, const uint8_t *b) {
  if (n == 0 || (n & (n - 1)) != 0) return nullptr;
  IppState *s = new IppState;
  s->n = n;
  s->lg = 0;
  while (((size_t)1 << s->lg) < n) ++s->lg;
  s->round = 0;
  s->a = new u64[n][4];
  s->b = new u64[n][4];
  s->wg = new u64[n][4];
  s->wh = new u64[n][4];
  s->G = new pt[n];
  s->H = new pt[n];
  s->gens_id = (gens_id >= 0 && gens_id < g_n_registries &&
                g_registries[gens_id].n_gens == 2 * n)
                   ? gens_id
                   : -1;
  s->sc_buf = new u64[2 * (n + 1)][4];
  s->pt_buf = new const pt *[2 * (n + 1)];
  s->idx_buf = new uint32_t[2 * (n + 1)];
  s->dig_buf = new int8_t[2 * 32 * (n + 1)];
  for (size_t i = 0; i < n; ++i) {
    load(a + 32 * i, s->a[i]);
    load(b + 32 * i, s->b[i]);
    // first-round factors fold into wg/wh (dalek folds G_factors/H_factors
    // into round one)
    load(gfac + 32 * i, s->wg[i]);
    load(hfac + 32 * i, s->wh[i]);
    pt_load(Gp + 128 * i, s->G[i]);
    pt_load(Hp + 128 * i, s->H[i]);
  }
  pt_load(Qp, s->Q);
  return s;
}

// Emit round ``round``'s L and R (compressed, 32B each).  ``u_prev`` must
// be NULL on the first call and the previous round's challenge afterwards.
// Returns 0 ok, 1 when all rounds are done (nothing written), 2 bad call.
int xhe_ipp_round(void *handle, const uint8_t *u_prev, uint8_t *L_out,
                  uint8_t *R_out) {
  IppState *s = (IppState *)handle;
  if (!s) return 2;
  if (s->round > 0) {
    if (!u_prev) return 2;
    ipp_fold(s, u_prev, s->round - 1);
  }
  if (s->round >= s->lg) return 1;
  size_t r = s->round;
  size_t n_r = s->n >> (r + 1);
  size_t hi_shift = s->lg - 1 - r;

  // c_L = <a_L, b_R>, c_R = <a_R, b_L>
  u64 c_L[4] = {0, 0, 0, 0}, c_R[4] = {0, 0, 0, 0};
  for (size_t i = 0; i < n_r; ++i) {
    u64 t[4], acc[4];
    mul_mod(s->a[i], s->b[n_r + i], t);
    add_mod(c_L, t, acc);
    std::memcpy(c_L, acc, 32);
    mul_mod(s->a[n_r + i], s->b[i], t);
    add_mod(c_R, t, acc);
    std::memcpy(c_R, acc, 32);
  }

  // L = <a_L, G'_hi> + <b_R, H'_lo> + c_L*Q over the original basis;
  // R = <a_R, G'_lo> + <b_L, H'_hi> + c_R*Q.  The two sides are
  // independent (read-only on the session, own scratch halves) and run
  // on two threads unless xhe_ipp_set_threads(1) — build_batch callers
  // already saturate the cores with per-tx workers.
  pt L_pt, R_pt;
  auto emit_side = [&](int side) {
    u64(*sc)[4] = s->sc_buf + (size_t)side * (s->n + 1);
    const pt **pp = s->pt_buf + (size_t)side * (s->n + 1);
    uint32_t *gi = s->idx_buf + (size_t)side * (s->n + 1);
    int8_t *dig = s->dig_buf + (size_t)side * 32 * (s->n + 1);
    size_t cnt = 0;
    for (size_t i = 0; i < s->n; ++i) {
      size_t logical = i & (2 * n_r - 1);
      int hi = (i >> hi_shift) & 1;
      if (side == 0 ? hi : !hi) {
        // side L: hi-half G lanes carry a_L[logical - n_r];
        // side R: lo-half G lanes carry a_R[logical] = a[n_r + logical]
        const u64 *av = side == 0 ? s->a[logical - n_r] : s->a[n_r + logical];
        mul_mod(av, s->wg[i], sc[cnt]);
        pp[cnt] = &s->G[i];
        gi[cnt] = (uint32_t)i;
        ++cnt;
      }
    }
    for (size_t i = 0; i < s->n; ++i) {
      size_t logical = i & (2 * n_r - 1);
      int hi = (i >> hi_shift) & 1;
      if (side == 0 ? !hi : hi) {
        // side L: lo-half H lanes carry b_R[logical] = b[n_r + logical];
        // side R: hi-half H lanes carry b_L[logical - n_r]
        const u64 *bv = side == 0 ? s->b[n_r + logical] : s->b[logical - n_r];
        mul_mod(bv, s->wh[i], sc[cnt]);
        pp[cnt] = &s->H[i];
        gi[cnt] = (uint32_t)(s->n + i);
        ++cnt;
      }
    }
    pt &out = side == 0 ? L_pt : R_pt;
    const u64 *cQ = side == 0 ? c_L : c_R;
    if (s->gens_id >= 0) {
      straus_msm(g_registries[s->gens_id], gi, sc, cnt, out, dig);
      // + c*Q (Q = w*B varies per proof — not table-able)
      uint8_t kb[32], qb[128], rb[128];
      store(kb, cQ);
      pt_store(s->Q, qb);
      xhe_pt_mul(kb, qb, rb);
      pt cq, t;
      pt_load(rb, cq);
      pt_add(out, cq, t);
      out = t;
    } else {
      std::memcpy(sc[cnt], cQ, 32);
      pp[cnt] = &s->Q;
      ++cnt;
      pt_msm_core(sc, pp, cnt, out);
    }
  };
  if (g_ipp_threads > 1) {
    std::thread t0(emit_side, 0);
    emit_side(1);
    t0.join();
  } else {
    emit_side(0);
    emit_side(1);
  }
  uint8_t packed[128];
  pt_store(L_pt, packed);
  xhe_pt_compress(packed, L_out);
  pt_store(R_pt, packed);
  xhe_pt_compress(packed, R_out);
  s->round = r + 1;
  return 0;
}

// Apply the final fold with the last challenge and emit a, b (32B each).
int xhe_ipp_final(void *handle, const uint8_t *u_last, uint8_t *a_out,
                  uint8_t *b_out) {
  IppState *s = (IppState *)handle;
  if (!s || s->round != s->lg) return 2;
  if (s->lg > 0) {
    if (!u_last) return 2;
    ipp_fold(s, u_last, s->round - 1);
  }
  store(a_out, s->a[0]);
  store(b_out, s->b[0]);
  return 0;
}

void xhe_ipp_free(void *handle) {
  IppState *s = (IppState *)handle;
  if (!s) return;
  delete[] s->a;
  delete[] s->b;
  delete[] s->wg;
  delete[] s->wh;
  delete[] s->G;
  delete[] s->H;
  delete[] s->sc_buf;
  delete[] s->pt_buf;
  delete[] s->idx_buf;
  delete[] s->dig_buf;
  delete s;
}

// Inner parallelism of the IPP rounds (L/R sides).  build_batch sets 1 in
// its workers (outer per-tx threads already saturate the cores).
void xhe_ipp_set_threads(int n) { g_ipp_threads = n > 1 ? n : 1; }

}  // extern "C"
